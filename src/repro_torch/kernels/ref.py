"""Plain PyTorch versions of the hand-written kernels: the CPU path of each
wrapper, and the oracle the card's kernel is held against."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def mha_reference(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0
                  ) -> torch.Tensor:
    """Plain version of `kernels.flash_attention.flash_attention`: dense
    softmax attention in float32, kv heads repeated for GQA, masked scores
    set to the finite ``NEG_INF``. q: (B, H, S, D); k/v: (B, Hkv, T, D);
    returns (B, H, S, D) in q's dtype. Its backward is autograd through
    it."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * d ** -0.5
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p,
                        v.to(torch.float32)).to(q.dtype)


def elastic_update_reference(params, mom, grads, w_sum, running, lr, *,
                             momentum: float = 0.9):
    """Plain version of `kernels.elastic_update.elastic_sgd_update`.

    params/mom/grads: (R, P) float32; w_sum/running/lr: (R,). grads are
    SUM-form; the masked-renormalized mean (Eq. (5), exact 0 when Σw = 0)
    and the gated momentum-SGD apply are computed as in the kernel:

        inv = Σw > 0 ? 1/max(Σw, 1e-6) : 0
        v'  = μ·v + g·inv
        p'  = p − lr·v'
        (p, v) kept where not running

    Returns new (params, mom) tensors; the inputs are left untouched."""
    w = w_sum.to(torch.float32)[:, None]
    inv = torch.where(w > 0, 1.0 / torch.clamp(w, min=1e-6),
                      torch.zeros_like(w))
    run = (running.to(torch.float32) > 0)[:, None]
    lr = lr.to(torch.float32)[:, None]
    v_new = momentum * mom + grads * inv
    p_new = params - lr * v_new
    return torch.where(run, p_new, params), torch.where(run, v_new, mom)
