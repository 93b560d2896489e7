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


def ssd_reference(xh, dt, a_h, bm, cm, h0=None):
    """Naive per-token SSD recurrence (the semantic ground truth).

    xh: (B, S, H, P), dt: (B, S, H), a_h: (H,), bm/cm: (B, S, G, N), head
    h reading group h // (H / G); h0: (B, H, P, N) initial state (default
    zeros, as in the reference, which takes none).

        h_t = exp(dt_t·a)·h_{t−1} + dt_t·B_t⊗x_t ;  y_t = C_t·h_t

    Returns (y (B, S, H, P) in xh's dtype, final state (B, H, P, N)
    float32)."""
    b, s, h, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    rep = h // g
    f32 = torch.float32
    bmh = bm.repeat_interleave(rep, dim=2).to(f32)          # (B, S, H, N)
    cmh = cm.repeat_interleave(rep, dim=2).to(f32)
    x = xh.to(f32)
    dt = dt.to(f32)
    a_h = a_h.to(f32)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
             if h0 is None else h0.to(f32))
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t] * a_h)                      # (B, H)
        state = (state * da[..., None, None]
                 + dt[:, t, :, None, None] * x[:, t, ..., None]
                 * bmh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cmh[:, t]))
    return torch.stack(ys, dim=1).to(xh.dtype), state


def ssd_chunk_reference(xh, dt, a_h, bm, cm, *, chunk: int):
    """Plain version of `kernels.ssd_scan.ssd_chunk` (K3): the intra-chunk
    SSD terms per (batch, head, chunk of Q = min(chunk, S) positions), in
    float32, formed as the reference's TPU kernel forms them:

        cs      = cumsum(dt·a)
        decay   = where(j ≤ i, exp(where(j ≤ i, cs_i − cs_j, 0)), 0)
        y_intra = ((C·Bᵀ) · decay · dt_j) @ x
        state   = (B · (exp(cs_last − cs)·dt))ᵀ @ x

    xh (B, S, H, P); dt (B, S, H); a_h (H,); bm, cm (B, S, G, N). Returns
    (y_intra (B, S, H, P) in xh's dtype, states (B, nc, H, N, P), cs (B,
    nc, H, Q), chunk_decay (B, nc, H)), the last three float32."""
    b, s, h, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD "
                         f"chunk {q}")
    nc, rep = s // q, h // g
    f32 = torch.float32

    def heads_first(t, k):                   # (B, S, k, D) -> (B, nc, k, Q, D)
        return t.to(f32).reshape(b, nc, q, k, -1).permute(0, 1, 3, 2, 4)

    x = heads_first(xh, h)
    bc = heads_first(bm, g).repeat_interleave(rep, dim=2)
    cc = heads_first(cm, g).repeat_interleave(rep, dim=2)
    dtc = dt.to(f32).reshape(b, nc, q, h).permute(0, 1, 3, 2)  # (B,nc,H,Q)
    cs = torch.cumsum(dtc * a_h.to(f32)[:, None], dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]                # cs_i − cs_j
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.where(tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0)
    w = (cc @ bc.transpose(-1, -2)) * decay * dtc[..., None, :]
    y = w @ x                                                # (B,nc,H,Q,P)
    last = cs[..., -1:]
    wstate = torch.exp(last - cs) * dtc
    states = (bc * wstate[..., None]).transpose(-1, -2) @ x  # (B,nc,H,N,P)
    y_intra = y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p).to(xh.dtype)
    return y_intra, states, cs, torch.exp(last[..., 0])
