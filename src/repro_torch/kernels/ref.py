"""Plain PyTorch versions of the hand-written kernels: the CPU path of each
wrapper, and the oracle the card's kernel is held against."""
from __future__ import annotations

import torch


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
