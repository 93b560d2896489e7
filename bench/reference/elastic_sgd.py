"""Eq. (5) of the paper with momentum: the elastic masked-mean gradient
step of one replica, in float32.

With y active workers, each worker's rows of the batch weigh 1 and the
others' 0, and the gradient is that of the weighted mean loss
Σ w·nll / Σ w (exactly 0 where Σ w = 0). The step keeps SGD momentum:

    v ← μ·v + g
    p ← p − lr·v

and changes nothing on a tick that does not run."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def row_weights(mask: np.ndarray, batch: int) -> np.ndarray:
    """(batch,) weights: each of the n workers owns batch/n contiguous
    rows, which take its mask value."""
    n = len(mask)
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} workers")
    return np.repeat(np.asarray(mask, np.float32), batch // n)


def masked_mean(nll: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ w·nll / Σ w, and 0 where Σ w = 0."""
    tot = w.sum()
    return torch.where(tot > 0, (nll * w).sum() / torch.where(
        tot > 0, tot, torch.ones_like(tot)), torch.zeros_like(tot))


@torch.no_grad()
def step(params: Dict[str, torch.Tensor], mom: Dict[str, torch.Tensor],
         grads: Dict[str, torch.Tensor], lr: float, momentum: float) -> None:
    """One momentum-SGD step on float32 leaves, in place."""
    for k, g in grads.items():
        mom[k].mul_(momentum).add_(g)
        params[k].sub_(lr * mom[k])
