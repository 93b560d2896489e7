"""Elastic synchronous SGD — the paper's technique as a runtime mechanism.

The global batch is partitioned into ``n_workers`` contiguous worker slices.
Each step takes an ``active_mask ∈ {0,1}^{n_workers}``; the gradient is the
masked, renormalized mean — exactly Eq. (5) with y_j = Σ mask: preempted
workers contribute zero and the sum is divided by the *active* example
count. The mask enters via per-example loss weights, so nothing is
re-laid-out on preemption events.
"""
from __future__ import annotations

import numpy as np
import torch


def example_weights(active_mask: torch.Tensor,
                    batch_size: int) -> torch.Tensor:
    """Per-example weights implementing the masked worker average.

    active_mask: (n_workers,) float {0,1}. Returns (batch_size,) float32
    weights w with w_e = mask[worker(e)] and worker(e) = e // (B/n_workers).
    The loss normalizer divides by Σ w (see ``weighted_mean``), so together
    this is (1/y_j)·Σ_{active} g^{(i)} — Eq. (5) with y_j active workers.
    """
    n_workers = active_mask.shape[0]
    if batch_size % n_workers:
        raise ValueError(f"batch {batch_size} does not split into "
                         f"{n_workers} worker slices")
    per = batch_size // n_workers
    return active_mask.to(torch.float32).repeat_interleave(per)


def weighted_mean(values: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Σ w·v / Σ w, exactly 0 (value *and* gradient) when Σ w = 0.

    y_j = 0 steps are idle time: every tick of the batched engine still
    evaluates the step, so an ε-denominator alone would silently scale the
    surviving Σ w·v (nonzero when weights are fractional) instead of
    erasing it. The double ``where`` keeps 0/0 out of both the value and
    the autograd graph, making the all-preempted step a true no-op.

    The denominator is Σ w itself whenever it is positive — NOT an
    ε-clamp: fractional weights can make Σ w arbitrarily small but nonzero,
    and ``max(Σw, ε)`` would silently shrink the mean there."""
    w_sum = weights.sum()
    pos = w_sum > 0
    mean = (values * weights).sum() / torch.where(pos, w_sum,
                                                  torch.ones_like(w_sum))
    return torch.where(pos, mean, torch.zeros_like(mean))


def active_fraction(active_mask: torch.Tensor) -> torch.Tensor:
    """The share of workers active this step (the mask's mean)."""
    return active_mask.mean()


def worker_of_example(batch_size: int, n_workers: int) -> np.ndarray:
    """The worker slice each example of the global batch belongs to."""
    return np.arange(batch_size) // (batch_size // n_workers)


def mask_from_active_count(n_workers: int, y: int) -> np.ndarray:
    """First-y-active mask (used by simulators that only track counts)."""
    m = np.zeros(n_workers, np.float32)
    m[:y] = 1.0
    return m


def mask_from_bids(bids: np.ndarray, price: float) -> np.ndarray:
    """Spot semantics: a worker is active iff its bid ≥ the prevailing
    price."""
    return (np.asarray(bids) >= price).astype(np.float32)
