"""Loss functions with elastic worker weighting."""
from __future__ import annotations

import torch

from repro_torch.core.elastic import example_weights, weighted_mean


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood (B, S) of logits (B, S, V), in
    float32 (the logits are upcast before the logsumexp)."""
    l32 = logits.to(torch.float32)
    lse = torch.logsumexp(l32, dim=-1)
    gold = l32.gather(-1, labels[..., None])[..., 0]
    return lse - gold


def next_token_loss(logits, labels, weights=None):
    """Cross entropy of logits (B,S,V) vs labels (B,S) with optional
    per-token weights (B,S). Normalizes by Σ weights (the masked worker
    average of Eq. (5)); all-masked batches are exactly 0 — see
    `core.elastic.weighted_mean`."""
    nll = token_nll(logits, labels)
    if weights is None:
        weights = torch.ones_like(nll)
    return weighted_mean(nll, weights.to(torch.float32))


def elastic_token_weights(active_mask, batch_size: int, seq_len: int,
                          label_mask=None):
    """(B,S) weights: worker mask broadcast over the sequence × optional
    label mask (e.g. VLM text-only positions)."""
    w = example_weights(active_mask, batch_size)[:, None]
    w = w.expand(batch_size, seq_len)
    if label_mask is not None:
        w = w * label_mask.to(w.dtype)
    return w
