"""Loss functions with elastic worker weighting, and the vocab-parallel
cross entropy over the logits' vocab slices of a mesh's tp ranks."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.elastic import example_weights, weighted_mean
from repro_torch.models import spmd
from repro_torch.models.common import tp_ranks, tp_slice
from repro_torch.models.transformer import unembed, unembed_ranks


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token negative log-likelihood (B, S) of logits (B, S, V), in
    float32 (the logits are upcast before the logsumexp). Under a mesh
    context whose model axis divides the vocab, the logits are cut into
    the tp ranks' vocab slices, each on its rank's device, batch groups
    over the data ranks, and the loss is `vocab_parallel_nll`, as the
    reference's runs over its vocab-sharded logits."""
    tpr = tp_ranks()
    if tpr is None or logits.shape[-1] % tpr.size:
        l32 = logits.to(torch.float32)
        lse = torch.logsumexp(l32, dim=-1)
        gold = l32.gather(-1, labels[..., None])[..., 0]
        return lse - gold
    return torch.cat([vocab_parallel_nll(
        [tp_slice(logits[rows], (None, None, "tp"), r).to(dev)
         for r, dev in enumerate(devs)], labels[rows]).to(logits.device)
        for rows, devs in tpr.groups(logits.shape[0])], dim=0)


def vocab_parallel_nll(ranks: Sequence[torch.Tensor], labels: torch.Tensor
                       ) -> torch.Tensor:
    """Per-token negative log-likelihood (B, S) from the tp ranks' logit
    slices (B, S, V / tp) in rank order, each on its rank's device, in
    float32, on the first rank's device: per rank the maximum, then a
    `spmd.pmax`; per rank Σ exp(l − max), then a `spmd.psum`; the gold
    logit read on the rank whose slice holds the label (0 on the others),
    then a `spmd.psum`. The logsumexp is log(Σ) + max, as
    ``torch.logsumexp`` forms it; the maximum carries no gradient, so the
    logits' gradient is the softmax less the label's one-hot. The ranks'
    sums add in rank order, where the whole logsumexp sums the vocab in
    one, so the two agree to rounding."""
    width = ranks[0].shape[-1]
    l32 = [t.to(torch.float32) for t in ranks]
    top = spmd.pmax([t.detach().amax(dim=-1) for t in l32])
    sums = spmd.psum([torch.exp(t - m[..., None]).sum(dim=-1)
                      for t, m in zip(l32, top)])
    golds = []
    for r, t in enumerate(l32):
        local = labels.to(t.device) - r * width
        held = (local >= 0) & (local < width)
        gold = t.gather(-1, local.clamp(0, width - 1)[..., None])[..., 0]
        golds.append(torch.where(held, gold, torch.zeros_like(gold)))
    return torch.log(sums[0]) + top[0] - spmd.psum(golds)[0]


def head_token_nll(params, cfg, x: torch.Tensor, labels: torch.Tensor,
                   skip: int = 0) -> torch.Tensor:
    """Per-token negative log-likelihood (B, S) of the LM head on the last
    hidden states x (B, skip + S, d) (before the final norm), the first
    ``skip`` positions (a VLM's patches) left out. Under a mesh context
    whose model axis divides the vocab each tp rank forms its logit slice
    on its device (`models.transformer.unembed_ranks`) and the loss is
    `vocab_parallel_nll`: the (B, S, V) logits are never joined. Else
    `token_nll` of `models.transformer.unembed`'s whole logits."""
    parts = unembed_ranks(params, cfg, x[:, skip:])
    if parts is None:
        return token_nll(unembed(params, cfg, x)[:, skip:], labels)
    return torch.cat([vocab_parallel_nll(ranks, labels[rows]).to(x.device)
                      for rows, ranks in parts], dim=0)


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
