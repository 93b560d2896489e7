"""Elastic train step builders over the model zoo: the loss/gradient core
shared by the plain train step and the zoo program, the train, eval and
serve steps, and the initial (params, opt_state). Gradients come from
``torch.autograd``."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import JobConfig, ModelConfig
from repro_torch.models import model_zoo
from repro_torch.models.common import init_params, shard
from repro_torch.optim.sgd import constant_lr, get_optimizer
from repro_torch.train.loss import (elastic_token_weights, head_token_nll,
                                    next_token_loss)
from repro_torch.tree import tree_leaves, tree_unflatten


def make_loss_grad(cfg: ModelConfig, job: JobConfig, remat: str = "full"):
    """Returns grad_step(params, batch, active_mask) -> (grads, loss, aux).

    Per-worker token weights from the elastic ``active_mask``, masked-mean
    normalization with `core.elastic.weighted_mean`'s exact-zero
    convention (Σw=0 → loss 0, grads 0; denominator ``where(Σw>0, Σw,
    1)``), and optional gradient accumulation over ``job.microbatch``
    micro-slices (float32 accumulators, as in the reference). ``grads``
    has ``params``' structure; ``loss`` and ``aux`` are 0-d float32
    tensors without a graph. The forward stops before the LM head, which
    `train.loss.head_token_nll` applies: under a mesh whose model axis
    divides the vocab, the loss is vocab-parallel and the (B, S, V)
    logits are never joined on one device."""
    n_micro = max(job.microbatch, 1)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0

    def _losses(p, batch, active_mask, b):
        """(weighted nll sum, weight sum, aux) for one (micro)batch —
        sum-form so microbatch accumulation is exactly the full-batch
        masked mean of Eq. (5)."""
        x, aux = model_zoo.forward_hidden(p, cfg, batch, remat=remat)
        skip = cfg.vision.num_patches if cfg.family == "vlm" else 0
        labels = batch["labels"]
        w = elastic_token_weights(active_mask, b, labels.shape[1],
                                  batch.get("label_mask"))
        w = shard(w, "batch", None).to(torch.float32)
        nll_sum = (head_token_nll(p, cfg, x, labels, skip) * w).sum()
        return nll_sum, w.sum(), aux

    def _grads(objective, leaves, like):
        g = torch.autograd.grad(objective, leaves, allow_unused=True)
        return [torch.zeros_like(x) if gi is None else gi
                for gi, x in zip(g, like)]

    def grad_step(params, batch: Dict, active_mask):
        leaves = tree_leaves(params)
        b = batch["tokens"].shape[0]

        if n_micro == 1:
            live = [x.detach().requires_grad_() for x in leaves]
            nll_sum, w_sum, aux = _losses(tree_unflatten(params, live),
                                          batch, active_mask, b)
            pos = w_sum > 0
            loss = nll_sum / torch.where(pos, w_sum, torch.ones_like(w_sum))
            if cfg.moe is not None:
                loss = loss + aux_w * aux
            # exact 0 (value and grads) when every worker is preempted
            loss = torch.where(pos, loss, torch.zeros_like(loss))
            grads = _grads(loss, live, leaves)
            return (tree_unflatten(params, grads), loss.detach(),
                    aux.detach())

        # gradient accumulation over micro-slices; grads of the SUM
        # accumulate in float32, normalization by Σw at the end
        assert b % n_micro == 0, (b, n_micro)
        mb = b // n_micro
        n_w = active_mask.shape[0]
        assert n_w % n_micro == 0, (
            "n_workers must split evenly across microbatches so worker "
            "slices stay contiguous", n_w, n_micro)
        mask_micro = active_mask.reshape(n_micro, n_w // n_micro)
        dev = batch["tokens"].device
        g_acc = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
                 for x in leaves]
        nll_acc, w_acc, aux_acc = (torch.zeros((), dtype=torch.float32,
                                               device=dev) for _ in range(3))
        for i in range(n_micro):
            mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            live = [x.detach().requires_grad_() for x in leaves]
            nll, w_sum, aux = _losses(tree_unflatten(params, live), mbatch,
                                      mask_micro[i], mb)
            # the aux loss folds in sum-form (× w_sum), so dividing by the
            # global Σw yields CE + aux_w·weighted-mean(aux)
            obj = nll + aux_w * aux * w_sum
            for acc, g in zip(g_acc, _grads(obj, live, leaves)):
                acc.add_(g)
            nll_acc = nll_acc + obj.detach()
            w_acc = w_acc + w_sum
            aux_acc = aux_acc + aux.detach()
        denom = torch.where(w_acc > 0, w_acc, torch.ones_like(w_acc))
        grads = [g / denom for g in g_acc]
        loss = torch.where(w_acc > 0, nll_acc / denom,
                           torch.zeros_like(nll_acc))
        return tree_unflatten(params, grads), loss, aux_acc / n_micro

    return grad_step


def make_train_step(cfg: ModelConfig, job: JobConfig,
                    lr_fn: Optional[Callable] = None, remat: str = "full"):
    """Returns train_step(params, opt_state, batch, active_mask, step).

    batch: tokens (B,S), labels (B,S), optional label_mask (B,S), frames
    for encdec, patches for vlm. active_mask: (n_workers,) float — the elastic worker mask
    (Eq. (5) with y_j = Σ mask)."""
    opt = get_optimizer(job.optimizer, job.momentum)
    lr_fn = lr_fn or constant_lr(job.learning_rate)
    grad_step = make_loss_grad(cfg, job, remat)

    def train_step(params, opt_state, batch: Dict, active_mask, step):
        grads, loss, aux = grad_step(params, batch, active_mask)
        lr = lr_fn(step)
        new_params, new_opt = opt.update(grads, opt_state, params, lr)
        metrics = {"loss": loss, "moe_aux": aux,
                   "active_workers": active_mask.sum(), "lr": lr}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            logits, _ = model_zoo.forward(params, cfg, batch, remat="none")
            if cfg.family == "vlm":
                logits = logits[:, cfg.vision.num_patches:]
            return next_token_loss(logits, batch["labels"],
                                   batch.get("label_mask"))

    return eval_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy next token (B, 1) and the updated caches.
    Runs under ``torch.no_grad()``: serving keeps no graph."""

    def serve_step(params, caches, tokens, pos):
        with torch.no_grad():
            logits, new_caches = model_zoo.decode_step(params, cfg, tokens,
                                                       caches, pos)
            return torch.argmax(logits[:, -1:], dim=-1), new_caches

    return serve_step


def init_train_state(cfg: ModelConfig, job: JobConfig, seed: int, *,
                     device):
    """(params, opt_state) on ``device``, drawn from ``seed`` by
    `models.common.init_params`."""
    params = init_params(model_zoo.param_defs(cfg), seed,
                         cfg.resolved_param_dtype(), device=device)
    opt = get_optimizer(job.optimizer, job.momentum)
    return params, opt.init(params)
