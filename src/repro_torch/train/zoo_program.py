"""Zoo ↔ engine adapter: a zoo ``ModelConfig`` as an engine ModelProgram
stepped cell by cell (`sim.engine.per_cell`), trained under elastic
worker masking.

* **Mixed precision**: when ``cfg.param_dtype`` is narrower than float32
  the carry holds bf16 params (what the forward and backward consume)
  beside float32 optimizer masters and float32 momentum. Grads are
  computed against the bf16 params, cast up, applied to the masters, and
  the masters are cast down to refresh the params. The loss stays float32
  end to end. With bf16 params and SGD with momentum (`lands_in_place`)
  all of that is one gated pass in place (`kernels.ops.mixed_sgd_update`,
  a CUDA kernel on the card), bit for bit the functional update followed
  by `sim.engine.gate_model`; other optimizers form new trees and land
  them through `gate_model`. With a float32 ``param_dtype`` the carry is
  exactly `train_step.init_train_state`'s ``(params, opt_state)``.
* **Elastic masking**: the engine's (n_max,) active-worker mask drives the
  per-worker token weights inside `train_step.make_loss_grad`, with
  `core.elastic.weighted_mean`'s exact-zero convention; idle ticks are
  true no-ops: every step lands its update only where the tick's
  ``running`` holds.
* **Flash attention**: ``cfg.use_flash_attention`` routes full-sequence
  self-attention through `kernels.ops.flash_mha` (K2 on the card); nothing
  else changes here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import JobConfig, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import model_zoo
from repro_torch.models.common import init_params, spec_dtypes
from repro_torch.optim.sgd import constant_lr, get_optimizer
from repro_torch.sim import engine
from repro_torch.spans import span
from repro_torch.train.train_step import init_train_state, make_loss_grad
from repro_torch.tree import tree_leaves, tree_map


def is_mixed_precision(cfg: ModelConfig) -> bool:
    """True when the config's param dtype is narrower than float32 —
    selects the master-copy carry layout. A bad dtype string raises the
    named `configs.base.DtypeError` here."""
    return cfg.resolved_param_dtype() != torch.float32


def lands_in_place(cfg: ModelConfig, job: JobConfig) -> bool:
    """True when the zoo step lands its own update in place, gated on the
    tick's ``running``: bf16 params over float32 masters (the dtypes
    `kernels.ops.mixed_sgd_update` takes) and SGD with momentum."""
    return (cfg.resolved_param_dtype() == torch.bfloat16
            and job.optimizer == "sgd" and job.momentum != 0.0)


def init_zoo_state(cfg: ModelConfig, job: JobConfig, seed: int, *, device):
    """The zoo program's initial model carry on ``device``.

    float32 configs: exactly ``init_train_state`` — ``(params,
    opt_state)``. Mixed-precision configs: ``{"params": bf16, "master":
    f32, "opt": f32}``, the params being the masters cast down leaf for
    leaf (per-ParamSpec dtype overrides honoured) and the optimizer state
    initialized over the masters."""
    if not is_mixed_precision(cfg):
        return init_train_state(cfg, job, seed, device=device)
    defs = model_zoo.param_defs(cfg)
    master = init_params(defs, seed, torch.float32, device=device)
    params = tree_map(lambda m, dt: m.to(dt), master,
                      spec_dtypes(defs, cfg.resolved_param_dtype()))
    opt = get_optimizer(job.optimizer, job.momentum)
    return {"params": params, "master": master, "opt": opt.init(master)}


def make_zoo_step(cfg: ModelConfig, job: JobConfig, remat: str = "none"):
    """One zoo training iteration over the `init_zoo_state` carry:
    ``zoo_step(model, batch, mask, j, running) -> (model, loss)``, which
    updates ``model`` in place where the 0-d ``running`` holds and leaves
    every bit of it elsewhere: in one pass where `lands_in_place`, else
    by new trees landed through `engine.gate_model`."""
    grad_step = make_loss_grad(cfg, job, remat)
    opt = get_optimizer(job.optimizer, job.momentum)
    lr_fn = constant_lr(job.learning_rate)

    if not is_mixed_precision(cfg):
        def zoo_step(model, batch, mask, j, running):
            params, opt_state = model
            grads, loss, _ = grad_step(params, batch, mask)
            with span("step.optimizer"):
                stepped = opt.update(grads, opt_state, params, lr_fn(j))
            del grads
            engine.gate_model(running, stepped, model)
            return model, loss

        return zoo_step

    if lands_in_place(cfg, job):
        def zoo_step(model, batch, mask, j, running):
            grads, loss, _ = grad_step(model["params"], batch, mask)
            with span("step.optimizer"):
                # autograd may hand back a strided gradient; the kernel
                # takes contiguous leaves
                ops.mixed_sgd_update(
                    [g.contiguous() for g in tree_leaves(grads)],
                    tree_leaves(model["opt"]), tree_leaves(model["master"]),
                    tree_leaves(model["params"]), running, lr_fn(j),
                    momentum=job.momentum)
            return model, loss

        return zoo_step

    def zoo_step(model, batch, mask, j, running):
        grads, loss, _ = grad_step(model["params"], batch, mask)
        with span("step.optimizer"):
            g32 = tree_map(lambda g: g.to(torch.float32), grads)
            del grads
            master, opt_state = opt.update(g32, model["opt"],
                                           model["master"], lr_fn(j))
            del g32
            # refresh the low-precision working copy from the masters
            params = tree_map(lambda m, p: m.to(p.dtype), master,
                              model["params"])
        engine.gate_model(running, {"params": params, "master": master,
                                    "opt": opt_state}, model)
        return model, loss

    return zoo_step


def make_zoo_program(cfg: ModelConfig, job: JobConfig, n_batches: int,
                     remat: str = "none") -> engine.ModelProgram:
    """A zoo ``ModelConfig`` as an engine ModelProgram, stepped cell by
    cell (`engine.per_cell`).

    ``data`` is the `trainer.stack_batches` dict (leading (n_batches,)
    axis), indexed ``j % n_batches`` on the device (no host sync). The
    scenario ``alpha`` and the random word are ignored — the learning rate
    comes from the job, as everywhere in the trainer."""
    step = make_zoo_step(cfg, job, remat)

    def cell_step(model, data, key, mask, j, alpha, running):
        del key, alpha
        idx = (j % n_batches).reshape(1)
        batch = {k: x.index_select(0, idx)[0] for k, x in data.items()}
        return step(model, batch, mask, j, running)

    mode = "mixed" if is_mixed_precision(cfg) else "f32"
    return engine.per_cell(cell_step,
                           f"zoo-{cfg.name}-{n_batches}-{mode}")
