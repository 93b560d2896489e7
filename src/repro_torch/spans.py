"""Host spans at the port's layer boundaries.

``with span(name):`` records a range named ``name`` on the host, on the
profiler's own clock, nested with the aten operations that run inside it.
With no profiler running it costs one C call and records nothing: an
operator gets the spans by running the launcher, or any trainer call,
under ``torch.profiler``. A span never syncs the device, never allocates
device memory, and has no twin on the device's timeline: it is a plain
function range (``torch.profiler.record_function`` opens a user annotation
instead, which the profiler mirrors onto the device as an event of its
own).

The spans, each with the one open around it on the host thread:

* ``engine.tick``: one tick of the engine's loop (`sim.engine._run_ticks`,
  the sharded path through it too);
* ``engine.market``: the tick's market and accounting
  (`sim.engine._market_tick`), under ``engine.tick``;
* ``engine.gate``: landing a step's new trees in the carry under the
  tick's ``running`` (`sim.engine.gate_model`, which a step calls after
  its ``step.optimizer`` closes), under ``engine.tick``; a step that lands
  its update in one pass (the mixed-precision zoo step with SGD and
  momentum, the megabatch step) opens none;
* ``step.forward``: the step's forward and loss (`train.megabatch`'s
  ``_fwd_res``; `train.train_step.make_loss_grad`'s loss, once a
  micro-slice), under ``engine.tick`` in the engine's programs;
* ``step.backward``: the step's gradient (`train.megabatch`'s ``_bwd``;
  ``torch.autograd.grad`` in ``make_loss_grad``). Autograd's backward
  may run on a worker thread of its own, while this thread waits inside
  the span;
* ``step.optimizer``: the update (the megabatch step's fused or plain
  update and its loss; the zoo step's gated in-place update, or its cast
  of the gradients, the optimizer and the refresh of the low-precision
  parameters; the train step's optimizer);
* ``train.prepare``: a trainer call's batches and program
  (`train.trainer._prepare_batched`) and the grid's initial carry
  (`train.trainer.batched_init_state`);
* ``engine.readback``: the engine call's copies of its results to the
  host (`sim.engine._engine_result`);
* ``moe.route``: an MoE block's router, softmax, top-k and (E, C)
  dispatch tables, the gather of its held experts' slots and the combine
  (`models.moe._moe_device`), under ``step.forward``;
* ``moe.experts``: the held experts' two batched products and the shared
  experts (`models.moe._moe_device`), under ``step.forward``;
* ``mla.core``: MLA's expansion of the latent to per-head keys and values
  and its float32 scores, softmax and values, or the absorbed path's over
  the latent cache (`models.mla._mla_heads`), under ``step.forward``.

The model's spans cover the forward only: autograd's backward of what they
launched runs under ``step.backward``, and under remat the recompute of a
layer in the backward opens them again there.
"""
from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast

NAMES = ("engine.tick", "engine.market", "engine.gate", "step.forward",
         "step.backward", "step.optimizer", "train.prepare",
         "engine.readback", "moe.route", "moe.experts", "mla.core")


def span(name: str) -> _RecordFunctionFast:
    """A context manager over the span ``name``, one of `NAMES`."""
    return _RecordFunctionFast(name)
