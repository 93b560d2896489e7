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
  every layout and the sharded path through it);
* ``engine.market``: the tick's market and accounting
  (`sim.engine._market_tick`), under ``engine.tick``;
* ``engine.gate``: landing a per-cell step in the carry
  (`sim.engine._gate_model`), under ``engine.tick``; a program that gates
  itself (the mixed-precision zoo step with SGD and momentum) opens none;
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
  host (`sim.engine._engine_result`).
"""
from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast

NAMES = ("engine.tick", "engine.market", "engine.gate", "step.forward",
         "step.backward", "step.optimizer", "train.prepare",
         "engine.readback")


def span(name: str) -> _RecordFunctionFast:
    """A context manager over the span ``name``, one of `NAMES`."""
    return _RecordFunctionFast(name)
