"""Fault execution: the process-local machinery that makes a `FaultPlan`
actually happen to a durable training run.

`FaultInjector` implements the chunk-hook protocol of
`trainer.train_batched_durable` (``on_resume`` / ``before_chunk`` /
``before_save`` / ``after_save`` / ``on_rollback`` — all optional,
resolved by ``getattr``), firing each due fault exactly once: fired
faults are recorded in a `FaultLedger` JSON file *before* the destructive
action executes, so the restarted process that resumes from a kill does
not re-kill itself.

`corrupt_checkpoint` damages a checkpoint on disk the way a real torn
write would (truncated shard, torn manifest, stale ``.tmp`` droppings);
`FlakyIO` arms `train.checkpoint._write_hook` to raise transient
``OSError``s. Both are also used directly by the test suite.
"""
from __future__ import annotations

import json
import os
import signal
import time
from typing import Optional

import numpy as np

from repro_torch.chaos.plan import Fault, FaultPlan
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.tree import tree_leaves


class FaultLedger:
    """Fired-fault persistence: a JSON file of plan indices that have
    already executed, written atomically (tmp + rename) *before* each
    destructive action so a SIGKILL between marking and dying still
    counts the fault as spent."""

    def __init__(self, path: str):
        self.path = path

    def fired(self) -> set:
        try:
            with open(self.path) as f:
                return set(json.load(f)["fired"])
        except (OSError, ValueError, KeyError):
            return set()

    def mark(self, index: int) -> None:
        fired = sorted(self.fired() | {int(index)})
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"fired": fired}, f)
        os.replace(tmp, self.path)


def corrupt_checkpoint(path: str, mode: str,
                       rng: Optional[np.random.Generator] = None) -> str:
    """Damage the checkpoint at `path` in-place. Returns a short
    description of what was done.

    ``truncate_shard``: cut a shard .npz (or the flat .npz itself) to a
    random prefix — an interrupted write that beat the rename barrier.
    ``torn_manifest``: cut the manifest/checkpoint file itself in half.
    ``stale_tmp``: drop junk ``.tmp.npz`` files next to the checkpoint —
    debris that must never shadow or invalidate the real files."""
    rng = rng or np.random.default_rng(0)
    if mode == "truncate_shard":
        target = path
        with open(path, "rb") as f:
            head = f.read(2)
        if head[:1] == b"{":               # sharded: pick a shard file
            with open(path) as f:
                manifest = json.load(f)
            shards = manifest["shards"]
            entry = shards[int(rng.integers(len(shards)))]
            target = os.path.join(os.path.dirname(os.path.abspath(path)),
                                  entry["file"])
        size = os.path.getsize(target)
        keep = int(rng.integers(1, max(2, size // 2)))
        with open(target, "r+b") as f:
            f.truncate(keep)
        return f"truncated {os.path.basename(target)} to {keep}B of {size}B"
    if mode == "torn_manifest":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return f"tore {os.path.basename(path)} to {size // 2}B of {size}B"
    if mode == "stale_tmp":
        d = os.path.dirname(os.path.abspath(path))
        names = []
        for i in range(2):
            junk = os.path.join(d, f"chaos{i}.tmp.npz")
            with open(junk, "wb") as f:
                f.write(rng.bytes(64))
            names.append(os.path.basename(junk))
        return f"dropped stale tmp files {names}"
    raise ValueError(f"unknown corrupt mode {mode!r}")


class FlakyIO:
    """Arms `checkpoint._write_hook` so the next `n` checkpoint writes
    raise a transient ``OSError`` (ENOSPC by default), then restores the
    hook. Re-arming while armed adds to the remaining count."""

    def __init__(self):
        self.remaining = 0
        # bound-method access mints a fresh object each time; pin one so
        # identity checks in arm/disarm actually match the installed hook
        self._bound = self._hook

    def arm(self, n: int, errno_: int = 28) -> None:   # 28 = ENOSPC
        self.remaining += int(n)
        self._errno = errno_
        if ckpt_mod._write_hook is not self._bound:
            self._prev = ckpt_mod._write_hook
            ckpt_mod._write_hook = self._bound

    def _hook(self, tmp, write_fn):
        if self.remaining > 0:
            self.remaining -= 1
            if self.remaining == 0:
                self.disarm()
            raise OSError(self._errno, "chaos: injected transient I/O "
                          "failure (disk full)")
        write_fn(tmp)

    def disarm(self) -> None:
        if ckpt_mod._write_hook is self._bound:
            ckpt_mod._write_hook = self._prev


def poison_model(state):
    """NaN every float leaf of the carry's model, in place — the injected
    analogue of a blown-up gradient step. Returns ``state``."""
    for leaf in tree_leaves(state.model):
        if leaf.is_floating_point():
            leaf.fill_(float("nan"))
    return state


class FaultInjector:
    """Executes a plan's tick-triggered faults at the durable loop's chunk
    hooks. Restart-triggered faults (``shrink``) are the supervisor's job
    and are ignored here.

    A tick-triggered fault is *due* at the first hook call whose tick is
    at or past its ``at_tick`` (chunks are the injection granularity —
    the loop only surfaces at boundaries) and fires at most once, ledgered
    across process restarts."""

    def __init__(self, plan: FaultPlan, ledger: FaultLedger,
                 sleep=time.sleep, die=None):
        self.plan = plan
        self.ledger = ledger
        self._sleep = sleep
        self._die = die or self._sigkill
        self._flaky = FlakyIO()
        self.events = []          # in-process record (the worker logs it)

    @staticmethod
    def _sigkill():
        os.kill(os.getpid(), signal.SIGKILL)

    def _due(self, tick: int, *kinds: str):
        fired = self.ledger.fired()
        for i, f in self.plan.by_kind(*kinds):
            if i not in fired and 0 <= f.at_tick <= tick:
                yield i, f

    def _fire(self, index: int, fault: Fault, detail: str = "") -> None:
        # ledger FIRST: a kill between mark and action must count as fired
        self.ledger.mark(index)
        self.events.append({"fault": fault.kind, "index": index,
                            "detail": detail, "time": time.time()})

    # ------------------------------------------------- chunk-hook protocol

    def before_chunk(self, tick: int, state):
        """hang → stall; nan → poison the carry; io_error → arm flaky
        writes. Returns the (possibly poisoned) state."""
        for i, f in self._due(tick, "hang"):
            self._fire(i, f, f"hang {f.duration}s at tick {tick}")
            self._sleep(f.duration)
        for i, f in self._due(tick, "io_error"):
            self._fire(i, f, f"next {f.count} writes fail at tick {tick}")
            self._flaky.arm(f.count)
        for i, f in self._due(tick, "nan"):
            self._fire(i, f, f"model poisoned with NaN at tick {tick}")
            state = poison_model(state)
        return state

    def before_save(self, tick: int):
        """kill → die after the chunk's compute, before its checkpoint —
        the mid-chunk preemption that loses the whole chunk."""
        for i, f in self._due(tick, "kill"):
            self._fire(i, f, f"SIGKILL before save at tick {tick}")
            self._die()

    def after_save(self, tick: int, path: str):
        """corrupt → tear the checkpoint that just landed, then die (the
        restart must fall back past it)."""
        for i, f in self._due(tick, "corrupt"):
            rng = np.random.default_rng(self.plan.seed + i)
            detail = corrupt_checkpoint(path, f.mode, rng)
            self._fire(i, f, f"{detail}; SIGKILL at tick {tick}")
            if f.mode != "stale_tmp":
                self._die()

    def on_rollback(self, tick: int, reason: str):
        self.events.append({"fault": "rollback", "detail":
                            f"rolled back to tick {tick}: {reason}",
                            "time": time.time()})
