"""Deterministic fault plans for chaos-testing durable training (the
reference's format: a plan file written by either package loads in the
other).

A `FaultPlan` is a seeded, JSON-round-trippable list of `Fault`s — each one
names a failure mode of a real spot deployment and when it strikes:

  kill      SIGKILL the training process mid-chunk (after the chunk's
            compute, before its checkpoint lands) — the paper's preemption
            applied to the *trainer itself*, the worst-case timing for a
            durable loop.
  corrupt   Tear the checkpoint that was just written (truncated shard
            .npz, torn manifest, or stale ``.tmp`` leftovers) and then die
            — the filesystem-level damage a preemption can leave behind
            beyond what tmp+rename guards against (e.g. a lost write on a
            network mount).
  io_error  Make the next `count` checkpoint writes raise a transient
            ``OSError`` (disk-full / EIO) — exercises the writer's
            retry-with-backoff and, past it, crash-and-resume.
  shrink    Between restarts, the visible device fleet shrinks to
            `devices` (8→4→1; the worker sees the first `devices` cards
            through ``CUDA_VISIBLE_DEVICES``) — exercises the supervisor's
            graceful degradation.
  nan       Poison the model carry with NaN at a chunk boundary — the
            numeric blowup the durable loop's NaN guard must catch and
            roll back instead of checkpointing poison.
  hang      Stall a chunk for `duration` seconds (a straggler / livelock)
            — the supervisor's heartbeat timeout must detect and restart.

Tick-triggered faults fire at the first chunk boundary at or after
``at_tick``; `shrink` fires before the restart numbered ``at_restart``.
Every fault fires at most once per run: `inject.FaultLedger` persists
fired faults across process restarts, so a kill does not re-kill the
process that resumes from it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np

KINDS = ("kill", "corrupt", "io_error", "shrink", "nan", "hang")
CORRUPT_MODES = ("truncate_shard", "torn_manifest", "stale_tmp")

PLAN_FORMAT = "repro-fault-plan-v1"


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled failure. Unused kind-specific fields keep their
    defaults and are omitted from the JSON form."""

    kind: str
    at_tick: int = -1        # tick-triggered kinds: first boundary >= this
    at_restart: int = -1     # shrink: before restart number N (0 = first
    #                          launch)
    mode: str = "truncate_shard"   # corrupt: one of CORRUPT_MODES
    devices: int = 1         # shrink: new visible device count
    duration: float = 600.0  # hang: seconds to stall
    count: int = 1           # io_error: consecutive failing writes

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose from {KINDS}")
        if self.kind == "shrink":
            if self.at_restart < 0:
                raise ValueError("shrink faults trigger between restarts: "
                                 "set at_restart >= 0")
            if self.devices < 1:
                raise ValueError(f"shrink to devices={self.devices} < 1")
        elif self.at_tick < 0:
            raise ValueError(f"{self.kind} faults trigger at a tick: set "
                             "at_tick >= 0")
        if self.kind == "corrupt" and self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown corrupt mode {self.mode!r}; "
                             f"choose from {CORRUPT_MODES}")

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        if self.kind == "shrink":
            d.update(at_restart=self.at_restart, devices=self.devices)
        else:
            d["at_tick"] = self.at_tick
        if self.kind == "corrupt":
            d["mode"] = self.mode
        if self.kind == "hang":
            d["duration"] = self.duration
        if self.kind == "io_error":
            d["count"] = self.count
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Fault":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown fault fields {sorted(extra)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered, seeded set of faults. The seed names the plan (and
    seeds `random` generation + the supervisor's backoff jitter) so a
    chaos run is reproducible end to end."""

    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    def by_kind(self, *kinds: str) -> list:
        """(index, fault) pairs of the given kinds, in plan order. The
        index is the fault's identity in the fired-fault ledger."""
        return [(i, f) for i, f in enumerate(self.faults)
                if f.kind in kinds]

    # ------------------------------------------------------------- JSON io

    def to_json(self) -> str:
        return json.dumps({"format": PLAN_FORMAT, "seed": self.seed,
                           "faults": [f.to_dict() for f in self.faults]},
                          indent=1)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        if not isinstance(d, dict) or d.get("format") != PLAN_FORMAT:
            raise ValueError(f"not a {PLAN_FORMAT} document")
        return cls(faults=tuple(Fault.from_dict(f)
                                for f in d.get("faults", [])),
                   seed=int(d.get("seed", 0)))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # ------------------------------------------------- seeded random plans

    @classmethod
    def random(cls, seed: int, n_ticks: int, save_every: int,
               kinds: Optional[Sequence[str]] = None,
               n_faults: int = 3, max_devices: int = 8) -> "FaultPlan":
        """A reproducible random plan: `n_faults` faults of the given
        kinds (default: every kind), tick-triggered ones landing on ticks
        inside the run, shrinks halving from `max_devices`."""
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds) if kinds else KINDS
        faults, n_shrinks = [], 0
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "shrink":
                n_shrinks += 1
                faults.append(Fault(
                    kind="shrink", at_restart=int(rng.integers(0, 3)),
                    devices=max(1, max_devices >> n_shrinks)))
                continue
            tick = int(rng.integers(1, max(2, n_ticks)))
            if kind == "corrupt":
                mode = CORRUPT_MODES[int(rng.integers(len(CORRUPT_MODES)))]
                faults.append(Fault(kind="corrupt", at_tick=tick,
                                    mode=mode))
            elif kind == "hang":
                faults.append(Fault(kind="hang", at_tick=tick,
                                    duration=600.0))
            elif kind == "io_error":
                faults.append(Fault(kind="io_error", at_tick=tick,
                                    count=int(rng.integers(1, 4))))
            else:
                faults.append(Fault(kind=kind, at_tick=tick))
        return cls(faults=tuple(faults), seed=seed)
