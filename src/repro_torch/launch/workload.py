"""Serializable training workloads for the supervisor.

A `WorkerSpec` pins *everything* that determines a durable batched run —
model overrides, scenario grid, seeds, tick budget, checkpoint cadence,
mesh width — as a JSON file, so the supervised worker subprocess and an
in-process reference run (`build_workload` in a test) construct the exact
same job and the recovered run can be checked bit-exact against the
unfailed one. Keep anything stochastic OUT of the worker: everything
derives from the spec's seeds.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.sim import engine

SPEC_FORMAT = "repro-worker-spec-v1"


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One durable training workload, JSON-round-trippable, in the
    reference's format (the same fields and ``SPEC_FORMAT``: a spec file
    written by either package loads in the other).

    ``bids`` is one per-worker bid vector per scenario (each of length
    ``n_workers``), tiled over ``iterations`` SGD steps. ``mesh`` > 1
    (sharding the scenario axis over devices) waits for the port's mesh
    slice: the worker raises on it. ``jit_cache`` is read and has no
    effect: the port builds its kernels once into ``_build/`` and has no
    compilation cache to warm.

    Real-model workloads: ``reduce_depth=N`` starts from the arch's FULL
    config (real widths/vocab) at N layers instead of the CPU-smoke
    ``reduced()`` variant; ``param_dtype`` overrides the model's
    param/activation dtype (e.g. "bfloat16"); ``overrides`` sets any other
    config field (e.g. ``{"use_flash_attention": 1}``); ``zoo=True`` routes
    the worker through `trainer.train_zoo` (mixed-precision carries, bf16
    checkpoints) instead of the plain reduced-model program — set
    automatically by the launcher whenever a sub-f32 ``param_dtype`` is
    requested."""

    arch: str = "qwen2-7b"
    overrides: Dict[str, int] = dataclasses.field(default_factory=dict)
    reduce_depth: Optional[int] = None
    param_dtype: Optional[str] = None
    zoo: bool = False
    n_workers: int = 4
    seq_len: int = 16
    global_batch: int = 8
    learning_rate: float = 0.1
    bids: Tuple[Tuple[float, ...], ...] = ((0.9, 0.9, 0.5, 0.5),)
    iterations: int = 12
    price_lo: float = 0.2
    price_hi: float = 1.0
    rt_kind: str = "exp"
    rt_lam: float = 2.0
    rt_delta: float = 0.05
    idle_step: float = 0.5
    seeds: int = 2
    n_ticks: int = 24
    save_every: int = 6
    save_shards: Optional[int] = None
    keep_last: int = 3
    mesh: int = 0
    async_save: bool = False
    jit_cache: bool = True
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "bids",
                           tuple(tuple(float(b) for b in row)
                                 for row in self.bids))
        object.__setattr__(self, "overrides", dict(self.overrides))
        if self.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.arch!r}")
        for row in self.bids:
            if len(row) != self.n_workers:
                raise ValueError(f"bid vector {row} has {len(row)} entries "
                                 f"for n_workers={self.n_workers}")

    # ------------------------------------------------------------- JSON io

    def to_json(self) -> str:
        d = {"format": SPEC_FORMAT, **dataclasses.asdict(self)}
        return json.dumps(d, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "WorkerSpec":
        d = json.loads(text)
        if not isinstance(d, dict) or d.pop("format", None) != SPEC_FORMAT:
            raise ValueError(f"not a {SPEC_FORMAT} document")
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown spec fields {sorted(extra)}")
        return cls(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "WorkerSpec":
        with open(path) as f:
            return cls.from_json(f.read())


def build_workload(spec: WorkerSpec):
    """Materialize ``(job, scenarios, seeds)`` from a spec — the arguments
    of `trainer.train_batched` / `train_batched_durable`. Deterministic:
    the same spec always builds the same workload."""
    if spec.reduce_depth:
        # full real config at reduced depth — real widths, real vocab
        cfg = ARCHS[spec.arch].with_(num_layers=spec.reduce_depth)
    else:
        cfg = ARCHS[spec.arch].reduced()
    if spec.param_dtype:
        cfg = cfg.with_(dtype=spec.param_dtype,
                        param_dtype=spec.param_dtype)
    if spec.overrides:
        cfg = cfg.with_(**spec.overrides)
    job = JobConfig(model=cfg,
                    shape=InputShape("supervised", seq_len=spec.seq_len,
                                     global_batch=spec.global_batch,
                                     kind="train"),
                    n_workers=spec.n_workers,
                    learning_rate=spec.learning_rate)
    scenarios: List[engine.Scenario] = []
    for i, row in enumerate(spec.bids):
        scenarios.append(engine.Scenario(
            price=engine.PriceSpec.uniform(spec.price_lo, spec.price_hi),
            alpha=spec.learning_rate,
            bid_schedule=np.tile(np.asarray(row, np.float32),
                                 (spec.iterations, 1)),
            rt_kind=spec.rt_kind, rt_lam=spec.rt_lam,
            rt_delta=spec.rt_delta, idle_step=spec.idle_step,
            name=f"s{i}"))
    seeds = list(range(spec.seed, spec.seed + spec.seeds))
    return job, scenarios, seeds
