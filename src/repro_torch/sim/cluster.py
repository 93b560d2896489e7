"""Volatile-cluster simulator: advances wall-clock time, produces per-
iteration active-worker masks (from spot bids or exogenous preemption), and
accounts cost at the prevailing price — the discrete-event substrate under
the trainer.

Time model (§III-C): an SGD iteration happens whenever ≥1 worker is active
and takes R(y) (sampled from the runtime model); when 0 workers are active
the clock advances by `idle_step` and no iteration runs (idle time)."""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.cost_model import RuntimeModel
from repro_torch.sim.market_core import iteration_cost, preemptible_active
from repro_torch.sim.spot_market import SpotMarket


@dataclasses.dataclass
class IterationRecord:
    j: int
    t_start: float
    duration: float
    price: float
    y: int
    cost: float
    idle_before: float


@dataclasses.dataclass
class VolatileCluster:
    n_workers: int
    runtime: RuntimeModel
    market: Optional[SpotMarket] = None       # bid-controlled preemption
    preempt_q: Optional[float] = None         # exogenous i.i.d. preemption
    on_demand_price: float = 1.0              # for preemptible-mode accounting
    idle_step: float = 0.1
    seed: int = 0
    max_idle: float = 1e6

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.t = 0.0
        self.total_cost = 0.0
        self.total_idle = 0.0
        self.records: List[IterationRecord] = []

    # -------------------------------------------------------------- spot

    def next_iteration_spot(self, j: int, bids: np.ndarray) -> np.ndarray:
        """Advance until ≥1 worker is active; run one iteration; account cost.
        Returns the active mask (n_workers,)."""
        assert self.market is not None
        idle = 0.0
        while True:
            price, mask = self.market.step(self.t, bids)
            if mask.sum() >= 1:
                break
            self.t += self.idle_step
            idle += self.idle_step
            if idle > self.max_idle:
                raise RuntimeError("cluster idle beyond max_idle; bids too low")
        y = int(mask.sum())
        dur = self.runtime.sample(self._rng, y)
        cost = iteration_cost(y, price, dur)   # pay the price, not the bid
        self.t += dur
        self.total_cost += cost
        self.total_idle += idle
        self.records.append(IterationRecord(j, self.t - dur, dur, price, y,
                                            cost, idle))
        return mask

    # -------------------------------------------------- preemptible (§V)

    def next_iteration_preemptible(self, j: int, provisioned: int
                                   ) -> np.ndarray:
        """GCP/Azure mode: each of `provisioned` workers is independently
        inactive w.p. q; zero-active rounds advance the clock (idle)."""
        q = self.preempt_q or 0.0
        idle = 0.0
        while True:
            up = preemptible_active(self._rng.uniform(size=provisioned), q)
            if up.sum() >= 1:
                break
            self.t += self.idle_step
            idle += self.idle_step
        y = int(up.sum())
        dur = self.runtime.sample(self._rng, y)
        cost = iteration_cost(y, self.on_demand_price, dur)
        self.t += dur
        self.total_cost += cost
        self.total_idle += idle
        self.records.append(IterationRecord(
            j, self.t - dur, dur, self.on_demand_price, y, cost, idle))
        mask = np.zeros(max(self.n_workers, provisioned), np.float32)
        mask[np.flatnonzero(up)] = 1.0
        return mask[:self.n_workers] if provisioned <= self.n_workers else mask

    # ------------------------------------------------------------- stats

    def summary(self) -> dict:
        ys = np.array([r.y for r in self.records]) if self.records else \
            np.zeros(1)
        return {
            "iterations": len(self.records),
            "time": self.t,
            "cost": self.total_cost,
            "idle": self.total_idle,
            "mean_active": float(ys.mean()),
            "mean_inv_y": float(np.mean(1.0 / np.maximum(ys, 1))),
        }
