"""Job-level strategies evaluated in the paper's experiments (§VI):

* ``NoInterruptions`` — bid above the max price ([14]'s recommendation).
* ``OptimalOneBid``  — Theorem 2.
* ``OptimalTwoBids`` — Theorem 3.
* ``DynamicBids``    — re-optimize the two bids when adding workers mid-job
  (§VI "Dynamic strategy": subtract consumed time from θ, remaining J).
* ``StaticWorkers`` / ``DynamicWorkers`` — §V provisioning (Theorem 4 / 5)
  for preemptible instances without bids.

Each strategy exposes ``plan(t_elapsed, j_done)`` → (bids | worker count)
so the trainer can consult it every iteration.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import bidding, convergence as conv, provisioning
from repro_torch.core.cost_model import PriceDist, RuntimeModel


#: Pad value for absent workers in stacked bid schedules (never active).
NEVER_BID = -np.inf


def _pad_bids(bids: np.ndarray, n_max: Optional[int]) -> np.ndarray:
    bids = np.asarray(bids, float)
    if n_max is not None and len(bids) < n_max:
        bids = np.pad(bids, (0, n_max - len(bids)),
                      constant_values=NEVER_BID)
    return bids


@dataclasses.dataclass(frozen=True)
class PlanTable:
    """A strategy fully resolved to data the batched engine can scan over.

    ``bids[b, j]`` are the per-worker bids for iteration ``j`` under
    elapsed-time bucket ``b``; ``starts`` (ascending, ``starts[0] == 0``)
    are the bucket start times; ``replan_at`` is the iteration at which the
    engine latches the bucket for the current wall clock (``J + 1`` — never
    — for time-invariant strategies, whose table has a single bucket).
    """

    bids: np.ndarray             # (B, J, n) float
    starts: np.ndarray           # (B,) float
    replan_at: int


class Strategy:
    name: str = "base"

    def bids(self, t_elapsed: float, j_done: int) -> np.ndarray:
        raise NotImplementedError

    def workers(self, j: int) -> int:
        """Provisioned workers at iteration j (preemptible-instance mode)."""
        raise NotImplementedError

    @property
    def total_iterations(self) -> int:
        raise NotImplementedError

    # ------------------------------------------------ batchable plan params

    def bid_schedule(self, J: Optional[int] = None,
                     n_max: Optional[int] = None) -> np.ndarray:
        """Stacked per-iteration bids, shape (J, n_max) — the batchable form
        consumed by `repro.sim.engine`. Time-dependent strategies resolve
        elapsed time with its *expected* value (the engine cannot call back
        into Python mid-scan); the legacy loop remains the exact-semantics
        path. Rows are padded to ``n_max`` with NEVER_BID."""
        J = J or self.total_iterations
        return np.stack([_pad_bids(self.bids(0.0, j), n_max)
                         for j in range(J)])

    def worker_schedule(self, J: Optional[int] = None) -> np.ndarray:
        """Provisioned worker counts per iteration, shape (J,)."""
        J = J or self.total_iterations
        return np.array([self.workers(j) for j in range(J)], np.int64)

    def plan_table(self, J: Optional[int] = None,
                   n_max: Optional[int] = None) -> PlanTable:
        """The strategy resolved to a precomputed engine plan table. Base
        strategies are time-invariant: one bucket, never replanned.
        Time-adaptive strategies (``DynamicBids``) override this with one
        schedule per coarse elapsed-time bucket; the engine latches the
        bucket from the scan carry's *wall clock* (the same clock that
        time-indexes trace replay), so the latch is exact under stochastic
        iteration durations."""
        J = J or self.total_iterations
        return PlanTable(bids=self.bid_schedule(J, n_max=n_max)[None],
                         starts=np.zeros(1), replan_at=J + 1)


@dataclasses.dataclass
class FixedBids(Strategy):
    plan_: bidding.BidPlan
    name: str = "fixed"

    def bids(self, t_elapsed, j_done):
        return self.plan_.bids

    @property
    def total_iterations(self):
        return self.plan_.J

    def bid_schedule(self, J=None, n_max=None):
        J = J or self.total_iterations
        return np.tile(_pad_bids(self.plan_.bids, n_max), (J, 1))


def no_interruptions(prob, eps, n, dist, rt) -> FixedBids:
    return FixedBids(bidding.no_interruption_bid(prob, eps, n, dist, rt),
                     name="no-interruptions")


def optimal_one_bid(prob, eps, theta, n, dist, rt) -> FixedBids:
    return FixedBids(bidding.optimal_uniform_bid(prob, eps, theta, n, dist,
                                                 rt), name="optimal-one-bid")


def optimal_two_bids(prob, eps, theta, n, dist, rt, n1=None) -> FixedBids:
    return FixedBids(bidding.co_optimize_two_bids(prob, eps, theta, n, dist,
                                                  rt, n1=n1),
                     name="optimal-two-bids")


@dataclasses.dataclass
class DynamicBids(Strategy):
    """§VI Dynamic strategy: start with (n1, n) workers and optimal two bids;
    at iteration ``switch_at`` add workers (n1', n') and re-optimize the bids
    with the remaining deadline and iterations."""

    prob: conv.SGDProblem
    eps: float
    theta: float
    dist: PriceDist
    rt: RuntimeModel
    stage1: Tuple[int, int]            # (n1, n)
    stage2: Tuple[int, int]
    switch_at: int
    name: str = "dynamic-bids"

    def __post_init__(self):
        n1, n = self.stage1
        self._plan1 = bidding.co_optimize_two_bids(
            self.prob, self.eps, self.theta, n, self.dist, self.rt, n1=n1)
        self._plan2: Optional[bidding.BidPlan] = None

    @property
    def total_iterations(self):
        return self._plan1.J

    def _replan(self, theta_left: float, j_left: int) -> bidding.BidPlan:
        """Re-optimize the two bids for the enlarged fleet on the remaining
        (ε, θ) budget, falling back to never-preempted bidding when the
        leftover deadline is infeasible."""
        n1p, np_ = self.stage2
        try:
            return bidding.optimal_two_bids(
                self.prob, self.eps, max(theta_left, 1e-6), n1p, np_,
                max(j_left, 1), self.dist, self.rt)
        except ValueError:
            return bidding.no_interruption_bid(
                self.prob, self.eps, np_, self.dist, self.rt)

    def bids(self, t_elapsed, j_done):
        if j_done < self.switch_at:
            return self._plan1.bids
        if self._plan2 is None:
            self._plan2 = self._replan(self.theta - t_elapsed,
                                       self._plan1.J - j_done)
        return self._plan2.bids

    def _stage2_plan_expected(self) -> bidding.BidPlan:
        """Stage-2 plan with elapsed time resolved at its expectation
        (E[τ₁]·switch_at/J₁) — the batchable approximation of the legacy
        path, which replans on the *actual* clock."""
        t_expected = self._plan1.expected_time * self.switch_at \
            / max(self._plan1.J, 1)
        return self._replan(self.theta - t_expected,
                            self._plan1.J - self.switch_at)

    def _rows(self, plan2, J: int, n_max: int) -> np.ndarray:
        """(J, n_max) schedule: stage-1 bids until ``switch_at``, then the
        given stage-2 plan — the single row-assembly shared by
        ``bid_schedule`` and every ``plan_table`` bucket."""
        rows1 = np.tile(_pad_bids(self._plan1.bids, n_max),
                        (min(self.switch_at, J), 1))
        rows2 = np.tile(_pad_bids(plan2.bids, n_max),
                        (max(J - self.switch_at, 0), 1))
        return np.concatenate([rows1, rows2])[:J]

    def bid_schedule(self, J=None, n_max=None):
        J = J or self.total_iterations
        plan2 = self._stage2_plan_expected()
        # both stages pad to the widest fleet, whatever n_max was requested
        n_max = max(n_max or 0, self._plan1.n, plan2.n)
        return self._rows(plan2, J, n_max)

    def plan_table(self, J=None, n_max=None, n_buckets: int = 8):
        """One stage-2 replan per coarse elapsed-time bucket over [0, θ]:
        bucket b assumes the switch happens at elapsed time ``starts[b]``
        and re-optimizes the bids on the leftover (ε, θ − starts[b])
        budget. The engine latches the bucket from the *actual* clock at
        iteration ``switch_at`` — recovering the legacy adaptive semantics
        (which replans on the true elapsed time) up to the bucket width,
        with no Python callback inside the scan."""
        J = J or self.total_iterations
        starts = np.linspace(0.0, self.theta, n_buckets)
        plans2 = [self._replan(self.theta - t, J - self.switch_at)
                  for t in starts]
        n_max = max([n_max or 0, self._plan1.n] + [p.n for p in plans2])
        table = np.stack([self._rows(p, J, n_max) for p in plans2])
        return PlanTable(bids=table, starts=starts,
                         replan_at=min(self.switch_at, J))


@dataclasses.dataclass
class StaticWorkers(Strategy):
    """Theorem 4 provisioning: fixed n for J iterations."""

    plan_: provisioning.ProvisionPlan
    name: str = "static-n"

    def workers(self, j):
        return self.plan_.n

    @property
    def total_iterations(self):
        return self.plan_.J


@dataclasses.dataclass
class DynamicWorkers(Strategy):
    """Theorem 5: n_j = ⌈n0 η^{j−1}⌉ for the log-shortened horizon."""

    n0: int
    eta: float
    J: int
    name: str = "dynamic-n"

    def workers(self, j):
        return int(np.ceil(self.n0 * self.eta ** j))

    @property
    def total_iterations(self):
        return self.J
