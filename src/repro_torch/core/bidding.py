"""Optimal spot-bidding strategies (§IV): Theorem 2 (uniform bid), Theorem 3
(two bids), Corollary 1 co-optimization of J, and n1 co-optimization."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import convergence as conv
from repro_torch.core import preemption
from repro_torch.core.cost_model import PriceDist, RuntimeModel


class DegeneratePriceError(ValueError):
    """The price distribution cannot support bid optimization: its support
    is (effectively) a single point, so Theorem 2/3's interior segments have
    zero width, the trapezoid cost integrals collapse to 0, and the
    "optimal" plan would be NaN/garbage. Callers should fall back to
    ``no_interruption_bid`` (bid the max price), which stays well-defined —
    the online planner does exactly that during warm-up, before the
    posterior has seen more than one distinct price."""


def ensure_optimizable(dist: PriceDist, tol: float = 1e-9) -> None:
    """Raise ``DegeneratePriceError`` if ``dist`` is too degenerate for the
    two-bid optimizers (zero-width support, or an empirical trace with a
    single distinct value)."""
    lo, hi = float(dist.lo), float(dist.hi)
    if not (math.isfinite(lo) and math.isfinite(hi)):
        raise DegeneratePriceError(
            f"price support [{lo}, {hi}] is not finite")
    if hi - lo <= tol * max(1.0, abs(hi)):
        raise DegeneratePriceError(
            f"price support [{lo}, {hi}] has zero width — a single support "
            "point admits no bid trade-off")
    samples = getattr(dist, "samples", None)
    if samples is not None:
        vals = np.unique(np.asarray(samples, float))
        if len(vals) < 2:
            raise DegeneratePriceError(
                "empirical price trace has a single distinct value "
                f"({vals[0]:.4g}); every candidate bid is equivalent")


@dataclasses.dataclass(frozen=True)
class BidPlan:
    """A resolved bidding plan for a job."""

    n: int                         # total provisioned workers
    n1: int                        # workers bidding b1 (= n for uniform)
    b1: float
    b2: float                      # = b1 for uniform bids
    J: int                         # iterations to run
    expected_cost: float
    expected_time: float
    expected_error: float

    @property
    def bids(self) -> np.ndarray:
        return np.concatenate([np.full(self.n1, self.b1),
                               np.full(self.n - self.n1, self.b2)])


# --------------------------------------------------------------------------
# Theorem 2: uniform bid
# --------------------------------------------------------------------------


def optimal_uniform_bid(prob: conv.SGDProblem, eps: float, theta: float,
                        n: int, dist: PriceDist, rt: RuntimeModel) -> BidPlan:
    """b* = F⁻¹(φ̂⁻¹(ε)·E[R(n)]/θ) (Theorem 2). With identical bids all
    workers are active together so E[1/y] = 1/n and the error bound is
    bid-independent."""
    J = conv.phi_inverse(prob, eps, 1.0 / n)
    er = rt.expected(n)
    demand = J * er / theta
    if demand > 1:
        raise ValueError(
            f"infeasible deadline: need J·E[R(n)]/θ = {demand:.3f} ≤ 1")
    b = float(dist.quantile(demand))
    from repro_torch.core.cost_model import (expected_cost_uniform_bid,
                                       expected_time_uniform_bid)
    return BidPlan(
        n=n, n1=n, b1=b, b2=b, J=J,
        expected_cost=expected_cost_uniform_bid(J, n, b, dist, rt),
        expected_time=expected_time_uniform_bid(J, n, b, dist, rt),
        expected_error=conv.error_bound_static(prob, J, 1.0 / n),
    )


def no_interruption_bid(prob: conv.SGDProblem, eps: float, n: int,
                        dist: PriceDist, rt: RuntimeModel) -> BidPlan:
    """The [14]-style benchmark: bid above the max spot price (never
    preempted)."""
    J = conv.phi_inverse(prob, eps, 1.0 / n)
    b = dist.hi
    from repro_torch.core.cost_model import (expected_cost_uniform_bid,
                                       expected_time_uniform_bid)
    return BidPlan(
        n=n, n1=n, b1=b, b2=b, J=J,
        expected_cost=expected_cost_uniform_bid(J, n, b, dist, rt),
        expected_time=expected_time_uniform_bid(J, n, b, dist, rt),
        expected_error=conv.error_bound_static(prob, J, 1.0 / n),
    )


# --------------------------------------------------------------------------
# Theorem 3: two bids
# --------------------------------------------------------------------------


def _two_bid_expectations(J, n1, n, F1, gamma, dist, rt):
    """(E[τ], E[C]) for the two-bid scheme with F(b1)=F1, γ=F(b2)/F(b1).

    E[R | running] = γ·E[R(n)] + (1−γ)·E[R(n1)];
    E[C] = J/F1 ∫ y(p)·E[R(y(p))]·p f(p) dp over p ≤ b1.
    """
    b1 = float(dist.quantile(F1))
    b2 = float(dist.quantile(gamma * F1))
    er = gamma * rt.expected(n) + (1 - gamma) * rt.expected(n1)
    e_tau = J * er / max(F1, 1e-12)

    # piecewise numeric integral for the cost
    def seg(lo, hi, y):
        if hi <= lo:
            return 0.0
        grid = np.linspace(lo, hi, 2049)
        return float(np.trapezoid(grid * dist.pdf(grid), grid)) * y * \
            rt.expected(y)

    cost = J / max(F1, 1e-12) * (seg(dist.lo, b2, n) + seg(b2, b1, n1))
    return e_tau, cost, b1, b2


def optimal_two_bids(prob: conv.SGDProblem, eps: float, theta: float,
                     n1: int, n: int, J: int, dist: PriceDist,
                     rt: RuntimeModel) -> BidPlan:
    """Theorem 3: closed-form optimal (b1, b2) for fixed J, n1.

    Preconditions (as in the theorem): 1/n < Q(ε) ≤ 1/n1 and
    θ ≥ J·E[R(n)] (feasible deadline).
    """
    ensure_optimizable(dist)
    Q = conv.q_eps(prob, J, eps)
    if not (1.0 / n < Q):
        raise ValueError(f"Q(ε)={Q:.4g} ≤ 1/n; even all-active workers "
                         "cannot reach ε in J iterations")
    gamma = preemption.gamma_for_inv_y(n1, n, Q)
    # F(b1*): make the deadline tight given γ* (Fig. 2d)
    er_gamma = gamma * rt.expected(n) + (1 - gamma) * rt.expected(n1)
    F1 = J * er_gamma / theta
    if F1 > 1:
        raise ValueError(f"infeasible: F(b1) would need to be {F1:.3f} > 1")
    e_tau, cost, b1, b2 = _two_bid_expectations(J, n1, n, F1, gamma, dist, rt)
    inv_y = preemption.inv_y_two_groups(n1, n, gamma)
    return BidPlan(n=n, n1=n1, b1=b1, b2=b2, J=J,
                   expected_cost=cost, expected_time=e_tau,
                   expected_error=conv.error_bound_static(prob, J, inv_y))


def co_optimize_two_bids(prob: conv.SGDProblem, eps: float, theta: float,
                         n: int, dist: PriceDist, rt: RuntimeModel,
                         n1: Optional[int] = None,
                         J_range: Optional[Tuple[int, int]] = None) -> BidPlan:
    """Co-optimize (J, n1, b⃗): sweep J (Corollary 1 gives the admissible
    range) and n1 ∈ {1..n−1}, solve Theorem 3 for each, keep the cheapest
    feasible plan."""
    ensure_optimizable(dist)  # raise the named error, not "no feasible plan"
    J_min = conv.phi_inverse(prob, eps, 1.0 / n)          # all workers active
    if J_range is None:
        J_hi = max(J_min + 1, int(theta / max(rt.expected(n), 1e-9)))
        J_range = (J_min, min(J_hi, 20 * J_min + 100))
    n1s = range(1, n) if n1 is None else [n1]

    best: Optional[BidPlan] = None
    for J in range(J_range[0], J_range[1] + 1):
        Q = conv.q_eps(prob, J, eps)
        for n1_try in n1s:
            if not (1.0 / n < Q):
                continue
            try:
                plan = optimal_two_bids(prob, eps, theta, n1_try, n, J, dist,
                                        rt)
            except ValueError:
                continue
            if plan.expected_time <= theta * (1 + 1e-9) and (
                    best is None or plan.expected_cost < best.expected_cost):
                best = plan
    if best is None:
        raise ValueError("no feasible two-bid plan under (ε, θ)")
    return best
