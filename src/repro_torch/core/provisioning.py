"""Optimal provisioning for preemptible instances without bids (§V):
Theorem 4 (joint n, J optimum) and Theorem 5 (exponential worker schedule)
with the Eqs. (20)–(23) convex program for η."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import convergence as conv


@dataclasses.dataclass(frozen=True)
class ProvisionPlan:
    n: int
    J: int
    expected_error: float
    cost_proxy: float             # ∝ Σ_j n_j (instance-iterations)


def _h_of_j(prob: conv.SGDProblem, j: float) -> float:
    """H(J̃) from Theorem 4's stationarity condition (monotone decreasing)."""
    beta = prob.beta
    a = prob.G0
    bj = beta ** j
    num = a * bj * (j * math.log(1 / beta) + 1 - bj)
    den = 1 + bj * (j * math.log(1 / beta) - 1)
    return num / max(den, 1e-300)


def optimal_n_and_j(prob: conv.SGDProblem, eps: float, theta_iters: int,
                    d: float = 1.0) -> ProvisionPlan:
    """Theorem 4. Assumes E[1/y_j] ≤ d/n, deterministic per-iteration
    runtime, so the deadline is simply J ≤ θδ = theta_iters.

    Minimizes J·n s.t. the Theorem-1 bound ≤ ε; for each J the tight n is
    n(J) = ⌈B(1−β^J) / ((1−β)(ε − Aβ^J))⌉ and the continuous optimum J̃
    solves H(J̃) = ε.
    """
    beta, A, B = prob.beta, prob.G0, prob.B * d

    def n_of_j(j: int) -> Optional[int]:
        denom = (1 - beta) * (eps - A * beta ** j)
        if denom <= 0:
            return None
        return max(1, math.ceil(B * (1 - beta ** j) / denom))

    def objective(j: int) -> float:
        n = n_of_j(j)
        return math.inf if n is None else j * n

    # bisection on the monotone H for the continuous stationary point J̃
    lo, hi = 1.0, 1.0
    while _h_of_j(prob, hi) > eps and hi < 1e9:
        hi *= 2
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _h_of_j(prob, mid) > eps:
            lo = mid
        else:
            hi = mid
    j_tilde = 0.5 * (lo + hi)

    # Theorem 4's candidates {⌊J̃⌋, ⌈J̃⌉, ⌊θδ⌋} are exact for the continuous
    # relaxation; the integer ceiling on n shifts the optimum to where n(J)
    # steps down, so refine with an exact search over the (bounded) J range.
    candidates = {max(1, math.floor(j_tilde)), math.ceil(j_tilde),
                  int(theta_iters)}
    if theta_iters <= 2_000_000:
        js = np.arange(1, theta_iters + 1, dtype=np.float64)
        bj = beta ** js
        denom = (1 - beta) * (eps - A * bj)
        with np.errstate(divide="ignore", invalid="ignore"):
            ns = np.ceil(B * (1 - bj) / denom)
        ns = np.where(denom > 0, np.maximum(ns, 1), np.inf)
        obj = js * ns
        if np.isfinite(obj).any():
            candidates.add(int(js[int(np.argmin(obj))]))
    J = min((j for j in candidates
             if 1 <= j <= theta_iters and objective(j) < math.inf),
            key=objective, default=None)
    if J is None:
        raise ValueError("no feasible (n, J): ε below reachable error")
    n = n_of_j(J)
    if n is None:
        raise ValueError("deadline too tight for target ε")
    return ProvisionPlan(
        n=n, J=J, expected_error=conv.error_bound_static(prob, J, d / n),
        cost_proxy=J * n)


# --------------------------------------------------------------------------
# Theorem 5: exponential worker schedule  n_j = ⌈n0 η^{j−1}⌉
# --------------------------------------------------------------------------


def dynamic_schedule(n0: int, eta: float, J: int, n_cap: int = 10 ** 9
                     ) -> np.ndarray:
    j = np.arange(J)
    with np.errstate(over="ignore"):
        n_j = np.minimum(n0 * np.power(eta, j), float(n_cap))
    return np.ceil(n_j).astype(np.int64)


def dynamic_cost_proxy(n0: int, eta: float, J: int) -> float:
    """Objective (20): Σ_{j=0..J−1} n0·η^j = n0·(1−η^J)/(1−η)."""
    if abs(eta - 1) < 1e-12:
        return n0 * J
    return n0 * (eta ** J - 1) / (eta - 1)


def dynamic_error_bound(prob: conv.SGDProblem, J: int, n0: int, eta: float,
                        chi: float, d: float) -> float:
    """Constraint (22) — the closed geometric form of Eq. (27)."""
    beta = prob.beta
    x = 1.0 / (beta * eta ** chi)
    if abs(1 - x) < 1e-12:
        tail = J * beta ** (J - 1)
    else:
        tail = beta ** (J - 1) * (1 - x ** J) / (1 - x)
    return beta ** J * prob.G0 + prob.B * d / n0 ** chi * tail


def dynamic_time(J: int, n0: int, eta: float, q: float, R: float) -> float:
    """Constraint (21): Σ_j R / (1 − q^{n_j}) (idle-time-inflated runtime)."""
    n_j = dynamic_schedule(n0, eta, J)
    with np.errstate(over="ignore", under="ignore"):
        q_pow = np.exp(np.minimum(n_j * np.log(max(q, 1e-300)), 0.0))
    return float(np.sum(R / (1 - q_pow)))


def optimize_eta(prob: conv.SGDProblem, eps: float, theta: float, n0: int,
                 J: int, chi: float = 1.0, d: float = 1.0, q: float = 0.5,
                 R: float = 1.0, eta_max: float = 4.0) -> float:
    """Solve Eqs. (20)–(23) for fixed J. The objective (20) is increasing in
    η>1 while both constraints relax as η grows, so the optimum is the
    smallest feasible η; find it by bisection over (β^{−1/χ}, eta_max]."""
    eta_lo = (1.0 / prob.beta) ** (1.0 / chi) + 1e-9   # constraint (23)

    def feasible(eta: float) -> bool:
        return (dynamic_error_bound(prob, J, n0, eta, chi, d) <= eps and
                dynamic_time(J, n0, eta, q, R) <= theta)

    if not feasible(eta_max):
        raise ValueError("infeasible even at eta_max; increase J or n0")
    if feasible(eta_lo):
        return eta_lo
    lo, hi = eta_lo, eta_max
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if feasible(mid):
            hi = mid
        else:
            lo = mid
    return hi


def co_optimize_eta_and_j(prob: conv.SGDProblem, eps: float, theta: float,
                          n0: int, chi: float = 1.0, d: float = 1.0,
                          q: float = 0.5, R: float = 1.0,
                          j_max: Optional[int] = None
                          ) -> Tuple[int, float, float]:
    """Iterate over J (there is a finite max J for which (21) is feasible)
    and pick (J, η) minimizing the cost proxy (20). Returns (J, η, cost)."""
    if j_max is None:
        j_max = max(1, int(theta / R))
    best = None
    for J in range(1, j_max + 1):
        try:
            eta = optimize_eta(prob, eps, theta, n0, J, chi, d, q, R)
        except ValueError:
            continue
        cost = dynamic_cost_proxy(n0, eta, J)
        if best is None or cost < best[2]:
            best = (J, eta, cost)
    if best is None:
        raise ValueError("no feasible (J, η)")
    return best
