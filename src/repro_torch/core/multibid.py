"""BEYOND-PAPER: K-level heterogeneous bids.

The paper (§VII) flags "different bids for each worker" as future work and
analyses only K=2 (Theorem 3). This module generalizes: bid levels
b_1 ≥ b_2 ≥ … ≥ b_K with group sizes (n_1, …, n_K).

With i.i.d. prices all workers see the same p each iteration, so the active
count is the cumulative group size above p:

  y(p) = N_k := n_1 + … + n_k   for  b_{k+1} < p ≤ b_k  (b_{K+1} := p̲).

Conditioned on the job running (p ≤ b_1):

  P[y = N_k] = (F(b_k) − F(b_{k+1})) / F(b_1)
  E[1/y]     = Σ_k P[y = N_k] / N_k
  E[R]       = Σ_k P[y = N_k] · E[R(N_k)]
  E[C]       = J/F(b_1) · Σ_k N_k · E[R(N_k)] · ∫_{b_{k+1}}^{b_k} p f(p) dp

Optimization strategy (generalizing the Theorem-3 proof structure): fix the
*shape* γ_k = F(b_k)/F(b_1) ∈ [0,1] (γ_1 = 1 ≥ γ_2 ≥ …); the error bound
depends only on γ (through E[1/y]), the deadline pins F(b_1) given the
expected per-iteration runtime, and cost is monotone in each γ_k — so we
search the (K−1)-dim γ-simplex by projected coordinate descent, warm-started
from the refined K−1 solutions (every adjacent-group coarsening, solved
recursively and lifted by duplicating the merged level) as well as the
Theorem-3-style single-γ init. The warm start makes the refinement
hierarchy monotone: a K-level partition can represent any coarsening
exactly, so its optimized cost is never above the best coarsening's —
descending from the single-γ init alone could end in a local minimum above
a coarser partition's optimum (e.g. (2,2,2,1,1) above (4,4)).
(tests/test_multibid.py: the K=2 special case reproduces Theorem 3 exactly;
K=4 is never worse; nested splits are never worse than their coarsenings.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import convergence as conv
from repro_torch.core.cost_model import PriceDist, RuntimeModel


@dataclasses.dataclass(frozen=True)
class MultiBidPlan:
    group_sizes: Tuple[int, ...]
    bid_levels: Tuple[float, ...]          # descending
    J: int
    expected_cost: float
    expected_time: float
    expected_error: float
    gammas: Tuple[float, ...] = ()         # shape vector F(b_k)/F(b_1) —
    #                                        kept so a K-level solution can
    #                                        warm-start a refinement

    @property
    def bids(self) -> np.ndarray:
        return np.concatenate([np.full(n, b) for n, b in
                               zip(self.group_sizes, self.bid_levels)])


def _cum_sizes(group_sizes: Sequence[int]) -> np.ndarray:
    return np.cumsum(np.asarray(group_sizes, dtype=float))


def inv_y_multilevel(group_sizes: Sequence[int], gammas: np.ndarray) -> float:
    """E[1/y | running] for shape vector γ (γ_1=1, descending, γ_{K+1}:=0)."""
    nk = _cum_sizes(group_sizes)
    g = np.append(gammas, 0.0)
    probs = g[:-1] - g[1:]
    return float(np.sum(probs / nk))


def expected_runtime_multilevel(group_sizes, gammas, rt: RuntimeModel
                                ) -> float:
    nk = _cum_sizes(group_sizes)
    g = np.append(gammas, 0.0)
    probs = g[:-1] - g[1:]
    return float(np.sum(probs * np.array([rt.expected(int(n)) for n in nk])))


def _expectations(group_sizes, gammas, f1, J, dist: PriceDist,
                  rt: RuntimeModel) -> Tuple[float, float]:
    """(E[τ], E[C]) given shape γ and F(b_1) = f1."""
    nk = _cum_sizes(group_sizes)
    er = expected_runtime_multilevel(group_sizes, gammas, rt)
    e_tau = J * er / max(f1, 1e-12)
    bids = [float(dist.quantile(g * f1)) for g in gammas] + [dist.lo]
    cost = 0.0
    for k in range(len(nk)):
        hi, lo = bids[k], bids[k + 1]
        if hi <= lo:
            continue
        grid = np.linspace(lo, hi, 513)
        seg = float(np.trapezoid(grid * dist.pdf(grid), grid))
        cost += nk[k] * rt.expected(int(nk[k])) * seg
    return e_tau, J * cost / max(f1, 1e-12)


def _adjacent_merges(group_sizes: Tuple[int, ...]):
    """All K−1 coarsenings obtained by merging one adjacent group pair —
    each is a sub-partition whose optimum the finer partition can represent
    exactly (the merged groups share one bid level)."""
    for i in range(len(group_sizes) - 1):
        yield i, group_sizes[:i] + (group_sizes[i] + group_sizes[i + 1],) \
            + group_sizes[i + 2:]


def optimize_multibid(prob: conv.SGDProblem, eps: float, theta: float,
                      group_sizes: Sequence[int], J: int, dist: PriceDist,
                      rt: RuntimeModel, sweeps: int = 60,
                      grid: int = 41, init_gammas=None,
                      warm_start: bool = True,
                      _memo=None) -> MultiBidPlan:
    """Coordinate descent on the γ-simplex; F(b_1) set from the tight
    deadline at each step (the Theorem-3 structure).

    The descent is started from the best of several inits and refined from
    the winner: the Theorem-3-style single-γ init, an explicit
    ``init_gammas`` if given, and (``warm_start``, the default) the
    *refined K−1 solutions* — every adjacent-pair coarsening of the
    partition, solved recursively and lifted by duplicating the merged
    level's γ. A K-level partition can represent any of its coarsenings
    exactly, so warm-starting guarantees the refined cost is never above
    the best coarsening's — fixing the nested-split regression where e.g.
    (2,2,2,1,1) landed above (4,4) when descending from the single-γ init
    alone (a local minimum of the coordinate sweep)."""
    group_sizes = tuple(int(n) for n in group_sizes)
    k = len(group_sizes)
    q_target = conv.q_eps(prob, J, eps)
    n_total = float(sum(group_sizes))
    if not (1.0 / n_total < q_target):
        raise ValueError(
            f"Q(ε)={q_target:.4g} ≤ 1/N: can't reach ε in {J} iterations")
    memo = {} if _memo is None else _memo
    if group_sizes in memo:
        return memo[group_sizes]

    def t3_init() -> np.ndarray:
        # Theorem-3 style: all lower levels share one γ hitting E[1/y]=Q
        gam = np.ones(k)
        if k > 1:
            lo_, hi_ = 0.0, 1.0
            for _ in range(60):
                mid = 0.5 * (lo_ + hi_)
                g = np.concatenate([[1.0], np.full(k - 1, mid)])
                if inv_y_multilevel(group_sizes, g) > q_target:
                    lo_ = mid
                else:
                    hi_ = mid
            gam[1:] = hi_
        return gam

    def f1_for(g):
        er = expected_runtime_multilevel(group_sizes, g, rt)
        return J * er / theta

    def total_cost(g) -> float:
        f1 = f1_for(g)
        if f1 > 1.0 or inv_y_multilevel(group_sizes, g) > q_target * (
                1 + 1e-9):
            return math.inf
        _, c = _expectations(group_sizes, g, f1, J, dist, rt)
        return c

    def descend(gam: np.ndarray) -> Tuple[float, np.ndarray]:
        best = total_cost(gam)
        if not np.isfinite(best):
            return best, gam
        for _ in range(sweeps):
            improved = False
            for i in range(1, k):
                lo_b = gam[i + 1] if i + 1 < k else 0.0
                hi_b = gam[i - 1]
                cand = np.linspace(lo_b, hi_b, grid)
                for c_ in cand:
                    trial = gam.copy()
                    trial[i] = c_
                    # keep descending order for the tail
                    trial[i + 1:] = np.minimum(trial[i + 1:], c_)
                    val = total_cost(trial)
                    if val < best - 1e-12:
                        best, gam, improved = val, trial, True
            if not improved:
                break
        return best, gam

    inits: List[np.ndarray] = []
    if init_gammas is not None:
        g = np.asarray(init_gammas, float)
        if g.shape != (k,) or g[0] != 1.0 or np.any(np.diff(g) > 1e-12):
            raise ValueError(f"init_gammas must be ({k},), descending from "
                             f"1.0, got {g}")
        inits.append(g)
    inits.append(t3_init())
    if warm_start and k > 1:
        for i, merged in _adjacent_merges(group_sizes):
            try:
                sub = optimize_multibid(
                    prob, eps, theta, merged, J, dist, rt, sweeps=sweeps,
                    grid=grid, warm_start=warm_start, _memo=memo)
            except ValueError:
                continue
            # lift the K−1 shape: the two groups born from the merge share
            # the merged level's γ (identical bids → identical cost)
            inits.append(np.insert(np.asarray(sub.gammas), i + 1,
                                   sub.gammas[i]))

    best, gam = math.inf, None
    for g0 in inits:
        val, g = descend(g0)
        if val < best:
            best, gam = val, g
    if not np.isfinite(best):
        raise ValueError("infeasible (deadline too tight for target ε)")

    f1 = f1_for(gam)
    e_tau, cost = _expectations(group_sizes, gam, f1, J, dist, rt)
    bids = tuple(float(dist.quantile(g * f1)) for g in gam)
    plan = MultiBidPlan(
        group_sizes=group_sizes, bid_levels=bids, J=J,
        expected_cost=cost, expected_time=e_tau,
        expected_error=conv.error_bound_static(
            prob, J, inv_y_multilevel(group_sizes, gam)),
        gammas=tuple(float(g) for g in gam))
    memo[group_sizes] = plan
    return plan
