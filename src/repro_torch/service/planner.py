"""Candidate-plan generation and one-call batched scoring.

Every horizon the planner, per job, turns the *current* posterior into a
fixed-length slate of candidate plans drawn from the paper's optimizers —
hold, no-interruption (the [14]-style benchmark), Theorem-2 uniform bid,
Theorem-3 two bids, K-level multibid partitions (``core.multibid``), and a
Theorem-4 preemptible provisioning plan (``core.provisioning``) — each
solved for the job's *remaining* work (J_left iterations inside θ_left),
the same remaining-work replan semantics as the legacy
``strategies.DynamicBids``.

The whole slate (all jobs × all candidates × seeds) is then scored in ONE
engine call: each candidate becomes a scenario replaying i.i.d. draws from
the posterior quantile grid (``PriceSpec.empirical``), the batch is
simulated with ``sim.engine.simulate_program`` on ``device`` (``cuda``
unless asked for the CPU), or sharded over a ``launch.mesh`` device mesh
with ``sim.engine.simulate_sharded`` when ``mesh=`` is given — bit for
bit either way — and the
committed plan is the argmin realized mean cost among candidates that
complete within θ_left and satisfy the paper's error constraint. The slate
length and every scenario shape are constant across horizons.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (bidding, convergence as conv, multibid,
                              provisioning)
from repro_torch.core.bidding import DegeneratePriceError
from repro_torch.core.cost_model import PriceDist, RuntimeModel
from repro_torch.core.strategies import NEVER_BID
from repro_torch.sim import engine


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One plan slot for one job. ``bids`` (spot mode) xor ``workers``
    (preemptible provisioning mode)."""

    kind: str
    bids: Optional[Tuple[float, ...]] = None
    workers: Optional[int] = None
    expected_error: float = math.inf
    expected_cost: float = math.inf
    expected_time: float = math.inf
    safe_default: bool = False     # never filtered out: the fallback that
    #                                keeps the job live when every optimized
    #                                plan is infeasible (paper §VI fallback)
    note: str = ""

    def describe(self) -> dict:
        return {
            "kind": self.kind,
            "bids": None if self.bids is None else
            [round(float(b), 6) for b in self.bids],
            "workers": self.workers,
            "expected_error": _r6(self.expected_error),
            "expected_cost": _r6(self.expected_cost),
            "expected_time": _r6(self.expected_time),
            "note": self.note,
        }


def _r6(x: float) -> Optional[float]:
    return None if not math.isfinite(x) else round(float(x), 6)


@dataclasses.dataclass
class PlanRequest:
    """Everything the scorer needs for one job at one horizon."""

    job: int
    market: int
    price_spec: engine.PriceSpec       # posterior predictive (fixed-shape)
    rt: RuntimeModel                   # posterior runtime model
    q_hat: float                       # posterior preemption probability
    j_left: int
    theta_left: float
    eps: float
    n_workers: int
    candidates: List[Candidate] = dataclasses.field(default_factory=list)
    done: bool = False


# --------------------------------------------------------------------------
# Candidate generation
# --------------------------------------------------------------------------


def slate_size(multibid_partitions: Sequence[Sequence[int]],
               include_provision: bool) -> int:
    """Fixed slate length: hold, no-interrupt, uniform, two-bid, one slot
    per multibid partition, optionally one provisioning slot."""
    return 4 + len(multibid_partitions) + (1 if include_provision else 0)


def generate_candidates(prob: conv.SGDProblem, *, eps: float,
                        theta_left: float, j_left: int, n: int,
                        dist: PriceDist, rt: RuntimeModel,
                        q_hat: float = 0.0,
                        current_bids: Optional[np.ndarray] = None,
                        multibid_partitions: Sequence[Sequence[int]] = (),
                        multibid_sweeps: int = 8, multibid_grid: int = 15,
                        include_provision: bool = True) -> List[Candidate]:
    """The fixed-length candidate slate for one job's remaining work.

    Optimizer infeasibilities (including ``DegeneratePriceError`` during
    warm-up, when the posterior has a single support point) degrade the
    slot to the no-interruption fallback instead of shrinking the slate —
    slate length is a compile-time constant for the scorer.
    """
    j_left = max(int(j_left), 1)
    hi = float(dist.hi)
    err_all_active = conv.error_bound_static(prob, j_left, 1.0 / n)

    def uniform_cand(kind: str, b: float, *, safe: bool = False,
                     note: str = "") -> Candidate:
        from repro_torch.core.cost_model import (
            expected_cost_uniform_bid, expected_time_uniform_bid)
        return Candidate(
            kind=kind, bids=tuple([float(b)] * n),
            expected_error=err_all_active,
            expected_cost=expected_cost_uniform_bid(j_left, n, b, dist, rt),
            expected_time=expected_time_uniform_bid(j_left, n, b, dist, rt),
            safe_default=safe, note=note)

    no_int = uniform_cand("no-interrupt", hi, safe=True)
    slate: List[Candidate] = []

    # hold: keep the currently committed plan (prevents thrashing; at the
    # first horizon there is nothing to hold, so it aliases no-interrupt)
    if current_bids is not None:
        slate.append(Candidate(
            kind="hold", bids=tuple(float(b) for b in current_bids),
            expected_error=err_all_active, safe_default=True,
            note="keep committed plan"))
    else:
        slate.append(dataclasses.replace(no_int, kind="hold",
                                         note="nothing committed yet"))
    slate.append(no_int)

    # Theorem 2 at fixed remaining J: bid the quantile that makes the
    # deadline tight
    try:
        bidding.ensure_optimizable(dist)
        demand = j_left * rt.expected(n) / max(theta_left, 1e-9)
        if demand > 1.0:
            raise ValueError(f"infeasible deadline: demand={demand:.3f} > 1")
        slate.append(uniform_cand(
            "uniform", float(dist.quantile(demand)),
            note=f"F(b)={demand:.3f}"))
    except (ValueError, DegeneratePriceError) as e:
        slate.append(dataclasses.replace(
            no_int, kind="uniform", note=f"fallback: {e}"))

    # Theorem 3 at fixed remaining J (the DynamicBids replan semantics)
    try:
        plan = bidding.optimal_two_bids(prob, eps, theta_left, max(n // 2, 1),
                                        n, j_left, dist, rt)
        slate.append(Candidate(
            kind="two-bid", bids=tuple(float(b) for b in plan.bids),
            expected_error=plan.expected_error,
            expected_cost=plan.expected_cost,
            expected_time=plan.expected_time,
            note=f"b1={plan.b1:.4f} b2={plan.b2:.4f}"))
    except (ValueError, DegeneratePriceError) as e:
        slate.append(dataclasses.replace(
            no_int, kind="two-bid", note=f"fallback: {e}"))

    for part in multibid_partitions:
        part = tuple(int(g) for g in part)
        kind = f"multibid-{'+'.join(map(str, part))}"
        if sum(part) != n:
            slate.append(dataclasses.replace(
                no_int, kind=kind, note=f"fallback: partition sums to "
                f"{sum(part)} != n={n}"))
            continue
        try:
            bidding.ensure_optimizable(dist)
            mb = multibid.optimize_multibid(
                prob, eps, theta_left, part, j_left, dist, rt,
                sweeps=multibid_sweeps, grid=multibid_grid)
            slate.append(Candidate(
                kind=kind, bids=tuple(float(b) for b in mb.bids),
                expected_error=mb.expected_error,
                expected_cost=mb.expected_cost,
                expected_time=mb.expected_time,
                note=f"levels={[round(b, 4) for b in mb.bid_levels]}"))
        except (ValueError, DegeneratePriceError) as e:
            slate.append(dataclasses.replace(
                no_int, kind=kind, note=f"fallback: {e}"))

    if include_provision:
        # Theorem 4 under the posterior q̂: provision pv.n preemptible
        # workers for the remaining J_left iterations (d = 1/(1−q̂) inflates
        # the E[1/y] bound for exogenous preemptions)
        try:
            d = 1.0 / max(1.0 - q_hat, 1e-6)
            pv = provisioning.optimal_n_and_j(prob, eps, j_left, d=d)
            n_prov = min(int(pv.n), n)    # the job's fleet is capped at n;
            #                               a clamped plan may miss ε and
            #                               then fails choose()'s filter
            r_exp = rt.expected(n_prov)
            live = 1.0 - min(q_hat, 1.0 - 1e-9) ** max(n_prov, 1)
            slate.append(Candidate(
                kind="provision", workers=n_prov,
                expected_error=conv.error_bound_static(
                    prob, j_left, d / n_prov),
                expected_cost=float(j_left * n_prov * r_exp),
                expected_time=float(j_left * r_exp / live),
                note=f"theorem4 n={n_prov} (unclamped {pv.n}, J̃={pv.J})"))
        except ValueError as e:
            slate.append(dataclasses.replace(
                no_int, kind="provision", note=f"fallback: {e}"))

    return slate


# --------------------------------------------------------------------------
# One-call batched scoring
# --------------------------------------------------------------------------


def _candidate_scenario(req: PlanRequest, cand: Candidate, *, alpha: float,
                        j_cap: int, n_cap: int, idle_step: float,
                        on_demand_price: float) -> engine.Scenario:
    """A candidate as an engine scenario over the posterior market, sized
    to the shared (j_cap, n_cap) grid so every slate stacks identically."""
    common = dict(price=req.price_spec, alpha=alpha,
                  J_target=min(max(req.j_left, 1), j_cap),
                  rt_kind=req.rt.kind, rt_lam=req.rt.lam,
                  rt_delta=req.rt.delta, rt_const=req.rt.r_const,
                  idle_step=idle_step, on_demand_price=on_demand_price,
                  name=f"job{req.job}:{cand.kind}")
    if cand.workers is not None:
        return engine.Scenario(
            worker_schedule=np.full(j_cap, int(cand.workers), np.int32),
            n_fleet=n_cap, preempt_q=float(req.q_hat), **common)
    bids = np.full(n_cap, NEVER_BID, np.float32)
    bids[:len(cand.bids)] = np.asarray(cand.bids, np.float32)
    return engine.Scenario(bid_schedule=np.tile(bids, (j_cap, 1)), **common)


def score_requests(requests: Sequence[PlanRequest], *, alpha: float,
                   model0, data, program: engine.ModelProgram,
                   j_cap: int, n_cap: int, seeds: Sequence[int],
                   score_ticks: int, grad: str = "full", batch: int = 4,
                   idle_step: float = 0.5, on_demand_price: float = 1.0,
                   min_complete: Optional[int] = None,
                   mesh=None, device=None) -> np.ndarray:
    """Score every job's whole slate in one batched engine call on
    ``device`` (default ``cuda``), or on ``mesh``'s devices.

    Returns (n_jobs, C) realized mean total cost per candidate; +inf where
    the candidate failed to finish its remaining iterations within
    ``score_ticks`` posterior ticks / θ_left wall-clock on at least
    ``min_complete`` of the seeds. ``mesh=`` routes the very same grid
    through `engine.simulate_sharded` (candidates over the mesh's
    ``data`` axis), bit for bit the unsharded scores.
    """
    sizes = {len(r.candidates) for r in requests}
    if len(sizes) != 1:
        raise ValueError(f"ragged candidate slates: {sorted(sizes)}")
    C = sizes.pop()
    scenarios = [
        _candidate_scenario(req, cand, alpha=alpha, j_cap=j_cap, n_cap=n_cap,
                            idle_step=idle_step,
                            on_demand_price=on_demand_price)
        for req in requests for cand in req.candidates]
    cfg = engine.SimConfig(n_ticks=int(score_ticks), batch=batch, grad=grad)
    if mesh is not None:
        res = engine.simulate_sharded(scenarios, program, model0, data,
                                      list(seeds), cfg, mesh=mesh)
    else:
        res = engine.simulate_program(
            engine.stack_scenarios(scenarios, device=device), program,
            model0, data, list(seeds), cfg, device=device)

    n_seeds = len(list(seeds))
    need = n_seeds if min_complete is None else int(min_complete)
    theta = np.asarray([r.theta_left for r in requests], float)
    theta = np.repeat(theta, C)                            # (S,)
    ok = res.completed & (res.total_time <= theta[:, None])  # (S, R)
    enough = ok.sum(axis=1) >= need
    with np.errstate(invalid="ignore"):
        mean_cost = np.where(
            ok.any(axis=1),
            np.nansum(np.where(ok, res.total_cost, np.nan), axis=1)
            / np.maximum(ok.sum(axis=1), 1), np.inf)
    scores = np.where(enough, mean_cost, np.inf)
    return scores.reshape(len(requests), C)


def choose(requests: Sequence[PlanRequest],
           scores: np.ndarray) -> List[Tuple[int, Candidate]]:
    """Commit per job: argmin score among candidates meeting the error
    constraint (expected_error ≤ ε, or the safe default).

    All-inf slates (the batched sim says nothing finishes within θ_left)
    fall back to guaranteed-progress mode: the *no-interrupt* safe default
    built from the current posterior, not "hold". Holding stale bids can
    self-lock — e.g. a price regime shift leaves the held bid inactive,
    so no iterations complete, no durations are observed, and the runtime
    posterior that made everything look infeasible never corrects.
    No-interrupt bids the posterior's max price, so the job keeps making
    progress while the posteriors catch up.
    """
    picks: List[Tuple[int, Candidate]] = []
    for r, row in zip(requests, scores):
        admissible = np.asarray([
            (c.expected_error <= r.eps * (1 + 1e-9)) or c.safe_default
            for c in r.candidates])
        masked = np.where(admissible, row, np.inf)
        if np.isfinite(masked).any():
            idx = int(np.argmin(masked))
        else:
            safe = [i for i, c in enumerate(r.candidates) if c.safe_default]
            no_int = [i for i in safe
                      if r.candidates[i].kind == "no-interrupt"]
            idx = (no_int or safe)[0]
        picks.append((idx, r.candidates[idx]))
    return picks
