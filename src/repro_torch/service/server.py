"""The rolling-horizon bid server: feed → estimate → replan → execute.

``BidServer.run`` drives many concurrent jobs against one shared
``PriceFeed``. Each feed tick is one iteration opportunity (the engine's
tick-indexed replay regime), and the jobs ARE the engine's scenario axis:

- **warm-up** — the first ``warmup`` ticks only feed the estimator.
- every **horizon** the server reads each job's progress out of the engine
  carry (iterations done, wall clock, cost), asks the planner for a
  candidate slate under the current posterior, scores all jobs' slates in
  one batched engine call, and commits per-job argmin-cost plans subject
  to the error constraint.
- the committed plans are swapped into the execution batch (same shapes,
  data only) and the next window of feed ticks is executed in one
  ``simulate_program`` call resuming from the persistent ``SimState``
  carry (``snapshot_state``/``tick0``, the checkpoint machinery doing
  double duty as the server's state store).
- the realized window (the exact rows the engine consumed — seed 0
  replays the feed verbatim) then updates the estimator, including
  iteration-duration observations for the runtime-rate posterior.

Every decision is appended to ``decisions.jsonl``; the final summary row
reports realized cost/time/error per job, regret vs. the hindsight-optimal
static uniform-bid plan (best bid level in hindsight on the same trace),
and regret vs. the best *static* paper-strategy baseline planned on the
warm-up posterior — the adaptive-vs-static comparison the end-to-end test
pins. With a fixed seed the whole run is bit-reproducible: all engine RNG
folds (seed, absolute tick) and the feed replay is deterministic.

Every engine call runs on the server's ``device`` (``cuda`` unless asked
for the CPU); the carry stays there between windows. ``mesh=`` (a
``launch.mesh`` device mesh) shards candidate scoring over its devices —
the decisions bit for bit those of the unsharded server.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import convergence as conv
from repro_torch.core.cost_model import RuntimeModel
from repro_torch.core.strategies import NEVER_BID
from repro_torch.device import resolve_device
from repro_torch.service import planner as pl
from repro_torch.service.estimator import OnlineEstimator
from repro_torch.service.stream import PriceFeed
from repro_torch.sim import engine


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One training job riding the service."""

    name: str
    market: int = 0
    eps: float = 0.05
    theta: float = 200.0           # wall-clock deadline (engine time units)
    n_workers: int = 4


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    horizon: int = 16              # feed ticks between replans
    warmup: int = 16               # estimator-only ticks before planning
    total_ticks: Optional[int] = None   # default: whole feed, trimmed to
    #                                     warmup + k*horizon (constant
    #                                     window shape → one compile)
    score_seeds: int = 2
    score_ticks: Optional[int] = None   # posterior ticks per scoring run
    sample_grid: int = 128         # posterior quantile-grid size
    seed: int = 0                  # execution seed (0 = replay verbatim)
    grad: str = "full"
    batch: int = 4
    idle_step: float = 0.5
    on_demand_price: float = 1.0
    q_true: float = 0.0            # ground-truth exogenous preemption rate
    multibid_partitions: tuple = ()
    include_provision: bool = True
    hindsight_levels: int = 9      # bid grid for the hindsight-optimal plan
    out_dir: Optional[str] = None


class BidServer:
    """Rolling-horizon control loop over one shared feed."""

    def __init__(self, feed: PriceFeed, jobs: Sequence[JobSpec], *,
                 prob: conv.SGDProblem, quad, w0, alpha: float,
                 rt_true: RuntimeModel, cfg: ServeConfig = ServeConfig(),
                 mesh=None, device=None):
        if not jobs:
            raise ValueError("need at least one job")
        for job in jobs:
            if not 0 <= job.market < feed.n_markets:
                raise ValueError(f"job {job.name!r}: market {job.market} "
                                 f"outside feed's {feed.n_markets} markets")
        self.feed = feed
        self.jobs = list(jobs)
        self.prob = prob
        self.quad = quad
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data = engine.torch_quadratic(quad, self.device)
        self.w0 = np.asarray(w0, np.float32)
        self.alpha = float(alpha)
        self.rt_true = rt_true
        self.cfg = cfg
        self.program = engine.quadratic_program(cfg.grad, cfg.batch)
        # fixed per-job iteration targets from the prior (all-active bound);
        # replans re-solve the *remaining* work against this fixed target
        self.J_total = [conv.phi_inverse(prob, j.eps, 1.0 / j.n_workers)
                        for j in self.jobs]
        self.j_cap = max(self.J_total)
        self.n_cap = max(j.n_workers for j in self.jobs)
        total = feed.n_ticks if cfg.total_ticks is None else cfg.total_ticks
        if total > feed.n_ticks:
            raise ValueError(f"total_ticks={total} exceeds the feed's "
                             f"{feed.n_ticks} ticks")
        n_windows = (total - cfg.warmup) // cfg.horizon
        if n_windows < 1:
            raise ValueError(
                f"no full horizon window fits: total={total}, "
                f"warmup={cfg.warmup}, horizon={cfg.horizon}")
        self.total_ticks = cfg.warmup + n_windows * cfg.horizon
        self.score_ticks = (cfg.score_ticks if cfg.score_ticks is not None
                            else 3 * self.j_cap)

    # -- helpers -----------------------------------------------------------

    def _exec_scenario(self, i: int, cand: pl.Candidate) -> engine.Scenario:
        """The execution scenario for job i under committed plan ``cand``:
        tick-indexed replay of the job's full market column (the engine
        only reads rows inside each executed window)."""
        job = self.jobs[i]
        common = dict(
            price=engine.PriceSpec.from_trace_ticks(
                self.feed.market_prices(job.market)),
            alpha=self.alpha, rt_kind=self.rt_true.kind,
            rt_lam=self.rt_true.lam, rt_delta=self.rt_true.delta,
            rt_const=self.rt_true.r_const, idle_step=self.cfg.idle_step,
            on_demand_price=self.cfg.on_demand_price,
            name=f"{job.name}:{cand.kind}")
        if cand.workers is not None:
            return engine.Scenario(
                worker_schedule=np.full(self.j_cap, int(cand.workers),
                                        np.int32),
                n_fleet=self.n_cap, preempt_q=self.cfg.q_true,
                J_target=self.J_total[i], **common)
        bids = np.full(self.n_cap, NEVER_BID, np.float32)
        bids[:len(cand.bids)] = np.asarray(cand.bids, np.float32)
        return engine.Scenario(bid_schedule=np.tile(bids, (self.j_cap, 1)),
                               J_target=self.J_total[i], **common)

    def _posterior_request(self, est: OnlineEstimator, i: int,
                           state: engine.SimState,
                           committed: List[Optional[pl.Candidate]]
                           ) -> pl.PlanRequest:
        job = self.jobs[i]
        j_done = int(state.j[i, 0])
        t_job = float(state.t[i, 0])
        grid = est.sample_grid(self.cfg.sample_grid)[job.market]
        cand = committed[i]
        req = pl.PlanRequest(
            job=i, market=job.market,
            price_spec=engine.PriceSpec.empirical(grid),
            rt=est.runtime_model(job.market),
            q_hat=float(est.preempt_mean[job.market]),
            j_left=max(self.J_total[i] - j_done, 1),
            theta_left=max(job.theta - t_job, 1e-6),
            eps=job.eps, n_workers=job.n_workers,
            done=j_done >= self.J_total[i])
        req.candidates = pl.generate_candidates(
            self.prob, eps=job.eps, theta_left=req.theta_left,
            j_left=req.j_left, n=job.n_workers,
            dist=est.price_dist(job.market, self.cfg.sample_grid),
            rt=req.rt, q_hat=req.q_hat,
            current_bids=None if cand is None or cand.bids is None
            else np.asarray(cand.bids),
            multibid_partitions=self.cfg.multibid_partitions,
            include_provision=self.cfg.include_provision)
        return req

    def _observe_window(self, est: OnlineEstimator, res: engine.EngineResult,
                        j_prev: np.ndarray, j_new: np.ndarray,
                        t_prev: np.ndarray) -> None:
        """Feed realized iteration durations into the runtime-rate
        posterior. Durations come from completion-time diffs, so they
        include any idle gap before the iteration — a conservative
        (λ̂-lowering) approximation; see estimator.observe_durations."""
        markets, durs, ys = [], [], []
        times = np.asarray(res.times)[:, 0]        # (S, J_cap)
        yarr = np.asarray(res.ys)[:, 0]
        for i, job in enumerate(self.jobs):
            lo, hi = int(j_prev[i]), int(j_new[i])
            if hi <= lo:
                continue
            tt = times[i, lo:hi]
            prev = np.concatenate([[t_prev[i]], tt[:-1]])
            markets.extend([job.market] * (hi - lo))
            durs.extend((tt - prev).tolist())
            ys.extend(yarr[i, lo:hi].tolist())
        if markets:
            est.observe_durations(np.asarray(markets), np.asarray(durs),
                                  np.asarray(ys))

    def _static_grid(self, requests_0: List[pl.PlanRequest]
                     ) -> Tuple[List[engine.Scenario], List[Dict[str, Any]]]:
        """All static reference plans, evaluated on the real trace over the
        service's own execution window in one engine call: per job, the
        hindsight uniform-bid grid (quantiles of the realized post-warmup
        trace) plus every warm-up-posterior paper-strategy candidate."""
        scenarios, meta = [], []
        for i, job in enumerate(self.jobs):
            col = self.feed.market_prices(job.market)
            realized = col[self.cfg.warmup:self.total_ticks]
            levels = np.quantile(
                realized, np.linspace(0.05, 1.0, self.cfg.hindsight_levels))
            levels = np.unique(np.round(levels, 9))
            for b in levels:
                cand = pl.Candidate(kind=f"hindsight-b={b:.4f}",
                                    bids=tuple([float(b)] * job.n_workers))
                scenarios.append(self._exec_scenario(i, cand))
                meta.append({"job": i, "family": "hindsight",
                             "kind": cand.kind})
            for c in requests_0[i].candidates:
                if c.kind == "hold":
                    continue          # aliases no-interrupt at horizon 0
                scenarios.append(self._exec_scenario(i, c))
                meta.append({"job": i, "family": "static-paper",
                             "kind": c.kind,
                             "expected_error": _num(c.expected_error)})
        return scenarios, meta

    def _eval_static(self, requests_0: List[pl.PlanRequest]
                     ) -> List[Dict[str, Any]]:
        scenarios, meta = self._static_grid(requests_0)
        stacked = engine.stack_scenarios(scenarios, device=self.device)
        state0 = engine.initial_state(stacked, self.w0, 1,
                                      device=self.device)
        cfg = engine.SimConfig(n_ticks=self.total_ticks, grad=self.cfg.grad,
                               batch=self.cfg.batch)
        res = engine.simulate_program(
            stacked, self.program, None, self.data, [self.cfg.seed], cfg,
            init_state=state0, tick0=self.cfg.warmup, device=self.device)
        for k, m in enumerate(meta):
            job = self.jobs[m["job"]]
            m["cost"] = float(res.total_cost[k, 0])
            m["time"] = float(res.total_time[k, 0])
            m["completed"] = bool(res.completed[k, 0])
            m["feasible"] = m["completed"] and m["time"] <= job.theta
        return meta

    # -- the loop ----------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        est = OnlineEstimator(self.feed.n_markets, delta=self.rt_true.delta)
        win = self.feed.next_window(cfg.warmup)
        est.update(win.prices, win.preempted)

        committed: List[Optional[pl.Candidate]] = [None] * len(self.jobs)
        exec_state: Optional[engine.SimState] = None
        tick_now = cfg.warmup
        decisions: List[Dict[str, Any]] = []
        latencies: List[float] = []
        requests_0: Optional[List[pl.PlanRequest]] = None
        zero_state = engine.initial_state(
            engine.stack_scenarios(
                [self._exec_scenario(i, pl.Candidate(
                    kind="init", bids=tuple([1.0] * j.n_workers)))
                 for i, j in enumerate(self.jobs)], device=self.device),
            self.w0, 1, device=self.device)
        exec_state = zero_state

        horizon_idx = 0
        while tick_now < self.total_ticks:
            t0 = time.perf_counter()
            requests = [self._posterior_request(est, i, exec_state, committed)
                        for i in range(len(self.jobs))]
            if requests_0 is None:
                requests_0 = requests
            scores = pl.score_requests(
                requests, alpha=self.alpha, model0=self.w0, data=self.data,
                program=self.program, j_cap=self.j_cap, n_cap=self.n_cap,
                seeds=[1000 + cfg.seed + r for r in range(cfg.score_seeds)],
                score_ticks=self.score_ticks, grad=cfg.grad, batch=cfg.batch,
                idle_step=cfg.idle_step,
                on_demand_price=cfg.on_demand_price, mesh=self.mesh,
                device=self.device)
            picks = pl.choose(requests, scores)
            for i, (idx, cand) in enumerate(picks):
                if not requests[i].done:
                    committed[i] = cand
            latency = time.perf_counter() - t0
            latencies.append(latency)

            # swap the committed plans into the execution batch (same
            # shapes — data only) and run the next feed window
            batch = engine.stack_scenarios(
                [self._exec_scenario(i, committed[i])
                 for i in range(len(self.jobs))], device=self.device)
            j_prev = _host(exec_state.j)[:, 0]
            t_prev = _host(exec_state.t)[:, 0]
            run_cfg = engine.SimConfig(
                n_ticks=tick_now + cfg.horizon, grad=cfg.grad,
                batch=cfg.batch, snapshot_every=cfg.horizon)
            res = engine.simulate_program(
                batch, self.program, None, self.data, [cfg.seed], run_cfg,
                init_state=exec_state, tick0=tick_now, device=self.device)
            exec_state, tick_now = engine.snapshot_state(res, -1)
            j_new = _host(exec_state.j)[:, 0]

            win = self.feed.next_window(cfg.horizon)
            est.update(win.prices, win.preempted)
            self._observe_window(est, res, j_prev, j_new, t_prev)

            for i, (idx, cand) in enumerate(picks):
                req = requests[i]
                decisions.append({
                    "type": "decision", "horizon": horizon_idx,
                    "tick": int(win.k0), "job": self.jobs[i].name,
                    "market": req.market, "done": req.done,
                    "j_done": int(j_prev[i]), "j_left": req.j_left,
                    "t": _num(t_prev[i]),
                    "theta_left": _num(req.theta_left),
                    "posterior": est.summary(req.market),
                    "chosen": cand.describe(), "chosen_index": idx,
                    "score": _num(scores[i][idx]),
                    "scores": [_num(s) for s in scores[i]],
                    "replan_latency_s": round(latency, 6),
                })
            horizon_idx += 1

        # -- final accounting ---------------------------------------------
        static = self._eval_static(requests_0)
        j_fin = _host(exec_state.j)[:, 0]
        total_cost = _host(exec_state.total_cost)
        t_final = _host(exec_state.t)
        err_trajs = _host(exec_state.err_traj)
        summary_jobs: Dict[str, Any] = {}
        for i, job in enumerate(self.jobs):
            cost = float(total_cost[i, 0])
            t_fin = float(t_final[i, 0])
            done = int(j_fin[i]) >= self.J_total[i]
            err_traj = err_trajs[i, 0]
            final_err = (float(err_traj[int(j_fin[i]) - 1])
                         if j_fin[i] > 0 else math.inf)
            mine = [m for m in static if m["job"] == i]
            hind = [m for m in mine if m["family"] == "hindsight"
                    and m["feasible"]]
            paper = [m for m in mine if m["family"] == "static-paper"
                     and m["feasible"]]
            hind_cost = min((m["cost"] for m in hind), default=math.inf)
            paper_cost = min((m["cost"] for m in paper), default=math.inf)
            summary_jobs[job.name] = {
                "iterations": int(j_fin[i]), "target_J": self.J_total[i],
                "completed": done, "deadline_met": t_fin <= job.theta,
                "cost": _num(cost), "time": _num(t_fin),
                "final_error": _num(final_err), "eps": job.eps,
                "hindsight_static_cost": _num(hind_cost),
                "regret_vs_hindsight": _num(cost - hind_cost),
                "best_static_paper_cost": _num(paper_cost),
                "regret_vs_static_paper": _num(cost - paper_cost),
            }
        lat = np.asarray(latencies)
        summary = {
            "type": "summary",
            "ticks": self.total_ticks, "warmup": cfg.warmup,
            "horizon": cfg.horizon, "horizons": horizon_idx,
            "n_jobs": len(self.jobs), "seed": cfg.seed,
            "decisions": horizon_idx * len(self.jobs),
            "replan_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "replan_p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 3),
            "decisions_per_sec": round(
                horizon_idx * len(self.jobs) / max(float(lat.sum()), 1e-9),
                3),
            "jobs": summary_jobs,
        }
        report = {"decisions": decisions, "summary": summary,
                  "static": static}
        if cfg.out_dir is not None:
            os.makedirs(cfg.out_dir, exist_ok=True)
            path = os.path.join(cfg.out_dir, "decisions.jsonl")
            with open(path, "w") as fh:
                for row in decisions:
                    fh.write(json.dumps(row) + "\n")
                fh.write(json.dumps(summary) + "\n")
            report["decisions_path"] = path
        return report


def _host(x) -> np.ndarray:
    """A carry tensor as a host array (a copy)."""
    return x.cpu().numpy().copy()


def _num(x) -> Optional[float]:
    x = float(x)
    return None if not math.isfinite(x) else round(x, 6)


def demo_problem(seed: int = 0, dim: int = 6, cond: float = 5.0):
    """A service-scale job: a small well-conditioned quadratic whose
    Theorem-1 constants give tens (not hundreds) of target iterations, so
    feeds of a few hundred ticks carry full jobs. Returns (quad, w0, prob)
    — `sim.evaluate.calibrated_quadratic` stays the honest-constants
    choice for figure experiments."""
    from repro_torch.data.synthetic import QuadraticProblem

    quad = QuadraticProblem(dim=dim, n_samples=64, cond=cond, noise=0.2,
                            seed=seed)
    w0 = quad.w_star + 1.0
    g0 = quad.loss(w0) - quad.g_star
    prob = conv.SGDProblem(
        alpha=0.4 / quad.L, c=quad.c, mu=1.0, L=quad.L,
        M=quad.grad_noise_bound(w_scale=1.0, batch=4), G0=g0)
    return quad, w0, prob
