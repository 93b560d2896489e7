"""Strategy evaluation harness: run a bidding/provisioning strategy against
the simulated market on the quadratic oracle problem (exact Theorem-1
constants) and record (error, cost, time) trajectories — the engine behind
the Fig. 3/4/5 benchmarks and the paper-claims validation.

``evaluate_batch`` runs the whole grid on the port's engine, on ``cuda``
unless asked for the CPU; the legacy one-scenario runners are the
reference's numpy loops as they stand."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core.cost_model import PriceDist, RuntimeModel
from repro_torch.core.strategies import Strategy
from repro_torch.data.synthetic import QuadraticProblem
from repro_torch.sim import engine
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.sim.spot_market import SpotMarket


@dataclasses.dataclass
class RunResult:
    errors: np.ndarray            # suboptimality per iteration
    costs: np.ndarray             # cumulative cost
    times: np.ndarray             # wall clock
    summary: Dict

    def cost_to_error(self, eps: float) -> float:
        """Cumulative cost when the error first reaches eps (inf if never)."""
        if len(self.errors) == 0:
            return float("inf")
        idx = np.argmax(self.errors <= eps)
        if self.errors[idx] > eps:
            return float("inf")
        return float(self.costs[idx])

    def time_to_error(self, eps: float) -> float:
        if len(self.errors) == 0:
            return float("inf")
        idx = np.argmax(self.errors <= eps)
        if self.errors[idx] > eps:
            return float("inf")
        return float(self.times[idx])


def calibrated_quadratic(noise: float = 0.3, batch: int = 16,
                         label_noise: float = 0.0, seed: int = 0):
    """Standard calibration for strategy experiments: a quadratic oracle
    whose Theorem-1 constants are honest and whose noise floor sits at
    ~G0/20 (bound-feasible ε targets). Returns (quad, w0, prob, batch)."""
    from repro_torch.core import convergence as conv

    quad = QuadraticProblem(dim=10, n_samples=256, cond=8.0, noise=noise,
                            label_noise=label_noise, seed=seed)
    w0 = quad.w_star + 2.0 * np.ones(quad.dim) / np.sqrt(quad.dim)
    g0 = quad.loss(w0) - quad.g_star
    m = quad.grad_noise_bound(w_scale=2.0, batch=batch)
    alpha = min(0.5 / quad.L, g0 * quad.c / (10 * quad.L * m))
    prob = conv.SGDProblem(alpha=alpha, c=quad.c, mu=1.0, L=quad.L, M=m,
                           G0=g0)
    return quad, w0, prob, batch


def run_spot_strategy(quad: QuadraticProblem, w0: np.ndarray, alpha: float,
                      strategy: Strategy, market: SpotMarket,
                      rt: RuntimeModel, iterations: Optional[int] = None,
                      batch: int = 2, seed: int = 0,
                      grad: str = "minibatch",
                      idle_step: Optional[float] = None) -> RunResult:
    """SGD on the quadratic with per-iteration bid-controlled preemption
    (the legacy one-scenario Python loop; `evaluate_batch` is the vectorized
    path). grad="full" uses the exact gradient — deterministic trajectories
    for parity checks and throughput benchmarks."""
    n = len(strategy.bids(0.0, 0))
    if idle_step is None:
        idle_step = rt.expected(max(n, 1))
    cluster = VolatileCluster(n_workers=n, runtime=rt, market=market,
                              seed=seed, idle_step=idle_step)
    rng = np.random.default_rng(seed + 1)
    w = w0.copy()
    total = iterations or strategy.total_iterations
    errors, costs, times = [], [], []
    for j in range(total):
        bids = strategy.bids(cluster.t, j)
        if len(bids) != n:  # dynamic strategies may grow the fleet
            n = len(bids)
            cluster.n_workers = n
        mask = cluster.next_iteration_spot(j, np.asarray(bids))
        active = np.flatnonzero(mask)
        if grad == "full":
            g = quad.full_grad(w)
        else:
            g = np.mean([quad.grad_minibatch(w, rng, batch)
                         for _ in active], axis=0)
        w = w - alpha * g
        errors.append(quad.loss(w) - quad.g_star)
        costs.append(cluster.total_cost)
        times.append(cluster.t)
    return RunResult(np.array(errors), np.array(costs), np.array(times),
                     cluster.summary())


def run_preemptible_strategy(quad: QuadraticProblem, w0: np.ndarray,
                             alpha: float, strategy: Strategy,
                             q: float, rt: RuntimeModel,
                             price: float = 1.0, batch: int = 2,
                             seed: int = 0,
                             iterations: Optional[int] = None) -> RunResult:
    """§V mode: exogenous preemption, the strategy controls n_j."""
    cluster = VolatileCluster(n_workers=10 ** 6, runtime=rt, preempt_q=q,
                              on_demand_price=price, seed=seed)
    rng = np.random.default_rng(seed + 1)
    w = w0.copy()
    total = iterations or strategy.total_iterations
    errors, costs, times = [], [], []
    for j in range(total):
        prov = strategy.workers(j)
        mask = cluster.next_iteration_preemptible(j, prov)
        y = int(mask.sum())
        g = np.mean([quad.grad_minibatch(w, rng, batch) for _ in range(y)],
                    axis=0)
        w = w - alpha * g
        errors.append(quad.loss(w) - quad.g_star)
        costs.append(cluster.total_cost)
        times.append(cluster.t)
    return RunResult(np.array(errors), np.array(costs), np.array(times),
                     cluster.summary())


# --------------------------------------------------------------------------
# Vectorized evaluation on the batched engine
# --------------------------------------------------------------------------


def nanmean(x: np.ndarray, axis=None) -> np.ndarray:
    """np.nanmean without the all-NaN RuntimeWarning — all-NaN slices are
    legitimate engine output (iterations no seed reached within the tick
    budget) and map to NaN."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmean(x, axis=axis)


def nanstd(x: np.ndarray, axis=None) -> np.ndarray:
    """np.nanstd with the same all-NaN / zero-dof silencing as `nanmean`."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanstd(x, axis=axis)


def _first_at_or_below(errors: np.ndarray, values: np.ndarray,
                       eps: float) -> float:
    """``values`` at the first index where ``errors`` ≤ eps (NaN-safe);
    inf if the error level is never reached."""
    with np.errstate(invalid="ignore"):
        hit = np.flatnonzero(errors <= eps)
    return float(values[hit[0]]) if len(hit) else float("inf")


def _mean_ci(x: np.ndarray, axis: int = -1):
    """(mean, 95% CI half-width) over ``axis``, ignoring NaN/inf entries.
    Student-t critical value with Bessel correction — at the small seed
    counts used here (n≈8) the normal 1.96 would understate the width."""
    import warnings

    from scipy import stats

    x = np.where(np.isfinite(x), x, np.nan)
    n = np.sum(~np.isnan(x), axis=axis)
    with warnings.catch_warnings():
        # all-NaN slices (e.g. no seed reached eps) are a legitimate input
        # here and mapped to (nan, inf) — keep numpy quiet about them
        warnings.simplefilter("ignore", RuntimeWarning)
        mean = np.nanmean(x, axis=axis)
        sd = np.nanstd(x, axis=axis, ddof=1)
    tcrit = stats.t.ppf(0.975, np.maximum(n - 1, 1))
    ci = np.where(n > 1, tcrit * sd / np.sqrt(np.maximum(n, 1)), np.inf)
    return mean, ci


@dataclasses.dataclass
class BatchResult:
    """Stacked multi-seed engine trajectories with per-scenario mean/CI
    summaries. Axis order: (scenario, seed, iteration)."""

    names: List[str]
    result: engine.EngineResult

    @property
    def n_scenarios(self) -> int:
        return len(self.names)

    @property
    def n_seeds(self) -> int:
        return self.result.errors.shape[1]

    def index(self, name: str) -> int:
        return self.names.index(name)

    def run(self, name: str) -> RunResult:
        """Seed-averaged RunResult for one scenario (mean trajectories,
        mean ± CI summary) — drop-in for the legacy `average_runs` output."""
        i = self.index(name)
        r = self.result
        J = int(r.J[i])
        errors = nanmean(r.errors[i, :, :J], axis=0)
        costs = nanmean(r.costs[i, :, :J], axis=0)
        times = nanmean(r.times[i, :, :J], axis=0)
        cost_m, cost_ci = _mean_ci(r.total_cost[i])
        time_m, time_ci = _mean_ci(r.total_time[i])
        err_m, err_ci = _mean_ci(r.errors[i, :, J - 1])
        return RunResult(errors, costs, times, summary={
            "reps": self.n_seeds,
            "completed": float(r.completed[i].mean()),
            "cost_mean": float(cost_m), "cost_ci": float(cost_ci),
            "time_mean": float(time_m), "time_ci": float(time_ci),
            "final_err_mean": float(err_m), "final_err_ci": float(err_ci),
        })

    def cost_to_error(self, name: str, eps: float):
        """(mean, CI) over seeds of the cumulative cost when the error first
        reaches eps (seeds that never reach it are dropped from the mean)."""
        i = self.index(name)
        r = self.result
        per_seed = np.array([
            _first_at_or_below(r.errors[i, s], r.costs[i, s], eps)
            for s in range(self.n_seeds)])
        mean, ci = _mean_ci(per_seed)
        return float(mean), float(ci), per_seed


def evaluate_batch(strategies: Mapping[str, Strategy],
                   scenarios: Union[Mapping[str, Optional[PriceDist]],
                                    Sequence[engine.Scenario]],
                   n_seeds: int = 8, *,
                   quad: QuadraticProblem, w0: np.ndarray, alpha: float,
                   rt: Optional[RuntimeModel] = None,
                   q: Optional[float] = None, on_demand_price: float = 1.0,
                   batch: int = 16, grad: str = "minibatch",
                   n_max: Optional[int] = None,
                   n_ticks: Optional[int] = None,
                   idle_step: Optional[float] = None,
                   snapshot_every: int = 0, device=None) -> BatchResult:
    """Run every strategy × market scenario × seed in one engine call on
    ``device`` (default ``cuda``).

    ``scenarios`` is either a mapping market-name → PriceDist (spot mode;
    use ``q`` instead of dists for §V preemptible mode) or a pre-built list
    of `engine.Scenario` (then ``strategies`` only labels them). Returns
    stacked trajectories with mean ± 95%-CI summaries per scenario; labels
    are "<strategy>@<market>". ``snapshot_every = k`` additionally stacks
    the full carry every k ticks into ``result.snapshots`` (see
    ``engine.snapshot_state``).
    """
    if isinstance(scenarios, Mapping):
        if rt is None:
            raise ValueError(
                "rt (RuntimeModel) is required when scenarios are given as "
                "a market-name → PriceDist mapping; it is only optional "
                "with pre-built engine.Scenario objects")
        built: List[engine.Scenario] = []
        for mname, dist in scenarios.items():
            for sname, strat in strategies.items():
                built.append(engine.scenario_from_strategy(
                    strat, alpha=alpha, rt=rt, dist=dist, q=q,
                    on_demand_price=on_demand_price, n_max=n_max,
                    idle_step=idle_step, name=f"{sname}@{mname}"))
    else:
        built = list(scenarios)
    names = [s.name or f"scenario{i}" for i, s in enumerate(built)]
    batch_spec = engine.stack_scenarios(built, device=device)
    if n_ticks is None:
        n_ticks = 4 * batch_spec.j_max + 64
    cfg = engine.SimConfig(n_ticks=n_ticks, batch=batch, grad=grad,
                           snapshot_every=snapshot_every)
    res = engine.simulate(batch_spec, quad, w0, n_seeds, cfg, device=device)
    return BatchResult(names=names, result=res)


def average_runs(fn: Callable[[int], RunResult], reps: int) -> RunResult:
    runs = [fn(s) for s in range(reps)]
    n = min(len(r.errors) for r in runs)
    return RunResult(
        errors=np.mean([r.errors[:n] for r in runs], axis=0),
        costs=np.mean([r.costs[:n] for r in runs], axis=0),
        times=np.mean([r.times[:n] for r in runs], axis=0),
        summary={"reps": reps},
    )
