"""Strategy evaluation results: per-scenario, seed-averaged views of the
batched engine's trajectories with mean ± CI summaries. The quadratic
oracle runners (`evaluate_batch`, the legacy loop runners) come with the
quadratic_program slice."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.sim import engine


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
