"""Online posterior estimation per market, vectorized across markets.

Three posteriors per tracked market, all updated in O(window) NumPy with no
per-market Python loop:

- **Price distribution** — a ring buffer of the last ``window`` observed
  prices per market; empirical quantiles of the buffer are the posterior
  predictive. ``sample_grid`` exports a *fixed-size* sorted quantile grid
  so downstream engine specs keep a constant trace shape (no recompile as
  the buffer grows).
- **Preemption probability** — conjugate Beta(a, b) over the per-tick
  exogenous preemption indicator (§V's q), updated from the feed's
  preemption channel.
- **Runtime rate** — conjugate Gamma(a, b) over the exponential
  per-worker rate λ (Eq. 10). An iteration with y active workers taking
  ``dur`` wall-clock has E[dur] = H_y/λ + Δ, so ``x = (dur − Δ)/H_y`` is
  a pseudo-sample with mean 1/λ; treating it as exp(λ) gives the standard
  Gamma update (a += 1, b += x). This is a moment-matched approximation —
  the max of y exponentials is not exponential — but its posterior mean
  converges to λ (see tests/test_estimator.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.cost_model import EmpiricalPrice, RuntimeModel


def _harmonic(n: int) -> np.ndarray:
    """H_0..H_n with H_0 := 1 (guards divide-by-zero on y=0 rows)."""
    h = np.concatenate([[1.0], np.cumsum(1.0 / np.arange(1, n + 1))])
    h[1] = 1.0
    return h


class OnlineEstimator:
    """Vectorized online posteriors for ``n_markets`` markets."""

    def __init__(self, n_markets: int, window: int = 4096,
                 delta: float = 0.05,
                 preempt_prior: tuple = (1.0, 1.0),
                 rate_prior_mean: float = 1.0,
                 rate_prior_strength: float = 2.0,
                 max_workers: int = 64):
        if n_markets < 1:
            raise ValueError("need at least one market")
        self.n_markets = int(n_markets)
        self.window = int(window)
        self.delta = float(delta)
        self._buf = np.full((self.n_markets, self.window), np.nan)
        self._pos = 0                      # shared write head (per-tick
        self._count = 0                    # updates cover all markets)
        self.pre_a = np.full(self.n_markets, float(preempt_prior[0]))
        self.pre_b = np.full(self.n_markets, float(preempt_prior[1]))
        self.rate_a = np.full(self.n_markets, float(rate_prior_strength))
        self.rate_b = np.full(self.n_markets,
                              float(rate_prior_strength) / rate_prior_mean)
        self._H = _harmonic(int(max_workers))

    # -- updates -----------------------------------------------------------

    def update(self, prices: np.ndarray,
               preempted: Optional[np.ndarray] = None) -> None:
        """Ingest ``T`` ticks for every market at once: ``prices`` is
        (T, M) (or (M,) for a single tick), ``preempted`` an optional
        boolean array of the same shape."""
        prices = np.asarray(prices, float)
        if prices.ndim == 1:
            prices = prices[None, :]
        T, M = prices.shape
        if M != self.n_markets:
            raise ValueError(f"update for {M} markets, tracking "
                             f"{self.n_markets}")
        idx = (self._pos + np.arange(T)) % self.window
        self._buf[:, idx] = prices.T
        self._pos = int((self._pos + T) % self.window)
        self._count += T
        if preempted is not None:
            preempted = np.asarray(preempted, bool)
            if preempted.ndim == 1:
                preempted = preempted[None, :]
            hits = preempted.sum(axis=0).astype(float)
            self.pre_a += hits
            self.pre_b += T - hits

    def observe_durations(self, markets: np.ndarray, durations: np.ndarray,
                          ys: np.ndarray) -> None:
        """Conjugate Gamma update from completed iterations: ``markets[i]``
        ran one iteration with ``ys[i]`` active workers in ``durations[i]``
        wall-clock. Vectorized over arbitrary (repeated) market indices."""
        markets = np.asarray(markets, int)
        durations = np.asarray(durations, float)
        ys = np.clip(np.asarray(ys, float), 1, len(self._H) - 1).astype(int)
        keep = np.isfinite(durations) & (durations > 0)
        markets, durations, ys = markets[keep], durations[keep], ys[keep]
        if len(markets) == 0:
            return
        x = np.maximum(durations - self.delta, 1e-9) / self._H[ys]
        self.rate_a += np.bincount(markets, minlength=self.n_markets)
        self.rate_b += np.bincount(markets, weights=x,
                                   minlength=self.n_markets)

    # -- views -------------------------------------------------------------

    @property
    def n_samples(self) -> int:
        return min(self._count, self.window)

    @property
    def ready(self) -> bool:
        return self._count > 0

    def prices(self) -> np.ndarray:
        """(M, n_samples) view of the retained price history."""
        return self._buf[:, :self.n_samples]

    def quantile(self, u) -> np.ndarray:
        """Posterior price quantiles, shape (M,) or (M, len(u))."""
        if not self.ready:
            raise ValueError("no price observations yet")
        q = np.quantile(self.prices(), np.asarray(u, float), axis=1)
        return np.moveaxis(q, 0, -1) if np.ndim(u) else q

    def sample_grid(self, size: int = 128) -> np.ndarray:
        """(M, size) sorted quantile grid at levels (i+½)/size — a
        fixed-shape posterior sample set for engine ``PriceSpec.empirical``
        specs and ``EmpiricalPrice`` fits."""
        levels = (np.arange(size) + 0.5) / size
        return self.quantile(levels)

    @property
    def preempt_mean(self) -> np.ndarray:
        """(M,) posterior mean of the per-tick preemption probability q."""
        return self.pre_a / (self.pre_a + self.pre_b)

    @property
    def rate_mean(self) -> np.ndarray:
        """(M,) posterior mean of the exponential runtime rate λ."""
        return self.rate_a / self.rate_b

    def price_dist(self, m: int, size: int = 128) -> EmpiricalPrice:
        return EmpiricalPrice(samples=self.sample_grid(size)[m])

    def runtime_model(self, m: int) -> RuntimeModel:
        return RuntimeModel(kind="exp", lam=float(self.rate_mean[m]),
                            delta=self.delta)

    def summary(self, m: int) -> dict:
        """Compact posterior snapshot for a decisions.jsonl row."""
        q = (self.quantile([0.1, 0.5, 0.9])[m].tolist()
             if self.ready else [None] * 3)
        return {
            "n_samples": self.n_samples,
            "price_q10": q[0], "price_q50": q[1], "price_q90": q[2],
            "preempt_mean": float(self.preempt_mean[m]),
            "rate_mean": float(self.rate_mean[m]),
        }
