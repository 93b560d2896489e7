"""Spot-price distributions, the per-iteration runtime model, and the
Lemma 1/2 expected completion-time and cost expressions."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np


# --------------------------------------------------------------------------
# Spot price distributions (i.i.d. per iteration, bounded support [lo, hi])
# --------------------------------------------------------------------------


class PriceDist:
    """Interface: cdf F, pdf f, quantile F⁻¹ on support [lo, hi]."""

    lo: float
    hi: float

    def cdf(self, p):  # noqa: D401
        raise NotImplementedError

    def pdf(self, p):
        raise NotImplementedError

    def quantile(self, u):
        """F⁻¹(u); u is clipped to [F(lo⁺), 1] so infeasible demands map to
        bidding the max price."""
        raise NotImplementedError

    def sample(self, rng: np.random.Generator, size=None):
        u = rng.uniform(size=size)
        return self.quantile(u)

    def mean_below(self, b: float) -> float:
        """E[p | p ≤ b] (numerical; used for cost accounting)."""
        grid = np.linspace(self.lo, b, 2049)
        pdf = self.pdf(grid)
        z = np.trapezoid(pdf, grid)
        if z <= 0:
            return self.lo
        return float(np.trapezoid(grid * pdf, grid) / z)


@dataclasses.dataclass
class UniformPrice(PriceDist):
    lo: float = 0.2
    hi: float = 1.0

    def cdf(self, p):
        return np.clip((np.asarray(p, float) - self.lo) / (self.hi - self.lo),
                       0.0, 1.0)

    def pdf(self, p):
        p = np.asarray(p, float)
        return np.where((p >= self.lo) & (p <= self.hi),
                        1.0 / (self.hi - self.lo), 0.0)

    def quantile(self, u):
        return self.lo + np.clip(u, 0, 1) * (self.hi - self.lo)


@dataclasses.dataclass
class TruncGaussianPrice(PriceDist):
    """Gaussian truncated to [lo, hi] (the paper's synthetic Gaussian trace:
    mean .6, std .175 on [0.2, 1])."""

    mu: float = 0.6
    sigma: float = 0.175
    lo: float = 0.2
    hi: float = 1.0

    def _phi(self, x):
        return 0.5 * (1 + np.vectorize(math.erf)(
            (np.asarray(x, float) - self.mu) / (self.sigma * math.sqrt(2))))

    def _z(self):
        return self._phi(self.hi) - self._phi(self.lo)

    def cdf(self, p):
        p = np.clip(np.asarray(p, float), self.lo, self.hi)
        return (self._phi(p) - self._phi(self.lo)) / self._z()

    def pdf(self, p):
        p = np.asarray(p, float)
        base = np.exp(-0.5 * ((p - self.mu) / self.sigma) ** 2) / (
            self.sigma * math.sqrt(2 * math.pi))
        return np.where((p >= self.lo) & (p <= self.hi), base / self._z(), 0.0)

    def quantile(self, u):
        u = np.clip(np.asarray(u, float), 0, 1)
        lo, hi = np.full_like(u, self.lo), np.full_like(u, self.hi)
        for _ in range(60):  # bisection; vectorized
            mid = 0.5 * (lo + hi)
            below = self.cdf(mid) < u
            lo = np.where(below, mid, lo)
            hi = np.where(below, hi, mid)
        return 0.5 * (lo + hi)


@dataclasses.dataclass
class EmpiricalPrice(PriceDist):
    """Empirical distribution of a price trace (the paper's
    DescribeSpotPriceHistory experiment — here a bundled synthetic trace)."""

    samples: np.ndarray = None

    def __post_init__(self):
        self.samples = np.sort(np.asarray(self.samples, float))
        self.lo = float(self.samples[0])
        self.hi = float(self.samples[-1])

    def cdf(self, p):
        return np.searchsorted(self.samples, np.asarray(p, float),
                               side="right") / len(self.samples)

    def pdf(self, p):  # kernel-free histogram density (for integrals only)
        hist, edges = np.histogram(self.samples, bins=64, density=True)
        idx = np.clip(np.searchsorted(edges, np.asarray(p, float)) - 1, 0,
                      len(hist) - 1)
        return hist[idx]

    def quantile(self, u):
        u = np.clip(np.asarray(u, float), 0, 1)
        idx = np.clip((u * len(self.samples)).astype(int), 0,
                      len(self.samples) - 1)
        return self.samples[idx]


# --------------------------------------------------------------------------
# Per-iteration runtime model
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RuntimeModel:
    """E[R(y)] for y active workers (Eq. 10).

    kind="exp": i.i.d. exp(λ) worker times ⇒ E[max] ≈ H_y/λ, plus the PS
    update time Δ. kind="det": deterministic R (straggler-free, §V).
    """

    kind: str = "exp"
    lam: float = 1.0
    delta: float = 0.05
    r_const: float = 1.0

    def expected(self, y: int) -> float:
        if y <= 0:
            return 0.0
        if self.kind == "det":
            return self.r_const
        h = float(np.sum(1.0 / np.arange(1, y + 1)))
        return h / self.lam + self.delta

    def sample(self, rng: np.random.Generator, y: int) -> float:
        if y <= 0:
            return 0.0
        if self.kind == "det":
            return self.r_const
        return float(np.max(rng.exponential(1.0 / self.lam, size=y))
                     + self.delta)


# --------------------------------------------------------------------------
# Lemma 1 / Lemma 2 (identical bids)
# --------------------------------------------------------------------------


def expected_time_uniform_bid(J: int, n: int, b: float, dist: PriceDist,
                              rt: RuntimeModel) -> float:
    """Lemma 1: E[τ] = J·E[R(n)] / F(b)."""
    Fb = float(dist.cdf(b))
    if Fb <= 0:
        return math.inf
    return J * rt.expected(n) / Fb


def expected_cost_uniform_bid(J: int, n: int, b: float, dist: PriceDist,
                              rt: RuntimeModel) -> float:
    """Lemma 2: E[C] = J·n·E[R(n)]·(p̲ + ∫_p̲^b (1 − F(p)/F(b)) dp)."""
    Fb = float(dist.cdf(b))
    if Fb <= 0:
        return math.inf
    grid = np.linspace(dist.lo, b, 4097)
    integrand = 1.0 - dist.cdf(grid) / Fb
    integral = float(np.trapezoid(integrand, grid))
    return J * n * rt.expected(n) * (dist.lo + integral)


def expected_price_paid(b: float, dist: PriceDist) -> float:
    """E[p | p ≤ b] — equivalent per-active-unit-time price. Lemma 2 equals
    J·n·E[R(n)]·E[p|p≤b]."""
    return dist.mean_below(b)
