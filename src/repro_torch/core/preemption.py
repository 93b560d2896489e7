"""Preemption models: distributions of the active-worker count y_j and the
E[1/y_j] quantities that drive Theorem 1 (Remark 2, Lemma 3).

All expectations condition on y_j > 0 (iterations with zero active workers
are idle time, not SGD iterations — §III-C).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy import special as sps


def inv_y_two_groups(n1: int, n: int, gamma: float) -> float:
    """Two-bid model (§IV-B): y = n w.p. γ = F(b2)/F(b1), else y = n1.
    E[1/y] = 1/n1 − γ(1/n1 − 1/n)."""
    assert 0 <= gamma <= 1 and 0 < n1 <= n
    return 1.0 / n1 - gamma * (1.0 / n1 - 1.0 / n)


def gamma_for_inv_y(n1: int, n: int, inv_y: float) -> float:
    """Invert `inv_y_two_groups` for γ (clamped to [0, 1])."""
    if n1 == n:
        return 1.0
    g = (1.0 / n1 - inv_y) / (1.0 / n1 - 1.0 / n)
    return min(1.0, max(0.0, g))


def inv_y_uniform(n: int) -> float:
    """Lemma 3(a): y ~ Uniform{1..n}: E[1/y] = H_n/n ≤ O(n^{−1/2})."""
    return float(np.sum(1.0 / np.arange(1, n + 1))) / n


def pmf_binomial_conditional(n: int, q: float) -> Tuple[np.ndarray, np.ndarray]:
    """P[y = k | y > 0] for y ~ Binom(n, 1−q) (each worker preempted w.p. q)."""
    k = np.arange(1, n + 1)
    logp = (sps.gammaln(n + 1) - sps.gammaln(k + 1) - sps.gammaln(n - k + 1)
            + k * np.log1p(-q) + (n - k) * np.log(max(q, 1e-300)))
    p = np.exp(logp)
    p0 = q ** n
    return k, p / max(1.0 - p0, 1e-300)


def inv_y_binomial(n: int, q: float) -> float:
    """Lemma 3(b): E[1/y | y>0] for per-iteration i.i.d. preemption prob q."""
    if q <= 0:
        return 1.0 / n
    k, p = pmf_binomial_conditional(n, q)
    return float(np.sum(p / k))


def inv_y_plus_one_binomial(n: int, q: float) -> float:
    """Closed form E[1/(z+1)] = (1 − q^{n+1})/((n+1)(1−q)) for z ~ Binom(n,1−q)
    (Chao & Strawderman 1972) — used in the Lemma 3 proof and as a test
    oracle."""
    return (1 - q ** (n + 1)) / ((n + 1) * (1 - q))


def fit_chi(n_values, inv_y_values) -> Tuple[float, float]:
    """Fit the paper's E[1/y] ≤ d/n^χ model: log-log least squares →
    (chi, d)."""
    ln_n = np.log(np.asarray(n_values, float))
    ln_iy = np.log(np.asarray(inv_y_values, float))
    chi, neg_logd = np.polyfit(ln_n, -ln_iy, 1)
    return float(chi), float(np.exp(-neg_logd))


def prob_all_preempted(n: int, q: float) -> float:
    """P[y = 0] = q^n — drives the idle-time term of E[τ] (§III-C)."""
    return q ** n


def sample_active_workers(rng: np.random.Generator, n: int, q: float) -> int:
    """Draw y (may be 0) for one iteration."""
    return int(rng.binomial(n, 1.0 - q))
