"""Theorem 1 machinery: SGD error bounds with a variable number of active
workers, and its inversions (Q(ε), Corollary 1's J, Theorem 5's dynamic-
worker bound).

Notation (paper §III): β = 1 − αcμ, A = E[G(w0) − G*], B = α²LM/2.
Theorem 1:  E[G(w_J) − G*] ≤ β^J A + B Σ_{j=1..J} β^{J−j} E[1/y_j].

NOTE on Eq. (17): the paper's denominator reads αLM(1 − (αcμ)^J); consistency
with Theorem 1 (geometric sum of β^{J−j}) requires (1 − β^J) = 1 − (1−αcμ)^J.
We implement the latter and flag the typo here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SGDProblem:
    """Constants of the (c-strongly-convex, L-smooth) objective and SGD run."""

    alpha: float          # fixed step size
    c: float              # strong convexity
    mu: float             # Assumption 2 lower bound (usually 1 for unbiased g)
    L: float              # smoothness
    M: float              # gradient-noise variance bound (per worker batch)
    G0: float             # A = E[G(w0) − G*]

    def __post_init__(self):
        assert 0 < self.alpha, "step size must be positive"
        assert self.beta < 1, "need αcμ < 1 for contraction"

    @property
    def beta(self) -> float:
        return 1.0 - self.alpha * self.c * self.mu

    @property
    def B(self) -> float:
        return 0.5 * self.alpha ** 2 * self.L * self.M


def error_bound(prob: SGDProblem, inv_y: Sequence[float]) -> float:
    """Theorem 1 with an explicit per-iteration E[1/y_j] sequence."""
    J = len(inv_y)
    beta = prob.beta
    noise = sum(beta ** (J - j) * iy for j, iy in enumerate(inv_y, start=1))
    return beta ** J * prob.G0 + prob.B * noise


def error_bound_static(prob: SGDProblem, J: int, inv_y: float) -> float:
    """Theorem 1 with constant E[1/y_j] = inv_y (geometric closed form)."""
    beta = prob.beta
    if J == 0:
        return prob.G0
    geo = (1 - beta ** J) / (1 - beta)
    return beta ** J * prob.G0 + prob.B * inv_y * geo


def q_eps(prob: SGDProblem, J: int, eps: float) -> float:
    """Eq. (17): the largest admissible E[1/y] to reach error ε in J iters."""
    beta = prob.beta
    denom = prob.B * (1 - beta ** J)
    num = (1 - beta) * (eps - beta ** J * prob.G0)
    if denom <= 0:
        return math.inf
    return num / denom


def iterations_required(prob: SGDProblem, eps: float, inv_y: float) -> int:
    """Corollary 1: minimum J with error bound ≤ ε under constant E[1/y].

    J = log_β ((ε − κ)/(G0 − κ)),  κ = B/(1−β) · E[1/y] (the noise floor).
    Raises ValueError if ε is below the asymptotic floor κ (unreachable).
    """
    beta = prob.beta
    kappa = prob.B * inv_y / (1 - beta)
    if eps <= kappa:
        raise ValueError(
            f"target eps={eps:.4g} is at/below the noise floor {kappa:.4g}; "
            "need more workers (smaller E[1/y]) or a smaller step size")
    if prob.G0 <= eps:
        return 0
    j = math.log((eps - kappa) / (prob.G0 - kappa)) / math.log(beta)
    return max(0, math.ceil(j))


def phi_inverse(prob: SGDProblem, eps: float, inv_y: float) -> int:
    """Alias used by the bidding sections: J ≥ φ̂⁻¹(ε)."""
    return iterations_required(prob, eps, inv_y)


# --------------------------------------------- non-convex extension
# The paper states (after Theorem 1) that the bound "can be extended to
# handle non-convex G(·) ... where we analyze the convergence speed to a
# stationary point", omitting the statement for brevity. We supply it:
# telescoping Eq. (26) without the PL step gives, for L-smooth G and the
# Assumption-2 noise model,
#
#   min_{j<J} E‖∇G(w_j)‖² ≤ 2(G(w0) − G_inf)/(αμJ)
#                            + (αLM/μ)·(1/J)·Σ_j E[1/y_j].
#
# The volatile-worker penalty is again the mean of E[1/y_j] — Remarks 1–2
# carry over verbatim. Validated by Monte Carlo in tests/test_convergence.


def grad_norm_bound_nonconvex(prob: SGDProblem, inv_y: Sequence[float],
                              g_inf: float = 0.0) -> float:
    """min_j E‖∇G(w_j)‖² bound after J = len(inv_y) iterations.
    ``prob.G0`` is E[G(w0)]; ``g_inf`` a lower bound on inf G."""
    J = len(inv_y)
    assert J > 0
    term1 = 2.0 * (prob.G0 - g_inf) / (prob.alpha * prob.mu * J)
    term2 = (prob.alpha * prob.L * prob.M / prob.mu) * (
        sum(inv_y) / J)
    return term1 + term2


def grad_norm_bound_nonconvex_static(prob: SGDProblem, J: int,
                                     inv_y: float,
                                     g_inf: float = 0.0) -> float:
    return grad_norm_bound_nonconvex(prob, [inv_y] * J, g_inf)


# ----------------------------------------------------------- Theorem 5

def dynamic_iterations(J: int, eta: float, chi: float = 1.0) -> int:
    """Theorem 5: iterations needed by the exponential-worker schedule to
    match provisioning n0 workers for J iterations: ⌈log_{η^χ}(1+(η−1)J)⌉."""
    assert eta > 1
    return max(1, math.ceil(math.log(1 + (eta - 1) * J)
                            / math.log(eta ** max(chi, 1e-12))))


def error_bound_dynamic(prob: SGDProblem, Jp: int, n0: int, eta: float,
                        chi: float = 1.0, d: float = 1.0) -> float:
    """Eq. (27): bound after J' iterations with n_j = ⌈n0 η^{j−1}⌉ workers and
    E[1/y_j] ≤ d/n_j^χ."""
    beta = prob.beta
    x = 1.0 / (eta ** chi * beta)
    total = 0.0
    for j in range(1, Jp + 1):
        total += beta ** (Jp - j) * d / (n0 * eta ** (j - 1)) ** chi
    return beta ** Jp * prob.G0 + prob.B * total


def asymptotic_floor_static(prob: SGDProblem, n0: int, chi: float = 1.0,
                            d: float = 1.0) -> float:
    """J→∞ limit of the static bound: B·d/((1−β)·n0^χ) — a positive constant
    (Theorem 5 discussion: the dynamic schedule drives this to 0)."""
    return prob.B * d / ((1 - prob.beta) * n0 ** chi)
