"""Dependency-free market/cost semantics shared by the legacy numpy loop
and the batched JAX engine.

These three pure helpers are the single source of truth for §IV/§V
semantics; they are array-library-agnostic (operators only), so
``SpotMarket``/``VolatileCluster`` call them with numpy inputs without
importing JAX, and ``repro.sim.engine`` (which re-exports them) traces
them with jnp inputs inside its scan — the two paths cannot drift apart.
"""
from __future__ import annotations

#: Bid semantics tolerance (§IV): active iff bid ≥ price − BID_EPS.
BID_EPS = 1e-12


def spot_active_mask(bids, price):
    """§IV bid semantics: a worker is active iff its bid covers the price."""
    return bids >= price - BID_EPS


def preemptible_active(u, q):
    """§V exogenous preemption: a provisioned worker with uniform draw ``u``
    stays up iff u ≥ q."""
    return u >= q


def iteration_cost(y, price, dur):
    """Cost of one iteration: y active workers pay the prevailing price (not
    the bid) for its duration."""
    return y * price * dur
