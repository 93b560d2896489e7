"""Spot-market simulation: price processes and the bid→active-set mechanism.

The container has no cloud access, so the market is simulated: i.i.d. draws
from the paper's synthetic distributions (uniform / truncated Gaussian), plus
a regime-switching + mean-reverting synthetic "historical" trace that mimics
the non-i.i.d. character of real c5.xlarge spot-price history (the paper's
robustness experiment).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.cost_model import EmpiricalPrice, PriceDist
from repro_torch.sim.market_core import spot_active_mask
from repro_torch.sim.traces import PriceTrace


class PriceProcess:
    """Yields the prevailing spot price at each query."""

    def price(self, t: float) -> float:
        raise NotImplementedError


@dataclasses.dataclass
class IIDPrices(PriceProcess):
    """Fresh i.i.d. draw per iteration (the paper's analytical model; prices
    are re-drawn every `redraw` time units while a job waits interrupted)."""

    dist: PriceDist
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def price(self, t: float) -> float:
        return float(self.dist.sample(self._rng))


def synthetic_history(hours: float = 24 * 30, step_minutes: float = 5.0,
                      lo: float = 0.068, hi: float = 0.20, seed: int = 0
                      ) -> np.ndarray:
    """Regime-switching Ornstein–Uhlenbeck price trace (c5.xlarge-like:
    on-demand $0.17/h, spot floor ~$0.068/h). Non-i.i.d. by construction."""
    rng = np.random.default_rng(seed)
    n = int(hours * 60 / step_minutes)
    base = lo * 1.3
    prices = np.empty(n)
    p = base
    regime = 0.0
    for i in range(n):
        if rng.uniform() < 0.003:          # demand spike regime flips
            regime = rng.uniform(0.0, hi - base) if regime == 0 else 0.0
        target = base + regime
        p += 0.15 * (target - p) + rng.normal(0, 0.004)
        p = min(max(p, lo), hi)
        prices[i] = p
    return prices


@dataclasses.dataclass
class TracePrices(PriceProcess):
    """Replay of a (synthetic or downloaded) historical trace, indexed by
    *wall-clock time* at resolution ``step`` (wrapping). The batched-engine
    counterpart is ``PriceSpec.from_trace(trace, step=step)``, which
    replays identically — including under stochastic iteration durations
    (tests/test_engine_parity.py pins the fig4 exp-runtime parity)."""

    trace: np.ndarray
    step: float = 1.0              # trace resolution in time units

    def __post_init__(self):
        # one shared representation (validation + lookup) for every trace
        # consumer — see sim.traces
        self._trace = PriceTrace.regular(np.asarray(self.trace),
                                         step=self.step)

    def price(self, t: float) -> float:
        return self._trace.price_at(t)

    def empirical_dist(self) -> EmpiricalPrice:
        """The F̂ the bidding optimizer sees (fit on history, as a user
        would)."""
        return self._trace.empirical()


@dataclasses.dataclass
class TickPrices(PriceProcess):
    """Call-counting replay: the k-th price *query* returns trace[k % len],
    regardless of the query time. This matches the engine's legacy
    tick-indexed mode (``PriceSpec.from_trace_ticks`` / PRICE_TRACE_TICK —
    one draw per tick), so feeding the same trace to a TickPrices market
    and a from_trace_ticks scenario yields tick-exact parity between the
    legacy loop and `repro.sim.engine.simulate`."""

    trace: np.ndarray

    def __post_init__(self):
        self._k = 0

    def price(self, t: float) -> float:
        p = float(self.trace[self._k % len(self.trace)])
        self._k += 1
        return p


@dataclasses.dataclass
class SpotMarket:
    """Bid semantics (§IV): a worker is active iff its bid ≥ the prevailing
    price; active workers pay the *price* (not the bid) per unit time.
    The mask logic is shared with the batched engine (`spot_active_mask`)."""

    process: PriceProcess

    def step(self, t: float, bids: np.ndarray):
        price = self.process.price(t)
        active = spot_active_mask(np.asarray(bids, float), price)
        return price, active.astype(np.float32)
