"""Replayed-streaming price feed: the service's market interface.

A ``PriceFeed`` replays per-market price traces tick by tick behind a
*monotone* wall clock — consumers can only move forward, exactly like a
live market subscription. The service treats one feed tick as one
iteration opportunity (the engine's tick-indexed ``PRICE_TRACE_TICK``
regime), so the same rows the estimator observes are the rows the
execution engine replays, in the same order.

Feeds come from ``sim.spot_market.synthetic_history`` (``synthetic_feed``)
or on-disk traces via the shared ``sim.traces`` loader
(``feed_from_traces``). An optional per-market Bernoulli preemption
channel models §V's exogenous preemptions for the posterior estimator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.sim.spot_market import synthetic_history
from repro_torch.sim.traces import PriceTrace, load_trace


class FeedExhaustedError(RuntimeError):
    """The feed has no ticks left to stream."""


class FeedMonotonicityError(RuntimeError):
    """A consumer tried to move the feed clock backwards."""


@dataclasses.dataclass(frozen=True)
class FeedWindow:
    """One consumed window of the stream: ticks ``[k0, k1)``."""

    k0: int
    k1: int
    times: np.ndarray              # (k1-k0,) wall-clock stamps
    prices: np.ndarray             # (k1-k0, M)
    preempted: np.ndarray          # (k1-k0, M) bool

    def __len__(self) -> int:
        return self.k1 - self.k0


class PriceFeed:
    """Multi-market replayed price stream with a forward-only cursor.

    ``prices`` is the full (T, M) tick × market matrix; ``next_window``
    hands out consecutive slices and advances the clock. ``market_prices``
    exposes a full column for building replay scenarios — the engine only
    ever indexes rows inside the executed window, so this is replay
    plumbing, not foresight.
    """

    def __init__(self, prices: np.ndarray, step: float = 1.0,
                 names: Optional[Sequence[str]] = None,
                 preempted: Optional[np.ndarray] = None):
        prices = np.atleast_2d(np.asarray(prices, float))
        if prices.ndim != 2 or prices.shape[0] < 1:
            raise ValueError(f"prices must be (T, M), got {prices.shape}")
        if not np.all(np.isfinite(prices)):
            raise ValueError("feed prices must be finite")
        self._prices = prices
        self.step = float(step)
        self.names = (list(names) if names is not None else
                      [f"market{m}" for m in range(prices.shape[1])])
        if len(self.names) != prices.shape[1]:
            raise ValueError(f"{len(self.names)} names for "
                             f"{prices.shape[1]} markets")
        if preempted is None:
            preempted = np.zeros(prices.shape, bool)
        preempted = np.asarray(preempted, bool)
        if preempted.shape != prices.shape:
            raise ValueError(
                f"preemption channel shape {preempted.shape} != price "
                f"shape {prices.shape}")
        self._preempted = preempted
        self._cursor = 0

    # -- introspection -----------------------------------------------------

    @property
    def n_ticks(self) -> int:
        return self._prices.shape[0]

    @property
    def n_markets(self) -> int:
        return self._prices.shape[1]

    @property
    def cursor(self) -> int:
        return self._cursor

    @property
    def clock(self) -> float:
        """Monotone wall clock: never decreases over a feed's lifetime."""
        return self._cursor * self.step

    @property
    def remaining(self) -> int:
        return self.n_ticks - self._cursor

    def market_prices(self, m: int) -> np.ndarray:
        """Full (T,) price column for market ``m`` (replay plumbing)."""
        return self._prices[:, m].copy()

    # -- streaming ---------------------------------------------------------

    def next_window(self, n: int) -> FeedWindow:
        """Consume the next ``min(n, remaining)`` ticks, advancing the
        clock. Raises ``FeedExhaustedError`` once the trace is spent."""
        if n <= 0:
            raise ValueError(f"window size must be positive, got {n}")
        if self.remaining == 0:
            raise FeedExhaustedError(
                f"feed exhausted after {self.n_ticks} ticks")
        k0, k1 = self._cursor, min(self._cursor + int(n), self.n_ticks)
        self._cursor = k1
        return FeedWindow(
            k0=k0, k1=k1,
            times=self.step * np.arange(k0, k1, dtype=float),
            prices=self._prices[k0:k1], preempted=self._preempted[k0:k1])

    def seek(self, k: int) -> None:
        """Skip forward to tick ``k``. Rewinding is a contract violation:
        a live market cannot replay the past."""
        if k < self._cursor:
            raise FeedMonotonicityError(
                f"cannot rewind the feed clock from tick {self._cursor} "
                f"to {k}")
        self._cursor = min(int(k), self.n_ticks)

    def replay(self) -> "PriceFeed":
        """A fresh feed over the same data with the cursor reset — each
        instance's own clock stays monotone."""
        return PriceFeed(self._prices, step=self.step, names=self.names,
                         preempted=self._preempted)


# --------------------------------------------------------------------------
# Constructors
# --------------------------------------------------------------------------


def synthetic_feed(n_markets: int = 1, n_ticks: int = 2048,
                   step: float = 1.0, seed: int = 0,
                   bands: Optional[Sequence] = None,
                   q: Optional[Sequence[float]] = None) -> PriceFeed:
    """Per-market ``synthetic_history`` traces on a shared tick grid.

    ``bands[m] = (lo, hi)`` sets market m's price range (default: the
    c5.xlarge-like defaults, jittered per market so markets differ).
    ``q[m]`` adds a Bernoulli(q) exogenous-preemption channel.
    """
    if bands is None:
        bands = [(0.068 * (1 + 0.1 * m), 0.20 * (1 + 0.05 * m))
                 for m in range(n_markets)]
    if len(bands) != n_markets:
        raise ValueError(f"{len(bands)} bands for {n_markets} markets")
    cols = []
    for m, (lo, hi) in enumerate(bands):
        tr = synthetic_history(hours=n_ticks * 5.0 / 60.0, step_minutes=5.0,
                               lo=float(lo), hi=float(hi),
                               seed=seed * 1000 + m)
        cols.append(tr[:n_ticks])
    prices = np.stack(cols, axis=1)
    preempted = None
    if q is not None:
        if len(q) != n_markets:
            raise ValueError(f"{len(q)} preemption rates for {n_markets} "
                             "markets")
        rng = np.random.default_rng(seed * 7919 + 17)
        preempted = rng.uniform(size=prices.shape) < np.asarray(q, float)
    return PriceFeed(prices, step=step, preempted=preempted)


def feed_from_traces(traces: Sequence, step: float = 1.0,
                     n_ticks: Optional[int] = None,
                     names: Optional[Sequence[str]] = None) -> PriceFeed:
    """Build a feed from on-disk trace paths and/or ``PriceTrace`` objects,
    resampled onto the shared ``step`` tick grid (heterogeneous trace
    resolutions are fine — ``PriceTrace.resample`` normalizes them)."""
    loaded = [t if isinstance(t, PriceTrace) else load_trace(t, step=step)
              for t in traces]
    if n_ticks is None:
        n_ticks = min(int(np.ceil(t.period / step)) for t in loaded)
    cols = [t.resample(step, int(n_ticks)) for t in loaded]
    return PriceFeed(np.stack(cols, axis=1), step=step, names=names)
