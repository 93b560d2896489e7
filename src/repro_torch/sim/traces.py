"""Canonical price-trace representation, parsing, and on-disk loading.

One ``PriceTrace`` backs every trace consumer in the repo:

- ``sim.spot_market.TracePrices`` — the legacy wall-clock replay loop,
- ``sim.engine.PriceSpec.from_trace`` — batched time-indexed replay,
- ``service.stream.PriceFeed`` — the rolling-horizon bidding service.

Validation (timestamps ascending strictly from 0, wrap period past the last
entry) lives here once instead of being re-implemented per consumer. Values
keep their input dtype (float64 by default) so the legacy NumPy paths lose no
precision; the engine casts to f32 itself when it builds a ``PriceSpec``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np


class TraceFormatError(ValueError):
    """A trace file or array violates the trace contract (bad shape,
    non-ascending timestamps, non-finite prices, unknown file format)."""


@dataclasses.dataclass(frozen=True)
class PriceTrace:
    """An immutable price trace: ``values[i]`` prevails from ``times[i]``
    until the next timestamp, wrapping modulo ``period``.

    ``times`` ascend strictly from 0 and ``period > times[-1]`` — the same
    contract ``PriceSpec.from_trace`` enforced inline before this module
    existed. Uniform traces (constant ``step`` spacing) keep the legacy
    ``TracePrices`` lookup ``int(t/step) % len`` bit-for-bit.
    """

    values: np.ndarray             # (L,) prices, dtype preserved
    times: np.ndarray              # (L,) timestamps ascending from 0
    period: float                  # wrap length, > times[-1]
    step: Optional[float] = None   # uniform spacing, None if irregular

    def __post_init__(self):
        values = np.asarray(self.values)
        times = np.asarray(self.times, float)
        if values.ndim != 1 or len(values) == 0:
            raise TraceFormatError(
                f"trace values must be a non-empty 1-D array, got shape "
                f"{values.shape}")
        if not np.all(np.isfinite(values)):
            raise TraceFormatError("trace contains non-finite prices")
        if times.shape != values.shape:
            raise TraceFormatError(
                f"{len(times)} timestamps for {len(values)} trace entries")
        if times[0] != 0.0 or np.any(np.diff(times) <= 0):
            raise TraceFormatError(
                f"trace timestamps must ascend strictly from 0, got {times}")
        if self.period <= float(times[-1]):
            raise TraceFormatError(
                f"period {self.period} must exceed the last timestamp "
                f"{times[-1]}")
        object.__setattr__(self, "values", values)
        object.__setattr__(self, "times", times)

    # -- construction ------------------------------------------------------

    @classmethod
    def regular(cls, values: np.ndarray, step: float = 1.0,
                period: Optional[float] = None) -> "PriceTrace":
        """Uniformly spaced trace: entry i prevails on
        [i*step, (i+1)*step)."""
        values = np.asarray(values)
        times = float(step) * np.arange(len(values), dtype=float)
        if period is None:
            period = float(step) * len(values)
        return cls(values=values, times=times, period=float(period),
                   step=float(step))

    @classmethod
    def from_arrays(cls, values: np.ndarray,
                    times: Optional[np.ndarray] = None, step: float = 1.0,
                    period: Optional[float] = None) -> "PriceTrace":
        """The ``PriceSpec.from_trace`` defaulting rules: explicit ``times``
        win; otherwise timestamps are ``step * arange(L)`` and the period
        defaults to one step past the last entry (``L * step``), matching
        the legacy ``int(t/step) % len`` modulo. With explicit irregular
        times and no period, the last gap is extrapolated."""
        values = np.asarray(values)
        if times is None:
            return cls.regular(values, step=step, period=period)
        times = np.asarray(times, float)
        if period is None:
            if times.shape != np.shape(values):
                raise TraceFormatError(
                    f"{len(times)} timestamps for {len(values)} trace "
                    "entries")
            last_gap = times[-1] - times[-2] if len(times) > 1 else 1.0
            period = float(times[-1] + last_gap)
        return cls(values=values, times=times, period=float(period))

    # -- queries -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self.values)

    def index_at(self, t: float) -> int:
        """Index of the entry prevailing at wall clock ``t`` (wrapping)."""
        if self.step is not None:
            # legacy TracePrices arithmetic, kept bit-exact
            return int(t / self.step) % len(self.values)
        t_eff = float(t) % self.period
        return max(int(np.searchsorted(self.times, t_eff, side="right")) - 1,
                   0)

    def price_at(self, t: float) -> float:
        return float(self.values[self.index_at(t)])

    def resample(self, step: float, n: int) -> np.ndarray:
        """(n,) prices at the uniform grid ``step * arange(n)`` — how the
        streaming feed normalizes heterogeneous traces onto shared ticks."""
        return np.asarray([self.price_at(k * step) for k in range(n)],
                          float)

    def empirical(self):
        """The fitted F̂ a bidder would estimate from this history."""
        from repro_torch.core.cost_model import EmpiricalPrice
        return EmpiricalPrice(samples=np.asarray(self.values, float))

    @property
    def lo(self) -> float:
        return float(np.min(self.values))

    @property
    def hi(self) -> float:
        return float(np.max(self.values))


# --------------------------------------------------------------------------
# On-disk formats
# --------------------------------------------------------------------------

_PRICE_KEYS = ("prices", "values", "price")
_TIME_KEYS = ("times", "timestamps", "time")


def _from_mapping(arrays, step: float, period: Optional[float],
                  where: str) -> PriceTrace:
    values = next((arrays[k] for k in _PRICE_KEYS if k in arrays), None)
    if values is None:
        raise TraceFormatError(
            f"{where}: no price array under any of {_PRICE_KEYS} "
            f"(found {sorted(arrays)})")
    times = next((arrays[k] for k in _TIME_KEYS if k in arrays), None)
    step = float(arrays.get("step", step))
    if "period" in arrays:
        period = float(arrays["period"])
    return PriceTrace.from_arrays(np.asarray(values), times=times, step=step,
                                  period=period)


def load_trace(path: str, step: float = 1.0,
               period: Optional[float] = None) -> PriceTrace:
    """Load a price trace from disk. Formats by extension:

    - ``.npy``  — 1-D price array (uniform spacing ``step``).
    - ``.npz``  — arrays ``prices`` (required) and optionally ``times`` /
      ``step`` / ``period``.
    - ``.csv`` / ``.txt`` — one column (prices) or two (time, price);
      ``#`` comments and a non-numeric header row are skipped.
    - ``.json`` — a bare list of prices, or an object with the same keys
      as ``.npz``.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return PriceTrace.from_arrays(np.load(path), step=step, period=period)
    if ext == ".npz":
        with np.load(path) as z:
            return _from_mapping({k: z[k] for k in z.files}, step, period,
                                 path)
    if ext in (".csv", ".txt"):
        rows = []
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = [p for p in line.replace(",", " ").split() if p]
                try:
                    rows.append([float(p) for p in parts])
                except ValueError:
                    if rows:
                        raise TraceFormatError(
                            f"{path}: non-numeric row {line!r}")
                    continue                      # header row
        if not rows:
            raise TraceFormatError(f"{path}: no numeric rows")
        width = len(rows[0])
        if any(len(r) != width for r in rows) or width not in (1, 2):
            raise TraceFormatError(
                f"{path}: expected 1 (price) or 2 (time, price) uniform "
                "columns")
        arr = np.asarray(rows, float)
        if width == 1:
            return PriceTrace.from_arrays(arr[:, 0], step=step, period=period)
        return PriceTrace.from_arrays(arr[:, 1], times=arr[:, 0],
                                      period=period)
    if ext == ".json":
        with open(path) as fh:
            payload = json.load(fh)
        if isinstance(payload, list):
            return PriceTrace.from_arrays(np.asarray(payload, float),
                                          step=step, period=period)
        if isinstance(payload, dict):
            arrays = {k: np.asarray(v, float) if isinstance(v, list) else v
                      for k, v in payload.items()}
            return _from_mapping(arrays, step, period, path)
        raise TraceFormatError(
            f"{path}: JSON trace must be a list or an object")
    raise TraceFormatError(f"{path}: unknown trace format {ext!r} "
                           "(want .npy/.npz/.csv/.txt/.json)")


def save_trace(path: str, trace: PriceTrace) -> None:
    """Round-trippable save (``.npz`` or ``.json``) for feed tooling."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        np.savez(path, prices=trace.values, times=trace.times,
                 period=np.asarray(trace.period))
    elif ext == ".json":
        with open(path, "w") as fh:
            json.dump({"prices": np.asarray(trace.values, float).tolist(),
                       "times": trace.times.tolist(),
                       "period": trace.period}, fh)
    else:
        raise TraceFormatError(f"{path}: save_trace writes .npz or .json")


def load_traces(paths: Sequence[str], step: float = 1.0) -> list:
    return [load_trace(p, step=step) for p in paths]
