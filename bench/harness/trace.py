"""The profiler's trace of the window, reduced.

`collect` takes from a ``torch.profiler`` run the device's operations
(kernels, copies and fills) and the host's operations, each as (name,
start, end) in microseconds on the profiler's clock, and the window's own
span (``bench.window``) from the same clock. The rest is arithmetic on
those intervals: the busy union, the top device operations, and the
longest idle gaps, each named by the innermost host operation under it."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

Interval = Tuple[str, float, float]
WINDOW_SPAN = "bench.window"


def collect(prof) -> Dict:
    from torch.autograd import DeviceType

    dev: List[Interval] = []
    host: List[Interval] = []
    win = None
    for e in prof.events():
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == WINDOW_SPAN:
            # the span shows on the device's timeline too, as an annotation
            if e.device_type == DeviceType.CPU:
                win = iv
        elif e.device_type == DeviceType.CPU:
            host.append(iv)
        else:
            dev.append(iv)
    return {"device": dev, "host": host, "window": win}


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def clip(ivs: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(n, max(a, lo), min(b, hi)) for n, a, b in ivs
            if b > lo and a < hi]


def union(ivs: List[Interval]) -> List[Tuple[float, float]]:
    spans = sorted((a, b) for _, a, b in ivs if b > a)
    out: List[List[float]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(dev: List[Interval], lo: float, hi: float) -> float:
    return sum(b - a for a, b in union(clip(dev, lo, hi)))


def top_ops(dev: List[Interval], lo: float, hi: float, n: int = 10
            ) -> List[list]:
    """[[name, seconds], ...] of the device operations that took the most
    time in [lo, hi], summed by name."""
    tot: Dict[str, float] = defaultdict(float)
    for name, a, b in clip(dev, lo, hi):
        tot[name] += b - a
    return [[k, v / 1e6] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev: List[Interval], host: List[Interval], lo: float,
              hi: float, n: int = 10) -> List[list]:
    """[[host operation, seconds], ...] of the ``n`` longest stretches of
    [lo, hi] in which no device operation ran, each named by the innermost
    host operation that spans its middle ("no host op" where none does)."""
    gaps, t = [], lo
    for a, b in union(clip(dev, lo, hi)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        under = [(e - s, name) for name, s, e in host if s <= mid <= e]
        out.append([min(under)[1] if under else "no host op",
                    (b - a) / 1e6])
    return out


def kernel_stats(dev: List[Interval], lo: float, hi: float
                 ) -> Dict[str, List[float]]:
    """{kernel name: [launches, device seconds]} of the kernels whose
    launch starts in [lo, hi]."""
    out: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, a, b in dev:
        if lo <= a <= hi and is_kernel(name):
            out[name][0] += 1
            out[name][1] += (b - a) / 1e6
    return dict(out)
