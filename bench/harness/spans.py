"""The window's device time split by the program's spans.

The program marks its layers with host spans (``repro_torch.spans``):
plain function ranges on the host, on the profiler's clock, with no twin
on the device. Each device operation of the window is charged to the
innermost span that was open on the host, on any thread, when the
operation was launched.

This reads only the trace as `harness.trace.collect` keeps it: host and
device intervals, each (name, start, end). Those do not say which host
call launched which device operation, so the launches are found by order.
The port issues all its work to one stream, which runs its operations in
the order they were launched. So the k-th kernel on the device is the one
the k-th kernel-launch call on the host (``cudaLaunchKernel``,
``cuLaunchKernel``, ...) launched, the k-th copy the k-th copy call, the
k-th fill the k-th fill call. Where a class's counts differ, an
operation is paired with the next unpaired call that started before it
did, and one with no such call is charged to no span."""
from __future__ import annotations

import bisect
import heapq
import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from bench.harness.trace import Interval, busy_us

TICK, READBACK = "engine.tick", "engine.readback"


def program_spans() -> Tuple[str, ...]:
    """The span names the program documents; none for a program without
    them."""
    try:
        from repro_torch.spans import NAMES
    except ImportError:
        return ()
    return tuple(NAMES)


def device_class(name: str) -> str:
    """``copy``, ``fill`` or ``kernel``: a device operation by its name."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "fill"
    return "kernel"


def launch_class(name: str) -> Optional[str]:
    """The class of device operation a host call into CUDA (``cuda…`` or
    ``cu…``) launches, or None for a call that launches none."""
    if not name.startswith("cu"):
        return None
    if "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
        return "kernel"
    if "Memcpy" in name:
        return "copy"
    if "Memset" in name:
        return "fill"
    return None


def pair(dev: List[Interval], host: List[Interval]) -> List[Optional[float]]:
    """For each device operation of ``dev``, the start of the host call
    that launched it (None where none is found)."""
    launches: Dict[str, List[float]] = defaultdict(list)
    for name, a, _ in host:
        k = launch_class(name)
        if k is not None:
            launches[k].append(a)
    ops: Dict[str, List[int]] = defaultdict(list)
    for i in sorted(range(len(dev)), key=lambda i: dev[i][1]):
        ops[device_class(dev[i][0])].append(i)
    out: List[Optional[float]] = [None] * len(dev)
    for k, idx in ops.items():
        calls = sorted(launches.get(k, ()))
        if len(calls) == len(idx):
            for i, t in zip(idx, calls):
                out[i] = t
            continue
        j = 0
        for i in idx:
            if j < len(calls) and calls[j] <= dev[i][1]:
                out[i] = calls[j]
                j += 1
    return out


def _innermost(spans: List[Interval]) -> Tuple[List[float], List[int]]:
    """(times, owners): over [times[i], times[i+1]) the innermost of
    ``spans`` open on the host is ``spans[owners[i]]`` (-1: none), the
    innermost being the one opened last."""
    times = sorted({t for _, a, b in spans for t in (a, b)})
    opening: Dict[float, List[int]] = defaultdict(list)
    for i, (_, a, _) in enumerate(spans):
        opening[a].append(i)
    heap: List[Tuple[float, int]] = []
    owners = []
    for t in times:
        for i in opening[t]:
            heapq.heappush(heap, (-spans[i][1], i))
        while heap and spans[heap[0][1]][2] <= t:
            heapq.heappop(heap)
        owners.append(heap[0][1] if heap else -1)
    return times, owners


def split(trace: Dict, names) -> Optional[Dict]:
    """The device time of ``trace``'s window split by the spans called
    ``names``; None where the trace holds none of them.

    Returns ``by_name`` ({name: {count, host_s, device_s}}, the spans that
    open in the window), ``unattributed_s`` (device seconds charged to no
    span), ``unpaired`` (device operations whose launch was not found)
    and ``call_idle_s``: for each boundary between two engine calls, the
    device's idle seconds from the end of the last operation launched
    under one call's ``engine.tick`` spans to the start of the first
    launched under the next call's (calls are told apart by the
    ``engine.readback`` between their ticks)."""
    names = tuple(names)
    if not trace or not trace.get("window") or not names:
        return None
    _, lo, hi = trace["window"]
    spans = sorted((iv for iv in trace["host"] if iv[0] in names),
                   key=lambda iv: (iv[1], -iv[2]))
    if not spans:
        return None
    times, owners = _innermost(spans)

    def owner_at(t: float) -> int:
        k = bisect.bisect_right(times, t) - 1
        return owners[k] if k >= 0 else -1

    by_name = {n: {"count": 0, "host_s": 0.0, "device_s": 0.0}
               for n in names}
    for n, a, b in spans:
        if lo <= a <= hi:
            by_name[n]["count"] += 1
            by_name[n]["host_s"] += (b - a) / 1e6

    ticks = [iv for iv in spans if iv[0] == TICK and lo <= iv[1] <= hi]
    reads = sorted(a for n, a, _ in spans if n == READBACK)
    call_of, call = [], 0
    for k, (_, a, _) in enumerate(ticks):
        if k and bisect.bisect_left(reads, ticks[k - 1][2]) < \
                bisect.bisect_left(reads, a):
            call += 1
        call_of.append(call)
    tick_starts = [a for _, a, _ in ticks]
    first = [math.inf] * (call + 1)
    last = [-math.inf] * (call + 1)

    dev = trace["device"]
    launched = pair(dev, trace["host"])
    unattributed, unpaired = 0.0, 0
    for (_, a, b), t in zip(dev, launched):
        if b <= lo or a >= hi:
            continue
        took = (min(b, hi) - max(a, lo)) / 1e6
        own = -1 if t is None else owner_at(t)
        if own < 0:
            unattributed += took
            unpaired += t is None
            continue
        by_name[spans[own][0]]["device_s"] += took
        k = bisect.bisect_right(tick_starts, t) - 1
        if k >= 0 and t <= ticks[k][2]:
            c = call_of[k]
            first[c] = min(first[c], a)
            last[c] = max(last[c], b)

    idle = []
    for c in range(call):
        a, b = last[c], first[c + 1]
        if a < b < math.inf:
            idle.append(((b - a) - busy_us(dev, a, b)) / 1e6)
    return {"by_name": by_name, "unattributed_s": unattributed,
            "unpaired": unpaired, "call_idle_s": idle}


_CACHE: List[Tuple[Dict, Optional[Dict]]] = []


def of(facts) -> Optional[Dict]:
    """`split` of a traced run's facts by the program's spans, reduced
    once for all the readers of one run."""
    trace = facts.get("trace")
    if not trace:
        return None
    if not _CACHE or _CACHE[0][0] is not trace:
        _CACHE[:] = [(trace, split(trace, program_spans()))]
    return _CACHE[0][1]


def device_ms_per_tick(facts, name: str) -> Optional[float]:
    """Device milliseconds a tick of the window charged to span ``name``,
    or None where the program has no such span."""
    s = of(facts)
    rec = s and s["by_name"].get(name)
    if not rec or not rec["count"] or not facts.get("ticks"):
        return None
    return 1e3 * rec["device_s"] / facts["ticks"]
