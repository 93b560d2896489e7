"""Device kernels launched per tick of the window (``ops``), from the
profiler's trace: every kernel that starts in the window, over the ticks
the window ran. Copies and fills are not kernels and are not counted."""


def read(facts):
    if not facts.get("kernels") or not facts.get("ticks"):
        return None
    return sum(n for n, _ in facts["kernels"].values()) / facts["ticks"]
