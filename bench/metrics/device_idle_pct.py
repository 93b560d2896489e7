"""The share of the window in which no operation ran on the device (%):
100 · (1 − busy / window), busy being the union of the device's kernels,
copies and fills in the profiler's trace."""


def read(facts):
    if not facts.get("busy_s") or not facts.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - facts["busy_s"] / facts["trace_window_s"])
