"""K1's share of its roofline (%): the least time the card could take for
every launch of ``elastic_update_kernel`` in the window, over the device
time the trace gives those launches.

One launch updates in place the rows of the grid's replicas whose tick
runs (a row that does not run returns at once): for each, of P float32
parameters, it reads p, v and g and writes p and v, 20·P bytes, and does
5·P operations (μ·v, g·inv, the sum, lr·v', the difference). Over the
window that is R·P for the R = running cell-steps, the iterations the
window advanced. Its least time is the larger of bytes over the HBM rate
and operations over the float32 rate; bytes bound it on an H100. P is the
configuration's parameter count, the sum of its reference's leaves."""
import math

KERNEL = "elastic_update_kernel"


def param_count(leaves) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaves)


def bound_s(replicas: int, params: int, peaks) -> float:
    return max(20.0 * replicas * params / peaks.hbm_bytes_per_s,
               5.0 * replicas * params / peaks.float32)


def read(facts):
    peaks = facts.get("peaks")
    rows = [v for k, v in (facts.get("kernels") or {}).items() if KERNEL in k]
    if peaks is None or not rows or not facts.get("running_steps"):
        return None
    dev_s = sum(s for _, s in rows)
    least = bound_s(facts["running_steps"], param_count(facts["leaves"]),
                    peaks)
    return 100.0 * least / dev_s
