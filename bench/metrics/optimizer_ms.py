"""Device milliseconds a tick of the update: the device time of the
operations launched under the program's ``step.optimizer`` span (K1 or
the plain update; the zoo's casts, SGD and the refresh of its bf16
parameters), summed over the grid's cells, over the window's ticks."""
from bench.harness.spans import device_ms_per_tick


def read(facts):
    return device_ms_per_tick(facts, "step.optimizer")
