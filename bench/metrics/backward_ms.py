"""Device milliseconds a tick of the model step's backward: the device
time of the operations launched while the program's ``step.backward``
span was open (autograd's worker thread included), summed over the grid's
cells, over the window's ticks."""
from bench.harness.spans import device_ms_per_tick


def read(facts):
    return device_ms_per_tick(facts, "step.backward")
