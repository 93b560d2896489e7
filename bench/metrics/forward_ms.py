"""Device milliseconds a tick of the model step's forward and loss: the
device time of the operations launched under the program's
``step.forward`` span, summed over the grid's cells, over the window's
ticks."""
from bench.harness.spans import device_ms_per_tick


def read(facts):
    return device_ms_per_tick(facts, "step.forward")
