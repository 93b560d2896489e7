"""Device milliseconds a tick of landing the per-cell steps in the carry:
the device time of the operations launched under the program's
``engine.gate`` span (`sim.engine._gate_model`, once a cell and tick),
summed over the grid's cells, over the window's ticks. The megabatch
program gates inside K1 and has no such span."""
from bench.harness.spans import device_ms_per_tick


def read(facts):
    return device_ms_per_tick(facts, "engine.gate")
