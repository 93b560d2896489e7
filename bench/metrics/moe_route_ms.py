"""Device milliseconds a tick of the MoE layers' routing: the device time
of the operations launched under the program's ``moe.route`` span (the
router, softmax, top-k, the (E, C) dispatch tables, the gather of the
held experts' slots and the combine), summed over the grid's cells, over
the window's ticks. The span covers the forward only: the backward of
what it launched is ``backward_ms``'s. A program without the span reads
nothing."""
from bench.harness.spans import device_ms_per_tick


def read(facts):
    return device_ms_per_tick(facts, "moe.route")
