"""Device milliseconds a tick of MLA's attention core: the device time of
the operations launched under the program's ``mla.core`` span (the
latent's expansion to per-head keys and values, and the float32 scores,
softmax and values), summed over the grid's cells, over the window's
ticks. The span covers the forward only: the backward of what it launched
is ``backward_ms``'s. A program without the span reads nothing."""
from bench.harness.spans import device_ms_per_tick


def read(facts):
    return device_ms_per_tick(facts, "mla.core")
