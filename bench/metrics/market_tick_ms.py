"""Device milliseconds a tick of the market and its accounting: the device
time of the operations launched under the program's ``engine.market``
span (`sim.engine._market_tick`, over the whole grid), over the window's
ticks."""
from bench.harness.spans import device_ms_per_tick


def read(facts):
    return device_ms_per_tick(facts, "engine.market")
