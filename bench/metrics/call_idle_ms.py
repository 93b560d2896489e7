"""The device's idle at a boundary between two calls of the trainer's
entry (ms): from the end of the last operation launched under one call's
``engine.tick`` spans to the start of the first launched under the
next's, less the device time in between, averaged over the window's
boundaries (`harness.spans.split`)."""
from bench.harness import spans


def read(facts):
    idle = (spans.of(facts) or {}).get("call_idle_s")
    return 1e3 * sum(idle) / len(idle) if idle else None
