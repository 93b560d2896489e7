#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one cell, one run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the card(s) the cell
asks for. The cell's traffic names its entry (``bench/entries/``), which
builds the program and its weights from ``--seed``, drives it through
set-up (which also builds and warms every kernel), measures it for
``--seconds``, and holds what it produced against the plain reference
(for a training grid, `harness.training`). The last line of
standard output is the result's JSON; the numbers compared, each beside
its limit, are the last lines of standard error. ``--trace 1`` runs the
window under ``torch.profiler`` and reports the per-layer metrics instead
of the end-to-end ones."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level module names that may not be loaded when the window closes
BANNED = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def banned_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def card_line():
    """(name, power limit) as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


class Window:
    """The measured window's span: under ``--trace 1`` on a card the
    profiler, whose trace `facts` reduces once the window is closed."""

    def __init__(self, trace: bool, on_card: bool):
        self.trace, self.on_card, self.prof = trace, on_card, None

    @contextlib.contextmanager
    def __call__(self):
        if not self.trace:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        from bench.harness import trace as tr
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if self.on_card else [])
        with profile(activities=acts) as self.prof:
            with record_function(tr.WINDOW_SPAN):
                yield

    def facts(self):
        """busy_s, trace_window_s, kernels, trace and the breakdown of a
        traced run on a card; {} otherwise."""
        if self.prof is None or not self.on_card:
            return {}
        from bench.harness import trace as tr
        ev = tr.collect(self.prof)
        self.prof = None
        lo, hi = ev["window"][1], ev["window"][2]
        return {"trace": ev, "trace_window_s": (hi - lo) / 1e6,
                "busy_s": tr.busy_us(ev["device"], lo, hi) / 1e6,
                "kernels": tr.kernel_stats(ev["device"], lo, hi),
                "breakdown": {
                    "device_ops": tr.top_ops(ev["device"], lo, hi),
                    "idle_gaps": tr.idle_gaps(ev["device"], ev["host"], lo,
                                              hi)}}


def run(cell, seed: int, seconds: float, trace: bool, device):
    """One run of ``cell`` on ``device``: (result, lines for standard
    error). The traffic's entry drives the program; each metric is read
    from the run's facts by its own reader, the end-to-end ones with
    ``--trace 0`` and the per-layer ones with ``--trace 1``."""
    import torch

    from bench import peaks
    from bench.harness import check, spec

    on_card = torch.device(device).type == "cuda"
    span = Window(trace, on_card)
    out = cell.entry.measure(cell, seed, seconds, span, device, T0)
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell.chips,
                   "memory_peak_bytes": out.memory_peak_bytes}
    if on_card:
        device_info["power_limit"] = card_line()
    facts = {**out.facts, **span.facts(), "conf": cell.config,
             "traffic": cell.traffic, "reference": cell.reference,
             "peaks": peaks.card_peaks(kind)}
    if "busy_s" in facts:
        device_info["busy_s"] = facts["busy_s"]
        device_info["window_s"] = facts["trace_window_s"]
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.metric_reader(m["name"]).read(facts)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check_line = {k: {"value": out.numbers[k], "limit": cell.limits[k]}
                  for k in check.NAMES}
    result = {"correct": bool(out.correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "device": device_info}
    if "breakdown" in facts:
        result["breakdown"] = facts["breakdown"]
    result["check"] = check_line
    lines = out.lines + [f"{k}: {v['value']!r} (limit {v['limit']!r})"
                         for k, v in check_line.items()]
    return result, lines


def main(argv=None) -> int:
    args = parse(argv)
    from bench.harness import spec

    cell = spec.cell(args.workload)
    import repro_torch  # noqa: F401  (the program under test, beside us)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"visible: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0))
    found = banned_modules()
    if found:
        print("modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
