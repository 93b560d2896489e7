#!/usr/bin/env python3
"""The readings that the correctness check's limits are set from, for one
cell, on the card at the cell's own size:

* the program's compared numbers on each ``--seeds`` seed (its set-up's
  checked iterations against the reference; no measured window);
* the control: the reference at the precision below the one the traffic
  states (the cell's ``control``: TF32 for float32, fp8 for bfloat16),
  put in the program's place;
* the faults, planted in the reference put in the program's place: half of
  the counted rows left out with the mean over the rest (``half_batch``),
  one input token of a counted row altered (``token``), and the answer a
  step produces, its loss, altered by one part in a hundred where it is
  produced (``answer``). A step that leaves its state unchanged reads 1 on
  ``change`` by the measure and needs no run.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--controls 3] [--out readings.jsonl]

Each reading is a JSON line on standard output (and in ``--out``)."""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FAULTS = ("half_batch", "token")
#: the ``answer`` fault: every checked loss off by one part in a hundred
ANSWER = 1.01


def readings(cell, seed: int, device, controls: bool):
    import torch

    from bench.harness import check, program, training

    conf, t = cell.config, cell.traffic
    checked = int(t["checked_iterations"])
    prog = program.Program(cell, seed, device)
    leaves = cell.reference.leaves(conf)
    t0 = time.perf_counter()
    state, srec = training.setup(prog, leaves, seed, checked, t)
    setup_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    ys = state.y_traj.reshape(len(srec.ends[-1][1]), -1).cpu().numpy()
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref_js, iters = check.frozen_market(t, prog.seeds, srec.ticks)
    gap = check.market_gap(srec.ends, ys.astype("float64"), ref_js, iters)

    def ref(**kw):
        return check.reference_run(cell.reference, conf, t, seed, iters,
                                   prog.batch_fn, device, checked, **kw)

    t0 = time.perf_counter()
    base = ref()
    ref_s = time.perf_counter() - t0
    out = [{"kind": "program", "seed": seed, "setup_ticks": srec.ticks,
            "setup_calls": len(srec.ends), "setup_s": setup_s,
            "reference_s": ref_s, "peak_bytes": peak,
            "losses": [x.tolist() for x in srec.losses],
            **check.numbers(gap, srec.losses, srec.grad_norms,
                            srec.change_norms, base, checked)}]

    def as_program(runs):
        return check.numbers(
            0, [r["losses"] for r in runs], [r["grad_norms"] for r in runs],
            [r["change_norms"] for r in runs], base, checked)

    if controls:
        out.append({"kind": "control", "seed": seed,
                    "precision": cell.control,
                    **as_program(ref(precision=cell.control))})
        for fault in FAULTS:
            out.append({"kind": "fault", "fault": fault, "seed": seed,
                        **as_program(ref(fault=fault))})
        altered = [dict(r, losses=r["losses"] * ANSWER) for r in base]
        out.append({"kind": "fault", "fault": "answer", "seed": seed,
                    **as_program(altered)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3,
                    help="run the control and the faults on the first N "
                         "seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from bench.harness import spec

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    dev = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        for rec in readings(cell, seed, dev, i < args.controls):
            rec["workload"] = args.workload
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
