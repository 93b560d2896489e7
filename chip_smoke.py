#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each printing one JSON line and raising on failure:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every kernel of the main path from ``src/repro_torch/csrc`` (nvcc,
   sm_90a);
2. each kernel against its plain PyTorch version on the card, bit for bit,
   on edge-case rows at a ragged width;
3. the main path through the launcher's own entry points: elastic
   megabatch training of full-width Qwen2-7B at depth 2 in float32, a
   grid of one strategy × 2 seeds (R = 2), the fused update through the
   kernel. Checks that every loss is finite, that the first loss lies near
   ln V, and that the kernel ran once per tick; reports time per tick,
   tokens per second, a steady-state step time and peak memory;
4. the kernel at the main path's own shape: bit-exact against its plain
   version, its time beside its bound, the plain version's time and a
   device-to-device copy rate.

Then the ``{"kernels": [...]}`` line and, last, the contract line
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits non-zero and prints no result. It imports neither ``jax`` nor
the reference package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

MAIN_ARGV = ["--config", "qwen2_7b", "--reduce-depth", "2",
             "--param-dtype", "float32", "--batched", "--megabatch",
             "--fused-update", "--seeds", "2", "--iterations", "3",
             "--device", "cuda"]

#: peak rates by card (NVIDIA data sheets; dense, no sparsity): HBM bytes/s
#: and float32 FLOP/s outside the tensor cores
PEAKS = [("H200", 4.8e12, 67e12, "H200 SXM"),
         ("NVL", 3.9e12, 60e12, "H100 NVL"),
         ("PCIe", 2.0e12, 51e12, "H100 PCIe"),
         ("H100", 3.35e12, 67e12, "H100 SXM")]

KERNEL_SOURCES = {"elastic_sgd_update": (
    "src/repro_torch/csrc/elastic_update.cu",
    "src/repro/kernels/elastic_update.py:56")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key, hbm, f32, label in PEAKS:
        if key in name:
            return hbm, f32, label
    return PEAKS[-1][1], PEAKS[-1][2], "H100 SXM (card not recognised)"


def timed(fn, n: int, torch):
    """Mean device milliseconds of ``fn()`` over ``n`` calls after one
    warm-up call, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_card_and_build():
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    records = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"path": os.path.relpath(r.path, ROOT),
                          "nvcc_s": r.seconds,
                          "ptxas": [ln.strip() for ln in r.ptxas.splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for n, r in records.items()}})
    return smi


def edge_inputs(torch, r, p, seed=0):
    """Rows covering Σw = 0, 0 < Σw < 1e-6, fractional Σw, a replica that
    is not running, and a learning rate per replica."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    params = torch.randn(r, p, generator=g, device=dev)
    mom = torch.randn(r, p, generator=g, device=dev)
    grads = torch.randn(r, p, generator=g, device=dev) * 3
    w = torch.rand(r, generator=g, device=dev) * 40 + 0.5
    w[:4] = torch.tensor([0.0, 1e-8, 0.375, 2.5e-7], device=dev)
    running = torch.ones(r, dtype=torch.bool, device=dev)
    running[4] = False
    lr = torch.rand(r, generator=g, device=dev) * 0.2 + 0.01
    return params, mom, grads, w, running, lr


def phase_small_compare(torch):
    from repro_torch.kernels import ops, ref

    worst = 0.0
    for r, p in [(8, 3 * 2 ** 20 + 37), (6, 1), (7, 255)]:
        for mu in (0.9, 0.0):
            args = edge_inputs(torch, r, p)
            want = ref.elastic_update_reference(*args, momentum=mu)
            ops.fused_elastic_update(*args, momentum=mu)
            torch.cuda.synchronize()
            err = max((args[0] - want[0]).abs().max().item(),
                      (args[1] - want[1]).abs().max().item())
            if not (torch.equal(args[0], want[0])
                    and torch.equal(args[1], want[1])):
                raise AssertionError(
                    f"elastic_sgd_update differs from its plain version at "
                    f"(R={r}, P={p}, momentum={mu}): max |err| {err}")
            worst = max(worst, err)
    emit({"phase": "kernel_vs_plain_small", "kernel": "elastic_sgd_update",
          "bit_exact": True, "max_abs_err": worst})


def phase_main_path(torch):
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.train.trainer import default_n_ticks

    args = launch.parse_args(MAIN_ARGV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, summary = launch.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    r = res.result
    n_ticks = default_n_ticks(int(r.J.max()))
    ran = r.iterations                                   # (S, R)
    losses = [r.errors[s, k, :ran[s, k]] for s in range(ran.shape[0])
              for k in range(ran.shape[1])]
    flat = [x for row in losses for x in row]
    if not flat or not all(math.isfinite(x) for x in flat):
        raise AssertionError(f"non-finite or no losses: {losses}")
    job = launch.build_trainer(args).job
    vocab = job.model.vocab_size
    first = [float(row[0]) for row in losses if len(row)]
    if not all(abs(x - math.log(vocab)) < 3.0 for x in first):
        raise AssertionError(f"first losses {first} not near ln V = "
                             f"{math.log(vocab):.3f}")
    if launches != {name: n_ticks for name in launches}:
        raise AssertionError(f"kernel launches {launches} in {n_ticks} "
                             "ticks: each kernel of the path runs once a "
                             "tick")
    tokens_per_step = job.shape.global_batch * (job.shape.seq_len - 1)
    trained = int(ran.sum()) * tokens_per_step
    emit({"phase": "main_path", "command": "python -m "
          "repro_torch.launch.train " + " ".join(MAIN_ARGV),
          "replicas": int(ran.size), "n_ticks": n_ticks,
          "iterations": ran.tolist(), "losses": [list(map(float, x))
                                                 for x in losses],
          "ln_V": math.log(vocab), "launches": launches,
          "run_s": run_s, "ms_per_tick_e2e": 1e3 * run_s / n_ticks,
          "trained_tokens_per_s_e2e": trained / run_s,
          "peak_mem_bytes": peak, "summary": summary})
    return res, job, launches


def phase_steady_step(torch, res, job):
    """Time the megabatch program's step alone over the run's final
    model: every replica running, the fused update included."""
    from repro_torch.train.trainer import (make_megabatch_train_program,
                                           stack_batches)

    model = res.result.final_model
    s, r = model["p"].shape[:2]
    n_batches = int(res.result.J.max())
    prog = make_megabatch_train_program(job, n_batches, True)
    data = stack_batches(job, n_batches, device="cuda")
    dev = torch.device("cuda")
    mask = torch.ones(s, r, job.n_workers, device=dev)
    j = torch.zeros(s, r, dtype=torch.int64, device=dev)
    alpha = torch.full((s, r), job.learning_rate, device=dev)
    running = torch.ones(s, r, dtype=torch.bool, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ms = timed(lambda: prog.step_fn(model, data, None, mask, j, alpha,
                                    running), 3, torch)
    tokens = s * r * job.shape.global_batch * (job.shape.seq_len - 1)
    emit({"phase": "steady_step", "ms_per_step": ms,
          "tokens_per_s": tokens / (ms / 1e3),
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})


def phase_kernel_at_main_shape(torch, res, smi, launches):
    """K1 at (R, P) of the main path, on the run's own final p and v."""
    from repro_torch.kernels import ops, ref

    model = res.result.final_model
    p = model["p"].view(-1, model["p"].shape[-1])
    v = model["v"].view(-1, model["v"].shape[-1])
    r, n = p.shape
    dev = p.device
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(r, n, generator=gen, device=dev)
    w = torch.tensor([1512.0, 0.375] + [7.0] * (r - 2), device=dev)[:r]
    running = torch.ones(r, dtype=torch.bool, device=dev)
    lr = torch.tensor([0.1, 0.05] + [0.1] * (r - 2), device=dev)[:r]
    mu = 0.9

    # the plain version's time: one call per replica row (the one-call
    # form's temporaries would not fit beside p, v and g)
    def plain_rows():
        for i in range(r):
            ref.elastic_update_reference(p[i:i + 1], v[i:i + 1], g[i:i + 1],
                                         w[i:i + 1], running[i:i + 1],
                                         lr[i:i + 1], momentum=mu)
    plain_ms = timed(plain_rows, 2, torch)

    # the plain version's answer, chunk by chunk, then the kernel in place
    chunk = 1 << 26
    p_exp, v_exp = torch.empty_like(p), torch.empty_like(v)
    for c in range(0, n, chunk):
        sl = slice(c, min(c + chunk, n))
        a, b = ref.elastic_update_reference(
            p[:, sl], v[:, sl], g[:, sl], w, running, lr, momentum=mu)
        p_exp[:, sl], v_exp[:, sl] = a, b
    ops.fused_elastic_update(p, v, g, w, running, lr, momentum=mu)
    torch.cuda.synchronize()
    err, equal = 0.0, True
    for c in range(0, n, chunk):
        sl = slice(c, min(c + chunk, n))
        equal &= bool(torch.equal(p[:, sl], p_exp[:, sl])
                      and torch.equal(v[:, sl], v_exp[:, sl]))
        err = max(err, (p[:, sl] - p_exp[:, sl]).abs().max().item(),
                  (v[:, sl] - v_exp[:, sl]).abs().max().item())
    del p_exp, v_exp
    if not equal:
        raise AssertionError(f"elastic_sgd_update differs from its plain "
                             f"version at (R={r}, P={n}): max |err| {err}")

    ms = timed(lambda: ops.fused_elastic_update(p, v, g, w, running, lr,
                                                momentum=mu), 5, torch)
    dst = torch.empty_like(p)
    copy_ms = timed(lambda: dst.copy_(p), 3, torch)
    del dst, g

    name = torch.cuda.get_device_name(0)
    hbm, f32, label = card_peaks(name)
    nbytes = 20 * r * n          # read p, v, g; write p, v (float32)
    flops = 5 * r * n            # μ·v, g·inv, +, lr·v', −
    bound_ms = 1e3 * max(nbytes / hbm, flops / f32)
    emit({"phase": "kernel_at_main_shape", "kernel": "elastic_sgd_update",
          "R": r, "P": n, "bit_exact": True, "max_abs_err": err,
          "ms": ms, "achieved_GBps": nbytes / ms / 1e6,
          "bound_ms": bound_ms, "peak": label, "plain_ms": plain_ms,
          "copy_ms": copy_ms, "copy_GBps": 2 * 4 * r * n / copy_ms / 1e6,
          "card": smi})
    src, replaces = KERNEL_SOURCES["elastic_sgd_update"]
    return {"name": "elastic_sgd_update", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches["elastic_sgd_update"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / hbm >= flops / f32
            else "operations",
            "library_ms": None}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the root "
              "of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.device import exact_float32

    exact_float32()
    smi = phase_card_and_build()
    phase_small_compare(torch)
    res, job, launches = phase_main_path(torch)
    phase_steady_step(torch, res, job)
    k1 = phase_kernel_at_main_shape(torch, res, smi, launches)
    emit({"kernels": [k1]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
