#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each printing one JSON line and raising on failure:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a, one process
   per source, all at once) with each kernel's ``ptxas`` report (no
   tensor-core kernel may spill), and the count of tensor-core
   instructions in the SASS of each tensor-core kernel (``cuobjdump
   -sass``), none of which may be 0: ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   load) in K2's forward, dK/dV and dQ kernels at both head dims, ``HMMA``
   (mma.sync) in each instantiation of K3's kernel;
2. each kernel against its plain PyTorch version on the card: K1 bit for
   bit on edge-case rows at a ragged width; K2 forward and backward on
   edge shapes (GQA g = 7, head_dim 64 and 128, and 112 and 80 through
   the entry point's zero padding, float32 and bf16, ragged S and T,
   windows, a query offset) within stated tolerances: float32 through the
   CUDA-core forward, dK/dV and dQ kernels, bf16 through the tensor-core
   ones (the forward's lse and the D_i pre-pass too, launched once for
   both backward halves), the backward from the forward's output and lse;
3. slice 1's path through the launcher's own entry points: elastic
   megabatch training of full-width Qwen2-7B at depth 2 in float32, a
   grid of one strategy × 2 seeds (R = 2), the fused update through K1.
   Checks that every loss is finite, that the first loss lies near ln V,
   and that K1 ran once per tick; reports time per tick, tokens per
   second, a steady-state step time and peak memory; then K1 at that
   path's own shape: bit-exact against its plain version, its time beside
   its bound, the plain version's time and a device-to-device copy rate;
4. slice 2's path: ``trainer.train_zoo`` of full-width Qwen2-7B at depth
   2 in bf16 mixed precision with ``use_flash_attention`` (K2), the same
   strategy, market and 2 seeds, 8 workers, batch 8, sequence 1024. Checks
   finite losses, first losses near ln V and K2's launches (one
   tensor-core forward, D_i pre-pass, tensor-core dK/dV and tensor-core dQ
   kernel per layer, cell and tick, and no CUDA-core forward, dK/dV or
   dQ); reports time per tick, a steady step over both cells, tokens per
   second and peak memory; one zoo step on the initial weights with K2 against the same
   step through the plain attention core (the loss and each attention
   weight's gradient); then K2 at that path's shape
   (B 8, H 28, Hkv 4, S = T = 1023, D 128, bf16, causal): each kernel's
   time beside its bound, the plain version's time and
   ``scaled_dot_product_attention``'s (timed here only; the port never
   calls it), the CUDA-core forward's, dK/dV and dQ kernels' bf16 times
   beside the tensor-core ones';
5. slice 3's path: serving full-width Mamba2-1.3B (48 layers, float32
   parameters initialised on the card, bf16 activations) through
   ``launch.serve``'s ``prefill_prompt`` (batch 8, a 2048-token prompt)
   and ``greedy_decode`` (``make_serve_step``, 32 generated tokens),
   twice. Checks K3's launches (48 in each prefill, none in decode), the
   tokens' range, finite caches and finite prefill logits whose argmax is
   the first token; reports prefill and decode times, tokens per second
   and peak memory; then one prefill and one decode step under
   ``torch.profiler`` (the device's busy time and idle share). Then K3 in
   place: one full-width ``ssm_block`` prefill with K3 against the same
   block with the plain version, and prefill-then-decode against one
   longer prefill (2048 + 32 against 2304 positions); then K3 at the
   path's shape: the tensor-core kernel's time beside its bound (3xTF32
   over the least work, the scores once per group), the CUDA-core
   kernel's time beside it, the plain version's, the glue's and K3's share
   of the prefill. K3 against its plain version on edge shapes (Q 16 to
   256, one, two and three heads a group, P 32 to 128, N 32 and 128,
   float32 and bf16) runs with the other small comparisons in phase 2;
6. slice 8's paths, which run no kernel of the reference (the device work
   is the engine's tick loop; each path's launch counts are set to 0
   before it and must stay 0): the paper's figures through
   ``sim.evaluate.evaluate_batch`` at the reference benchmark's set-up
   (fig3 under two i.i.d. markets, fig4 on the 30-day trace, fig5a and
   fig5b; 8 seeds, the engine's default tick budget; a 16-tick warm-up
   call on the same grid, then a timed one), checking that every
   completed cell is finite; one RNG-free grid on the card and the CPU
   (equal accounting, errors within rtol 1e-5) and a stochastic one (64
   seeds, within 4 standard errors);
   ``examples/scenario_sweep.py``'s 200 × 4 grid, timed and with a window
   of ticks under ``torch.profiler`` (the device's busy time and idle
   share); the fig3-uniform grid as two halves through ``snapshot_every``,
   ``snapshot_state`` and ``tick0``, bit for bit the straight run; and
   ``python -m repro_torch.launch.bidserve`` at its defaults, twice, the
   second report bit for bit the first.

Then the ``{"kernels": [...]}`` line and, last, the contract line
``{"ok": true, "device": {...}}``. Without a card, or outside a checkout,
it exits non-zero and prints no result. It imports neither ``jax`` nor
the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

MAIN_ARGV = ["--config", "qwen2_7b", "--reduce-depth", "2",
             "--param-dtype", "float32", "--batched", "--megabatch",
             "--fused-update", "--seeds", "2", "--iterations", "3",
             "--device", "cuda"]

ZOO_ARGV = ["--config", "qwen2_7b", "--reduce-depth", "2",
            "--param-dtype", "bfloat16", "--workers", "8", "--batch", "8",
            "--seq", "1024", "--seeds", "2", "--iterations", "3",
            "--device", "cuda"]

#: peak rates by card (NVIDIA data sheets; dense, no sparsity): HBM bytes/s,
#: float32 FLOP/s outside the tensor cores, bf16 and TF32 tensor-core FLOP/s
PEAKS = [("H200", 4.8e12, 67e12, 989e12, 495e12, "H200 SXM"),
         ("NVL", 3.9e12, 60e12, 835e12, 418e12, "H100 NVL"),
         ("PCIe", 2.0e12, 51e12, 756e12, 378e12, "H100 PCIe"),
         ("H100", 3.35e12, 67e12, 989e12, 495e12, "H100 SXM")]

K2_SOURCE = ("src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:88")
K2_TC_SOURCE = ("src/repro_torch/csrc/flash_attention_sm90.cu",
                "src/repro/kernels/flash_attention.py:88")
KERNEL_SOURCES = {"elastic_sgd_update": (
    "src/repro_torch/csrc/elastic_update.cu",
    "src/repro/kernels/elastic_update.py:56"),
    "flash_attention_fwd": K2_SOURCE,
    "flash_attention_fwd_tc": K2_TC_SOURCE,
    "flash_attention_bwd_dkdv": K2_SOURCE,
    "flash_attention_bwd_delta": K2_TC_SOURCE,
    "flash_attention_bwd_dkdv_tc": K2_TC_SOURCE,
    "flash_attention_bwd_dq": K2_SOURCE,
    "flash_attention_bwd_dq_tc": K2_TC_SOURCE}
#: the CUDA-core forward, dK/dV and dQ kernels take float32 (and bf16 when
#: called directly); the tensor-core ones take bf16, which is what the zoo
#: path runs, the dK/dV and dQ kernels after one D_i pre-pass
K2_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_tc",
              "flash_attention_bwd_dkdv", "flash_attention_bwd_delta",
              "flash_attention_bwd_dkdv_tc", "flash_attention_bwd_dq",
              "flash_attention_bwd_dq_tc")
K2_ZOO_KERNELS = ("flash_attention_fwd_tc", "flash_attention_bwd_delta",
                  "flash_attention_bwd_dkdv_tc", "flash_attention_bwd_dq_tc")
#: the forward, dK/dV and dQ kernel each dtype routes to
#: (kernels.flash_attention.forward_for, dkdv_for, dq_for)
K2_FWD_OF = {"float32": "flash_attention_fwd",
             "bfloat16": "flash_attention_fwd_tc"}
K2_DKDV_OF = {"float32": "flash_attention_bwd_dkdv",
              "bfloat16": "flash_attention_bwd_dkdv_tc"}
K2_DQ_OF = {"float32": "flash_attention_bwd_dq",
            "bfloat16": "flash_attention_bwd_dq_tc"}
#: instructions the SASS of each tensor-core kernel must hold: wgmma and
#: TMA loads
TC_OPCODES = ("HGMMA", "UTMALDG")
TC_FUNCTIONS = ("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
                "flash_bwd_dq_tc_kernel")
#: K3: the path's kernel on the tensor cores (mma.sync, so HMMA in its
#: SASS), and the CUDA-core kernel kept beside it off the path
KERNEL_SOURCES["ssd_chunk"] = ("src/repro_torch/csrc/ssd_scan_sm90.cu",
                               "src/repro/kernels/ssd_scan.py:72")
KERNEL_SOURCES["ssd_chunk_cuda_core"] = ("src/repro_torch/csrc/ssd_scan.cu",
                                         "src/repro/kernels/ssd_scan.py:72")
K3_TC_OPCODES = ("HMMA",)
K3_TC_FUNCTION = "ssd_chunk_tc_kernel"
#: its instantiations: x's type, P padded to 64 or 128, the cp.async route
K3_TC_KERNELS = {f"{K3_TC_FUNCTION}<{t},{pw},{a}>"
                 for t in ("float", "__nv_bfloat16") for pw in (64, 128)
                 for a in (0, 1)}

#: K2 against its plain version, per row (the head dimension): the largest
#: |kernel - plain| in a row over the larger of that row's largest |plain|
#: and the whole tensor's RMS, the worst row counting (the floor keeps rows
#: whose true value cancels to zero, such as dQ of a query with one key,
#: from dividing rounding noise by nothing). float32 sums in other orders;
#: bf16 computes in float32 as the plain version does and rounds each
#: output to 8 bits of mantissa, so the two differ by an ulp where their
#: float32 values straddle a rounding boundary: at most 2^-7 = 7.8e-3 of
#: the row's largest entry, so 1e-2 allows one ulp and not two. dQ has one
#: more source: the kernel forms D = rowsum(dO * O) from the bf16 output,
#: the plain version from float32, and in a row whose softmax sits on few
#: keys dS = P (dP - D) nearly cancels, so that D's rounding is large
#: beside the row's dQ. The inputs are seeded, so the errors repeat from
#: run to run; on an H100 the worst were, float32 over the shapes below:
#: 3.1e-6 (out), 1.3e-5 (dq), 6.2e-6 (dk, dv); bf16 over those and the
#: path's shape: 7.4e-3 (out), 9.2e-2 (dq), 7.8e-3 (dk, dv). The bf16
#: forward runs on the tensor cores, which take P = exp(s - m) rounded to
#: bf16 before P·V where the plain version keeps it float32: a unit
#: roundoff of 2^-8 on each weight, summed over hundreds of keys with random
#: signs, about 1e-3 of a row's largest output (3.3e-3 in the worst row of
#: tests/test_torch_flash_tc.py's shapes), under the one-ulp 1e-2. Its
#: worst row measured on an H100 over these shapes and the path's: 7.8e-3
#: (out); the backward from its output and lse 9.0e-2 (dq, at the path's
#: shape), 7.8e-3 (dk, dv). The bf16 dK/dV kernel runs on the tensor
#: cores too and rounds Pᵀ and dSᵀ to bf16 before its products: 4.9e-3 in
#: the worst row alone on the CPU (tests/test_torch_flash_bwd_tc.py), and
#: on an H100 over these shapes, the padded head_dims and the path's
#: 7.8e-3 (dk) and 7.9e-3 (dv, at the path's shape), under the same 1e-2.
#: The bf16 dQ kernel runs on the tensor cores too and rounds dS to bf16
#: before dS·K: 4.5e-3 in the worst row alone on the CPU
#: (tests/test_torch_flash_dq_tc.py), beside the cancellation above; on an
#: H100 7.3e-2 over these shapes and the padded head_dims, 9.0e-2 at the
#: path's shape (as the CUDA-core dQ kernel's 9.0e-2 there), and 7.8e-3
#: against the CUDA-core kernel, under the unchanged 0.1.
K2_TOL = {"float32": {"out": 1e-5, "dq": 5e-5, "dk": 2e-5, "dv": 2e-5},
          "bfloat16": {"out": 1e-2, "dq": 0.1, "dk": 1e-2, "dv": 1e-2}}
K2_GRADS = ("out", "dq", "dk", "dv")
#: the tensor-core forward's lse (float32) against the plain version's
#: logsumexp of the same float32 scores, absolute: the two sum the scores
#: in other orders, and an lse of 5 to 12 has an ulp of 9.5e-7 (measured
#: on an H100: 9.5e-7), so ten ulps
K2_LSE_TOL = 1e-5

#: K2 on edge shapes: (B, S, T, H, Hkv, D, causal, window, q_offset)
K2_EDGE_SHAPES = [
    (2, 100, 100, 14, 2, 128, True, None, 0),
    (1, 77, 200, 7, 1, 64, True, None, 123),
    (2, 130, 130, 4, 4, 64, True, 32, 0),
    (1, 70, 199, 7, 1, 128, True, 48, 129),
    (1, 64, 190, 4, 2, 128, False, None, 0),
    (1, 150, 150, 7, 1, 64, False, 50, 0),
    (1, 1023, 1023, 28, 4, 128, True, None, 0),
]
#: K2 at head_dims its kernels do not take, through the entry point's
#: zero padding: Zamba2-7B's 112, and 80 (not a multiple of 16)
K2_ANY_D_SHAPES = [
    (2, 100, 100, 14, 2, 112, True, None, 0),
    (1, 77, 200, 7, 1, 80, True, 48, 123),
]
#: the shape the zoo path gives K2
K2_PATH_SHAPE = (8, 1023, 1023, 28, 4, 128, True, None, 0)
#: the D_i pre-pass against its plain version, per row over the row's sum
#: of |dO_id O_id|: both sum exact float32 products of bf16 values in
#: other orders, each within (D - 1) 2^-24 of that sum
K2_DELTA_TOL = 2e-5

#: one zoo step on the initial bf16 weights with K2 against the plain
#: attention core: the loss relative to itself, and each attention weight's
#: gradient in relative L2. The two round the attention output and its
#: gradients to bf16 (2^-8 = 0.39 % a rounding) where their float32 values
#: differ, and the bf16 layers after them carry that on. Measured on an
#: H100: loss 1.1e-5, gradients 1.2e-3 (bv) to 4.5e-3 (bk).
K2_IN_PLACE_TOL = {"loss_rel": 3e-5, "grads_rel_l2": 1e-2}
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


#: slice 3: serving full-width Mamba2-1.3B as published (its config's bf16
#: activations, float32 parameters and caches as the reference's launcher
#: makes them), batch 8, a 2048-token prompt (8 chunks), 32 generated
#: tokens, weights and prompt drawn from the seed
SERVE = {"arch": "mamba2-1.3b", "batch": 8, "prompt": 2048, "gen": 32,
         "seed": 0}

#: K3 on edge shapes: (B, S, H, P, G, N, chunk) — Q = 16, 64, 100 (a
#: ragged 64-row tile), 256 and S < chunk (Q = S = 48); one and two
#: groups, and three heads a group (H 6, G 2); P 32, 64, 128 (with Q 100
#: too); N 32, 64, 128; two or more chunks where Q < S
K3_EDGE_SHAPES = [
    (2, 32, 4, 32, 1, 32, 16),
    (1, 128, 4, 64, 2, 128, 64),
    (1, 300, 2, 64, 1, 64, 100),
    (1, 512, 2, 64, 1, 128, 256),
    (2, 768, 4, 32, 2, 32, 256),
    (1, 48, 2, 128, 1, 128, 256),
    (1, 512, 6, 64, 2, 128, 256),
    (1, 300, 2, 128, 1, 64, 100),
]
#: the shape the serving path gives K3 (per layer of the prefill)
K3_PATH_SHAPE = (8, 2048, 64, 64, 1, 128, 256)
K3_OUTS = ("y", "states", "cs", "decay")

#: K3 against its plain version, per row as K2 (the worst row's max |kernel
#: - plain| over the larger of its max |plain| and the tensor's RMS).
#: float32 sums in other orders (fmaf chains against cuBLAS, a warp scan
#: against torch.cumsum). cs runs to about -180 over 256 positions, where a
#: float32 ulp is 1.5e-5: the two cumsums differ there by a random walk of
#: 256 roundings of up to 7.6e-6, 1.2e-4 at one sigma, and exp(cs_i - cs_j)
#: carries that into y, the states and the decay as a relative error; the
#: worst of a million rows sits in the tail: 5e-4. cs itself within 1e-5 of
#: its row. bf16 inputs are widened exactly on both sides and y_intra is
#: rounded to bf16 from float32 values that differ in their last bits: one
#: ulp, at most 2^-7 of its row's largest, so 1e-2. Measured on an H100
#: over these shapes and the path's: float32 y 1.2e-4, states 5.6e-5, cs
#: 5.2e-7, decay 3.9e-6; bf16 y 7.8e-3.
K3_TOL = {"float32": {"y": 5e-4, "states": 5e-4, "cs": 1e-5, "decay": 5e-4},
          "bfloat16": {"y": 1e-2, "states": 5e-4, "cs": 1e-5,
                       "decay": 5e-4}}
#: ops.ssd_chunked from a nonzero state against the naive recurrence from
#: it: the reference's own tolerance (tests/test_kernels.py), |a - b| <=
#: atol + rtol |b|
K3_GLUE_TOL = 5e-4

#: K3 in place: one full-width ssm_block prefill (layer 0 of the served
#: model, its input and its cache after the path) with K3 and with the
#: plain version, both in float32 from the block's promotion: its output
#: and new state, max |a - b| over max |b|. Prefill then decode against
#: one longer prefill, in float32 activations (the bf16 config rounds layer
#: 0's decode output to bf16 where the prefill keeps float32, a difference
#: by design): max |logit difference| within tests/test_prefill.py's 2e-3.
K3_IN_PLACE_TOL = {"block_rel": 1e-4, "decode_vs_prefill_abs": 2e-3}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    """(HBM bytes/s, float32 FLOP/s, bf16 FLOP/s, TF32 FLOP/s, label) of the
    card."""
    for key, *rates, label in PEAKS:
        if key in name:
            return (*rates, label)
    return PEAKS[-1][1:5] + ("H100 SXM (card not recognised)",)


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


def kernel_name(mangled: str) -> str:
    """``name<args>`` (or ``name``) of a mangled kernel: the last of the
    nested name's length-prefixed parts, and its template arguments (a
    type by name, ``f`` as float; an integer or bool literal by value)."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if not mangled.startswith("I", i):
        return name
    args, i = [], i + 1
    while i < len(mangled) and mangled[i] != "E":
        if mangled[i] == "L":                  # L <type> <value> E
            j = mangled.index("E", i)
            args.append(mangled[i + 2:j])
            i = j + 1
        elif mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            n = int(mangled[i:j])
            args.append(mangled[j:j + n])
            i = j + n
        else:
            args.append({"f": "float"}.get(mangled[i], mangled[i]))
            i += 1
    return f"{name}<{','.join(args)}>"


def ptxas_report(text: str) -> dict:
    """Each kernel's ``ptxas -v`` lines (registers, spills), keyed by
    `kernel_name`, from nvcc's build log."""
    out, name = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = kernel_name(ln.split("'")[1])
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.replace("ptxas info    :", "").strip())
    return out


def phase_card_and_build():
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    records = build.build_all()
    reports = {n: ptxas_report(r.ptxas) for n, r in records.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"path": os.path.relpath(r.path, ROOT),
                          "nvcc_s": r.seconds, "ptxas": reports[n]}
                      for n, r in records.items()}})
    spilled = {k: v for lib in ("flash_attention_sm90", "ssd_scan_sm90")
               for k, v in reports[lib].items()
               if any(int(n) for ln in v
                      for n in re.findall(r"(\d+) bytes spill", ln))}
    if spilled:
        raise AssertionError(f"a tensor-core kernel spills: {spilled}")
    phase_sass(records)
    return smi


def sass_counts(lib_path, functions, opcodes):
    """(instructions in the library, {kernel_name: {opcode: count}} of each
    kernel whose mangled name holds one of ``functions``), from its SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    ops, fn = {}, None
    for ln in sass.splitlines():      # "/*0a50*/  [@P0] OPCODE.MODS ..."
        words = ln.split()
        if "Function :" in ln:
            fn = words[-1]
            ops[fn] = []
        elif fn and len(words) > 2 and words[0].startswith("/*") \
                and words[0].endswith("*/"):
            ops[fn].append(words[2 if words[1].startswith("@") else 1])
    return sum(map(len, ops.values())), {
        kernel_name(f): {op: sum(o.split(".")[0] == op for o in seen)
                         for op in opcodes}
        for f, seen in ops.items() if any(k in f for k in functions)}


def phase_sass(records):
    """Count the tensor-core instructions of each tensor-core kernel in its
    library's SASS: wgmma (``HGMMA``) and TMA loads (``UTMALDG``) in K2's
    forward, dK/dV and dQ kernels at both head dims; mma.sync (``HMMA``)
    in each instantiation of K3's kernel. A kernel really runs on the
    tensor cores (and K2's is fed by TMA) only if none is 0."""
    libs = {"flash_attention_sm90": (TC_FUNCTIONS, TC_OPCODES),
            "ssd_scan_sm90": ((K3_TC_FUNCTION,), K3_TC_OPCODES)}
    found, total = {}, {}
    for lib, (functions, opcodes) in libs.items():
        total[lib], found[lib] = sass_counts(records[lib].path, functions,
                                             opcodes)
    emit({"phase": "sass", "libraries": {
        lib: os.path.relpath(records[lib].path, ROOT) for lib in libs},
        "instructions": total, "counts": found})
    want = {"flash_attention_sm90": {f"{k}<{w}>" for k in TC_FUNCTIONS
                                     for w in ("64", "128")},
            "ssd_scan_sm90": K3_TC_KERNELS}
    for lib, counts in found.items():
        lacking = {k: [op for op, n in c.items() if not n]
                   for k, c in counts.items() if not all(c.values())}
        if set(counts) != want[lib] or lacking:
            raise AssertionError(
                f"the tensor-core kernels' SASS in {lib}: found "
                f"{sorted(counts)} of {sorted(want[lib])}, lacking "
                f"{lacking}")


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
    if launches != {name: n_ticks if name == "elastic_sgd_update" else 0
                    for name in launches}:
        raise AssertionError(f"kernel launches {launches} in {n_ticks} "
                             "ticks: K1 runs once a tick on this path and "
                             "no other kernel runs")
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
    hbm, f32, _, _, label = card_peaks(name)
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


# ------------------------------------------------------------------ K2


def row_err(a, b) -> float:
    """The worst row's max |a - b| over the larger of its max |b| and b's
    RMS; rows lie along the last axis."""
    a, b = a.float(), b.float()
    num = (a - b).abs().amax(-1)
    den = b.abs().amax(-1).clamp_min(b.pow(2).mean().sqrt().item())
    return (num / den.clamp_min(1e-30)).max().item()


def abs_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def k2_inputs(torch, shape, dtype, seed=0):
    """q, k, v and an output gradient in the model layout (B, S, H, D)."""
    b, s, t, h, hkv, d = shape[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    return [torch.randn(*dims, generator=g, device=dev).to(dtype) for dims in
            ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d))]


def k2_both(torch, q, k, v, do, mask):
    """(kernel, plain) results: each is (out, dq, dk, dv)."""
    from repro_torch.kernels import ops, ref

    def run(attend):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = attend(*leaves)
        return (out.detach(),) + torch.autograd.grad(out, leaves, do)

    kern = run(lambda a, b, c: ops.flash_mha(a, b, c, **mask))
    plain = run(lambda a, b, c: ref.mha_reference(
        *(x.transpose(1, 2) for x in (a, b, c)), **mask).transpose(1, 2))
    torch.cuda.synchronize()
    return kern, plain


def k2_check(errs, dtype: str, where) -> list:
    """The names in ``errs`` (out, dq, dk, dv -> per-row error) beyond
    their tolerance, each with its place."""
    return [(where, dtype, n, e) for n, e in errs.items()
            if not e <= K2_TOL[dtype][n]]


def delta_err(torch, delta, out, dout) -> float:
    """The D_i pre-pass against its plain version: the worst row's
    |kernel - plain| over its sum of |dO_id O_id|."""
    from repro_torch.kernels import ref

    terms = (out.float() * dout.float()).abs().sum(-1).clamp_min(1e-30)
    return ((delta - ref.mha_delta_reference(out, dout)).abs()
            / terms).max().item()


def phase_k2_small(torch):
    """Through ``ops.flash_mha`` (the forward, dK/dV and dQ kernels of the
    dtype's route; for bf16 one D_i pre-pass) against autograd through the
    plain version, head_dims 64 and 128 and, through the entry point's
    padding, 112 and 80; then the tensor-core forward's lse against the
    plain logsumexp and the D_i pre-pass against its plain version."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops, ref

    worst, bad, lse_err, d_err = {}, [], 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        worst[key] = dict.fromkeys(K2_GRADS, 0.0)
        for shape in K2_EDGE_SHAPES + K2_ANY_D_SHAPES:
            causal, window, q_offset = shape[6:]
            mask = dict(causal=causal, window=window, q_offset=q_offset)
            inputs = k2_inputs(torch, shape, dtype)
            ops.reset_launch_counts()
            kern, plain = k2_both(torch, *inputs, mask)
            counts = ops.launch_counts()
            for route in (K2_FWD_OF, K2_DKDV_OF, K2_DQ_OF):
                got = {n: counts[n] for n in route.values()}
                if got != {n: int(n == route[key]) for n in route.values()}:
                    raise AssertionError(f"K2 {key} launches {got}: "
                                         f"{route[key]} is its route")
            if counts["flash_attention_bwd_delta"] != int(key == "bfloat16"):
                raise AssertionError(f"K2 {key}: {counts} launches D_i's "
                                     "pre-pass once for bf16, never for "
                                     "float32")
            errs = {n: row_err(a, b) for n, a, b in zip(K2_GRADS, kern,
                                                         plain)}
            bad += k2_check(errs, key, shape)
            for n, e in errs.items():
                worst[key][n] = max(worst[key][n], e)
            if dtype == torch.bfloat16 and shape[5] in flash.HEAD_DIMS:
                qt, kt, vt, dot = (x.transpose(1, 2) for x in inputs)
                out, lse = flash.flash_fwd_tc(qt, kt, vt, **mask)
                lse_err = max(lse_err, abs_err(
                    lse, ref.mha_lse_reference(qt, kt, **mask)))
                d_err = max(d_err, delta_err(
                    torch, flash.flash_bwd_delta(out, dot), out, dot))
    emit({"phase": "k2_vs_plain_small",
          "shapes": K2_EDGE_SHAPES + K2_ANY_D_SHAPES,
          "forward_of": K2_FWD_OF, "dkdv_of": K2_DKDV_OF, "dq_of": K2_DQ_OF,
          "tolerance_per_row": K2_TOL, "worst_row_err": worst,
          "tc_lse_abs_err": lse_err, "lse_tolerance": K2_LSE_TOL,
          "delta_rel_err": d_err, "delta_tolerance": K2_DELTA_TOL})
    if bad:
        raise AssertionError(f"K2 differs from its plain version (shape, "
                             f"dtype, tensor, per-row error): {bad}")
    if not lse_err <= K2_LSE_TOL:
        raise AssertionError(f"the tensor-core forward's lse differs from "
                             f"the plain logsumexp by {lse_err}")
    if not d_err <= K2_DELTA_TOL:
        raise AssertionError(f"the D_i pre-pass differs from its plain "
                             f"version by {d_err} of a row's terms")


def zoo_job_and_scenario():
    """The zoo job (bf16, K2 on) and its scenario, built by the
    launcher's own helpers from ``ZOO_ARGV``."""
    from repro_torch.launch import train as launch

    args = launch.build_parser().parse_args(ZOO_ARGV)
    trainer = launch.build_trainer(args)
    job = dataclasses.replace(trainer.job, model=trainer.job.model.with_(
        use_flash_attention=True))
    scenario = trainer._scenario(trainer.strategy, args.iterations,
                                 args.strategy)
    return job, scenario, args


def phase_zoo_path(torch):
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import default_n_ticks, train_zoo

    job, scenario, args = zoo_job_and_scenario()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_zoo(job, [scenario], seeds=args.seeds, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    n_ticks = default_n_ticks(int(res.J.max()))
    ran = res.iterations
    cells = int(ran.size)
    losses = [res.errors[s, k, :ran[s, k]] for s in range(ran.shape[0])
              for k in range(ran.shape[1])]
    flat = [x for row in losses for x in row]
    if not flat or not all(math.isfinite(x) for x in flat):
        raise AssertionError(f"zoo: non-finite or no losses: {losses}")
    vocab = job.model.vocab_size
    first = [float(row[0]) for row in losses if len(row)]
    if not all(abs(x - math.log(vocab)) < 3.0 for x in first):
        raise AssertionError(f"zoo: first losses {first} not near ln V = "
                             f"{math.log(vocab):.3f}")
    # every cell's step runs on every tick (idle ones are gated away)
    per_kernel = job.model.num_layers * cells * n_ticks
    want = {n: per_kernel if n in K2_ZOO_KERNELS else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"zoo: kernel launches {launches}, designed "
                             f"{want} ({job.model.num_layers} layers × "
                             f"{cells} cells × {n_ticks} ticks)")
    tokens_per_step = job.shape.global_batch * (job.shape.seq_len - 1)
    trained = int(ran.sum()) * tokens_per_step
    emit({"phase": "zoo_path", "entry": "trainer.train_zoo",
          "argv": ZOO_ARGV, "use_flash_attention": True,
          "param_dtype": job.model.param_dtype, "cells": cells,
          "n_ticks": n_ticks, "iterations": ran.tolist(),
          "losses": [list(map(float, x)) for x in losses],
          "ln_V": math.log(vocab), "launches": launches, "run_s": run_s,
          "ms_per_tick_e2e": 1e3 * run_s / n_ticks,
          "trained_tokens_per_s_e2e": trained / run_s,
          "peak_mem_bytes": peak})
    return res, job, launches


def phase_zoo_steady(torch, res, job):
    """One tick's worth of steps over the run's final carry: every cell
    stepped and gated in, all running."""
    from repro_torch.sim import engine
    from repro_torch.train.trainer import stack_batches
    from repro_torch.train.zoo_program import make_zoo_program
    from repro_torch.tree import tree_index

    n_batches = int(res.J.max())
    prog = make_zoo_program(job.model, job, n_batches)
    data = stack_batches(job, n_batches, device="cuda")
    dev = torch.device("cuda")
    s_dim, r_dim = res.iterations.shape
    mask = torch.ones(job.n_workers, device=dev)
    j = torch.zeros((), dtype=torch.int64, device=dev)
    alpha = torch.full((), job.learning_rate, device=dev)
    running = torch.ones((), dtype=torch.bool, device=dev)

    def tick():
        for s in range(s_dim):
            for r in range(r_dim):
                cell = tree_index(res.final_model, (s, r))
                stepped, _ = prog.step_fn(cell, data, None, mask, j, alpha)
                engine._gate_model(running, stepped, cell)
                del stepped      # as the engine does: one new tree at a time

    torch.cuda.reset_peak_memory_stats()
    ms = timed(tick, 2, torch)
    cells = s_dim * r_dim
    tokens = cells * job.shape.global_batch * (job.shape.seq_len - 1)
    emit({"phase": "zoo_steady_step", "cells": cells,
          "ms_per_tick": ms, "ms_per_cell_step": ms / cells,
          "tokens_per_s": tokens / (ms / 1e3),
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    return ms


def phase_k2_in_place(torch, job):
    """One zoo step's loss and gradients on the run's initial bf16 weights
    and its first batch, attention through K2 and through the plain core
    `_attend`; each attention weight's gradient compared on its own."""
    from repro_torch.train.trainer import stack_batches
    from repro_torch.train.train_step import make_loss_grad
    from repro_torch.train.zoo_program import init_zoo_state

    params = init_zoo_state(job.model, job, job.seed, device="cuda")["params"]
    free(torch)
    data = stack_batches(job, 1, device="cuda")
    batch = {k: x[0] for k, x in data.items()}
    mask = torch.ones(job.n_workers, device="cuda")
    on, loss_on, _ = make_loss_grad(job.model, job)(params, batch, mask)
    off_cfg = job.model.with_(use_flash_attention=False)
    off, loss_off, _ = make_loss_grad(off_cfg, job)(params, batch, mask)

    def rel_l2(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    rel = {n: rel_l2(on["layers"]["attn"][n], off["layers"]["attn"][n])
           for n in ATTN_LEAVES}
    dloss = abs(loss_on.item() - loss_off.item()) / abs(loss_off.item())
    emit({"phase": "k2_in_place", "weights": "initial",
          "loss_k2": loss_on.item(), "loss_plain_core": loss_off.item(),
          "loss_rel_diff": dloss, "attn_grads_rel_l2": rel,
          "tolerance": K2_IN_PLACE_TOL})
    worst = max(rel.values())
    if not (dloss <= K2_IN_PLACE_TOL["loss_rel"]
            and worst <= K2_IN_PLACE_TOL["grads_rel_l2"]):
        raise AssertionError(f"zoo step with K2 differs from the plain core: "
                             f"loss by {dloss}, attention gradients by {rel} "
                             "rel L2")


def valid_pairs(s, t, causal, window, q_offset) -> int:
    """(query, key) pairs the mask keeps: the work the kernels must do."""
    n = 0
    for qpos in range(q_offset, q_offset + s):
        lo = max(0, qpos - window + 1) if window is not None else 0
        hi = min(t - 1, qpos) if causal else t - 1
        n += max(0, hi - lo + 1)
    return n


def phase_k2_at_path_shape(torch, smi, launches, step_ms, n_layers):
    """K2 at the zoo path's shape, in the model layout it receives there:
    each kernel's time beside its bound, the plain version's and
    ``scaled_dot_product_attention``'s. The path runs the tensor-core
    forward, dK/dV and dQ kernels; the CUDA-core forward, dK/dV and dQ
    kernels are held and timed here in bf16 beside them."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops, ref

    shape = K2_PATH_SHAPE
    b, s, t, h, hkv, d = shape[:6]
    mask = dict(causal=True, window=None, q_offset=0)
    q, k, v, do = k2_inputs(torch, shape, torch.bfloat16, seed=5)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    kern, plain = k2_both(torch, q, k, v, do, mask)
    out, lse = flash.flash_fwd_tc(qt, kt, vt, **mask)
    delta = flash.flash_bwd_delta(out, dot)
    cuda_core_out, _ = flash.flash_fwd(qt, kt, vt, **mask)
    cc_dk, cc_dv = (x.transpose(1, 2) for x in flash.flash_bwd_dkdv(
        qt, kt, vt, out, lse, dot, **mask))
    cc_dq = flash.flash_bwd_dq(qt, kt, vt, out, lse, dot,
                               **mask).transpose(1, 2)
    d_err = delta_err(torch, delta, out, dot)
    errs = {"flash_attention_fwd_tc": abs_err(kern[0], plain[0]),
            "flash_attention_fwd": abs_err(cuda_core_out.transpose(1, 2),
                                           plain[0]),
            "flash_attention_bwd_dq_tc": abs_err(kern[1], plain[1]),
            "flash_attention_bwd_dq": abs_err(cc_dq, plain[1]),
            "flash_attention_bwd_dkdv_tc": max(abs_err(kern[2], plain[2]),
                                               abs_err(kern[3], plain[3])),
            "flash_attention_bwd_dkdv": max(abs_err(cc_dk, plain[2]),
                                            abs_err(cc_dv, plain[3])),
            "flash_attention_bwd_delta": abs_err(
                delta, ref.mha_delta_reference(out, dot))}
    rels = {n: row_err(a, c) for n, a, c in zip(K2_GRADS, kern, plain)}
    bad = k2_check(rels, "bfloat16", shape)
    off_path = {"flash_attention_fwd out": row_err(
        cuda_core_out.transpose(1, 2), plain[0]),
        "flash_attention_bwd_dkdv dk": row_err(cc_dk, plain[2]),
        "flash_attention_bwd_dkdv dv": row_err(cc_dv, plain[3]),
        "flash_attention_bwd_dq dq": row_err(cc_dq, plain[1])}
    bad += [(shape, "bfloat16", n, e) for n, e in off_path.items()
            if not e <= K2_TOL["bfloat16"][n.split()[-1]]]
    if not d_err <= K2_DELTA_TOL:
        bad.append((shape, "bfloat16", "flash_attention_bwd_delta", d_err))
    tc_vs_cc = max(row_err(kern[2], cc_dk), row_err(kern[3], cc_dv))
    dq_tc_vs_cc = row_err(kern[1], cc_dq)
    del cuda_core_out, cc_dk, cc_dv, cc_dq
    if bad:
        raise AssertionError(f"K2 at the path's shape differs from its plain "
                             f"version: {bad}")
    n = 10
    ms = {"flash_attention_fwd_tc": timed(
        lambda: flash.flash_fwd_tc(qt, kt, vt, **mask), 5 * n, torch),
        "flash_attention_fwd": timed(
        lambda: flash.flash_fwd(qt, kt, vt, **mask), n, torch),
        "flash_attention_bwd_delta": timed(
            lambda: flash.flash_bwd_delta(out, dot), 5 * n, torch),
        "flash_attention_bwd_dkdv_tc": timed(
            lambda: flash.flash_bwd_dkdv_tc(qt, kt, vt, out, lse, dot,
                                            **mask, delta=delta),
            5 * n, torch),
        "flash_attention_bwd_dkdv": timed(
            lambda: flash.flash_bwd_dkdv(qt, kt, vt, out, lse, dot, **mask),
            n, torch),
        "flash_attention_bwd_dq_tc": timed(
            lambda: flash.flash_bwd_dq_tc(qt, kt, vt, out, lse, dot, **mask,
                                          delta=delta), 5 * n, torch),
        "flash_attention_bwd_dq": timed(
            lambda: flash.flash_bwd_dq(qt, kt, vt, out, lse, dot, **mask),
            n, torch)}

    def fwd_bwd(attend):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = attend(*leaves)
        torch.autograd.grad(o, leaves, do)

    fwd_bwd_ms = timed(lambda: fwd_bwd(lambda a, b_, c: ops.flash_mha(
        a, b_, c, causal=True)), n, torch)

    # the plain version (autograd through ref.mha_reference) and the
    # library call, split the same way: forward; grads of k and v; grad
    # of q — each backward on a graph kept across the repeats
    def split_times(attend, reps):
        with torch.no_grad():
            f_ms = timed(lambda: attend(qt, kt, vt), reps, torch)
        leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
        o = attend(*leaves)
        kv_ms = timed(lambda: torch.autograd.grad(
            o, leaves[1:], dot, retain_graph=True), reps, torch)
        q_ms = timed(lambda: torch.autograd.grad(
            o, leaves[:1], dot, retain_graph=True), reps, torch)
        return {"flash_attention_fwd": f_ms, "flash_attention_fwd_tc": f_ms,
                "flash_attention_bwd_dkdv": kv_ms,
                "flash_attention_bwd_dkdv_tc": kv_ms,
                "flash_attention_bwd_dq": q_ms,
                "flash_attention_bwd_dq_tc": q_ms}

    plain_ms = split_times(lambda a, b_, c: ref.mha_reference(
        a, b_, c, causal=True), 3)
    plain_ms["flash_attention_bwd_delta"] = timed(
        lambda: ref.mha_delta_reference(out, dot), n, torch)
    library_ms = split_times(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, is_causal=True, enable_gqa=True), n)
    # no one PyTorch call forms rowsum(dO∘O) in float32 from bf16 inputs
    library_ms["flash_attention_bwd_delta"] = None

    name = torch.cuda.get_device_name(0)
    hbm, _, bf16, _, label = card_peaks(name)
    pairs = valid_pairs(s, t, **mask)
    el = 2                                     # bytes per bf16 element
    q_bytes, kv_bytes = b * s * h * d * el, b * t * hkv * d * el
    lse_bytes = b * h * s * 4
    fwd_work = (4 * b * h * d * pairs, 2 * q_bytes + 2 * kv_bytes + lse_bytes)
    work = {  # (FLOP, bytes): products × 2·pairs·D per head; reads, writes
        "flash_attention_fwd": fwd_work, "flash_attention_fwd_tc": fwd_work,
        "flash_attention_bwd_dkdv": (8 * b * h * d * pairs,
                                     3 * q_bytes + 4 * kv_bytes + lse_bytes),
        # q, dout, lse, D_i in; k, v in; dk, dv out
        "flash_attention_bwd_dkdv_tc": (
            8 * b * h * d * pairs, 2 * q_bytes + 4 * kv_bytes
            + 2 * lse_bytes),
        "flash_attention_bwd_delta": (2 * b * h * s * d,
                                      2 * q_bytes + lse_bytes),
        "flash_attention_bwd_dq": (6 * b * h * d * pairs,
                                   4 * q_bytes + 2 * kv_bytes + lse_bytes),
        # q, dout, lse, D_i in; k, v in; dq out
        "flash_attention_bwd_dq_tc": (6 * b * h * d * pairs,
                                      3 * q_bytes + 2 * kv_bytes
                                      + 2 * lse_bytes)}
    rows = []
    for kname in K2_KERNELS:
        flops, nbytes = work[kname]
        t_ops, t_bytes = flops / bf16, nbytes / hbm
        src, replaces = KERNEL_SOURCES[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": errs[kname], "ms": ms[kname],
                     "plain_ms": plain_ms[kname],
                     "bound_ms": 1e3 * max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes",
                     "library_ms": library_ms[kname]})
    fb_flops = sum(work[kk][0] for kk in K2_ZOO_KERNELS)
    emit({"phase": "k2_at_path_shape", "shape": shape, "dtype": "bfloat16",
          "valid_pairs": pairs, "row_err": rels,
          "off_path_row_err": off_path, "delta_rel_err": d_err,
          "dkdv_tc_vs_cuda_core_row_err": tc_vs_cc,
          "dq_tc_vs_cuda_core_row_err": dq_tc_vs_cc, "peak": label,
          "kernels": {r["name"]: {kk: r[kk] for kk in
                                  ("ms", "bound_ms", "plain_ms",
                                   "library_ms", "max_abs_err")}
                      for r in rows},
          "achieved_TFLOPs": {kk: work[kk][0] / ms[kk] / 1e9
                              for kk in K2_KERNELS},
          "fwd_ms": ms["flash_attention_fwd_tc"],
          "cuda_core_fwd_ms": ms["flash_attention_fwd"],
          "fwd_speedup_over_cuda_core": ms["flash_attention_fwd"]
          / ms["flash_attention_fwd_tc"],
          "dkdv_ms": ms["flash_attention_bwd_dkdv_tc"]
          + ms["flash_attention_bwd_delta"],
          "cuda_core_dkdv_ms": ms["flash_attention_bwd_dkdv"],
          "dkdv_speedup_over_cuda_core": ms["flash_attention_bwd_dkdv"]
          / ms["flash_attention_bwd_dkdv_tc"],
          "dq_ms": ms["flash_attention_bwd_dq_tc"],
          "cuda_core_dq_ms": ms["flash_attention_bwd_dq"],
          "dq_speedup_over_cuda_core": ms["flash_attention_bwd_dq"]
          / ms["flash_attention_bwd_dq_tc"], "fwd_bwd_ms": fwd_bwd_ms,
          "fwd_bwd_bound_ms": 1e3 * fb_flops / bf16,
          "plain_fwd_bwd_ms": sum(plain_ms[kk] for kk in (
              "flash_attention_fwd_tc", "flash_attention_bwd_dkdv_tc",
              "flash_attention_bwd_dq_tc")),
          "library_fwd_ms": library_ms["flash_attention_fwd"],
          "share_of_zoo_cell_step": fwd_bwd_ms * n_layers / step_ms,
          "card": smi})
    return rows


# ------------------------------------------------------------------ K3


def k3_inputs(torch, shape, dtype, seed=0):
    """xh, dt (post-softplus), a_h < 0, bm, cm in the model's layouts."""
    b, s, h, p, g, n = shape[:6]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def randn(*dims):
        return torch.randn(*dims, generator=gen, device=dev)

    xh = randn(b, s, h, p) * 0.5
    dt = torch.nn.functional.softplus(randn(b, s, h))
    a_h = -torch.exp(randn(h) * 0.2)
    bm, cm = randn(b, s, g, n) * 0.3, randn(b, s, g, n) * 0.3
    return xh.to(dtype), dt, a_h, bm.to(dtype), cm.to(dtype)


def k3_errs(torch, args, chunk):
    """K3 against its plain version on ``args``: (per-row error of each
    output, the largest absolute difference over all four)."""
    from repro_torch.kernels import ref, ssd_scan

    got = ssd_scan.ssd_chunk(*args, chunk=chunk)
    want = ref.ssd_chunk_reference(*args, chunk=chunk)
    torch.cuda.synchronize()
    for name, a, b in zip(K3_OUTS, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"K3 {name}: {tuple(a.shape)} {a.dtype}, "
                                 f"plain {tuple(b.shape)} {b.dtype}")
    return ({n: row_err(a, b) for n, a, b in zip(K3_OUTS, got, want)},
            max(abs_err(a, b) for a, b in zip(got, want)))


def phase_k3_small(torch):
    from repro_torch.kernels import ops, ref

    worst, bad = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        worst[key] = dict.fromkeys(K3_OUTS, 0.0)
        for shape in K3_EDGE_SHAPES:
            errs, _ = k3_errs(torch, k3_inputs(torch, shape, dtype), shape[6])
            bad += [(shape, key, n, e) for n, e in errs.items()
                    if not e <= K3_TOL[key][n]]
            for n, e in errs.items():
                worst[key][n] = max(worst[key][n], e)
    # the glue from a nonzero initial state against the naive recurrence
    glue = {}
    for shape in K3_EDGE_SHAPES[1:4]:
        b, _, h, p, _, n, chunk = shape
        args = k3_inputs(torch, shape, torch.float32, seed=1)
        gen = torch.Generator(device="cuda").manual_seed(2)
        h0 = torch.randn(b, h, p, n, generator=gen, device="cuda") * 0.5
        y, hfin = ops.ssd_chunked(*args, chunk=chunk, h0=h0)
        yr, hr = ref.ssd_reference(*args, h0=h0)
        torch.cuda.synchronize()
        over = max(((a - r).abs() - K3_GLUE_TOL * (1 + r.abs())).max().item()
                   for a, r in ((y, yr), (hfin, hr)))
        glue[str(shape)] = max(abs_err(y, yr), abs_err(hfin, hr))
        if over > 0:
            bad.append((shape, "float32", "ssd_chunked from h0",
                        glue[str(shape)]))
    emit({"phase": "k3_vs_plain_small", "shapes": K3_EDGE_SHAPES,
          "tolerance_per_row": K3_TOL, "worst_row_err": worst,
          "glue_from_h0_vs_naive_max_abs_err": glue,
          "glue_tolerance": K3_GLUE_TOL})
    if bad:
        raise AssertionError(f"K3 differs from its plain version (shape, "
                             f"dtype, output, error): {bad}")


def serve_model(torch):
    """The served model: full-width config, float32 parameters on the card
    and the prompt, both from ``SERVE["seed"]``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params

    cfg = get_config(SERVE["arch"])
    params = init_params(model_zoo.param_defs(cfg), SERVE["seed"],
                         torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SERVE["seed"])
    prompt = torch.randint(0, cfg.vocab_size,
                           (SERVE["batch"], SERVE["prompt"]), generator=gen,
                           device="cuda")
    return cfg, params, prompt


def fresh_caches(torch, cfg):
    """A fresh (zero) cache tree for the served batch, as the reference's
    launcher makes it (``init_params`` of ``cache_defs``, float32)."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params

    return init_params(
        model_zoo.cache_defs(cfg, SERVE["batch"],
                             SERVE["prompt"] + SERVE["gen"]),
        SERVE["seed"], torch.float32, device="cuda")


def phase_serve_path(torch):
    """Slice 3's path, twice: ``prefill_prompt`` then ``greedy_decode``,
    each with the launch counts set to 0 just before and read just
    after."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo
    from repro_torch.tree import tree_leaves

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, prompt = serve_model(torch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bsz, plen, n_gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    runs = []
    for _ in range(2):
        caches = fresh_caches(torch, cfg)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        nxt, caches = serve.prefill_prompt(cfg, params, caches, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = ops.launch_counts()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tokens, caches = serve.greedy_decode(cfg, params, caches, nxt, plen,
                                             n_gen - 1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec = ops.launch_counts()
        want_pre = {n: cfg.num_layers if n == "ssd_chunk" else 0 for n in pre}
        if pre != want_pre or set(dec.values()) != {0}:
            raise AssertionError(
                f"serve: launches {pre} in the prefill (designed {want_pre}: "
                f"K3 once per layer) and {dec} in decode (designed none)")
        if tuple(tokens.shape) != (bsz, n_gen) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"serve: tokens {tuple(tokens.shape)} out "
                                 f"of range [0, {cfg.vocab_size})")
        if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(caches)):
            raise AssertionError("serve: non-finite caches after decode")
        runs.append({"prefill_ms": 1e3 * prefill_s,
                     "prefill_tokens_per_s": bsz * plen / prefill_s,
                     "decode_ms_per_step": 1e3 * decode_s / (n_gen - 1),
                     "generated_tokens_per_s": bsz * (n_gen - 1) / decode_s,
                     "call_s": prefill_s + decode_s,
                     "launches_prefill": pre, "launches_decode": dec,
                     "tokens": tokens})
    peak = torch.cuda.max_memory_allocated()
    same = bool(torch.equal(runs[0]["tokens"], runs[1]["tokens"]))
    tokens = runs[1].pop("tokens")
    runs[0].pop("tokens")

    # the prefill's logits: prefill_prompt returns only their argmax, so
    # compute them again (the same call, outside the counted window) and
    # hold the path's first token against them
    with torch.no_grad():
        logits, _ = model_zoo.prefill(params, cfg, {"tokens": prompt},
                                      fresh_caches(torch, cfg))
    finite = bool(torch.isfinite(logits).all())
    last = logits[:, -1].float()
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    agree = bool((last.argmax(-1)[clear] == tokens[clear, 0]).all())
    logits_shape = list(logits.shape)
    del logits
    emit({"phase": "serve_path", "entry": "launch.serve.prefill_prompt + "
          "greedy_decode (make_serve_step)", "serve": SERVE,
          "config": {"layers": cfg.num_layers, "d_model": cfg.d_model,
                     "activation_dtype": cfg.dtype,
                     "param_dtype": "float32"},
          "init_s": init_s, "runs": runs, "same_tokens_both_runs": same,
          "peak_mem_bytes": peak, "prefill_logits": logits_shape,
          "logits_finite": finite, "first_token_is_argmax": agree,
          "sample": tokens[0, :16].tolist()})
    if not (finite and agree):
        raise AssertionError(f"serve: prefill logits finite {finite}, the "
                             f"first token their argmax {agree}")
    return cfg, params, prompt, tokens, caches, runs[1]


def phase_serve_profile(torch, cfg, params, prompt, run):
    """One prefill and one decode step under ``torch.profiler``: the
    device's busy time (the sum of its kernels' and copies' own times), the
    idle share of the path's unprofiled wall time that leaves, the number
    of device operations and the five that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.train.train_step import make_serve_step

    step = make_serve_step(cfg)
    nxt, caches = serve.prefill_prompt(cfg, params, fresh_caches(torch, cfg),
                                       prompt)
    torch.cuda.synchronize()
    work = {"prefill": (lambda: serve.prefill_prompt(
        cfg, params, fresh_caches(torch, cfg), prompt), run["prefill_ms"]),
        "decode_step": (lambda: step(params, caches, nxt, SERVE["prompt"]),
                        run["decode_ms_per_step"])}
    out = {}
    for name, (fn, wall_ms) in work.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the device's own rows (kernels, copies, fills); a host operator's
        # row repeats the device time of the kernels it launched
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type != DeviceType.CPU]
        rows = [r for r in rows if r[2] > 0]
        busy_ms = sum(r[2] for r in rows) / 1e3
        top = sorted(rows, key=lambda r: -r[2])[:5]
        out[name] = {"device_busy_ms": busy_ms if rows else "not measured",
                     "wall_ms_unprofiled": wall_ms,
                     "device_idle_share": 1 - busy_ms / wall_ms if rows
                     else "not measured",
                     "device_ops": sum(r[1] for r in rows),
                     "top5_ms": [(k[:60], c, t / 1e3) for k, c, t in top]}
    emit({"phase": "serve_profile", **out})


@contextlib.contextmanager
def plain_k3():
    """Within the block, ``ops.ssd_chunked`` takes K3's plain version on
    CUDA tensors too (the in-place comparison's other side)."""
    from repro_torch.kernels import ref, ssd_scan

    kernel = ssd_scan.ssd_chunk
    ssd_scan.ssd_chunk = ref.ssd_chunk_reference
    try:
        yield
    finally:
        ssd_scan.ssd_chunk = kernel


def phase_k3_in_place(torch, cfg, params, prompt, tokens, caches):
    from repro_torch.models import model_zoo, ssm
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import embed_tokens
    from repro_torch.tree import tree_index

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    # one block: layer 0 on the prompt, from its cache after the path
    lay = tree_index(params["layers"], 0)
    with torch.no_grad():
        x = rms_norm(embed_tokens(params, cfg, prompt), lay["ln"],
                     cfg.norm_eps)
        cache0 = tree_index(caches, 0)
        out_k, c_k = ssm.ssm_block(lay["ssm"], cfg, x, cache=cache0)
        with plain_k3():
            out_p, c_p = ssm.ssm_block(lay["ssm"], cfg, x, cache=cache0)
    block = {"out": rel(out_k, out_p), "h": rel(c_k["h"], c_p["h"]),
             "conv": rel(c_k["conv"], c_p["conv"])}
    del out_k, out_p, c_k, c_p, x

    # prefill then decode against one longer prefill, float32 activations
    cfg32 = cfg.with_(dtype="float32")
    bsz, plen, n_gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    q = cfg.ssm.chunk_size
    long_len = -(-(plen + n_gen) // q) * q                 # 2304: 9 chunks
    gen = torch.Generator(device="cuda").manual_seed(SERVE["seed"] + 1)
    filler = torch.randint(0, cfg.vocab_size, (bsz, long_len - plen - n_gen),
                           generator=gen, device="cuda")
    with torch.no_grad():
        logits, c = model_zoo.prefill(params, cfg32, {"tokens": prompt},
                                      fresh_caches(torch, cfg))
        last_prompt = logits[:, -1].clone()
        finite = bool(torch.isfinite(logits).all())
        del logits
        steps = []
        for k in range(n_gen):
            lg, c = model_zoo.decode_step(params, cfg32, tokens[:, k:k + 1],
                                          c, plen + k)
            steps.append(lg[:, 0])
            finite &= bool(torch.isfinite(lg).all())
        steps = torch.stack(steps, dim=1)
        del c
        long_logits, _ = model_zoo.prefill(
            params, cfg32,
            {"tokens": torch.cat([prompt, tokens, filler], dim=1)},
            fresh_caches(torch, cfg))
        at_steps = long_logits[:, plen:plen + n_gen].clone()
        at_last = long_logits[:, plen - 1].clone()
        del long_logits
    dec_err = abs_err(steps, at_steps)
    pre_err = abs_err(last_prompt, at_last)
    emit({"phase": "k3_in_place", "block": "layer 0 ssm_block prefill of "
          "the path's prompt from its served cache, K3 vs plain",
          "block_rel_err": block, "long_prefill_tokens": long_len,
          "decode_vs_long_prefill_max_abs": dec_err,
          "prefill_vs_long_prefill_max_abs": pre_err,
          "logit_scale": at_steps.abs().max().item(),
          "finite": finite, "tolerance": K3_IN_PLACE_TOL})
    if not (finite and max(block.values()) <= K3_IN_PLACE_TOL["block_rel"]
            and max(dec_err, pre_err)
            <= K3_IN_PLACE_TOL["decode_vs_prefill_abs"]):
        raise AssertionError(
            f"K3 in place: block {block} (tolerance "
            f"{K3_IN_PLACE_TOL['block_rel']}), decode vs prefill {dec_err}, "
            f"prefill vs longer prefill {pre_err}, finite {finite}")


def k3_work(shape, slab):
    """(least FLOP, FLOP of the tensor-core kernel's products) of K3 at
    ``shape``: the least work forms the scores once per (batch, chunk,
    group) over the causal pairs, y over them per head, and each state;
    the kernel forms the scores once per slab of ``slab`` heads and query
    tile over whole 64 x 64 key tiles at or below the diagonal (N in
    32-column stages), y over whole tiles below it and, on a diagonal
    tile, over the 2560 pairs its four warps' 8-column steps reach, the
    states over 64-row blocks of N; P padded to 64 or 128. Useful
    products only: 3xTF32 issues three tensor-core products for each
    float32 one (two for bf16)."""
    b, s, h, p, g, n, q = shape
    nc, rep, t = s // q, h // g, -(-q // 64)
    pairs = q * (q + 1) // 2
    least = b * nc * (g * 2 * pairs * n + h * (2 * pairs * p + 2 * q * n * p))
    slabs = g * -(-rep // min(slab, rep))
    tiles = t * (t + 1) // 2
    pw, n_kc, n_state = (64 if p <= 64 else 128), -(-n // 32), -(-n // 64)
    done = b * nc * (slabs * tiles * 64 * 64 * 2 * 32 * n_kc
                     + h * 2 * pw * ((tiles - t) * 64 * 64 + t * 2560
                                     + n_state * 64 * 64 * t))
    return least, done


def phase_k3_at_path_shape(torch, smi, launches, prefill_ms):
    """K3 at the serving path's shape: the tensor-core kernel's time beside
    its bound, 3xTF32 over the least work (the scores once per group) or
    the bytes, whichever is the larger; the CUDA-core kernel's time on the
    same inputs; the plain version's, the glue's (``ops.ssd_chunked`` less
    K3) and K3's share of the path's prefill."""
    from repro_torch.kernels import ops, ref, ssd_scan

    shape = K3_PATH_SHAPE
    b, s, h, p, g, n, q = shape
    args = k3_inputs(torch, shape, torch.float32, seed=5)
    errs, err = k3_errs(torch, args, q)
    cc_got = ssd_scan.ssd_chunk_cuda_core(*args, chunk=q)
    want = ref.ssd_chunk_reference(*args, chunk=q)
    tc_got = ssd_scan.ssd_chunk(*args, chunk=q)
    torch.cuda.synchronize()
    cc_errs = {o: row_err(a, c) for o, a, c in zip(K3_OUTS, cc_got, want)}
    cc_err = max(abs_err(a, c) for a, c in zip(cc_got, want))
    tc_vs_cc = {o: row_err(a, c) for o, a, c in zip(K3_OUTS, tc_got, cc_got)}
    del cc_got, want, tc_got
    bad = [(k, o, e) for k, es in (("ssd_chunk", errs),
                                   ("ssd_chunk_cuda_core", cc_errs))
           for o, e in es.items() if not e <= K3_TOL["float32"][o]]
    if bad:
        raise AssertionError(f"K3 at the path's shape differs from its plain "
                             f"version: {bad}")
    n_rep = 20
    ms = timed(lambda: ssd_scan.ssd_chunk(*args, chunk=q), n_rep, torch)
    cc_ms = timed(lambda: ssd_scan.ssd_chunk_cuda_core(*args, chunk=q), 10,
                  torch)
    ms_again = timed(lambda: ssd_scan.ssd_chunk(*args, chunk=q), n_rep,
                     torch)
    plain_ms = timed(lambda: ref.ssd_chunk_reference(*args, chunk=q), 3,
                     torch)
    chunked_ms = timed(lambda: ops.ssd_chunked(*args, chunk=q), n_rep, torch)

    name = torch.cuda.get_device_name(0)
    hbm, _, _, tf32, label = card_peaks(name)
    least, done = k3_work(shape, ssd_scan.SLAB_HEADS)
    nc, el = s // q, 4
    nbytes = (2 * b * s * h * p * el + b * s * h * 4 + h * 4
              + 2 * b * s * g * n * el + b * nc * h * (n * p + q + 1) * 4)
    t_ops, t_bytes = 3 * least / tf32, nbytes / hbm
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    per_prefill = launches["ssd_chunk"]
    emit({"phase": "k3_at_path_shape", "shape": shape, "dtype": "float32",
          "row_err": errs, "max_abs_err": err,
          "cuda_core_row_err": cc_errs, "tc_vs_cuda_core_row_err": tc_vs_cc,
          "ms": ms, "ms_again": ms_again, "cuda_core_ms": cc_ms,
          "speedup_over_cuda_core": cc_ms / ms,
          "slab_heads": ssd_scan.SLAB_HEADS, "flops_least": least,
          "flops_kernel": done, "tensor_core_flops_issued": 3 * done,
          "achieved_TFLOPs": least / ms / 1e9,
          "cuda_core_achieved_TFLOPs": least / cc_ms / 1e9,
          "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_share": bound_ms / ms, "peak": label + " (TF32 dense)",
          "plain_ms": plain_ms, "ssd_chunked_ms": chunked_ms,
          "glue_ms": chunked_ms - ms,
          "launches_per_prefill": per_prefill,
          "cuda_core_launches_per_prefill": launches["ssd_chunk_cuda_core"],
          "k3_share_of_prefill": per_prefill * ms / prefill_ms,
          "glue_share_of_prefill": per_prefill * (chunked_ms - ms)
          / prefill_ms, "card": smi})
    rows = []
    for kname, kms, kerr in (("ssd_chunk", ms, err),
                             ("ssd_chunk_cuda_core", cc_ms, cc_err)):
        src, replaces = KERNEL_SOURCES[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": kerr, "ms": kms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    return rows


# ---------------------------------------------------------------------------
# Slice 8: the paper's figures and the bidding service (no kernel of the
# reference lies on these paths; the device work is the engine's tick loop)
# ---------------------------------------------------------------------------

#: the reference benchmark's seeds per figure point (benchmarks/run.py)
FIG_SEEDS = 8
#: ticks of the warm-up call before a timed one: the same grid, enough to
#: pay every first use (cuBLAS, the allocator's pool) without the loop
WARMUP_TICKS = 16
#: figures_card_vs_cpu's grids: seeds of the stochastic one, iterations
#: per job of both
CARD_VS_CPU_SEEDS, CARD_VS_CPU_J = 64, 100
#: examples/scenario_sweep.py's grid, and the profiled window of its ticks
SWEEP = {"n1": 4, "n": 8, "J": 150, "seeds": 4, "ticks": 900,
         "profile_ticks": 100}


def fig_strategies(prob, eps, theta, n, dist, rt):
    """benchmarks/run.py's ``_strategies``, on the port's core."""
    from repro_torch.core import strategies as strat

    out = {
        "no-interruptions": strat.no_interruptions(prob, eps, n, dist, rt),
        "optimal-one-bid": strat.optimal_one_bid(prob, eps, theta, n, dist,
                                                 rt),
        "optimal-two-bids": strat.optimal_two_bids(prob, eps, theta, n, dist,
                                                   rt, n1=n // 2),
        "dynamic-bids": strat.DynamicBids(
            prob, eps, theta, dist, rt, stage1=(n // 4, n // 2),
            stage2=(n // 2, n), switch_at=2),
    }
    dyn = out["dynamic-bids"]
    dyn.switch_at = max(2, int(0.4 * dyn.total_iterations))
    return out


def fig_calibration(dist):
    """benchmarks/run.py's ``_calibration``: (quad, w0, prob, rt,
    strategies, eps_emp, n) for fig3/fig4."""
    from repro_torch.core import convergence as conv
    from repro_torch.core.cost_model import RuntimeModel
    from repro_torch.sim.evaluate import calibrated_quadratic

    quad, w0, prob, _batch = calibrated_quadratic()
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    n = 8
    eps = 5.0 * prob.B / (1 - prob.beta) / n
    j_min = conv.phi_inverse(prob, eps, 1.0 / n)
    theta = 3.0 * j_min * rt.expected(n)
    return (quad, w0, prob, rt, fig_strategies(prob, eps, theta, n, dist,
                                               rt), eps / 4, n)


def figure_setups():
    """The reference benchmark's fig3 (two i.i.d. markets), fig4 (the
    30-day synthetic trace, time-indexed), fig5a (Theorem 4's worker count
    against half and double it, q 0.5) and fig5b (static n 1 against
    dynamic η 1.002) as ``evaluate_batch`` calls (benchmarks/run.py
    :199-333): (tag, strategies, scenarios, keyword arguments, empirical
    error level or None)."""
    from repro_torch.core import convergence as conv
    from repro_torch.core import provisioning as prov
    from repro_torch.core import strategies as strat
    from repro_torch.core.cost_model import (RuntimeModel,
                                             TruncGaussianPrice,
                                             UniformPrice)
    from repro_torch.sim import engine
    from repro_torch.sim.evaluate import calibrated_quadratic
    from repro_torch.sim.spot_market import TracePrices, synthetic_history

    out = []
    for tag, dist in [("fig3_uniform", UniformPrice(0.2, 1.0)),
                      ("fig3_gaussian",
                       TruncGaussianPrice(0.6, 0.175, 0.2, 1.0))]:
        quad, w0, prob, rt, strategies, eps_emp, n = fig_calibration(dist)
        scenarios = [engine.scenario_from_strategy(
            s, alpha=prob.alpha, rt=rt, dist=dist, n_max=n,
            name=f"{name}@{tag}") for name, s in strategies.items()]
        out.append((tag, strategies, scenarios,
                    dict(quad=quad, w0=w0, alpha=prob.alpha, rt=rt,
                         batch=16), eps_emp))
    trace = synthetic_history(hours=24 * 30, seed=0)
    dist = TracePrices(trace, step=0.05).empirical_dist()
    quad, w0, prob, rt, strategies, eps_emp, n = fig_calibration(dist)
    spec = engine.PriceSpec.from_trace(trace, step=0.05)
    out.append(("fig4_trace", strategies, [engine.scenario_from_strategy(
        s, alpha=prob.alpha, rt=rt, n_max=n, price_spec=spec,
        name=f"{name}@fig4_trace") for name, s in strategies.items()],
        dict(quad=quad, w0=w0, alpha=prob.alpha, rt=rt, batch=16),
        eps_emp))
    quad, w0, prob, _ = calibrated_quadratic(label_noise=1.0)
    rt = RuntimeModel(kind="det", r_const=1.0)
    q5 = dict(quad=quad, w0=w0, alpha=prob.alpha, rt=rt, q=0.5,
              on_demand_price=0.5, batch=1, idle_step=0.1)
    plan = prov.optimal_n_and_j(prob, 0.5, 2000, d=1.0 / (1 - 0.5))
    choices = {
        "theorem4": strat.StaticWorkers(plan),
        "half-n": strat.StaticWorkers(prov.ProvisionPlan(
            n=max(1, plan.n // 2), J=plan.J, expected_error=0,
            cost_proxy=0)),
        "double-n": strat.StaticWorkers(prov.ProvisionPlan(
            n=plan.n * 2, J=plan.J, expected_error=0, cost_proxy=0))}
    out.append(("fig5a", choices, {"q": None}, q5, 0.02))
    J_static, eta = 3000, 1.002
    runs = {"static_n1": strat.DynamicWorkers(n0=1, eta=1.0, J=J_static),
            "dynamic_eta": strat.DynamicWorkers(
                n0=1, eta=eta, J=conv.dynamic_iterations(J_static, eta,
                                                          chi=1.0))}
    out.append(("fig5b", runs, {"q": None}, q5, None))
    return out


def check_completed_finite(tag, r):
    """Every completed cell's trajectories, cost and clock are finite."""
    for s in range(r.errors.shape[0]):
        J = int(r.J[s])
        for k in np.flatnonzero(r.completed[s]):
            vals = [r.errors[s, k, :J], r.costs[s, k, :J], r.times[s, k, :J],
                    r.total_cost[s, k], r.total_time[s, k]]
            if not all(np.isfinite(v).all() for v in vals):
                raise AssertionError(f"{tag}: non-finite values in the "
                                     f"completed cell ({s}, {k})")


def phase_figures(torch):
    """Each figure through ``evaluate_batch`` on the card at the reference
    benchmark's set-up and the engine's default tick budget: a warm-up
    call on the same grid (``WARMUP_TICKS`` ticks), then a timed one."""
    from repro_torch.kernels import ops
    from repro_torch.sim.evaluate import evaluate_batch

    t_phase = time.perf_counter()
    out = {}
    for tag, strategies, scenarios, kw, eps_emp in figure_setups():
        def call(n_ticks=None):
            return evaluate_batch(strategies, scenarios, FIG_SEEDS,
                                  device="cuda", n_ticks=n_ticks, **kw)

        call(WARMUP_TICKS)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        bres = call()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        r = bres.result
        ticks = 4 * r.errors.shape[2] + 64
        check_completed_finite(tag, r)
        rows = {}
        for label in bres.names:
            run = bres.run(label)
            row = {"J": int(r.J[bres.index(label)]),
                   "completed": run.summary["completed"],
                   "cost": [run.summary["cost_mean"], run.summary["cost_ci"]],
                   "final_err": [run.summary["final_err_mean"],
                                 run.summary["final_err_ci"]]}
            if eps_emp is not None:
                c, ci, _ = bres.cost_to_error(label, eps_emp)
                row["cost_to_err"] = [c, ci]
            rows[label.split("@")[0]] = row
        out[tag] = {"cells": int(r.iterations.size), "ticks": ticks,
                    "wall_s": wall, "ticks_per_s": ticks / wall,
                    "cell_ticks_per_s": ticks * r.iterations.size / wall,
                    "completed_share": float(r.completed.mean()),
                    "eps_emp": eps_emp, "launches": launches,
                    "strategies": rows}
        if set(launches.values()) - {0}:
            raise AssertionError(f"{tag}: kernel launches {launches} on a "
                                 "path that runs none")
        if tag == "fig3_uniform":
            fig3 = (strategies, scenarios, kw, bres)
    emit({"phase": "figures", "phase_s": time.perf_counter() - t_phase,
          "seeds": FIG_SEEDS, **out})
    return fig3


def phase_figures_card_vs_cpu(torch):
    """An RNG-free grid (a one-bid, a two-bid and a preemptible plan with
    q 0 over a tick-indexed U(0.2, 1) trace, a deterministic runtime, the
    exact gradient) on the card and on the CPU: iterations, active counts,
    cost and time equal, errors within rtol 1e-5. Then a stochastic grid
    (the two bid plans under uniform prices, exp runtimes, minibatch
    gradients) on both: mean final error and mean cost within 4 standard
    errors."""
    from repro_torch.sim import engine
    from repro_torch.sim.evaluate import calibrated_quadratic, evaluate_batch

    t_phase = time.perf_counter()
    quad, w0, prob, _ = calibrated_quadratic()
    J = CARD_VS_CPU_J
    trace = np.random.default_rng(7).uniform(0.2, 1.0, 4096).astype(
        np.float32)
    bids = [("one-bid", [0.6] * 8), ("two-bids", [0.9] * 4 + [0.45] * 4)]
    free = [engine.Scenario(price=engine.PriceSpec.from_trace_ticks(trace),
                            alpha=prob.alpha, bid_schedule=np.tile(b_, (J, 1)),
                            rt_kind="det", rt_const=1.0, idle_step=0.5,
                            name=name) for name, b_ in bids]
    free.append(engine.Scenario(
        price=engine.PriceSpec.uniform(0.0, 1.0), alpha=prob.alpha,
        worker_schedule=np.full(J, 6), preempt_q=0.0, on_demand_price=0.5,
        rt_kind="det", rt_const=1.0, name="preemptible"))
    kw = dict(quad=quad, w0=w0, alpha=prob.alpha, grad="full")
    t0 = time.perf_counter()
    card = evaluate_batch({}, free, FIG_SEEDS, device="cuda", **kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = evaluate_batch({}, free, FIG_SEEDS, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    a, b = card.result, cpu.result
    equal = {f: bool(np.array_equal(getattr(a, f), getattr(b, f),
                                    equal_nan=True))
             for f in ("iterations", "ys", "costs", "times", "total_cost",
                       "total_time", "total_idle")}
    both = np.isfinite(a.errors) & np.isfinite(b.errors)
    nan_same = bool(np.array_equal(np.isnan(a.errors), np.isnan(b.errors)))
    rel = float(np.max(np.abs(a.errors[both] - b.errors[both])
                       / np.maximum(np.abs(b.errors[both]), 1e-30)))

    scs = [engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0),
                           alpha=prob.alpha, bid_schedule=np.tile(b_, (J, 1)),
                           rt_kind="exp", rt_lam=2.0, rt_delta=0.05,
                           idle_step=0.5, name=name) for name, b_ in bids]
    stoch = {}
    for dev in ("cuda", "cpu"):
        res = evaluate_batch({}, scs, CARD_VS_CPU_SEEDS, quad=quad, w0=w0,
                             alpha=prob.alpha, batch=16, device=dev).result
        stoch[dev] = (res.errors[:, :, J - 1], res.total_cost,
                      res.completed)
    stats = {}
    ok_stat = True
    for name, k in (("final_err", 0), ("cost", 1)):
        x, y = stoch["cuda"][k], stoch["cpu"][k]
        se = np.sqrt(x.var(1, ddof=1) / x.shape[1]
                     + y.var(1, ddof=1) / y.shape[1])
        gap = np.abs(x.mean(1) - y.mean(1))
        ok_stat &= bool((gap <= 4 * se).all())
        stats[name] = {"card_mean": x.mean(1).tolist(),
                       "cpu_mean": y.mean(1).tolist(),
                       "gap_over_se": (gap / np.maximum(se, 1e-30)).tolist()}
    completed = bool(stoch["cuda"][2].all() and stoch["cpu"][2].all())
    emit({"phase": "figures_card_vs_cpu",
          "phase_s": time.perf_counter() - t_phase,
          "rng_free": {"cells": int(a.iterations.size),
                       "ticks": 4 * a.errors.shape[2] + 64,
                       "card_s": card_s, "cpu_s": cpu_s, "equal": equal,
                       "nan_at_same_places": nan_same,
                       "errors_max_rel": rel,
                       "completed_share": float(a.completed.mean())},
          "stochastic": {"seeds": CARD_VS_CPU_SEEDS, "J": J,
                         "completed": completed, **stats}})
    if not (all(equal.values()) and nan_same and rel <= 1e-5):
        raise AssertionError(f"figures_card_vs_cpu: RNG-free grid differs "
                             f"(equal {equal}, errors rel {rel})")
    if not (ok_stat and completed):
        raise AssertionError(f"figures_card_vs_cpu: stochastic grid "
                             f"outside 4 SE or incomplete: {stats}")


def sweep_grid():
    """examples/scenario_sweep.py's 200 two-bid scenarios (20 high bids ×
    10 low/high ratios, 4 workers on each), on the port."""
    from repro_torch.core.cost_model import RuntimeModel, UniformPrice
    from repro_torch.data.synthetic import QuadraticProblem
    from repro_torch.sim import engine

    quad = QuadraticProblem(dim=10, n_samples=256, cond=8.0, noise=0.3,
                            label_noise=1.0, seed=0)
    w0 = quad.w_star + 2.0 * np.ones(quad.dim) / np.sqrt(quad.dim)
    dist = UniformPrice(0.2, 1.0)
    n, n1, J = SWEEP["n"], SWEEP["n1"], SWEEP["J"]
    idle = RuntimeModel(kind="exp", lam=2.0, delta=0.05).expected(n)
    scenarios = []
    for b1 in np.linspace(0.35, 1.0, 20):
        for r in np.linspace(0.0, 1.0, 10):
            b2 = dist.lo + r * (b1 - dist.lo)
            bids = np.concatenate([np.full(n - n1, b1), np.full(n1, b2)])
            scenarios.append(engine.Scenario(
                price=engine.PriceSpec.uniform(dist.lo, dist.hi),
                alpha=0.5 / quad.L, bid_schedule=np.tile(bids, (J, 1)),
                rt_kind="exp", rt_lam=2.0, rt_delta=0.05, idle_step=idle,
                name=f"b1={b1:.2f},b2={b2:.2f}"))
    return quad, w0, scenarios


def device_profile(torch, fn):
    """(device busy ms, device operations, the five that take the most
    time) of ``fn()`` under ``torch.profiler``; "not measured" when the
    profiler records no device rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    rows = [r for r in rows if r[2] > 0]
    if not rows:
        return "not measured", 0, []
    top = sorted(rows, key=lambda r: -r[2])[:5]
    return (sum(r[2] for r in rows) / 1e3, sum(r[1] for r in rows),
            [(k[:60], c, t / 1e3) for k, c, t in top])


def phase_sweep(torch):
    """examples/scenario_sweep.py's grid on the card (200 scenarios × 4
    seeds, J 150, 900 ticks, batch 1): a warm-up call, a timed one, then a
    window of ticks under ``torch.profiler`` beside the same window
    unprofiled: how much of the tick loop's wall time the device is busy.
    The warm-up call runs ``WARMUP_TICKS`` ticks of the same grid."""
    from repro_torch.kernels import ops
    from repro_torch.sim import engine

    t_phase = time.perf_counter()
    quad, w0, scenarios = sweep_grid()
    cfg = engine.SimConfig(n_ticks=SWEEP["ticks"], batch=1)

    def call(c):
        return engine.simulate(scenarios, quad, w0, SWEEP["seeds"], c,
                               device="cuda")

    call(engine.SimConfig(n_ticks=WARMUP_TICKS, batch=1))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = call(cfg)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_completed_finite("sweep", res)
    window = engine.SimConfig(n_ticks=SWEEP["profile_ticks"], batch=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(window)
    torch.cuda.synchronize()
    window_ms = 1e3 * (time.perf_counter() - t0)
    busy, n_ops, top = device_profile(torch, lambda: call(window))
    ticks = SWEEP["profile_ticks"]
    emit({"phase": "sweep", "phase_s": time.perf_counter() - t_phase,
          "scenarios": len(scenarios),
          "seeds": SWEEP["seeds"], "J": SWEEP["J"], "ticks": SWEEP["ticks"],
          "cells": int(res.iterations.size), "wall_s": wall,
          "ticks_per_s": SWEEP["ticks"] / wall,
          "ms_per_tick": 1e3 * wall / SWEEP["ticks"],
          "completed_share": float(res.completed.mean()),
          "launches": launches,
          "profile": {"ticks": ticks, "wall_ms_unprofiled": window_ms,
                      "device_busy_ms": busy,
                      "device_idle_share": (1 - busy / window_ms
                                            if n_ops else "not measured"),
                      "device_ops": n_ops,
                      "device_ops_per_tick": n_ops / ticks,
                      "top5_ms": top}})
    if set(launches.values()) - {0}:
        raise AssertionError(f"sweep: kernel launches {launches}")


def phase_resume(torch, fig3):
    """The fig3-uniform grid run straight through (the figures phase's
    timed call) against the same grid as two halves: the first half with
    one snapshot at its end, ``snapshot_state``, then the rest from its
    tick. Bit for bit on the card."""
    from repro_torch.sim import engine

    strategies, scenarios, kw, straight = fig3
    r = straight.result
    n_ticks = 4 * r.errors.shape[2] + 64
    half = n_ticks // 2
    batch = engine.stack_scenarios(scenarios, device="cuda")
    quad = engine.torch_quadratic(kw["quad"], "cuda")
    program = engine.quadratic_program("minibatch", kw["batch"])
    w0 = torch.as_tensor(np.asarray(kw["w0"], np.float32), device="cuda")
    t0 = time.perf_counter()
    first = engine.simulate_program(
        batch, program, w0, quad, FIG_SEEDS,
        engine.SimConfig(n_ticks=half, batch=kw["batch"],
                         snapshot_every=half), device="cuda")
    state, tick = engine.snapshot_state(first, -1)
    second = engine.simulate_program(
        batch, program, None, quad, FIG_SEEDS,
        engine.SimConfig(n_ticks=n_ticks, batch=kw["batch"]),
        init_state=state, tick0=tick, device="cuda")
    wall = time.perf_counter() - t0
    equal = {f: bool(np.array_equal(getattr(second, f), getattr(r, f),
                                    equal_nan=True))
             for f in ("errors", "costs", "times", "ys", "iterations",
                       "total_time", "total_cost", "total_idle")}
    equal["final_model"] = bool(torch.equal(second.final_model,
                                            r.final_model))
    unfinished = int((first.iterations < first.J[:, None]).sum())
    emit({"phase": "resume", "grid": "fig3_uniform",
          "cells": int(r.iterations.size), "ticks": n_ticks,
          "split_at_tick": tick, "cells_unfinished_at_split": unfinished,
          "wall_s_two_halves": wall, "bit_equal": equal})
    if not all(equal.values()) or unfinished == 0:
        raise AssertionError(f"resume: two halves differ from the straight "
                             f"run {equal} (unfinished cells at the split: "
                             f"{unfinished})")


def phase_bidserve(torch):
    """``python -m repro_torch.launch.bidserve`` at its defaults (2 jobs, 2
    markets, 416 ticks, horizon 32, warm-up 32, 2 scoring seeds) on the
    card, twice: the report must repeat bit for bit (latencies aside)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import bidserve

    reports, walls = [], []
    for _ in range(2):
        args = bidserve.build_parser().parse_args([])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reports.append(bidserve.run(args))
        walls.append(time.perf_counter() - t0)
        launches = ops.launch_counts()
        if set(launches.values()) - {0}:
            raise AssertionError(f"bidserve: kernel launches {launches}")

    def strip(rep):
        rep = {"decisions": [dict(d) for d in rep["decisions"]],
               "summary": dict(rep["summary"]), "static": rep["static"]}
        for d in rep["decisions"]:
            d.pop("replan_latency_s")
        for k in ("replan_p50_ms", "replan_p95_ms", "decisions_per_sec"):
            rep["summary"].pop(k)
        return json.dumps(rep, sort_keys=True)

    same = strip(reports[0]) == strip(reports[1])
    s = reports[1]["summary"]
    jobs = {name: {k: j[k] for k in ("completed", "deadline_met",
                                     "iterations", "target_J", "cost",
                                     "final_error", "regret_vs_hindsight",
                                     "regret_vs_static_paper")}
            for name, j in s["jobs"].items()}
    emit({"phase": "bidserve", "phase_s": sum(walls),
          "command": "python -m "
          "repro_torch.launch.bidserve", "wall_s": walls,
          "replans": s["horizons"], "decisions": s["decisions"],
          "replan_p50_ms": s["replan_p50_ms"],
          "replan_p95_ms": s["replan_p95_ms"],
          "decisions_per_sec": s["decisions_per_sec"], "jobs": jobs,
          "bit_reproducible": same})
    if not same:
        raise AssertionError("bidserve: a second run with the same seed "
                             "gave another report")
    if not all(j["completed"] and j["final_error"] is not None
               for j in jobs.values()):
        raise AssertionError(f"bidserve: a job did not finish: {jobs}")


def free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    t_main = time.perf_counter()
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
    phase_k2_small(torch)
    phase_k3_small(torch)
    res, job, launches = phase_main_path(torch)
    phase_steady_step(torch, res, job)
    k1 = phase_kernel_at_main_shape(torch, res, smi, launches)
    del res
    free(torch)
    zres, zjob, zlaunches = phase_zoo_path(torch)
    tick_ms = phase_zoo_steady(torch, zres, zjob)
    cells = int(zres.iterations.size)
    del zres
    free(torch)
    phase_k2_in_place(torch, zjob)
    free(torch)
    k2 = phase_k2_at_path_shape(torch, smi, zlaunches, tick_ms / cells,
                                zjob.model.num_layers)
    free(torch)
    cfg, params, prompt, tokens, caches, run = phase_serve_path(torch)
    phase_serve_profile(torch, cfg, params, prompt, run)
    phase_k3_in_place(torch, cfg, params, prompt, tokens, caches)
    del params, caches
    free(torch)
    k3 = phase_k3_at_path_shape(torch, smi, run["launches_prefill"],
                                run["prefill_ms"])
    free(torch)
    fig3 = phase_figures(torch)
    phase_figures_card_vs_cpu(torch)
    phase_sweep(torch)
    phase_resume(torch, fig3)
    phase_bidserve(torch)
    emit({"phase": "total", "seconds": time.perf_counter() - t_main})
    emit({"kernels": [k1] + k2 + k3})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0

if __name__ == "__main__":
    sys.exit(main())
