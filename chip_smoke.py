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
   fig5b, the latter at half the benchmark's 3000 static iterations; 8
   seeds, the engine's default tick budget; a 16-tick warm-up
   call on the same grid, then a timed one), checking that every
   completed cell is finite; one RNG-free grid on the card and the CPU
   (equal accounting, errors within rtol 1e-5) and a stochastic one (64
   seeds, within 4 standard errors);
   ``examples/scenario_sweep.py``'s 200 × 4 grid, timed and with a window
   of ticks under ``torch.profiler`` (the device's busy time and idle
   share); the fig3-uniform grid in two parts (its first 480 ticks, then
   the rest) through ``snapshot_every``, ``snapshot_state`` and
   ``tick0``, bit for bit the straight run; and ``python -m
   repro_torch.launch.bidserve`` at its defaults, twice, the second time
   through ``--mesh 1``, the second report bit for bit the first;
7. slice 9's path, durable training (the free disk space of the run
   directory checked first; the directory removed at the end): InternVL2-1B
   as published (24 layers, bf16 with float32 masters and momentum, K2 at
   B 8, S = T = 1023, H 14, Hkv 2, D 64), one scenario × one seed, 24
   ticks, built from one ``WorkerSpec`` by ``launch.workload``:
   ``train_zoo`` without a checkpoint (K2's tensor-core kernels 24 × 24
   times each, finite losses, the first near ln V, the final carry copied
   to the host); K2 at that path's shape, each backward kernel held against
   its plain version on its own inputs (the forward's bf16 output and lse);
   ``train_zoo(checkpoint_path=, save_every=8, keep_last=2)`` (its final
   carry and its newest step through ``restore_newest`` bit for bit the
   first run's; save and restore rates, durability's overhead);
   ``python -m repro_torch.launch.supervisor`` over the same spec with a
   kill at tick 8, a torn step 16, a NaN carry and two failing writes at
   16 (two restarts, a rollback, the torn step quarantined, ticks lost
   within ``save_every`` a dying fault, the worker on the card through
   K2, the newest step bit for bit the first run's final carry; wall
   seconds, MTTR, bytes written); and the reduced Qwen2-7B megabatch grid
   through K1 snapshotted mid-way, saved, restored and resumed, bit for
   bit the straight run;
8. slice 10's path, serving the decoder-only transformer at full width in
   bf16 (parameters, activations and caches; no kernel of the repo lies
   on it, and each run's launch counts must stay 0): Qwen2-7B as
   published (``serve_dense``) and DeepSeek-V2-Lite as the repo's config
   gives it (MLA's latent cache, 64 routed experts top-6 plus 2 shared;
   ``serve_moe_mla``), each through ``prefill_prompt`` (batch 8, a
   2048-token prompt) and ``greedy_decode`` (32 generated tokens), twice.
   Checks the tokens' range and their bit-equality across the two runs,
   finite caches whose positions hold 0..2078, finite prefill logits
   whose argmax is the first token, and prefill-then-decode against one
   longer prefill (2048 + 32 against 2080 positions; in bf16, and in
   float32 at depth 2); reports set-up seconds, prefill and decode times,
   tokens per second, peak memory and cache bytes, one decode step under
   ``torch.profiler``, and for DeepSeek-V2-Lite its latent cache beside
   a full K/V cache and the share of routed assignments that capacity
   drops in the prefill and in a decode step;
9. slice 11's serving of the hybrid (``serve_hybrid``): Zamba2-7B at full
   width and depth in bf16 through ``prefill_prompt`` (batch 8, a
   2048-token prompt: K3 once per Mamba2 layer, 81 times, the SSD's
   training route never) and ``greedy_decode`` (32 tokens, no kernel),
   twice; tokens in range and bit-equal across the runs, finite caches,
   KV positions 0..2078; one prefill and one decode step under
   ``torch.profiler``; K3 in place (the first Mamba2 layer's block with K3
   and with the plain version); prefill-then-decode against one longer
   prefill (reported in bf16 at full depth, held in float32 at depth 7);
   then K3 at the path's shape in bf16 (112 heads of one group, N 64):
   its time beside its bound and the plain version's;
10. slice 11's training of the hybrid (``train_hybrid``): ``train_zoo``
   of Zamba2-7B at full width, depth 12 (two super-groups), bf16 with K2,
   ``remat="full"``, batch 8, seq 1024, 4 ticks: K2's tensor-core forward
   twice a site and tick (the recompute), its backward once, the SSD's
   training route twice a Mamba2 layer, K3 never; finite losses, the
   first near ln V; one loss-and-gradient step under "full", "none" and
   "dots" at batch 2, bit-equal, with each mode's counts, time and peak;
   K2 at the path's shape (B 8, S = T = 1023, H = Hkv = 32, D 112 padded
   to 128);
11. slice 11's enc-dec: ``train_zoo`` of Whisper-base as published (bf16,
   K2 non-causal in the encoder and causal in the decoder, batch 8, 1500
   frames, 448 tokens, 4 ticks) with K2's launches held; K2 at the
   encoder's shape (S = T = 1500, H 8, D 64, non-causal) against its
   plain version, timed beside its bound and SDPA's; serving through
   ``model_zoo.prefill`` with the frames (the cross cache, K2 six times)
   and 31 serve steps, twice;
12. slice 12's scenario mesh (``sim.engine.simulate_sharded``; shards of
   a ``launch.mesh.Mesh`` that lists the one card more than once run in
   turn): slice 1's grid twice more, through ``launch/train.py ...
   --mesh 1`` and through ``run_batched(mesh=)`` with its two seeds in two
   shards, held against phase 3's run (a digest of its final carry taken
   before K1 was timed on it): K1 once per shard and tick, ms per tick
   and peak memory beside phase 3's (the two shards' peak within 1.1×),
   the market bit for bit, the losses and carry bit for bit or within
   tests/test_torch_megabatch.py's tolerance with the largest difference
   printed; K1 at the shard's shape (1, P) against its plain version; the
   fig3-uniform grid's first 480 ticks in three shards (2 + 1 + 1
   scenarios), bit for bit phase 6's first part; ``score_requests`` of
   four jobs' slates over two shards, bit for bit unsharded; the reduced
   megabatch grid through ``train_batched_durable(mesh=, save_shards=2)``
   killed before a save, restored and resumed unsharded, bit for bit the
   straight run.

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
    # what the mesh phase holds its runs of the same argv against: the
    # trajectories, and a digest of the final carry (K1's timing below
    # updates the carry in place)
    main = {"n_ticks": n_ticks, "run_s": run_s, "peak_mem_bytes": peak,
            "trajectories": {f: getattr(r, f) for f in TRAJECTORIES},
            "digest": carry_digests(torch, r.final_model)}
    return res, job, launches, main


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
    model = res.result.final_model
    row = k1_at_shape(torch, model["p"].view(-1, model["p"].shape[-1]),
                      model["v"].view(-1, model["v"].shape[-1]), smi,
                      "kernel_at_main_shape")
    src, replaces = KERNEL_SOURCES["elastic_sgd_update"]
    return {"name": "elastic_sgd_update", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches["elastic_sgd_update"], **row,
            "library_ms": None}


def k1_at_shape(torch, p, v, smi, phase):
    """K1 on rows ``p``, ``v`` (R, P) of a run's final carry, updated in
    place: bit for bit against its plain version, its time beside its
    bound, the plain version's time and a device-to-device copy rate.
    Returns the kernel line's measured keys."""
    from repro_torch.kernels import ops, ref

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
    emit({"phase": phase, "kernel": "elastic_sgd_update",
          "R": r, "P": n, "bit_exact": True, "max_abs_err": err,
          "ms": ms, "achieved_GBps": nbytes / ms / 1e6,
          "bound_ms": bound_ms, "peak": label, "plain_ms": plain_ms,
          "copy_ms": copy_ms, "copy_GBps": 2 * 4 * r * n / copy_ms / 1e6,
          "card": smi})
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if nbytes / hbm >= flops / f32
            else "operations"}


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
    on, loss_on, _ = make_loss_grad(job.model, job, "none")(params, batch,
                                                            mask)
    off_cfg = job.model.with_(use_flash_attention=False)
    off, loss_off, _ = make_loss_grad(off_cfg, job, "none")(params, batch,
                                                            mask)

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


def k2_plain_grads(torch, qt, kt, vt, out, lse, dout, mask):
    """Plain versions of K2's backward kernels on their own inputs: dq, dk
    and dv in float32 from q, k, v, the forward's bf16 output and lse, and
    dO, with D_i = rowsum(dO∘O) formed from that bf16 output, as the
    kernels form it (autograd through the plain forward forms it from the
    float32 output). Layout (B, H, S, D) and (B, Hkv, T, D)."""
    from repro_torch.kernels import ref

    b, h, s, d = qt.shape
    hkv = kt.shape[1]
    g = h // hkv
    scale = d ** -0.5
    p = torch.exp(ref._masked_scores(qt, kt, **mask) - lse[..., None])
    k32 = kt.float().repeat_interleave(g, dim=1)
    v32 = vt.float().repeat_interleave(g, dim=1)
    do32 = dout.float()
    ds = p * (torch.einsum("bhsd,bhtd->bhst", do32, v32)
              - ref.mha_delta_reference(out, dout)[..., None])
    dq = torch.einsum("bhst,bhtd->bhsd", ds, k32) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qt.float()) * scale
    dv = torch.einsum("bhst,bhsd->bhtd", p, do32)
    return (dq, dk.view(b, hkv, g, -1, d).sum(2),
            dv.view(b, hkv, g, -1, d).sum(2))


def phase_k2_at_path_shape(torch, smi, launches, step_ms, n_layers,
                           shape=K2_PATH_SHAPE, phase="k2_at_path_shape",
                           per_kernel_plain=False, cuda_core=True):
    """K2 at a path's shape (by default the zoo path's), in the model
    layout it receives there: each kernel's time beside its bound, the
    plain version's and ``scaled_dot_product_attention``'s. The path runs
    the tensor-core forward, dK/dV and dQ kernels; with ``cuda_core`` the
    CUDA-core forward, dK/dV and dQ kernels are held and timed here in bf16
    beside them. A head_dim other than 64 or 128 runs, as on the path,
    zero-padded to the next of them (``pad_head_dim``) with the unpadded
    scale; the bound counts the unpadded work.

    The gradients are held against autograd through the plain forward, or
    with ``per_kernel_plain`` against `k2_plain_grads`: the plain version
    of each backward kernel on that kernel's own inputs (the bf16 output
    and lse), whose D_i is rounded as the kernels' is."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import ops, ref

    b, s, t, h, hkv, d = shape[:6]
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = k2_inputs(torch, shape, torch.bfloat16, seed=5)
    kern, plain = k2_both(torch, q, k, v, do, mask)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    # what the kernels receive on the path: padded when d is not 64 or 128
    qp, kp, vp, _ = flash.pad_head_dim(q, k, v)
    dop = F.pad(do, (0, qp.shape[-1] - d))
    qpt, kpt, vpt, dopt = (x.transpose(1, 2) for x in (qp, kp, vp, dop))
    scaled = dict(mask, scale=d ** -0.5)
    kernels = K2_KERNELS if cuda_core else K2_ZOO_KERNELS
    out, lse = flash.flash_fwd_tc(qpt, kpt, vpt, **scaled)
    if per_kernel_plain:
        plain = (plain[0],) + tuple(x.transpose(1, 2) for x in
                                    k2_plain_grads(torch, qt, kt, vt,
                                                   out[..., :d], lse, dot,
                                                   mask))
    delta = flash.flash_bwd_delta(out, dopt)
    d_err = delta_err(torch, delta, out, dopt)
    errs = {"flash_attention_fwd_tc": abs_err(kern[0], plain[0]),
            "flash_attention_bwd_dq_tc": abs_err(kern[1], plain[1]),
            "flash_attention_bwd_dkdv_tc": max(abs_err(kern[2], plain[2]),
                                               abs_err(kern[3], plain[3])),
            "flash_attention_bwd_delta": abs_err(
                delta, ref.mha_delta_reference(out, dopt))}
    rels = {n: row_err(a, c) for n, a, c in zip(K2_GRADS, kern, plain)}
    bad = k2_check(rels, "bfloat16", shape)
    if not d_err <= K2_DELTA_TOL:
        bad.append((shape, "bfloat16", "flash_attention_bwd_delta", d_err))
    off_path, cc = {}, {}
    if cuda_core:
        cuda_core_out, _ = flash.flash_fwd(qpt, kpt, vpt, **scaled)
        cc_dk, cc_dv = (x.transpose(1, 2)[..., :d] for x in
                        flash.flash_bwd_dkdv(qpt, kpt, vpt, out, lse, dopt,
                                             **scaled))
        cc_dq = flash.flash_bwd_dq(qpt, kpt, vpt, out, lse, dopt,
                                   **scaled).transpose(1, 2)[..., :d]
        cc_out = cuda_core_out.transpose(1, 2)[..., :d]
        errs.update({
            "flash_attention_fwd": abs_err(cc_out, plain[0]),
            "flash_attention_bwd_dq": abs_err(cc_dq, plain[1]),
            "flash_attention_bwd_dkdv": max(abs_err(cc_dk, plain[2]),
                                            abs_err(cc_dv, plain[3]))})
        off_path = {"flash_attention_fwd out": row_err(cc_out, plain[0]),
                    "flash_attention_bwd_dkdv dk": row_err(cc_dk, plain[2]),
                    "flash_attention_bwd_dkdv dv": row_err(cc_dv, plain[3]),
                    "flash_attention_bwd_dq dq": row_err(cc_dq, plain[1])}
        bad += [(shape, "bfloat16", n, e) for n, e in off_path.items()
                if not e <= K2_TOL["bfloat16"][n.split()[-1]]]
        cc = {"dkdv_tc_vs_cuda_core_row_err": max(row_err(kern[2], cc_dk),
                                                  row_err(kern[3], cc_dv)),
              "dq_tc_vs_cuda_core_row_err": row_err(kern[1], cc_dq)}
        del cuda_core_out, cc_out, cc_dk, cc_dv, cc_dq
    if bad:
        raise AssertionError(f"K2 at the path's shape differs from its plain "
                             f"version: {bad}")
    n = 10
    ms = {"flash_attention_fwd_tc": timed(
        lambda: flash.flash_fwd_tc(qpt, kpt, vpt, **scaled), 5 * n, torch),
        "flash_attention_bwd_delta": timed(
            lambda: flash.flash_bwd_delta(out, dopt), 5 * n, torch),
        "flash_attention_bwd_dkdv_tc": timed(
            lambda: flash.flash_bwd_dkdv_tc(qpt, kpt, vpt, out, lse, dopt,
                                            **scaled, delta=delta),
            5 * n, torch),
        "flash_attention_bwd_dq_tc": timed(
            lambda: flash.flash_bwd_dq_tc(qpt, kpt, vpt, out, lse, dopt,
                                          **scaled, delta=delta),
            5 * n, torch)}
    if cuda_core:
        ms.update({
            "flash_attention_fwd": timed(
                lambda: flash.flash_fwd(qpt, kpt, vpt, **scaled), n, torch),
            "flash_attention_bwd_dkdv": timed(
                lambda: flash.flash_bwd_dkdv(qpt, kpt, vpt, out, lse, dopt,
                                             **scaled), n, torch),
            "flash_attention_bwd_dq": timed(
                lambda: flash.flash_bwd_dq(qpt, kpt, vpt, out, lse, dopt,
                                           **scaled), n, torch)})

    def fwd_bwd(attend):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = attend(*leaves)
        torch.autograd.grad(o, leaves, do)

    fwd_bwd_ms = timed(lambda: fwd_bwd(lambda a, b_, c: ops.flash_mha(
        a, b_, c, **mask)), n, torch)

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
        a, b_, c, **mask), 3)
    plain_ms["flash_attention_bwd_delta"] = timed(
        lambda: ref.mha_delta_reference(out, dopt), n, torch)
    library_ms = split_times(lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, is_causal=causal, enable_gqa=True), n)
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
    for kname in kernels:
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
        if phase != "k2_at_path_shape":
            rows[-1]["path"] = phase
    fb_flops = sum(work[kk][0] for kk in K2_ZOO_KERNELS)
    out_line = {
        "phase": phase, "shape": shape, "dtype": "bfloat16",
        "padded_head_dim": qp.shape[-1], "valid_pairs": pairs,
        "row_err": rels, "off_path_row_err": off_path,
        "delta_rel_err": d_err, **cc, "peak": label,
        "kernels": {r["name"]: {kk: r[kk] for kk in
                                ("ms", "bound_ms", "plain_ms",
                                 "library_ms", "max_abs_err")}
                    for r in rows},
        "achieved_TFLOPs": {kk: work[kk][0] / ms[kk] / 1e9
                            for kk in kernels},
        "fwd_ms": ms["flash_attention_fwd_tc"],
        "dkdv_ms": ms["flash_attention_bwd_dkdv_tc"]
        + ms["flash_attention_bwd_delta"],
        "dq_ms": ms["flash_attention_bwd_dq_tc"], "fwd_bwd_ms": fwd_bwd_ms,
        "fwd_bwd_bound_ms": 1e3 * fb_flops / bf16,
        "plain_fwd_bwd_ms": sum(plain_ms[kk] for kk in (
            "flash_attention_fwd_tc", "flash_attention_bwd_dkdv_tc",
            "flash_attention_bwd_dq_tc")),
        "library_fwd_ms": library_ms["flash_attention_fwd"],
        "share_of_zoo_cell_step": fwd_bwd_ms * n_layers / step_ms,
        "card": smi}
    if cuda_core:
        out_line.update(
            cuda_core_fwd_ms=ms["flash_attention_fwd"],
            fwd_speedup_over_cuda_core=ms["flash_attention_fwd"]
            / ms["flash_attention_fwd_tc"],
            cuda_core_dkdv_ms=ms["flash_attention_bwd_dkdv"],
            dkdv_speedup_over_cuda_core=ms["flash_attention_bwd_dkdv"]
            / ms["flash_attention_bwd_dkdv_tc"],
            cuda_core_dq_ms=ms["flash_attention_bwd_dq"],
            dq_speedup_over_cuda_core=ms["flash_attention_bwd_dq"]
            / ms["flash_attention_bwd_dq_tc"])
    emit(out_line)
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
    """(least FLOP, FLOP of the tensor-core kernel's products, the scores'
    share of the least FLOP) of K3 at ``shape``: the least work forms the
    scores once per (batch, chunk, group) over the causal pairs, y over
    them per head, and each state; the kernel forms the scores once per
    slab of ``slab`` heads and query tile over whole 64 x 64 key tiles at
    or below the diagonal (N in 32-column stages), y over whole tiles below
    it and, on a diagonal tile, over the 2560 pairs its four warps'
    8-column steps reach, the states over 64-row blocks of N; P padded to
    64 or 128. Useful products only: 3xTF32 issues three tensor-core
    products for each float32 one (two for bf16)."""
    b, s, h, p, g, n, q = shape
    nc, rep, t = s // q, h // g, -(-q // 64)
    pairs = q * (q + 1) // 2
    scores = b * nc * g * 2 * pairs * n
    least = scores + b * nc * h * (2 * pairs * p + 2 * q * n * p)
    slabs = g * -(-rep // min(slab, rep))
    tiles = t * (t + 1) // 2
    pw, n_kc, n_state = (64 if p <= 64 else 128), -(-n // 32), -(-n // 64)
    done = b * nc * (slabs * tiles * 64 * 64 * 2 * 32 * n_kc
                     + h * 2 * pw * ((tiles - t) * 64 * 64 + t * 2560
                                     + n_state * 64 * 64 * t))
    return least, done, scores


def phase_k3_at_path_shape(torch, smi, launches, prefill_ms,
                           shape=K3_PATH_SHAPE, dtype="float32",
                           phase="k3_at_path_shape", cuda_core=True):
    """K3 at a serving path's shape (by default Mamba2-1.3B's): the
    tensor-core kernel's time beside its bound, the plain version's, the
    glue's (``ops.ssd_chunked`` less K3) and K3's share of the path's
    prefill; with ``cuda_core`` the CUDA-core kernel's time on the same
    inputs. The bound is the larger of the bytes and the least work's
    products: float32 inputs 3xTF32 for every product; bf16 inputs the
    scores from the bf16 B and C at the bf16 rate, y and the states
    (float32 weights against exact bf16 x) two TF32 products each."""
    from repro_torch.kernels import ops, ref, ssd_scan

    b, s, h, p, g, n, q = shape
    args = k3_inputs(torch, shape, getattr(torch, dtype), seed=5)
    errs, err = k3_errs(torch, args, q)
    bad = [("ssd_chunk", o, e) for o, e in errs.items()
           if not e <= K3_TOL[dtype][o]]
    extra = {}
    if cuda_core:
        cc_got = ssd_scan.ssd_chunk_cuda_core(*args, chunk=q)
        want = ref.ssd_chunk_reference(*args, chunk=q)
        tc_got = ssd_scan.ssd_chunk(*args, chunk=q)
        torch.cuda.synchronize()
        cc_errs = {o: row_err(a, c) for o, a, c in zip(K3_OUTS, cc_got,
                                                        want)}
        cc_err = max(abs_err(a, c) for a, c in zip(cc_got, want))
        extra["cuda_core_row_err"] = cc_errs
        extra["tc_vs_cuda_core_row_err"] = {
            o: row_err(a, c) for o, a, c in zip(K3_OUTS, tc_got, cc_got)}
        del cc_got, want, tc_got
        bad += [("ssd_chunk_cuda_core", o, e) for o, e in cc_errs.items()
                if not e <= K3_TOL[dtype][o]]
    if bad:
        raise AssertionError(f"K3 at the path's shape {shape} ({dtype}) "
                             f"differs from its plain version: {bad}")
    n_rep = 20
    ms = timed(lambda: ssd_scan.ssd_chunk(*args, chunk=q), n_rep, torch)
    if cuda_core:
        cc_ms = timed(lambda: ssd_scan.ssd_chunk_cuda_core(*args, chunk=q),
                      10, torch)
        extra.update(cuda_core_ms=cc_ms, speedup_over_cuda_core=cc_ms / ms)
    ms_again = timed(lambda: ssd_scan.ssd_chunk(*args, chunk=q), n_rep,
                     torch)
    plain_ms = timed(lambda: ref.ssd_chunk_reference(*args, chunk=q), 3,
                     torch)
    chunked_ms = timed(lambda: ops.ssd_chunked(*args, chunk=q), n_rep, torch)

    name = torch.cuda.get_device_name(0)
    hbm, _, bf16, tf32, label = card_peaks(name)
    least, done, scores = k3_work(shape, ssd_scan.SLAB_HEADS)
    nc, el = s // q, (4 if dtype == "float32" else 2)
    nbytes = (2 * b * s * h * p * el + b * s * h * 4 + h * 4
              + 2 * b * s * g * n * el + b * nc * h * (n * p + q + 1) * 4)
    t_ops = (3 * least / tf32 if dtype == "float32"
             else scores / bf16 + 2 * (least - scores) / tf32)
    t_bytes = nbytes / hbm
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    per_prefill = launches["ssd_chunk"]
    emit({"phase": phase, "shape": shape, "dtype": dtype,
          "row_err": errs, "max_abs_err": err, **extra,
          "ms": ms, "ms_again": ms_again,
          "slab_heads": ssd_scan.SLAB_HEADS, "flops_least": least,
          "flops_scores": scores, "flops_kernel": done,
          "achieved_TFLOPs": least / ms / 1e9,
          "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
          "bound_share": bound_ms / ms, "peak": label,
          "plain_ms": plain_ms, "ssd_chunked_ms": chunked_ms,
          "glue_ms": chunked_ms - ms,
          "launches_per_prefill": per_prefill,
          "k3_share_of_prefill": per_prefill * ms / prefill_ms,
          "glue_share_of_prefill": per_prefill * (chunked_ms - ms)
          / prefill_ms, "card": smi})
    rows = [("ssd_chunk", ms, err)]
    if cuda_core:
        rows.append(("ssd_chunk_cuda_core", cc_ms, cc_err))
    out = []
    for kname, kms, kerr in rows:
        src, replaces = KERNEL_SOURCES[kname]
        out.append({"name": kname, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[kname],
                    "max_abs_err": kerr, "ms": kms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None})
        if phase != "k3_at_path_shape":
            out[-1]["path"] = phase
    return out


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
#: (50: the profiler's trace of 100 ticks cost ≈ 35 s of the run's limit)
SWEEP = {"n1": 4, "n": 8, "J": 150, "seeds": 4, "ticks": 900,
         "profile_ticks": 50}
#: fig5b's static iterations: the reference benchmark's 3000, cut in half
#: to keep the whole script inside its time limit (the tick loop is
#: host-bound, so its time goes with the ticks, 4·J + 64, not the seeds)
FIG5B_J_STATIC = 1500


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
    dynamic η 1.002, at ``FIG5B_J_STATIC`` iterations) as
    ``evaluate_batch`` calls (benchmarks/run.py :199-333): (tag,
    strategies, scenarios, keyword arguments, empirical error level or
    None)."""
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
    J_static, eta = FIG5B_J_STATIC, 1.002
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
    timed call) against the same grid in two parts: the first
    ``RESUME_SPLIT_TICK`` ticks with one snapshot at their end,
    ``snapshot_state``, then the rest from its tick. Bit for bit on the
    card. Returns the first part's run (and what made it), which the mesh
    phase repeats in shards."""
    from repro_torch.sim import engine

    strategies, scenarios, kw, straight = fig3
    r = straight.result
    n_ticks = 4 * r.errors.shape[2] + 64
    split = RESUME_SPLIT_TICK
    batch = engine.stack_scenarios(scenarios, device="cuda")
    quad = engine.torch_quadratic(kw["quad"], "cuda")
    program = engine.quadratic_program("minibatch", kw["batch"])
    w0 = torch.as_tensor(np.asarray(kw["w0"], np.float32), device="cuda")
    t0 = time.perf_counter()
    first = engine.simulate_program(
        batch, program, w0, quad, FIG_SEEDS,
        engine.SimConfig(n_ticks=split, batch=kw["batch"],
                         snapshot_every=split), device="cuda")
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
    return {"batch": batch, "quad": quad, "program": program, "w0": w0,
            "cfg": engine.SimConfig(n_ticks=split, batch=kw["batch"],
                                    snapshot_every=split), "run": first}


def phase_bidserve(torch):
    """``python -m repro_torch.launch.bidserve`` at its defaults (2 jobs, 2
    markets, 416 ticks, horizon 32, warm-up 32, 2 scoring seeds) on the
    card, twice, the second time with ``--mesh 1`` (scoring through
    ``simulate_sharded`` on a one-card mesh): the report must repeat bit
    for bit (latencies aside)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import bidserve

    reports, walls = [], []
    for flags in ([], ["--mesh", "1"]):
        args = bidserve.build_parser().parse_args(flags)
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
          "repro_torch.launch.bidserve", "second_run_flags": ["--mesh", "1"],
          "wall_s": walls,
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


# ------------------------------------------------------------- slice 9

#: slice 9: InternVL2-1B as published (configs/internvl2_1b.py, arXiv:
#: 2404.16821; 24 layers, d_model 896, 14 q / 2 kv heads of 64, d_ff 4864,
#: vocab 151655, the 256-patch vision prefix), bf16 mixed precision with K2,
#: one scenario (four workers bidding 0.9, four 0.5) × one seed, 24 ticks
#: in chunks of 8, the two newest steps kept
DURABLE_SPEC = dict(
    arch="internvl2-1b", reduce_depth=24, param_dtype="bfloat16", zoo=True,
    overrides={"use_flash_attention": 1}, n_workers=8, global_batch=8,
    seq_len=1024, bids=((0.9, 0.9, 0.9, 0.9, 0.5, 0.5, 0.5, 0.5),),
    iterations=8, seeds=1, n_ticks=24, save_every=8, keep_last=2)
#: the supervised run's faults, at the chunk boundaries 8 and 16: a kill
#: before the first save; a torn step 16 (then a kill); a NaN carry and two
#: failing writes in the attempt that resumes from step 8
DURABLE_FAULTS = [dict(kind="kill", at_tick=8),
                  dict(kind="corrupt", at_tick=16, mode="truncate_shard"),
                  dict(kind="nan", at_tick=16),
                  dict(kind="io_error", at_tick=16, count=2)]
#: the durable phases' run directory, inside the checkout and removed at
#: the end; it holds the clean run's steps, then the supervised run's
DURABLE_DIR = os.path.join(ROOT, "_durable_run")
#: one carry per parameter: bf16 params, float32 master and momentum
DURABLE_BYTES_PER_PARAM = 10


def durable_workload():
    from repro_torch.launch.workload import WorkerSpec, build_workload

    spec = WorkerSpec(**DURABLE_SPEC)
    return (spec,) + tuple(build_workload(spec))


def carry_bits_equal(a: dict, b: dict) -> dict:
    """Leaf by leaf (keyed as the checkpoint keys them), whether two host
    copies of a carry hold the same bits; NaN and -0.0 compare as bits."""
    if set(a) != set(b):
        return {"keys": False}

    def bits(x):
        return np.ascontiguousarray(x).reshape(-1).view(np.uint8)

    return {k: a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            and np.array_equal(bits(a[k]), bits(b[k])) for k in a}


def zoo_losses(res):
    ran = res.iterations
    return [res.errors[s, k, :ran[s, k]] for s in range(ran.shape[0])
            for k in range(ran.shape[1])]


def phase_durable_disk(job):
    """The run directory's free space against the durable phases' peak:
    ``keep_last`` steps of the carry plus one being written."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import map_specs
    from repro_torch.tree import tree_leaves

    n_params = sum(tree_leaves(map_specs(
        lambda _, spec: math.prod(spec.shape),
        model_zoo.param_defs(job.model))))
    need = (DURABLE_SPEC["keep_last"] + 1) * DURABLE_BYTES_PER_PARAM \
        * n_params + (1 << 30)
    os.makedirs(DURABLE_DIR, exist_ok=True)
    free_b = shutil.disk_usage(DURABLE_DIR).free
    emit({"phase": "durable_disk",
          "dir": os.path.relpath(DURABLE_DIR, ROOT), "params": n_params,
          "free_bytes": free_b, "need_bytes": need})
    if free_b < need:
        raise AssertionError(
            f"durable phases: {free_b / 1e9:.1f} GB free under "
            f"{DURABLE_DIR}, {need / 1e9:.1f} GB needed ({n_params} "
            "parameters, the kept steps and one being written)")
    return n_params


def phase_durable_reference(torch):
    """``train_zoo`` of the durable workload in process, no checkpoint:
    K2's launches, the losses, time per tick and peak memory; returns the
    final carry copied to the host, keyed as a checkpoint keys it."""
    from repro_torch.kernels import ops
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import train_zoo

    spec, job, scenarios, seeds = durable_workload()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_zoo(job, scenarios, seeds, n_ticks=spec.n_ticks,
                    device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cells = int(res.iterations.size)
    per_kernel = job.model.num_layers * cells * spec.n_ticks
    want = {n: per_kernel if n in K2_ZOO_KERNELS else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"durable_reference: kernel launches "
                             f"{launches}, designed {want}")
    losses = zoo_losses(res)
    flat = [float(x) for row in losses for x in row]
    vocab = job.model.vocab_size
    if not flat or not all(math.isfinite(x) for x in flat) or \
            not abs(flat[0] - math.log(vocab)) < 3.0:
        raise AssertionError(f"durable_reference: losses {losses} (ln V = "
                             f"{math.log(vocab):.3f})")
    t0 = time.perf_counter()
    host = ckpt.host_snapshot(res.final_state).flat
    host_s = time.perf_counter() - t0
    carry_bytes = sum(a.nbytes for a in host.values())
    emit({"phase": "durable_reference", "entry": "trainer.train_zoo",
          "spec": DURABLE_SPEC, "cells": cells, "n_ticks": spec.n_ticks,
          "iterations": res.iterations.tolist(),
          "losses": [list(map(float, x)) for x in losses],
          "ln_V": math.log(vocab), "launches": launches, "run_s": run_s,
          "ms_per_tick": 1e3 * run_s / spec.n_ticks,
          "peak_mem_bytes": peak, "carry_bytes": carry_bytes,
          "carry_to_host_s": host_s})
    return host, run_s, launches


class _SaveClock:
    """Chunk hooks timing each save: ``before_save`` to ``after_save``."""

    def __init__(self):
        self.saves = []

    def before_save(self, tick):
        self._t = time.perf_counter()

    def after_save(self, tick, path):
        self.saves.append(time.perf_counter() - self._t)


def phase_durable_clean(torch, reference, ref_run_s):
    """The same workload through ``train_zoo(checkpoint_path=,
    save_every=8, keep_last=2)``, no faults: the final carry bit for bit
    the reference's, the newest step restored by ``restore_newest`` too;
    save and restore rates and durability's overhead."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import batched_init_state, train_zoo
    from repro_torch.train.zoo_program import init_zoo_state

    spec, job, scenarios, seeds = durable_workload()
    root = os.path.join(DURABLE_DIR, "clean", "ckpt")
    clock = _SaveClock()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_zoo(job, scenarios, seeds, n_ticks=spec.n_ticks,
                    checkpoint_path=root, save_every=spec.save_every,
                    keep_last=spec.keep_last, hooks=clock, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_equal = carry_bits_equal(ckpt.host_snapshot(res.final_state).flat,
                                 reference)
    del res
    free(torch)
    steps = ckpt.list_steps(root)
    path = ckpt.step_path(root, steps[-1])
    nbytes = os.path.getsize(path)
    like = batched_init_state(
        job, scenarios, seeds, device="cuda",
        model0=lambda: init_zoo_state(job.model, job, job.seed,
                                      device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, tick, _ = ckpt.restore_newest(root, like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del like
    restored_equal = carry_bits_equal(ckpt.host_snapshot(state).flat,
                                      reference)
    del state
    free(torch)
    save_s = float(np.mean(clock.saves))
    emit({"phase": "durable_clean", "entry": "trainer.train_zoo("
          "checkpoint_path=, save_every=8, keep_last=2)",
          "run_s": run_s, "reference_run_s": ref_run_s,
          "durability_overhead_pct": 100 * (run_s - ref_run_s) / ref_run_s,
          "saves": len(clock.saves), "save_s": clock.saves,
          "ckpt_bytes": nbytes, "save_GBps": nbytes / save_s / 1e9,
          "restore_s": restore_s, "restore_GBps": nbytes / restore_s / 1e9,
          "steps_kept": steps, "restored_tick": tick,
          "final_carry_bit_equal": all(run_equal.values()),
          "restored_bit_equal": all(restored_equal.values())})
    bad = [k for k, ok in {**run_equal, **{f"restored {k}": v for k, v in
                                           restored_equal.items()}}.items()
           if not ok]
    if bad or tick != spec.n_ticks or len(steps) != spec.keep_last:
        raise AssertionError(f"durable_clean: leaves differ from the "
                             f"reference run: {bad[:8]} (restored tick "
                             f"{tick}, steps {steps})")
    shutil.rmtree(os.path.join(DURABLE_DIR, "clean"))
    return {"save_s": save_s, "restore_s": restore_s, "bytes": nbytes}


def phase_supervised(torch, reference):
    """``python -m repro_torch.launch.supervisor`` over the durable
    workload with `DURABLE_FAULTS`: two restarts, a rollback, the torn step
    quarantined, ticks lost within ``save_every`` a fault, and the newest
    step bit for bit the reference's final carry; the worker ran on the
    card and launched K2."""
    from repro_torch.chaos import Fault, FaultPlan
    from repro_torch.launch import supervisor as sup
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import batched_init_state
    from repro_torch.train.zoo_program import init_zoo_state

    spec, job, scenarios, seeds = durable_workload()
    d = os.path.join(DURABLE_DIR, "supervised")
    os.makedirs(d)
    spec.save(os.path.join(d, sup.SPEC_NAME))
    FaultPlan(tuple(Fault(**f) for f in DURABLE_FAULTS), seed=20).save(
        os.path.join(d, sup.PLAN_NAME))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.supervisor",
           "--run-dir", d, "--max-restarts", "4", "--hang-timeout", "300",
           "--device", "cuda"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    wall = time.perf_counter() - t0
    logs = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("attempt_"):
            with open(os.path.join(d, name)) as f:
                logs[name] = f.read()
    if out.returncode != 0:
        raise AssertionError(f"supervised: exit {out.returncode}\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}\n"
                             + "\n".join(f"{k}: {v[-3000:]}"
                                         for k, v in logs.items()))
    with open(os.path.join(d, sup.RECOVERY_NAME)) as f:
        recovery = json.load(f)
    with open(os.path.join(d, sup.RESULT_NAME)) as f:
        result = json.load(f)
    summary = recovery["summary"]
    fired = [w["fault"] for w in recovery["worker_events"]]
    saves = [json.loads(line) for log in logs.values()
             for line in log.splitlines() if line.startswith('{"saved"')]
    root = os.path.join(d, sup.CKPT_DIRNAME)
    qdir = os.path.join(root, ckpt.QUARANTINE_DIRNAME)
    quarantined = sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []
    like = batched_init_state(
        job, scenarios, seeds, device="cuda",
        model0=lambda: init_zoo_state(job.model, job, job.seed,
                                      device="cuda"))
    state, tick, _ = ckpt.restore_newest(root, like)
    del like
    equal = carry_bits_equal(ckpt.host_snapshot(state).flat, reference)
    del state
    free(torch)
    per_kernel = job.model.num_layers * spec.n_ticks
    worker_k2 = {n: result["launches"].get(n) for n in K2_ZOO_KERNELS}
    emit({"phase": "supervised", "command": " ".join(cmd[1:]),
          "faults": DURABLE_FAULTS, "wall_s": wall, "summary": summary,
          "mttr_s": summary["mttr_s"], "ticks_lost": summary["ticks_lost"],
          "restarts": summary["restarts"], "worker_events": fired,
          "quarantined": quarantined, "saves": saves,
          "ckpt_bytes_written": sum(x["bytes"] for x in saves),
          "restored_tick": tick, "worker_device": result["device"],
          "worker_launches": result["launches"],
          "final_carry_bit_equal": all(equal.values())})
    problems = []
    if not (summary["ok"] and summary["restarts"] == 2
            and summary["final_tick"] == spec.n_ticks):
        problems.append(f"summary {summary}")
    if "rollback" not in fired or \
            summary["ticks_lost"] > 2 * spec.save_every:
        problems.append(f"events {fired}, ticks lost "
                        f"{summary['ticks_lost']}")
    if not quarantined:
        problems.append("no quarantined step")
    if result["device"] not in ("cuda", "cuda:0"):
        problems.append(f"worker device {result['device']}")
    if any(v != per_kernel for v in worker_k2.values()):
        problems.append(f"worker K2 launches {worker_k2}, designed "
                        f"{per_kernel} each")
    bad = [k for k, ok in equal.items() if not ok]
    if bad or tick != spec.n_ticks:
        problems.append(f"leaves differ from the reference run: {bad[:8]} "
                        f"(restored tick {tick})")
    if problems:
        raise AssertionError("supervised: " + "; ".join(problems))
    return summary


def phase_megabatch_resume(torch):
    """``train_batched(megabatch=True, use_fused_update=True)`` at the
    reduced Qwen2-7B config, snapshotted mid-way through its iterations
    (every cell unfinished), saved with
    ``save_batched``, restored with ``restore_batched(megabatch=True)``
    and resumed at its tick: bit for bit the uninterrupted run, with K1
    launched once a tick in both."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.train.trainer import (default_n_ticks, restore_batched,
                                           save_batched, train_batched)

    args = launch.parse_args(["--config", "qwen2_7b", "--batched",
                              "--megabatch", "--fused-update", "--seeds",
                              "2", "--iterations", "6", "--device", "cuda"])
    tr = launch.build_trainer(args)
    scenarios = [tr._scenario(tr.strategy, args.iterations, "s")]
    n_ticks = default_n_ticks(args.iterations)
    half = args.iterations // 2          # mid-way through the iterations
    kw = dict(megabatch=True, use_fused_update=True, device="cuda",
              batch_seed=tr.seed)
    path = os.path.join(DURABLE_DIR, "megabatch.npz")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    straight = train_batched(tr.job, scenarios, args.seeds,
                             n_ticks=n_ticks, snapshot_every=half, **kw)
    straight_k1 = ops.launch_counts()["elastic_sgd_update"]
    tick = save_batched(path, straight, index=0)
    state, tick_back = restore_batched(path, tr.job, scenarios, args.seeds,
                                       megabatch=True, device="cuda")
    ops.reset_launch_counts()
    resumed = train_batched(tr.job, scenarios, args.seeds, n_ticks=n_ticks,
                            init_state=state, tick0=tick_back, **kw)
    resumed_k1 = ops.launch_counts()["elastic_sgd_update"]
    wall = time.perf_counter() - t0
    equal = {f: bool(np.array_equal(getattr(resumed, f),
                                    getattr(straight, f), equal_nan=True))
             for f in ("errors", "costs", "times", "ys", "iterations",
                       "total_time", "total_cost", "total_idle")}
    equal.update({k: bool(torch.equal(resumed.final_model[k],
                                      straight.final_model[k]))
                  for k in ("p", "v")})
    unfinished = int((straight.snapshots.j[:, :, 0].cpu().numpy()
                      < straight.J[:, None]).sum())
    emit({"phase": "megabatch_resume", "config": "qwen2-7b reduced",
          "n_ticks": n_ticks, "split_at_tick": tick,
          "cells_unfinished_at_split": unfinished,
          "k1_launches": {"straight": straight_k1, "resumed": resumed_k1},
          "ckpt_bytes": os.path.getsize(path), "wall_s": wall,
          "bit_equal": equal})
    if not all(equal.values()) or tick != tick_back or unfinished == 0 \
            or straight_k1 != n_ticks or resumed_k1 != n_ticks - tick:
        raise AssertionError(f"megabatch_resume: {equal}, ticks {tick}/"
                             f"{tick_back}, unfinished {unfinished}, K1 "
                             f"{straight_k1}/{resumed_k1} of {n_ticks}/"
                             f"{n_ticks - tick}")


def phase_durable(torch, smi):
    """Slice 9's phases; returns the K2 rows at the durable path's shape.
    The run directory goes at the end, whatever happened."""
    spec, job, _, _ = durable_workload()
    try:
        phase_durable_disk(job)
        reference, ref_run_s, launches = phase_durable_reference(torch)
        free(torch)
        # the 256-patch prefix and the text's tokens after the shift
        s_total = spec.seq_len - 1
        shape = (spec.global_batch, s_total, s_total, job.model.num_heads,
                 job.model.num_kv_heads, job.model.resolved_head_dim, True,
                 None, 0)
        k2_rows = phase_k2_at_path_shape(
            torch, smi, launches, 1e3 * ref_run_s / spec.n_ticks,
            job.model.num_layers, shape=shape, phase="k2_at_durable_shape",
            per_kernel_plain=True)
        free(torch)
        phase_durable_clean(torch, reference, ref_run_s)
        free(torch)
        phase_supervised(torch, reference)
        del reference
        phase_megabatch_resume(torch)
        free(torch)
        return k2_rows
    finally:
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)


# ------------------------------------------------------------ slice 10

#: slice 10: serving the decoder-only transformer at full width in its
#: configs' own dtypes (bf16 parameters, activations and caches; positions
#: int32): Qwen2-7B as published (configs/qwen2_7b.py, arXiv:2407.10671;
#: 28 layers, d_model 3584, 28 q / 4 kv heads of 128, d_ff 18944, vocab
#: 152064, QKV bias) and DeepSeek-V2-Lite as the repo gives it
#: (configs/deepseek_v2_lite_16b.py, arXiv:2405.04434; 27 layers, d_model
#: 2048, 16 heads, MLA with kv_lora_rank 512 and rope 64, 64 routed experts
#: top-6 plus 2 shared), batch 8, a 2048-token prompt, 32 generated
#: tokens, weights and prompt drawn from the seed
SERVE_TF = {"archs": ("qwen2-7b", "deepseek-v2-lite-16b"), "batch": 8,
            "prompt": 2048, "gen": 32, "seed": 0}
#: prefill-then-decode against one longer prefill (2048 + 32 against 2080
#: positions): max |logit difference| over the largest |logit|. In bf16 at
#: full depth the two run the same function through GEMMs of other shapes
#: (M = 8 a decode step against M = 16,640), whose bf16 outputs round at
#: other places, and every layer's bf16 residual carries that on: 5e-2
#: for the dense model (measured on an H100: 1.7e-2). The MoE model's
#: bf16 error is reported, not held: rounding that differs flips its
#: near-tied top-6 of 64 experts for some tokens, a discrete change of
#: their hidden state (measured 0.24, top-1 agreement 87 %; the share of
#: routings that differ is reported beside it). Both are held in float32
#: at full width and depth 2 within the reference tests' 2e-3
#: (tests/test_prefill.py; measured 2.4e-5 and 2.0e-5).
TF_DECODE_TOL = {"bfloat16": 5e-2, "float32_abs": 2e-3}
#: the depth of the float32 prefill-then-decode check
TF_F32_DEPTH = 2


def tf_serve_model(torch, arch):
    """A served transformer: its full-width config, bf16 parameters on the
    card (the router float32, as its spec says) and the prompt, both from
    ``SERVE_TF["seed"]``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params

    cfg = get_config(arch)
    params = init_params(model_zoo.param_defs(cfg), SERVE_TF["seed"],
                         torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SERVE_TF["seed"])
    prompt = torch.randint(0, cfg.vocab_size,
                           (SERVE_TF["batch"], SERVE_TF["prompt"]),
                           generator=gen, device="cuda")
    return cfg, params, prompt


def tf_fresh_caches(torch, cfg):
    """A fresh cache tree for the served batch in the config's dtype:
    zeros, positions −1 (int32)."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params

    return init_params(
        model_zoo.cache_defs(cfg, SERVE_TF["batch"],
                             SERVE_TF["prompt"] + SERVE_TF["gen"]),
        SERVE_TF["seed"], cfg.resolved_param_dtype(), device="cuda")


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


@contextlib.contextmanager
def recorded_routes(record: list):
    """Within the block, every `moe._route` call appends its top-k expert
    indices to ``record``."""
    from repro_torch.models import moe

    route = moe._route

    def recording(x2d, router, moe_cfg):
        out = route(x2d, router, moe_cfg)
        record.append(out[0])
        return out

    moe._route = recording
    try:
        yield
    finally:
        moe._route = route


def tf_decode_vs_longer_prefill(torch, cfg, params, prompt, tokens):
    """The prefill's last logits and 31 decode steps fed the path's tokens,
    against one prefill of the 2080 tokens: the worst |difference|, the
    same over the largest |logit|, the share of positions whose argmax
    agrees where the longer prefill's top two differ, and for an MoE model
    the share of (layer, token) routings whose expert set differs between
    the decode steps and the longer prefill. The MoE model runs at a
    capacity of every token an expert (capacity_factor E / top_k): at the
    configured factor a decode step (capacity 1) drops assignments that a
    prefill keeps, by the reference's design."""
    from repro_torch.models import model_zoo

    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    plen, n_gen = SERVE_TF["prompt"], SERVE_TF["gen"]
    routes = {"decode": [], "long": []}
    with torch.no_grad():
        logits, caches = model_zoo.prefill(params, cfg, {"tokens": prompt},
                                           tf_fresh_caches(torch, cfg))
        steps = [logits[:, -1].float()]
        del logits
        with recorded_routes(routes["decode"]):
            for g in range(n_gen - 1):
                lg, caches = model_zoo.decode_step(
                    params, cfg, tokens[:, g:g + 1], caches, plen + g)
                steps.append(lg[:, 0].float())
        del caches
        got = torch.stack(steps, dim=1)
        with recorded_routes(routes["long"]):
            long, _ = model_zoo.prefill(
                params, cfg, {"tokens": torch.cat([prompt, tokens], dim=1)},
                tf_fresh_caches(torch, cfg))
        want = long[:, plen - 1:plen + n_gen - 1].float()
        del long
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 0
    out = {"max_abs_err": err, "rel_err": err / float(want.abs().max()),
           "top1_agree": float((got.argmax(-1) == want.argmax(-1))[clear]
                               .float().mean())}
    if cfg.moe is not None:
        n_l, b, k = cfg.num_layers, prompt.shape[0], cfg.moe.top_k
        dec = torch.stack(routes["decode"]).reshape(n_gen - 1, n_l, b, k)
        lng = torch.stack(routes["long"]).reshape(n_l, b, plen + n_gen, k)
        differ = (dec.permute(1, 2, 0, 3).sort(-1).values
                  != lng[:, :, plen:plen + n_gen - 1].sort(-1).values).any(-1)
        out["routing_differs_share"] = float(differ.float().mean())
        out["routing_differs_share_layer0"] = float(differ[0].float().mean())
    return out


def tf_drop_shares(torch, cfg, params, prompt, tokens, caches):
    """The share of routed assignments that capacity drops at layer 0's
    MoE input (`moe._route` and `moe._dispatch_tables` at the config's
    capacity factor): in the prefill (from a fresh cache) and in the first
    decode step (from ``caches``, the path's, whose later positions the
    causal mask hides)."""
    from repro_torch.models import mla, moe
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import embed_tokens
    from repro_torch.tree import tree_index

    m = cfg.moe
    lp = tree_index(params["layers"], 0)
    out = {}
    with torch.no_grad():
        for name, toks, c, pos in (
                ("prefill", prompt, tf_fresh_caches(torch, cfg), 0),
                ("decode_step", tokens[:, :1], caches, SERVE_TF["prompt"])):
            x = embed_tokens(params, cfg, toks)
            b, s, _ = x.shape
            qpos = pos + torch.arange(s, device=x.device).expand(b, s)
            a, _ = mla.mla_block(lp["mla"], cfg,
                                 rms_norm(x, lp["ln1"], cfg.norm_eps), qpos,
                                 cache=tree_index(c, 0), cache_pos=pos)
            h = rms_norm(x + a, lp["ln2"], cfg.norm_eps).reshape(b * s, -1)
            cap = max(1, math.ceil(b * s * m.top_k / m.num_experts
                                   * m.capacity_factor))
            topi, topv, _ = moe._route(h, lp["moe"]["router"], m)
            kept = moe._dispatch_tables(topi, topv, m.num_experts, cap)[2]
            out[name] = {"capacity": cap, "assignments": b * s * m.top_k,
                         "dropped_share": 1 - int(kept.sum())
                         / (b * s * m.top_k)}
    return out


def phase_serve_transformer(torch, arch, smi):
    """Slice 10's path for ``arch``, twice: ``launch.serve.prefill_prompt``
    then ``greedy_decode``, each with the launch counts set to 0 just
    before and read just after (the cached path runs no kernel: its
    attention is the plain core, as the reference's). Then the prefill's
    logits, one decode step under ``torch.profiler``, prefill-then-decode
    against one longer prefill, and for the MoE model the cache's size
    beside a full K/V cache's and capacity's drop shares."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params
    from repro_torch.train.train_step import make_serve_step
    from repro_torch.tree import tree_leaves

    name = "serve_dense" if arch == "qwen2-7b" else "serve_moe_mla"
    bsz, plen, n_gen = SERVE_TF["batch"], SERVE_TF["prompt"], SERVE_TF["gen"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, prompt = tf_serve_model(torch, arch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        caches = tf_fresh_caches(torch, cfg)
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
        if set(pre.values()) != {0} or set(dec.values()) != {0}:
            raise AssertionError(f"{name}: launches {pre} in the prefill "
                                 f"and {dec} in decode (designed none)")
        if tuple(tokens.shape) != (bsz, n_gen) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"{name}: tokens {tuple(tokens.shape)} out "
                                 f"of range [0, {cfg.vocab_size})")
        if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(caches)
                   if x.is_floating_point()):
            raise AssertionError(f"{name}: non-finite caches after decode")
        want_pos = torch.arange(plen + n_gen, dtype=torch.int32,
                                device=caches["pos"].device)
        want_pos[-1] = -1        # the last generated token is not fed back
        if not bool((caches["pos"] == want_pos).all()):
            raise AssertionError(f"{name}: cache positions are not 0.."
                                 f"{plen + n_gen - 2} and one unwritten")
        runs.append({"prefill_ms": 1e3 * prefill_s,
                     "prefill_tokens_per_s": bsz * plen / prefill_s,
                     "decode_ms_per_step": 1e3 * decode_s / (n_gen - 1),
                     "generated_tokens_per_s": bsz * (n_gen - 1) / decode_s,
                     "launches_prefill": pre, "launches_decode": dec,
                     "tokens": tokens})
    peak = torch.cuda.max_memory_allocated()
    same = bool(torch.equal(runs[0]["tokens"], runs[1]["tokens"]))
    tokens = runs[1].pop("tokens")
    runs[0].pop("tokens")
    out = {"phase": name, "entry": "launch.serve.prefill_prompt + "
           "greedy_decode (make_serve_step)", "serve": SERVE_TF,
           "config": {"arch": arch, "layers": cfg.num_layers,
                      "d_model": cfg.d_model, "dtype": "bfloat16",
                      "params": sum(x.numel() for x in tree_leaves(params))},
           "init_s": init_s, "init_peak_mem_bytes": init_peak,
           "runs": runs, "same_tokens_both_runs": same,
           "peak_mem_bytes": peak, "param_bytes": tree_bytes(params),
           "cache_bytes": tree_bytes(caches),
           "sample": tokens[0, :16].tolist()}
    if cfg.mla is not None:
        m, hq = cfg.mla, cfg.num_heads
        out["full_kv_cache_bytes"] = (
            cfg.num_layers * bsz * (plen + n_gen) * hq
            * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) * 2)
        out["capacity_drops"] = tf_drop_shares(torch, cfg, params, prompt,
                                               tokens, caches)
    del caches
    free(torch)

    # the prefill's logits: prefill_prompt returns only their argmax, so
    # compute them again (outside the counted window)
    with torch.no_grad():
        logits, _ = model_zoo.prefill(params, cfg, {"tokens": prompt},
                                      tf_fresh_caches(torch, cfg))
        last = logits[:, -1].float()
        finite = bool(torch.isfinite(logits).all())
        del logits
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 0
    agree = bool((last.argmax(-1)[clear] == tokens[clear, 0]).all())
    out.update(logits_finite=finite, first_token_is_argmax=agree,
               first_token_rows_compared=int(clear.sum()))
    free(torch)

    # one decode step under the profiler, from a prefilled cache
    step = make_serve_step(cfg)
    nxt, caches = serve.prefill_prompt(cfg, params,
                                       tf_fresh_caches(torch, cfg), prompt)
    step(params, caches, nxt, plen)
    torch.cuda.synchronize()
    busy, n_ops, top = device_profile(
        torch, lambda: step(params, caches, nxt, plen))
    wall = runs[1]["decode_ms_per_step"]
    out["decode_profile"] = {
        "device_busy_ms": busy, "wall_ms_unprofiled": wall,
        "device_idle_share": 1 - busy / wall if busy != "not measured"
        else "not measured", "device_ops": n_ops, "top5_ms": top}
    del caches
    free(torch)

    # prefill then decode against one longer prefill: bf16 at full depth,
    # then float32 at full width and depth TF_F32_DEPTH
    bf16 = tf_decode_vs_longer_prefill(torch, cfg, params, prompt, tokens)
    del params
    free(torch)
    cfg32 = cfg.with_(num_layers=TF_F32_DEPTH, dtype="float32",
                      param_dtype="float32")
    f32 = tf_decode_vs_longer_prefill(
        torch, cfg32, init_params(model_zoo.param_defs(cfg32),
                                  SERVE_TF["seed"], device="cuda"),
        prompt, tokens)
    free(torch)
    held = cfg.moe is None
    out["decode_vs_longer_prefill"] = {
        "bfloat16": bf16, "bfloat16_held": held,
        f"float32_depth_{TF_F32_DEPTH}": f32, "tolerance": TF_DECODE_TOL}
    out["card"] = smi
    emit(out)
    ok_bf16 = bf16["rel_err"] <= TF_DECODE_TOL["bfloat16"] or not held
    ok_f32 = f32["max_abs_err"] <= TF_DECODE_TOL["float32_abs"]
    if not (same and finite and agree and ok_bf16 and ok_f32):
        raise AssertionError(
            f"{name}: same tokens both runs {same}, prefill logits finite "
            f"{finite}, first token their argmax {agree}, prefill-then-"
            f"decode vs longer prefill bf16 {bf16}, float32 {f32} "
            f"(tolerance {TF_DECODE_TOL})")


# ------------------------------------------------------------ slice 11

#: slice 11, serving the hybrid: Zamba2-7B as published
#: (configs/zamba2_7b.py, arXiv:2411.15242; 81 Mamba2 layers in 13
#: super-groups of 6 plus a tail of 3, d_model 3584, 112 SSD heads of 64,
#: N 64, chunk 256; one shared attention/MLP block, 32 heads of 112, d_ff
#: 14336, at 13 sites; vocab 32000) at full width and depth in its own
#: bf16 (parameters, activations, KV and conv caches; the SSM states
#: float32 as their spec says), batch 8, a 2048-token prompt, 32 generated
#: tokens, weights and prompt drawn from the seed
SERVE_HYBRID = {"arch": "zamba2-7b", "batch": 8, "prompt": 2048, "gen": 32,
                "seed": 0}
#: the shape the hybrid's prefill gives K3 (per Mamba2 layer), bf16
K3_HYBRID_SHAPE = (8, 2048, 112, 64, 1, 64, 256)
#: prefill-then-decode against one longer prefill (2048 + 32 positions
#: against 2304, a whole number of chunks): max |logit difference|. Held in
#: float32 at full width and depth HYBRID_F32_DEPTH (one super-group and a
#: tail layer) within the reference tests' 2e-3 (tests/test_prefill.py;
#: measured on an NVIDIA H100 80GB HBM3 at 700 W: 3.5e-5). In bf16 at full
#: depth it is reported, not held: the reference's decode rounds each
#: Mamba2 layer's SSD output to bf16 where its chunked route keeps float32
#: until y_intra + y_inter (and K3's glue rounds the two apart), and 81
#: such layers and 13 attention sites carry the difference on (measured on
#: the same card: 0.11 of the largest logit, top-1 agreement 83 %).
HYBRID_DECODE_TOL = {"float32_abs": 2e-3}
HYBRID_F32_DEPTH = 7
#: K3 in place: one full-width bf16 ssm_block prefill (the first Mamba2
#: layer on the path's prompt, from its cache after the path) with K3 and
#: with the plain version, max |a - b| over max |b|: the output is bf16, and
#: K3 rounds y_intra to bf16 from float32 values that differ from the plain
#: version's in their last bits (one ulp, 2^-8 of an entry), which the
#: gate, the norm and the output product carry on; the state is float32
#: (measured on an NVIDIA H100 80GB HBM3 at 700 W: out 5.6e-3, h 7.3e-6)
HYBRID_IN_PLACE_TOL = {"out": 2e-2, "h": 1e-4, "conv": 0.0}

#: slice 11, training the hybrid: Zamba2-7B at full width, depth cut from
#: 81 to 12 (two super-groups, so the shared block is applied, and its
#: gradient summed, at two sites), bf16 with float32 masters and momentum,
#: K2 on (head_dim 112 zero-padded to 128), one scenario (four workers
#: bidding 0.9, four 0.5) × one seed, batch 8, seq 1024, 4 ticks, through
#: ``train_zoo(remat="full")``
TRAIN_HYBRID_SPEC = dict(
    arch="zamba2-7b", reduce_depth=12, param_dtype="bfloat16", zoo=True,
    overrides={"use_flash_attention": 1}, n_workers=8, global_batch=8,
    seq_len=1024, bids=((0.9, 0.9, 0.9, 0.9, 0.5, 0.5, 0.5, 0.5),),
    iterations=4, seeds=1, n_ticks=4)
#: the batch (and workers) of the one-step remat comparison: without remat
#: the SSD's training route keeps ≈ 7 GB of float32 temporaries a Mamba2
#: layer at batch 8 (three (B, nc, Q, Q, H) tensors of 0.94 GB among
#: them; the saved tensors' sizes, counted at a smaller batch and scaled),
#: 85 GB over 12 layers, so the three modes are compared at batch 2
REMAT_BATCH = 2
#: the shape the hybrid's training gives K2 (the shared block's sites)
K2_HYBRID_SHAPE = (8, 1023, 1023, 32, 32, 112, True, None, 0)

#: slice 11, the enc-dec: Whisper-base as published
#: (configs/whisper_base.py, arXiv:2212.04356; 6 + 6 layers, d_model 512,
#: 8 heads of 64, d_ff 2048, vocab 51865, 1500 frames), bf16 with float32
#: masters and momentum, K2 on: non-causal in the encoder (S = T = 1500),
#: causal in the decoder (S = T = 447 of the 448-token context); one
#: scenario × one seed, batch 8, 4 ticks
TRAIN_ENCDEC_SPEC = dict(
    arch="whisper-base", reduce_depth=6, param_dtype="bfloat16", zoo=True,
    overrides={"use_flash_attention": 1}, n_workers=8, global_batch=8,
    seq_len=448, bids=((0.9, 0.9, 0.9, 0.9, 0.5, 0.5, 0.5, 0.5),),
    iterations=4, seeds=1, n_ticks=4)
#: serving it: the frames' cross cache built by ``model_zoo.prefill``, a
#: 32-token decoder prompt, 32 generated tokens, batch 8 (the serve
#: launcher hands ``prefill`` only tokens, as the reference's does, so
#: the phase calls ``model_zoo`` directly)
SERVE_ENCDEC = {"arch": "whisper-base", "batch": 8, "prompt": 32, "gen": 32,
                "seed": 0}
#: the shape the encoder gives K2 (non-causal)
K2_WHISPER_SHAPE = (8, 1500, 1500, 8, 8, 64, False, None, 0)


def reset_counts():
    """Every kernel's launch count and the SSD training route's call count
    to 0."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm

    ops.reset_launch_counts()
    ssm.ssd_chunked.calls = 0


def read_counts():
    """The launch counts and, under ``ssd_training_route``, the SSD
    training route's calls."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm

    return {**ops.launch_counts(),
            "ssd_training_route": ssm.ssd_chunked.calls}


def zoo_train_phase(torch, name, spec_kw, want_of, remat="none"):
    """``train_zoo`` of a `WorkerSpec` workload with the counts set to 0
    just before and read just after; the counts held against
    ``want_of(job, cells, n_ticks)``, the losses finite and the first near
    ln V. Returns (job, counts, ms a tick)."""
    from repro_torch.launch.workload import WorkerSpec, build_workload
    from repro_torch.models import model_zoo
    from repro_torch.models.common import map_specs
    from repro_torch.train.trainer import train_zoo
    from repro_torch.tree import tree_leaves

    spec = WorkerSpec(**spec_kw)
    job, scenarios, seeds = build_workload(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = train_zoo(job, scenarios, seeds, n_ticks=spec.n_ticks,
                    remat=remat, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    cells = int(res.iterations.size)
    want = want_of(job, cells, spec.n_ticks)
    losses = zoo_losses(res)
    flat = [float(x) for row in losses for x in row]
    vocab = job.model.vocab_size
    emit({"phase": name, "entry": f"trainer.train_zoo(remat={remat!r})",
          "spec": spec_kw, "params": sum(tree_leaves(map_specs(
              lambda _, sp: math.prod(sp.shape),
              model_zoo.param_defs(job.model)))), "cells": cells,
          "n_ticks": spec.n_ticks, "iterations": res.iterations.tolist(),
          "losses": [list(map(float, x)) for x in losses],
          "ln_V": math.log(vocab), "counts": counts, "designed": want,
          "run_s": run_s, "ms_per_tick": 1e3 * run_s / spec.n_ticks,
          "peak_mem_bytes": peak})
    if counts != want:
        raise AssertionError(f"{name}: counts {counts}, designed {want}")
    if not flat or not all(math.isfinite(x) for x in flat) or \
            not abs(flat[0] - math.log(vocab)) < 3.0:
        raise AssertionError(f"{name}: losses {losses} (ln V = "
                             f"{math.log(vocab):.3f})")
    return job, counts, 1e3 * run_s / spec.n_ticks


def designed(**per_kernel):
    """The counts a run should read: the named ones, every other 0."""
    from repro_torch.kernels import ops

    return {n: per_kernel.get(n, 0)
            for n in list(ops.launch_counts()) + ["ssd_training_route"]}


def k2_sites(fwd, bwd):
    """K2's tensor-core kernels: ``fwd`` forwards, ``bwd`` backwards (each
    one D_i pre-pass, one dK/dV and one dQ)."""
    return {"flash_attention_fwd_tc": fwd, "flash_attention_bwd_delta": bwd,
            "flash_attention_bwd_dkdv_tc": bwd,
            "flash_attention_bwd_dq_tc": bwd}


def phase_train_hybrid(torch, smi):
    """``train_zoo(remat="full")`` of the cut Zamba2-7B: per cell and tick
    K2's forward twice a site (the recompute), its backward once, the SSD's
    training route twice a Mamba2 layer, K3 never. Then one cell step each
    under "none", "dots" and "full" at `REMAT_BATCH`, and K2 at the path's
    shape."""
    def want(job, cells, ticks):
        sites = job.model.num_layers // job.model.attn_every
        return designed(**k2_sites(2 * sites * cells * ticks,
                                   sites * cells * ticks),
                        ssd_training_route=2 * job.model.num_layers
                        * cells * ticks)

    job, counts, tick_ms = zoo_train_phase(torch, "train_hybrid",
                                           TRAIN_HYBRID_SPEC, want,
                                           remat="full")
    free(torch)
    phase_remat_compare(torch, job)
    free(torch)
    sites = job.model.num_layers // job.model.attn_every
    rows = phase_k2_at_path_shape(torch, smi, counts, tick_ms, sites,
                                  shape=K2_HYBRID_SHAPE,
                                  phase="k2_at_hybrid_shape",
                                  cuda_core=False)
    free(torch)
    return rows


def phase_remat_compare(torch, job):
    """One loss-and-gradient step of the cut hybrid at `REMAT_BATCH` under
    "full", "none" and "dots" on the same bf16 weights and batch: the loss
    and every gradient leaf bit-equal to "full"'s, and each mode's counts
    (K2's forward relaunched by both recomputing modes, the SSD's training
    route run again), time and peak memory."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params
    from repro_torch.train.train_step import make_loss_grad
    from repro_torch.train.trainer import stack_batches
    from repro_torch.tree import tree_leaves

    job = dataclasses.replace(job, n_workers=REMAT_BATCH,
                              shape=dataclasses.replace(
                                  job.shape, global_batch=REMAT_BATCH))
    cfg = job.model
    params = init_params(model_zoo.param_defs(cfg), job.seed,
                         cfg.resolved_param_dtype(), device="cuda")
    batch = {k: x[0] for k, x in stack_batches(job, 1, device="cuda").items()}
    mask = torch.ones(job.n_workers, device="cuda")
    sites, layers = cfg.num_layers // cfg.attn_every, cfg.num_layers
    # one untimed step first: the batch's GEMM shapes are new to cuBLAS
    make_loss_grad(cfg, job, "none")(params, batch, mask)
    runs, ref_grads, ref_loss, bad = {}, None, None, []
    for remat in ("full", "none", "dots"):
        again = 1 if remat == "none" else 2
        want = designed(**k2_sites(again * sites, sites),
                        ssd_training_route=again * layers)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        grads, loss, _ = make_loss_grad(cfg, job, remat)(params, batch, mask)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        counts = read_counts()
        if counts != want:
            bad.append((remat, "counts", counts, want))
        if ref_grads is None:
            ref_grads, ref_loss = grads, loss
            equal = True
        else:
            equal = bool(torch.equal(loss, ref_loss)) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                  tree_leaves(ref_grads)))
            if not equal:
                bad.append((remat, "gradients differ from full's"))
        runs[remat] = {"step_ms": 1e3 * step_s, "loss": loss.item(),
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "counts": counts, "bit_equal_to_full": equal}
        del grads
    emit({"phase": "remat_hybrid", "batch": REMAT_BATCH,
          "layers": layers, "sites": sites, "runs": runs})
    if bad:
        raise AssertionError(f"remat_hybrid: {bad}")


def hybrid_fresh_caches(torch, cfg, seq_len):
    """A fresh cache tree for the served batch in the config's dtype
    (states float32): zeros, positions −1."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params

    return init_params(model_zoo.cache_defs(cfg, SERVE_HYBRID["batch"],
                                            seq_len),
                       SERVE_HYBRID["seed"], cfg.resolved_param_dtype(),
                       device="cuda")


def hybrid_decode_vs_longer_prefill(torch, cfg, params, prompt, tokens):
    """The prefill's last logits and 31 decode steps fed the path's
    tokens, against one prefill of 2304 positions (the prompt, the tokens
    and seeded filler to a whole number of chunks): the worst |difference|,
    the same over the largest |logit|, and the share of positions whose
    argmax agrees where the longer prefill's top two differ."""
    from repro_torch.models import model_zoo

    plen, n_gen = SERVE_HYBRID["prompt"], SERVE_HYBRID["gen"]
    q = cfg.ssm.chunk_size
    long_len = -(-(plen + n_gen) // q) * q
    gen = torch.Generator(device="cuda").manual_seed(SERVE_HYBRID["seed"] + 1)
    filler = torch.randint(0, cfg.vocab_size,
                           (prompt.shape[0], long_len - plen - n_gen),
                           generator=gen, device="cuda")
    with torch.no_grad():
        logits, caches = model_zoo.prefill(
            params, cfg, {"tokens": prompt},
            hybrid_fresh_caches(torch, cfg, plen + n_gen))
        steps = [logits[:, -1].float()]
        del logits
        for g in range(n_gen - 1):
            lg, caches = model_zoo.decode_step(params, cfg,
                                               tokens[:, g:g + 1], caches,
                                               plen + g)
            steps.append(lg[:, 0].float())
        del caches
        got = torch.stack(steps, dim=1)
        long, _ = model_zoo.prefill(
            params, cfg,
            {"tokens": torch.cat([prompt, tokens, filler], dim=1)},
            hybrid_fresh_caches(torch, cfg, long_len))
        want = long[:, plen - 1:plen + n_gen - 1].float()
        del long
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 0
    return {"long_prefill_tokens": long_len, "max_abs_err": err,
            "rel_err": err / float(want.abs().max()),
            "finite": bool(torch.isfinite(got).all()),
            "top1_agree": float((got.argmax(-1) == want.argmax(-1))[clear]
                                .float().mean())}


def phase_serve_hybrid(torch, smi):
    """Slice 11's serving path, twice: ``launch.serve.prefill_prompt`` (K3
    once per Mamba2 layer, the SSD's training route never) then
    ``greedy_decode`` (no kernel), each with the counts set to 0 just
    before and read just after. Then one prefill and one decode step under
    ``torch.profiler``, prefill-then-decode against one longer prefill, K3
    in place, and K3 at the path's shape. Returns K3's kernel rows."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo, ssm
    from repro_torch.models.common import init_params, rms_norm
    from repro_torch.models.transformer import embed_tokens
    from repro_torch.train.train_step import make_serve_step
    from repro_torch.tree import tree_index, tree_leaves

    bsz, plen, n_gen = (SERVE_HYBRID["batch"], SERVE_HYBRID["prompt"],
                        SERVE_HYBRID["gen"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(SERVE_HYBRID["arch"])
    params = init_params(model_zoo.param_defs(cfg), SERVE_HYBRID["seed"],
                         torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SERVE_HYBRID["seed"])
    prompt = torch.randint(0, cfg.vocab_size, (bsz, plen), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    want_pre = designed(ssd_chunk=cfg.num_layers)
    want_dec = designed()
    runs = []
    for _ in range(2):
        caches = hybrid_fresh_caches(torch, cfg, plen + n_gen)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        nxt, caches = serve.prefill_prompt(cfg, params, caches, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = read_counts()
        reset_counts()
        t0 = time.perf_counter()
        tokens, caches = serve.greedy_decode(cfg, params, caches, nxt, plen,
                                             n_gen - 1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec = read_counts()
        if pre != want_pre or dec != want_dec:
            raise AssertionError(
                f"serve_hybrid: counts {pre} in the prefill (designed "
                f"{want_pre}: K3 once per Mamba2 layer) and {dec} in decode "
                "(designed none)")
        if tuple(tokens.shape) != (bsz, n_gen) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"serve_hybrid: tokens "
                                 f"{tuple(tokens.shape)} out of range")
        if not all(bool(torch.isfinite(x).all()) for x in tree_leaves(caches)
                   if x.is_floating_point()):
            raise AssertionError("serve_hybrid: non-finite caches")
        want_pos = torch.arange(plen + n_gen, dtype=torch.int32,
                                device="cuda")
        want_pos[-1] = -1        # the last generated token is not fed back
        if not bool((caches["attn"]["pos"] == want_pos).all()):
            raise AssertionError("serve_hybrid: KV cache positions are not "
                                 f"0..{plen + n_gen - 2} and one unwritten")
        runs.append({"prefill_ms": 1e3 * prefill_s,
                     "prefill_tokens_per_s": bsz * plen / prefill_s,
                     "decode_ms_per_step": 1e3 * decode_s / (n_gen - 1),
                     "generated_tokens_per_s": bsz * (n_gen - 1) / decode_s,
                     "counts_prefill": pre, "counts_decode": dec,
                     "tokens": tokens})
    peak = torch.cuda.max_memory_allocated()
    same = bool(torch.equal(runs[0]["tokens"], runs[1]["tokens"]))
    tokens = runs[1].pop("tokens")
    runs[0].pop("tokens")
    g_sites, tail = divmod(cfg.num_layers, cfg.attn_every)
    out = {"phase": "serve_hybrid", "entry": "launch.serve.prefill_prompt "
           "+ greedy_decode (make_serve_step)", "serve": SERVE_HYBRID,
           "config": {"arch": cfg.name, "mamba2_layers": cfg.num_layers,
                      "super_groups": g_sites, "tail": tail,
                      "d_model": cfg.d_model, "dtype": "bfloat16",
                      "params": sum(x.numel() for x in tree_leaves(params))},
           "init_s": init_s, "runs": runs, "same_tokens_both_runs": same,
           "peak_mem_bytes": peak, "param_bytes": tree_bytes(params),
           "kv_cache_bytes": tree_bytes(caches["attn"]),
           "ssm_cache_bytes": tree_bytes(caches["ssm_groups"])
           + tree_bytes(caches.get("ssm_tail", {})),
           "sample": tokens[0, :16].tolist()}

    # one prefill and one decode step under the profiler
    step = make_serve_step(cfg)
    nxt = tokens[:, -1:]
    busy_d, ops_d, top_d = device_profile(
        torch, lambda: step(params, caches, nxt, plen + n_gen - 1))
    busy_p, ops_p, top_p = device_profile(
        torch, lambda: serve.prefill_prompt(
            cfg, params, hybrid_fresh_caches(torch, cfg, plen + n_gen),
            prompt))
    for key, busy, n_ops, top, wall in (
            ("prefill_profile", busy_p, ops_p, top_p, runs[1]["prefill_ms"]),
            ("decode_profile", busy_d, ops_d, top_d,
             runs[1]["decode_ms_per_step"])):
        out[key] = {"device_busy_ms": busy, "wall_ms_unprofiled": wall,
                    "device_idle_share": 1 - busy / wall
                    if busy != "not measured" else "not measured",
                    "device_ops": n_ops, "top5_ms": top}

    # K3 in place: the first Mamba2 layer's block on the prompt, from its
    # cache after the path, with K3 and with the plain version
    lay = tree_index(params["groups"], (0, 0))
    cache0 = tree_index(caches["ssm_groups"], (0, 0))
    del caches
    free(torch)

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    with torch.no_grad():
        x = rms_norm(embed_tokens(params, cfg, prompt), lay["ln"],
                     cfg.norm_eps)
        reset_counts()
        out_k, c_k = ssm.ssm_block(lay["ssm"], cfg, x, cache=cache0)
        in_place_counts = read_counts()
        with plain_k3():
            out_p, c_p = ssm.ssm_block(lay["ssm"], cfg, x, cache=cache0)
    block = {"out": rel(out_k, out_p), "h": rel(c_k["h"], c_p["h"]),
             "conv": rel(c_k["conv"], c_p["conv"])}
    del out_k, out_p, c_k, c_p, x, cache0
    free(torch)
    out["k3_in_place"] = {"block_rel_err": block,
                          "tolerance": HYBRID_IN_PLACE_TOL,
                          "counts": in_place_counts}

    # prefill then decode against one longer prefill: bf16 at full depth,
    # then float32 at full width and depth HYBRID_F32_DEPTH
    bf16 = hybrid_decode_vs_longer_prefill(torch, cfg, params, prompt,
                                           tokens)
    del params
    free(torch)
    cfg32 = cfg.with_(num_layers=HYBRID_F32_DEPTH, dtype="float32",
                      param_dtype="float32")
    f32 = hybrid_decode_vs_longer_prefill(
        torch, cfg32, init_params(model_zoo.param_defs(cfg32),
                                  SERVE_HYBRID["seed"], device="cuda"),
        prompt, tokens)
    free(torch)
    out["decode_vs_longer_prefill"] = {
        "bfloat16": bf16, "bfloat16_held": False,
        f"float32_depth_{HYBRID_F32_DEPTH}": f32,
        "tolerance": HYBRID_DECODE_TOL}
    out["card"] = smi
    emit(out)
    ok_block = all(block[k] <= HYBRID_IN_PLACE_TOL[k] for k in block) and \
        in_place_counts == designed(ssd_chunk=1)
    ok_bf16 = bf16["finite"]
    ok_f32 = f32["finite"] and f32["max_abs_err"] <= \
        HYBRID_DECODE_TOL["float32_abs"]
    if not (same and ok_block and ok_bf16 and ok_f32):
        raise AssertionError(
            f"serve_hybrid: same tokens both runs {same}, K3 in place "
            f"{block} {in_place_counts}, prefill-then-decode vs longer "
            f"prefill bf16 {bf16}, float32 {f32} (tolerance "
            f"{HYBRID_DECODE_TOL})")
    rows = phase_k3_at_path_shape(
        torch, smi, runs[1]["counts_prefill"], runs[1]["prefill_ms"],
        shape=K3_HYBRID_SHAPE, dtype="bfloat16",
        phase="k3_at_hybrid_shape", cuda_core=False)
    free(torch)
    return rows


def phase_train_encdec(torch, smi):
    """``train_zoo`` of Whisper-base (no remat, as the trainer's default):
    per cell and tick K2's forward and backward once at each of the six
    encoder (non-causal) and six decoder (causal) sites, no other kernel;
    then K2 at the encoder's shape. Returns K2's kernel rows there."""
    def want(job, cells, ticks):
        sites = (job.model.encoder.num_layers + job.model.num_layers) \
            * cells * ticks
        return designed(**k2_sites(sites, sites))

    job, counts, tick_ms = zoo_train_phase(torch, "train_encdec",
                                           TRAIN_ENCDEC_SPEC, want)
    free(torch)
    rows = phase_k2_at_path_shape(torch, smi, counts, tick_ms,
                                  job.model.encoder.num_layers,
                                  shape=K2_WHISPER_SHAPE,
                                  phase="k2_at_whisper_encoder_shape",
                                  cuda_core=False)
    free(torch)
    return rows


def phase_serve_encdec(torch, smi):
    """Whisper-base served through ``model_zoo.prefill`` (the encoder over
    the frames, K2 non-causal once per encoder layer, and the cross cache)
    and 31 ``make_serve_step`` steps (no kernel), twice, each with the
    counts set to 0 just before and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params
    from repro_torch.train.train_step import make_serve_step
    from repro_torch.tree import tree_leaves

    bsz, plen, n_gen = (SERVE_ENCDEC["batch"], SERVE_ENCDEC["prompt"],
                        SERVE_ENCDEC["gen"])
    cfg = get_config(SERVE_ENCDEC["arch"]).with_(use_flash_attention=True)
    params = init_params(model_zoo.param_defs(cfg), SERVE_ENCDEC["seed"],
                         torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SERVE_ENCDEC["seed"])
    prompt = torch.randint(0, cfg.vocab_size, (bsz, plen), generator=gen,
                           device="cuda")
    frames = torch.randn(bsz, cfg.encoder.src_len, cfg.d_model,
                         generator=gen, device="cuda") * 0.5
    step = make_serve_step(cfg)
    want_pre = designed(flash_attention_fwd_tc=cfg.encoder.num_layers)
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        caches = init_params(model_zoo.cache_defs(cfg, bsz, plen + n_gen),
                             SERVE_ENCDEC["seed"], torch.bfloat16,
                             device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, caches = model_zoo.prefill(
                params, cfg, {"tokens": prompt, "frames": frames}, caches)
            nxt = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = read_counts()
        finite = bool(torch.isfinite(logits).all())
        del logits
        reset_counts()
        t0 = time.perf_counter()
        out = [nxt]
        for g in range(n_gen - 1):
            nxt, caches = step(params, caches, nxt, plen + g)
            out.append(nxt)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec = read_counts()
        tokens = torch.cat(out, dim=1)
        cross_ok = tuple(caches["cross"]["k"].shape) == (
            cfg.num_layers, bsz, cfg.encoder.src_len, cfg.num_kv_heads,
            cfg.resolved_head_dim)
        if pre != want_pre or dec != designed():
            raise AssertionError(f"serve_encdec: counts {pre} in the prefill "
                                 f"(designed {want_pre}) and {dec} in "
                                 "decode (designed none)")
        if not (finite and cross_ok and bool(
                ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
                and all(bool(torch.isfinite(x).all())
                        for x in tree_leaves(caches)
                        if x.is_floating_point())):
            raise AssertionError(f"serve_encdec: logits finite {finite}, "
                                 f"cross cache shape {cross_ok}, tokens "
                                 f"{tokens[0].tolist()}")
        runs.append({"prefill_ms": 1e3 * prefill_s,
                     "decode_ms_per_step": 1e3 * decode_s / (n_gen - 1),
                     "generated_tokens_per_s": bsz * (n_gen - 1) / decode_s,
                     "counts_prefill": pre, "counts_decode": dec,
                     "tokens": tokens})
    same = bool(torch.equal(runs[0].pop("tokens"), runs[1]["tokens"]))
    tokens = runs[1].pop("tokens")
    emit({"phase": "serve_encdec", "entry": "model_zoo.prefill (frames) + "
          "make_serve_step", "serve": SERVE_ENCDEC, "runs": runs,
          "same_tokens_both_runs": same,
          "params": sum(x.numel() for x in tree_leaves(params)),
          "cache_bytes": tree_bytes(caches),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "sample": tokens[0, :16].tolist(), "card": smi})
    if not same:
        raise AssertionError("serve_encdec: tokens differ between the runs")


# ------------------------------------------------------------ slice 12

#: the fig3-uniform grid's first part in the resume phase, which the mesh
#: phase repeats in three shards on the card (each shard runs every tick
#: of its own, and the tick loop is host-bound: 3 × 480 ticks ≈ 15 s)
RESUME_SPLIT_TICK = 480
#: an EngineResult's trajectories and accounting
TRAJECTORIES = ("errors", "costs", "times", "ys", "iterations", "total_time",
                "total_cost", "total_idle")
#: the market's part of them: bit for bit whatever the shards' products
MARKET = TRAJECTORIES[1:]
#: tests/test_torch_megabatch.py's tolerance (RTOL, ATOL) for the
#: megabatch's losses and carry, should the card's products over fewer
#: replicas not give the unsharded run's bits
MEGABATCH_TOL = (5e-4, 1e-5)
#: the elements of a carry leaf compared or digested at once
CHUNK = 1 << 26


class MeshKilled(Exception):
    """The mesh phase's stand-in for a kill of its durable run."""


def card_mesh(n, axis):
    """``n`` shards on the one card, along ``axis``."""
    from repro_torch.launch.mesh import Mesh

    return Mesh(["cuda:0"] * n, (axis,))


def carry_digests(torch, model) -> dict:
    """A 64-bit digest of each flat carry leaf's bits on the card: the sum
    mod 2^64 of each element's bits times an odd weight from its position.
    Integer sums do not depend on their order, so equal bits give equal
    digests on any run, and one changed element changes the digest."""
    out = {}
    for k, x in model.items():
        flat = x.reshape(-1).view(torch.int32)
        total = 0
        for lo in range(0, flat.numel(), CHUNK):
            part = flat[lo:lo + CHUNK].to(torch.int64)
            weight = torch.arange(lo, lo + part.numel(), dtype=torch.int64,
                                  device=x.device) * 2654435762 + 1
            total = (total + int((part * weight).sum())) % (1 << 64)
        out[k] = total
    return out


def compare_carries(torch, a, b) -> dict:
    """Bit-equality, the largest |a − b| and whether every element is
    within ``MEGABATCH_TOL`` of b, over flat carries on the card."""
    rtol, atol = MEGABATCH_TOL
    equal, err, within = True, 0.0, True
    for k in a:
        x, y = a[k].reshape(-1), b[k].reshape(-1)
        for lo in range(0, x.numel(), CHUNK):
            xs, ys = x[lo:lo + CHUNK], y[lo:lo + CHUNK]
            equal &= bool(torch.equal(xs, ys))
            d = (xs - ys).abs()
            err = max(err, float(d.max()))
            within &= bool((d <= atol + rtol * ys.abs()).all())
    return {"bit_equal": equal, "max_abs_diff": err,
            "within_megabatch_tol": within}


def same_trajectories(a, b, fields=TRAJECTORIES) -> dict:
    return {f: bool(np.array_equal(getattr(a, f), b[f] if isinstance(b, dict)
                                   else getattr(b, f), equal_nan=True))
            for f in fields}


def phase_mesh_megabatch(torch, smi, main):
    """Slice 1's grid (``MAIN_ARGV``: Qwen2-7B at full width, depth 2,
    float32, the megabatch through K1, R = 2) twice more, held against the
    main path's run of the same argv: through ``launch/train.py ...
    --mesh 1`` (one shard, the whole grid), then through
    ``ElasticTrainer.run_batched(mesh=)`` with its two seeds in two shards
    on the card (replica axis; each shard's step a batch of one replica).
    K1 runs once per shard and tick; each run's time per tick and peak
    memory (above what was held before it) beside the main path's; the
    market bit for bit, the losses and the final carry bit for bit or
    their largest difference held at ``MEGABATCH_TOL``. Then K1 at the
    shard's shape (1, P). Returns the phase's record."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    n_ticks = main["n_ticks"]

    def run(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn().result
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, {"run_s": wall, "ms_per_tick_e2e": 1e3 * wall / n_ticks,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()
                     - base, "launches_k1":
                     ops.launch_counts()["elastic_sgd_update"]}

    args = launch.parse_args(MAIN_ARGV + ["--mesh", "1"])
    one, one_rec = run(lambda: launch.run(args)[0])
    one_rec.update(trajectories_bit_equal=same_trajectories(
        one, main["trajectories"]),
        carry_digest_equal=carry_digests(torch, one.final_model)
        == main["digest"])
    tr = launch.build_trainer(launch.parse_args(MAIN_ARGV))
    two, two_rec = run(lambda: tr.run_batched(
        seeds=args.seeds, iterations=args.iterations, megabatch=True,
        use_fused_update=True, mesh=card_mesh(2, "replica")))
    two_rec.update(market_bit_equal=same_trajectories(
        two, main["trajectories"], MARKET),
        losses_bit_equal=bool(np.array_equal(
            two.errors, main["trajectories"]["errors"], equal_nan=True)),
        carry=compare_carries(torch, two.final_model, one.final_model))
    want = main["trajectories"]["errors"]
    diff = np.abs(np.nan_to_num(two.errors) - np.nan_to_num(want))
    two_rec.update(losses_max_abs_diff=float(diff.max()),
                   losses_within_megabatch_tol=bool(
                       (np.isnan(two.errors) == np.isnan(want)).all()
                       and (diff <= MEGABATCH_TOL[1] + MEGABATCH_TOL[0]
                            * np.abs(np.nan_to_num(want))).all()))
    del one
    free(torch)
    # K1 at the shard's shape, on the first shard's rows of the final carry
    k1 = k1_at_shape(torch, two.final_model["p"][0, 0:1],
                     two.final_model["v"][0, 0:1], smi, "k1_at_shard_shape")
    del two
    rec = {"grid": "python -m repro_torch.launch.train " + " ".join(
        MAIN_ARGV), "n_ticks": n_ticks,
        "unsharded": {k: main[k] for k in ("run_s", "peak_mem_bytes")},
        "mesh_1": one_rec, "two_shards": two_rec,
        "k1_at_shard_shape": k1}
    return rec


def phase_mesh_fig3(torch, resumed):
    """The fig3-uniform grid's first ``RESUME_SPLIT_TICK`` ticks (4
    scenarios × 8 seeds, the resume phase's first part) over three shards
    on the card (2 + 1 + 1 scenarios): every trajectory, the final iterates
    and the snapshot bit for bit the straight run's."""
    from repro_torch.kernels import ops
    from repro_torch.sim import engine

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.simulate_sharded(
        resumed["batch"], resumed["program"], resumed["w0"],
        resumed["quad"], FIG_SEEDS, resumed["cfg"],
        mesh=card_mesh(3, "data"))
    wall = time.perf_counter() - t0
    first = resumed["run"]
    equal = same_trajectories(res, first)
    equal["final_model"] = bool(torch.equal(res.final_model,
                                            first.final_model))
    equal["snapshot"] = all(
        torch.equal(torch.nan_to_num(x.float(), 7.0),
                    torch.nan_to_num(y.float(), 7.0))
        for x, y in zip(res.snapshots, first.snapshots)
        if isinstance(x, torch.Tensor))
    return {"cells": int(res.iterations.size), "shards": 3,
            "ticks": resumed["cfg"].n_ticks, "wall_s": wall,
            "launches": ops.launch_counts(), "bit_equal": equal}


def phase_mesh_score_requests(torch):
    """``service.planner.score_requests`` of four jobs' slates (the
    service's candidates from ``generate_candidates`` over empirical
    posteriors and exp runtimes; the demo problem, minibatch gradients),
    unsharded and over two shards on the card: the scores bit for bit."""
    from repro_torch.core.cost_model import EmpiricalPrice, RuntimeModel
    from repro_torch.kernels import ops
    from repro_torch.service import planner as pl
    from repro_torch.service.server import demo_problem
    from repro_torch.sim import engine

    quad, w0, prob = demo_problem(seed=0)
    rng = np.random.default_rng(0)
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    requests = []
    for i in range(4):
        samples = rng.uniform(0.2, 1.0, 128).astype(np.float32)
        j_left, theta = 20 + 4 * i, 60.0 + 10 * i
        requests.append(pl.PlanRequest(
            job=i, market=i, price_spec=engine.PriceSpec.empirical(samples),
            rt=rt, q_hat=0.1, j_left=j_left, theta_left=theta, eps=0.5,
            n_workers=4, candidates=pl.generate_candidates(
                prob, eps=0.5, theta_left=theta, j_left=j_left, n=4,
                dist=EmpiricalPrice(samples=samples), rt=rt, q_hat=0.1,
                multibid_partitions=((2, 2),))))
    kw = dict(alpha=prob.alpha, model0=torch.as_tensor(
        np.asarray(w0, np.float32), device="cuda"),
        data=engine.torch_quadratic(quad, "cuda"),
        program=engine.quadratic_program("minibatch", 4),
        j_cap=max(r.j_left for r in requests), n_cap=4, seeds=[1000, 1001],
        score_ticks=256, grad="minibatch", batch=4)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    plain = pl.score_requests(requests, device="cuda", **kw)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = pl.score_requests(requests, mesh=card_mesh(2, "data"), **kw)
    sharded_s = time.perf_counter() - t0
    return {"jobs": len(requests), "slate": len(requests[0].candidates),
            "finite": int(np.isfinite(plain).sum()),
            "wall_s": {"unsharded": plain_s, "two_shards": sharded_s},
            "launches": ops.launch_counts(),
            "bit_equal": bool(np.array_equal(plain, sharded))}


def phase_mesh_durable(torch):
    """The reduced Qwen2-7B megabatch grid (phase 7's: one scenario × 2
    seeds) through ``train_batched_durable(mesh=two shards on the replica
    axis, save_shards=2)`` (the manifest and min(2, S) shard files),
    killed before its tick-16 save, restored from the tick-8 files and
    resumed unsharded: bit for bit the same ticks run without the file
    (0-8 in two shards, 8-28 unsharded, through ``init_state``/``tick0``),
    and against the straight unsharded run the market bit for bit, the
    losses and carry bit for bit or within ``MEGABATCH_TOL`` (the shards'
    products over one replica). K1 once per shard and tick while
    sharded."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch
    from repro_torch.train import megabatch as mb
    from repro_torch.train import trainer

    args = launch.parse_args(["--config", "qwen2_7b", "--batched",
                              "--megabatch", "--fused-update", "--seeds",
                              "2", "--iterations", "6", "--device", "cuda"])
    tr = launch.build_trainer(args)
    job = tr.job
    scenarios = [tr._scenario(tr.strategy, args.iterations, "s")]
    n_ticks = trainer.default_n_ticks(args.iterations)

    class Kill:
        def before_save(self, tick):
            if tick == 16:
                raise MeshKilled(tick)

    kw = dict(n_ticks=n_ticks, save_every=8, save_shards=2,
              batch_seed=tr.seed, device="cuda",
              program=lambda n: trainer.make_megabatch_train_program(
                  job, n, True),
              model0=lambda: mb.init_megabatch_state(job.model, job,
                                                     job.seed, device="cuda"))
    path = os.path.join(DURABLE_DIR, "mesh_megabatch.ckpt")
    os.makedirs(DURABLE_DIR, exist_ok=True)
    try:
        ops.reset_launch_counts()
        try:
            trainer.train_batched_durable(job, scenarios, args.seeds,
                                          checkpoint_path=path,
                                          mesh=card_mesh(2, "replica"),
                                          hooks=Kill(), **kw)
            killed = False
        except MeshKilled:
            killed = True
        k1_sharded = ops.launch_counts()["elastic_sgd_update"]
        with open(path) as f:
            n_files = len(json.load(f)["shards"])
        ops.reset_launch_counts()
        resumed = trainer.train_batched_durable(
            job, scenarios, args.seeds, checkpoint_path=path, **kw)
        k1_resumed = ops.launch_counts()["elastic_sgd_update"]
        run_kw = dict(megabatch=True, use_fused_update=True,
                      batch_seed=tr.seed, device="cuda")
        first = trainer.train_batched(job, scenarios, args.seeds,
                                      n_ticks=8, mesh=card_mesh(2, "replica"),
                                      **run_kw)
        same_ticks = trainer.train_batched(
            job, scenarios, args.seeds, n_ticks=n_ticks,
            init_state=first.final_state, tick0=8, **run_kw)
        equal = same_trajectories(resumed, same_ticks)
        equal.update({k: bool(torch.equal(resumed.final_model[k],
                                          same_ticks.final_model[k]))
                      for k in ("p", "v")})
        del first, same_ticks
        straight = trainer.train_batched(job, scenarios, args.seeds,
                                         n_ticks=n_ticks, **run_kw)
        market = same_trajectories(resumed, straight, MARKET)
        carry = compare_carries(torch, resumed.final_model,
                                straight.final_model)
        diff = np.abs(np.nan_to_num(resumed.errors)
                      - np.nan_to_num(straight.errors))
        losses_within = bool(
            (np.isnan(resumed.errors) == np.isnan(straight.errors)).all()
            and (diff <= MEGABATCH_TOL[1] + MEGABATCH_TOL[0] * np.abs(
                np.nan_to_num(straight.errors))).all())
    finally:
        shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    return {"config": "qwen2-7b reduced", "n_ticks": n_ticks,
            "scenarios": len(scenarios), "seeds": args.seeds,
            "killed_before_save": 16 if killed else None,
            "shard_files": n_files,
            "k1_launches": {"sharded_ticks_0_16": k1_sharded,
                            "resumed_unsharded_8_end": k1_resumed},
            "bit_equal_same_ticks": equal,
            "vs_straight_unsharded": {
                "market_bit_equal": market, "carry": carry,
                "losses_max_abs_diff": float(diff.max()),
                "losses_within_megabatch_tol": losses_within}}


def phase_mesh(torch, smi, main, resumed):
    """Slice 12's paths, each with the launch counts set to 0 before it
    and read after; one line, then the checks."""
    t0 = time.perf_counter()
    mega = phase_mesh_megabatch(torch, smi, main)
    free(torch)
    fig3 = phase_mesh_fig3(torch, resumed)
    score = phase_mesh_score_requests(torch)
    durable = phase_mesh_durable(torch)
    free(torch)
    n_ticks = main["n_ticks"]
    emit({"phase": "mesh", "phase_s": time.perf_counter() - t0,
          "megabatch": mega, "fig3_uniform": fig3,
          "score_requests": score, "durable_megabatch": durable,
          "card": smi})
    one, two = mega["mesh_1"], mega["two_shards"]
    bad = []
    if one["launches_k1"] != n_ticks or two["launches_k1"] != 2 * n_ticks:
        bad.append(f"K1 launches {one['launches_k1']} / "
                   f"{two['launches_k1']}: want {n_ticks} (one shard) and "
                   f"{2 * n_ticks} (two shards × {n_ticks} ticks)")
    if not all(one["trajectories_bit_equal"].values()) \
            or not one["carry_digest_equal"]:
        bad.append("--mesh 1 differs from the main path's run")
    if not all(two["market_bit_equal"].values()):
        bad.append(f"two shards: market {two['market_bit_equal']}")
    if not (two["carry"]["bit_equal"] and two["losses_bit_equal"]) and not (
            two["carry"]["within_megabatch_tol"]
            and two["losses_within_megabatch_tol"]):
        bad.append(f"two shards: carry {two['carry']}, losses "
                   f"{two['losses_max_abs_diff']}")
    if two["peak_mem_bytes"] > 1.1 * main["peak_mem_bytes"]:
        bad.append(f"two shards' peak {two['peak_mem_bytes']} > 1.1 × "
                   f"{main['peak_mem_bytes']}")
    if not all(fig3["bit_equal"].values()):
        bad.append(f"fig3 in three shards: {fig3['bit_equal']}")
    if not score["bit_equal"] or not score["finite"]:
        bad.append(f"score_requests: {score}")
    vs = durable["vs_straight_unsharded"]
    if not durable["killed_before_save"] or durable["shard_files"] != min(
            2, durable["scenarios"]) \
            or not all(durable["bit_equal_same_ticks"].values()) \
            or not all(vs["market_bit_equal"].values()) \
            or not (vs["carry"]["within_megabatch_tol"]
                    and vs["losses_within_megabatch_tol"]) \
            or durable["k1_launches"] != {
                "sharded_ticks_0_16": 2 * 16,
                "resumed_unsharded_8_end": durable["n_ticks"] - 8}:
        bad.append(f"durable megabatch: {durable}")
    for name, rec in (("fig3_uniform", fig3), ("score_requests", score)):
        if set(rec["launches"].values()) - {0}:
            bad.append(f"{name}: a kernel launched on a path that runs none")
    if bad:
        raise AssertionError("mesh: " + "; ".join(bad))


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
    res, job, launches, main_run = phase_main_path(torch)
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
    resumed = phase_resume(torch, fig3)
    phase_bidserve(torch)
    free(torch)
    phase_durable(torch, smi)
    free(torch)
    for arch in SERVE_TF["archs"]:
        phase_serve_transformer(torch, arch, smi)
    t11 = time.perf_counter()
    k3_hybrid = phase_serve_hybrid(torch, smi)
    k2_hybrid = phase_train_hybrid(torch, smi)
    k2_whisper = phase_train_encdec(torch, smi)
    phase_serve_encdec(torch, smi)
    free(torch)
    t12 = time.perf_counter()
    phase_mesh(torch, smi, main_run, resumed)
    emit({"phase": "total", "seconds": time.perf_counter() - t_main,
          "slice_11_seconds": t12 - t11,
          "slice_12_seconds": time.perf_counter() - t12})
    emit({"kernels": [k1] + k2 + k3 + k3_hybrid + k2_hybrid + k2_whisper})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0

if __name__ == "__main__":
    sys.exit(main())
