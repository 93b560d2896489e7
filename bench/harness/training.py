"""The driver of a training grid: set-up, the measured window and the
check, for every entry that trains (``bench/entries/megabatch.py``,
``zoo.py``).

Set-up builds the program once, hands it every replica's weights, and
drives it through its public entry over a fixed number of ticks, the
traffic's ``setup_ticks``, in calls of ``chunk_ticks`` as the window makes
them. The check needs the carry of each replica right after its first
iteration (SGD momentum then is the first gradient as the optimizer got
it) and right after its ``checked``-th (the parameters' change). The
frozen market says on which ticks those fall, so set-up ends a call there
too, which adds a call or two and no tick. A seed whose replicas have not
all run the checked iterations within ``setup_ticks`` runs further whole
chunks until they have (about 1 seed in 100 at the cells' market). The
window then runs the same object on, in chunks, until ``--seconds`` have
passed on the host's clock."""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench.harness import check, program, weights as wmod


@dataclasses.dataclass
class SetupRecord:
    ticks: int
    ends: List[Tuple[int, np.ndarray]]   # (ticks run, iterations) per call
    losses: List[np.ndarray]             # per cell: checked losses
    grad_norms: List[Optional[Dict[str, float]]]
    change_norms: List[Optional[Dict[str, float]]]


@dataclasses.dataclass
class WindowRecord:
    seconds: float
    ticks: int
    chunks: int
    ends: List[Tuple[int, np.ndarray]]
    ys: np.ndarray                 # (cells, J) active workers per iteration
    cell_steps: int                # every cell's step on every tick
    running_steps: int             # the cell-steps that advanced an iteration
    nonfinite: int                 # of those, losses that came back non-finite


def leaf_norms(views: Dict[str, torch.Tensor], s: int, r: int
               ) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v[s, r].float()))
            for k, v in views.items()}


def change_norms(views: Dict[str, torch.Tensor], s: int, r: int, leaves,
                 seed: int, cell: int, device) -> Dict[str, float]:
    """‖p − p0‖ per leaf, p0 made again leaf by leaf from the seed."""
    out = {}
    for leaf in leaves:
        p0 = wmod.make_leaf(leaf, seed, device, cell)
        out[leaf[0]] = float(torch.linalg.vector_norm(
            views[leaf[0]][s, r].float() - p0))
        del p0
    return out


def plan(ref_js: np.ndarray, checked: int, chunk: int, min_ticks: int
         ) -> List[int]:
    """The tick counts at which set-up's calls end: every multiple of
    ``chunk`` up to ``min_ticks`` or, where the frozen market's counts
    ``ref_js`` (ticks, cells) reach ``checked`` later, up to the chunk
    that holds that tick; and for each cell and each count in (1,
    ``checked``) the first tick after the cell reached it, unless a
    multiple of ``chunk`` falls before the cell's next iteration."""
    horizon = len(ref_js)
    done = ref_js >= checked
    last = int(done.all(1).argmax()) + 1 if done.all(1).any() else horizon
    end = max(min_ticks, -(-last // chunk) * chunk)
    ends = set(range(chunk, end + 1, chunk))
    for c in range(ref_js.shape[1]):
        for count in (1, checked):
            at = np.flatnonzero(ref_js[:, c] == count)
            if not len(at):
                continue
            first, past = int(at[0]) + 1, int(at[-1]) + 1
            aligned = -(-first // chunk) * chunk
            if aligned > past:
                ends.add(first)
    return sorted(t for t in ends if t <= end)


def setup(prog, leaves, seed: int, checked: int, traffic: Dict):
    """Returns (carry, SetupRecord)."""
    s_dim, r_dim = prog.grid
    n = s_dim * r_dim
    ref_js, _ = check.frozen_market(traffic, prog.seeds,
                                    int(traffic["max_setup_ticks"]))
    ends_at = plan(ref_js, checked, int(traffic["chunk_ticks"]),
                   int(traffic["setup_ticks"]))
    state = prog.initial_state(leaves, seed)
    grads: List[Optional[Dict]] = [None] * n
    changes: List[Optional[Dict]] = [None] * n
    ends, tick, res = [], 0, None
    for stop in ends_at:
        res = prog.call(state, tick, stop)
        state, tick = res.final_state, stop
        j = res.iterations.reshape(-1).astype(np.int64)
        ends.append((tick, j))
        for i in range(n):
            s, r = divmod(i, r_dim)
            if j[i] == 1 and grads[i] is None:
                grads[i] = leaf_norms(prog.leaves(state, "mom"), s, r)
            if j[i] == checked and changes[i] is None:
                changes[i] = change_norms(prog.leaves(state, "params"), s,
                                          r, leaves, seed, i, prog.device)
    errs = res.errors.reshape(n, -1)
    losses = [errs[i, :min(checked, ends[-1][1][i])].astype(np.float64)
              for i in range(n)]
    return state, SetupRecord(ticks=tick, ends=ends, losses=losses,
                              grad_norms=grads, change_norms=changes)


def window(prog, state, tick: int, seconds: float, chunk: int):
    """Chunks of ``chunk`` ticks from ``tick`` until ``seconds`` have
    passed on the host's clock; every chunk ends in the entry's own read
    back of its trajectories, so the clock stops with the device. Returns
    (carry, WindowRecord)."""
    s_dim, r_dim = prog.grid
    j0 = state.j.reshape(-1).cpu().numpy().astype(np.int64)
    t0 = time.perf_counter()
    ticks = chunks = 0
    ends = []
    while True:
        res = prog.call(state, tick, tick + chunk)
        state, tick = res.final_state, tick + chunk
        ticks, chunks = ticks + chunk, chunks + 1
        ends.append((tick, res.iterations.reshape(-1).astype(np.int64)))
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    j1 = ends[-1][1]
    errs = res.errors.reshape(len(j1), -1)
    bad = sum(int((~np.isfinite(errs[i, j0[i]:j1[i]])).sum())
              for i in range(len(j1)))
    return state, WindowRecord(
        seconds=elapsed, ticks=ticks, chunks=chunks, ends=ends,
        ys=res.ys.reshape(len(j1), -1).astype(np.float64),
        cell_steps=ticks * s_dim * r_dim,
        running_steps=int((j1 - j0).sum()), nonfinite=bad)


@dataclasses.dataclass
class Outcome:
    """What a run measured: ``facts`` for the metrics' readers, the
    compared numbers, and the lines for standard error."""
    facts: Dict
    numbers: Dict[str, float]
    correct: bool
    attempted: int
    failed: int
    memory_peak_bytes: int
    lines: List[str]


def measure(cell, seed: int, seconds: float, window_span, device,
            t0: float) -> Outcome:
    """One run of a training cell: set-up from process start ``t0``, the
    window under ``window_span()`` (the profiler in a traced run), then
    the check, once the program's state is freed."""
    from repro_torch.kernels import ops

    t = cell.traffic
    on_card = torch.device(device).type == "cuda"
    checked = int(t["checked_iterations"])
    phases = [("imports", time.perf_counter() - t0)]
    prog = program.Program(cell, seed, device)
    phases.append(("trainer and scenario", time.perf_counter() - t0))
    leaves = cell.reference.leaves(cell.config)
    state, srec = setup(prog, leaves, seed, checked, t)
    phases.append((f"{srec.ticks} set-up ticks in {len(srec.ends)} calls",
                   time.perf_counter() - t0))
    setup_peak = 0
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    counts0 = dict(ops.launch_counts())
    with window_span():
        state, wrec = window(prog, state, srec.ticks, seconds,
                             int(t["chunk_ticks"]))
    counts = {k: v - counts0.get(k, 0) for k, v in ops.launch_counts().items()}
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the program's state goes before the reference runs
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    total = srec.ticks + wrec.ticks
    ref_js, ref_iters = check.frozen_market(t, prog.seeds, total)
    gap = check.market_gap(srec.ends + wrec.ends, wrec.ys, ref_js,
                           ref_iters)
    ref_runs = check.reference_run(cell.reference, cell.config, t, seed,
                                   ref_iters, prog.batch_fn, device, checked)
    nums = check.numbers(gap, srec.losses, srec.grad_norms,
                         srec.change_norms, ref_runs, checked)
    facts = {"grid": prog.grid, "leaves": leaves, "setup_s": setup_s,
             "window_s": wrec.seconds, "ticks": wrec.ticks,
             "cell_steps": wrec.cell_steps,
             "running_steps": wrec.running_steps,
             "tokens_per_cell_step": t["batch"] * (t["seq_len"] - 1),
             "peak_window_bytes": window_peak, "launch_counts": counts}
    lines = [f"set-up: {name} done at {sec:.3f} s" for name, sec in phases]
    lines.append(f"window: {wrec.ticks} ticks in {wrec.chunks} chunks, "
                 f"{wrec.seconds:.3f} s, {wrec.running_steps} running "
                 f"cell-steps")
    return Outcome(facts=facts, numbers=nums,
                   correct=check.judge(nums, cell.limits),
                   attempted=wrec.cell_steps, failed=wrec.nonfinite,
                   memory_peak_bytes=max(setup_peak, window_peak),
                   lines=lines)
