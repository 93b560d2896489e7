"""The comparison that decides ``correct`` for a training cell.

The reference (the configuration's plain float32 file, `elastic_sgd` and
the frozen market fed the traffic's own bids) follows the first
``checked`` iterations of every replica from the same weights (each
replica its own), batches and market seeds. Compared:

* ``market``: over every call of the entry in set-up and in the window,
  the replicas whose iteration counter at the call's end differs from the
  frozen market's, plus the iterations run up to the window's end whose
  count of active workers differs (an iteration that one side ran and the
  other did not counts once): an exact comparison (limit 0). The program
  reports no masks, only their counts; a mask that differs at the same
  count changes the rows that weigh, and so the loss and the gradient.
* ``loss``: the largest relative gap of a checked iteration's loss.
* ``grad``: over replicas and leaves, |‖g‖ − ‖g_ref‖| of the first
  gradient as the optimizer got it, over the larger of ‖g_ref‖ for that
  leaf and the median leaf's.
* ``change``: the same of the parameters' change after the last checked
  iteration, leaving out leaves whose reference first gradient is under
  a thousandth of the median leaf's (a key's bias under softmax moves by
  round-off alone).

A number that is not finite reads as infinite, so it fails its limit."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.harness import weights as wmod
from bench.reference import elastic_sgd, market
from bench.reference.precision import products

NAMES = ("market", "loss", "grad", "change")
#: leaves whose reference first gradient is under this share of the
#: median leaf's are left out of ``change``
SMALL_GRAD = 1e-3


def frozen_market(traffic: Dict, seeds: Sequence[int], n_ticks: int):
    """The frozen market over ticks 0 … n_ticks-1 for every cell of the
    grid (scenario-major; every scenario runs the traffic's bids over the
    replicas' market ``seeds``): (j after each tick (n_ticks, cells), and
    per cell the list of (tick, mask, y) of every iteration it ran). Each
    worker's bid, stated in the traffic, holds for every iteration."""
    bids = np.asarray(traffic["bids"], np.float32)[None]
    cells = np.tile(np.asarray(seeds, np.int64), int(traffic["scenarios"]))
    return market.replay(cells, n_ticks, bids, traffic["price_lo"],
                         traffic["price_hi"], int(traffic["iterations"]))


def market_gap(ends: List[Tuple[int, np.ndarray]], prog_ys: np.ndarray,
               ref_js: np.ndarray, ref_iters) -> int:
    """``ends``: (ticks run, the program's iteration counts) at the end of
    every call; ``prog_ys`` (cells, J) the program's active workers per
    iteration, NaN past the last it ran; ``ref_js`` and ``ref_iters`` the
    frozen market's over at least as many ticks."""
    gap = sum(int((j != ref_js[t - 1]).sum()) for t, j in ends if t > 0)
    for ys, ref in zip(prog_ys, ref_iters):
        ys = ys[np.isfinite(ys)]
        ref_ys = np.array([y for _, _, y in ref], np.float64)
        n = min(len(ys), len(ref_ys))
        gap += abs(len(ys) - len(ref_ys)) + int((ys[:n] != ref_ys[:n]).sum())
    return gap


def reference_run(ref, conf: Dict, traffic: Dict, seed: int, iters,
                  batch_fn, device, checked: int,
                  precision: str = "float32", fault: Optional[str] = None):
    """Per cell of the grid, from its own weights and the frozen market's
    masks (``iters``): losses (checked,), first-gradient norms and change
    norms by leaf."""
    leaves = ref.leaves(conf)
    b = traffic["batch"]
    lr, mu = traffic["learning_rate"], traffic["momentum"]
    return [_follow(ref, conf, leaves, seed, cell, steps[:checked], batch_fn,
                    b, lr, mu, device, precision, fault)
            for cell, steps in enumerate(iters)]


def _follow(ref, conf, leaves, seed, cell, steps, batch_fn, b, lr, mu,
            device, precision, fault):
    w = wmod.make_all(leaves, seed, device, cell)
    for x in w.values():
        x.requires_grad_(True)
    mom = {k: torch.zeros_like(x) for k, x in w.items()}
    losses, grad_norms = [], None
    for i, (_, mask, _) in enumerate(steps):
        batch = batch_fn(i)
        tokens = torch.as_tensor(batch["tokens"], device=device)
        labels = torch.as_tensor(batch["labels"], device=device)
        rows = elastic_sgd.row_weights(mask, b)
        if fault == "half_batch":
            live = np.flatnonzero(rows)
            rows[live[1::2]] = 0.0
        if fault == "token":
            row = int(np.flatnonzero(rows)[0]) if rows.any() else 0
            tokens = tokens.clone()
            tokens[row, 0] = (tokens[row, 0] + 1) % conf["vocab_size"]
        wts = torch.as_tensor(rows, device=device)[:, None].expand(
            tokens.shape).contiguous()
        with products(precision):
            loss = ref.loss(w, conf, tokens, labels, wts, precision)
            grads = torch.autograd.grad(loss, list(w.values()))
        grads = dict(zip(w.keys(), grads))
        losses.append(float(loss.detach()))
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g))
                          for k, g in grads.items()}
        with torch.no_grad():
            elastic_sgd.step(w, mom, grads, lr, mu)
        del grads, loss
    del mom
    changes = {}
    with torch.no_grad():
        for leaf in leaves:
            p0 = wmod.make_leaf(leaf, seed, device, cell)
            changes[leaf[0]] = float(torch.linalg.vector_norm(
                w[leaf[0]] - p0))
            del p0
    del w
    return {"losses": np.array(losses, np.float64),
            "grad_norms": grad_norms, "change_norms": changes}


def _rel_norm_gap(prog: Dict[str, float], ref: Dict[str, float],
                  keep: Optional[List[str]] = None) -> float:
    keys = keep if keep is not None else list(ref)
    if not keys:
        return math.inf
    med = float(np.median([ref[k] for k in keys]))
    worst = 0.0
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def numbers(market: int, prog_losses: Sequence[np.ndarray],
            prog_grads: List[Optional[Dict]],
            prog_changes: List[Optional[Dict]], ref_runs: List[Dict],
            checked: int) -> Dict[str, float]:
    """The four compared numbers (see the module's docstring), from the
    market's gap and, per cell, the program's checked losses, first
    gradient norms and change norms (None where it never got there)."""
    loss_gap = grad_gap = change_gap = 0.0
    for i, rr in enumerate(ref_runs):
        if len(rr["losses"]) < checked or len(prog_losses[i]) < checked \
                or prog_grads[i] is None or prog_changes[i] is None:
            return {"market": market + 1, "loss": math.inf,
                    "grad": math.inf, "change": math.inf}
        gap = np.abs(prog_losses[i] - rr["losses"]) / np.abs(rr["losses"])
        loss_gap = max(loss_gap, float(gap.max()) if np.isfinite(gap).all()
                       else math.inf)
        g = rr["grad_norms"]
        grad_gap = max(grad_gap, _rel_norm_gap(prog_grads[i], g))
        med = float(np.median(list(g.values())))
        keep = [k for k, v in g.items() if v >= SMALL_GRAD * med]
        change_gap = max(change_gap, _rel_norm_gap(
            prog_changes[i], rr["change_norms"], keep))
    return {"market": market, "loss": loss_gap, "grad": grad_gap,
            "change": change_gap}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(nums[k] <= limits[k] for k in NAMES)
