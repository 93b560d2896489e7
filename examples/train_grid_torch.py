"""Trainer grid on the PyTorch port: train a real (reduced) transformer
under an 8-strategy × 8-seed spot-market grid in one call of the batched
engine, on the card.

Every (strategy, seed) cell runs the full elastic training loop — price
draw, bid→active-mask, masked-renormalized SGD on the model, time/cost/idle
accounting — inside the engine's tick loop, with the grid's cells stacked
on the device (`repro_torch.train.trainer.train_batched`).

Prints the accuracy-vs-cost frontier the paper trades: mean final loss vs
mean $-cost per strategy, plus the per-cell spread over seeds.

The run is preemption-safe end to end: `--snapshot-every k` makes the
engine keep its full carry every k ticks; the demo then persists the
*first* snapshot, pretends the job died there, resumes from disk, and
verifies the resumed grid is bit-exact with the uninterrupted one.

Run: PYTHONPATH=src python examples/train_grid_torch.py [--seeds 8]
         [--steps 40] [--snapshot-every 20] [--device cpu]
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core import bidding, strategies as strat
from repro_torch.core.cost_model import RuntimeModel, UniformPrice
from repro_torch.device import resolve_device
from repro_torch.sim import engine
from repro_torch.train.trainer import (restore_batched, save_batched,
                                       train_batched)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--snapshot-every", type=int, default=20,
                    help="full-carry checkpoint cadence in ticks "
                         "(0 disables the kill-and-resume demo)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    n_w, J = 4, args.steps
    cfg = ARCHS["qwen2-7b"].reduced().with_(
        num_layers=1, d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
        vocab_size=128, head_dim=16)
    job = JobConfig(model=cfg, shape=InputShape("grid", 16, 8, "train"),
                    n_workers=n_w, learning_rate=0.1)
    dist = UniformPrice(0.2, 1.0)
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)

    def two_bid(b1, b2, name):
        return strat.FixedBids(bidding.BidPlan(
            n=n_w, n1=n_w // 2, b1=b1, b2=b2, J=J, expected_cost=0,
            expected_time=0, expected_error=0), name=name)

    strategies = [two_bid(1.0, round(b2, 2), f"b2={b2:.2f}")
                  for b2 in np.linspace(0.3, 1.0, 8)]
    scenarios = [engine.scenario_from_strategy(
        s, alpha=job.learning_rate, rt=rt, dist=dist, n_max=n_w,
        name=s.name) for s in strategies]

    print(f"training {len(scenarios)} strategies x {args.seeds} seeds "
          f"({len(scenarios) * args.seeds} end-to-end runs of a "
          f"{cfg.name}-reduced transformer, J={J}) on {device}...")
    t0 = time.time()
    n_ticks = 2 * J + 16
    res = train_batched(job, scenarios, seeds=args.seeds, n_ticks=n_ticks,
                        snapshot_every=args.snapshot_every, device=device)
    wall = time.time() - t0
    runs = res.losses.shape[0] * res.losses.shape[1]
    print(f"wall={wall:.1f}s ({runs / wall:.1f} training runs/sec, "
          f"completed={res.completed.mean():.0%})\n")

    print(f"{'strategy':>10} {'final_loss':>16} {'cost':>14} "
          f"{'idle':>8} {'mean_y':>7}")
    s = res.summary()
    for i, sc in enumerate(scenarios):
        fl = res.losses[i, :, -1]
        print(f"{sc.name:>10} {np.nanmean(fl):>9.3f} ±{np.nanstd(fl):.3f} "
              f"{res.total_cost[i].mean():>9.1f} "
              f"±{res.total_cost[i].std():.1f} "
              f"{res.total_idle[i].mean():>8.1f} "
              f"{np.nanmean(s['mean_active'][i]):>7.2f}")
    print("\nlow b2 → cheaper but slower/noisier (fewer active workers); "
          "the frontier is the paper's accuracy-vs-cost trade-off on a "
          "real model.")

    if args.snapshot_every and res.snapshots is not None:
        # kill-and-resume demo: persist the first snapshot, pretend the
        # grid died there, restore from disk and finish the run — the
        # resumed run must be bit-exact with the uninterrupted one
        path = os.path.join(tempfile.mkdtemp(prefix="train_grid_torch_"),
                            "grid.npz")
        tick = save_batched(path, res, index=0)
        state, tick = restore_batched(path, job, scenarios, args.seeds,
                                      device=device)
        t0 = time.time()
        resumed = train_batched(job, scenarios, seeds=args.seeds,
                                n_ticks=n_ticks, init_state=state,
                                tick0=tick, device=device)
        exact = (np.array_equal(resumed.losses, res.losses, equal_nan=True)
                 and np.array_equal(resumed.total_cost, res.total_cost))
        print(f"\nkill-and-resume: checkpointed the full batched carry at "
              f"tick {tick} ({os.path.getsize(path) / 1e6:.1f} MB), "
              f"resumed {n_ticks - tick} ticks in {time.time() - t0:.1f}s "
              f"-> bit-exact with the uninterrupted run: {exact}")
        assert exact, "resumed run diverged from the uninterrupted one"


if __name__ == "__main__":
    main()
