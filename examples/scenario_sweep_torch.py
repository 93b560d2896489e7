"""Batched scenario sweep on the PyTorch port: a 200-point two-bid grid in
one call of the vectorized engine, on the card.

Sweeps 20 high-bid levels b1 × 10 low/high-bid ratios (b2 = lo + r·(b1−lo))
for an 8-worker fleet (4 workers on each bid) under uniform i.i.d. spot
prices, 4 seeds per point — 800 simulated jobs — and prints the cost-vs-
error Pareto frontier (`repro_torch.sim.engine`).

Run: PYTHONPATH=src python examples/scenario_sweep_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.cost_model import RuntimeModel, UniformPrice
from repro_torch.data.synthetic import QuadraticProblem
from repro_torch.device import resolve_device
from repro_torch.sim import engine

N1, N, J, SEEDS = 4, 8, 150, 4


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # label noise keeps gradient noise alive at the optimum, so the error
    # floor depends on the realized active-worker counts — the frontier
    # trades idle-time cost against that floor
    quad = QuadraticProblem(dim=10, n_samples=256, cond=8.0, noise=0.3,
                            label_noise=1.0, seed=0)
    w0 = quad.w_star + 2.0 * np.ones(quad.dim) / np.sqrt(quad.dim)
    alpha = 0.5 / quad.L
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    dist = UniformPrice(0.2, 1.0)

    grid = [(b1, r) for b1 in np.linspace(0.35, 1.0, 20)
            for r in np.linspace(0.0, 1.0, 10)]
    scenarios = []
    for b1, r in grid:
        b2 = dist.lo + r * (b1 - dist.lo)
        bids = np.concatenate([np.full(N - N1, b1), np.full(N1, b2)])
        scenarios.append(engine.Scenario(
            price=engine.PriceSpec.uniform(dist.lo, dist.hi), alpha=alpha,
            bid_schedule=np.tile(bids, (J, 1)), rt_kind="exp", rt_lam=2.0,
            rt_delta=0.05, idle_step=rt.expected(N),
            name=f"b1={b1:.2f},b2={b2:.2f}"))

    cfg = engine.SimConfig(n_ticks=6 * J, batch=1)
    t0 = time.time()
    res = engine.simulate(scenarios, quad, w0, SEEDS, cfg, device=device)
    dt = time.time() - t0
    print(f"# {len(scenarios)} scenarios x {SEEDS} seeds in {dt:.2f}s "
          f"({len(scenarios) * SEEDS / dt:.0f} sims/sec on {device}), "
          f"completed={float(res.completed.mean()):.2f}")

    # mean final cost / tail error per scenario (seeds axis), then the
    # frontier (tail-20 mean error ≈ the scenario's noise floor)
    tail = np.stack([np.nanmean(res.errors[i, :, max(j - 20, 0):j], axis=-1)
                     for i, j in enumerate(res.J)])
    cost = np.nanmean(res.total_cost, axis=1)
    err = np.nanmean(tail, axis=1)

    order = np.argsort(cost)
    frontier, best = [], np.inf
    for i in order:
        if err[i] < best:
            best = err[i]
            frontier.append(i)
    print("# cost-vs-error Pareto frontier (cheapest first)")
    print("name,cost,final_err,mean_active,idle")
    s = res.summary()
    for i in frontier:
        print(f"{scenarios[i].name},{cost[i]:.1f},{err[i]:.2e},"
              f"{np.nanmean(s['mean_active'][i]):.2f},"
              f"{np.nanmean(s['idle'][i]):.1f}")


if __name__ == "__main__":
    main()
