"""Strategy comparison on the simulated spot market (paper §VI, Figs. 3–4),
through the PyTorch port.

Calibrates the Theorem-1 constants on the quadratic oracle problem (so the
optimizers see honest (c, L, M, G0)), then runs all four strategies under
uniform / Gaussian / trace prices and reports cost-to-target-error — the
paper's headline comparison. The runs go through the legacy one-scenario
loop (`sim.evaluate.run_spot_strategy`), which is numpy on the host as the
reference's is; the card is asked for all the same, as every example of
the port asks for it (`examples/scenario_sweep_torch.py` runs such grids
on the card).

Run: PYTHONPATH=src python examples/spot_bidding_torch.py [--reps 5]
         [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import convergence as conv, strategies as strat
from repro_torch.core.cost_model import (RuntimeModel, TruncGaussianPrice,
                                         UniformPrice)
from repro_torch.device import resolve_device
from repro_torch.sim.evaluate import (average_runs, calibrated_quadratic,
                                      run_spot_strategy)
from repro_torch.sim.spot_market import (IIDPrices, SpotMarket, TracePrices,
                                         synthetic_history)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--eps", type=float, default=0.35)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    resolve_device(args.device)

    # calibrate constants on the oracle problem (shared with benchmarks)
    quad, w0, prob, batch = calibrated_quadratic()
    print(f"calibrated: c={prob.c:.2f} L={prob.L:.2f} M={prob.M:.2f} "
          f"G0={prob.G0:.2f} beta={prob.beta:.4f}")

    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    n = 8
    floor = prob.B / (1 - prob.beta)
    if args.eps <= floor / n:
        args.eps = 5.0 * floor / n
        print(f"eps below the Theorem-1 noise floor; using eps={args.eps:.3f}")
    j_min = conv.phi_inverse(prob, args.eps, 1.0 / n)
    theta = 3.0 * j_min * rt.expected(n)
    trace = synthetic_history(hours=24 * 30, seed=0)
    markets = {
        "uniform": (UniformPrice(0.2, 1.0),
                    lambda s, d: SpotMarket(IIDPrices(d, seed=s))),
        "gaussian": (TruncGaussianPrice(0.6, 0.175, 0.2, 1.0),
                     lambda s, d: SpotMarket(IIDPrices(d, seed=s))),
        "trace": (TracePrices(trace, step=0.05).empirical_dist(),
                  lambda s, d: SpotMarket(TracePrices(np.roll(trace,
                                                              s * 1013),
                                                      step=0.05))),
    }

    for mname, (dist, mk) in markets.items():
        print(f"\n=== {mname} prices ===")
        strategies = {
            "no-interruptions": strat.no_interruptions(prob, args.eps, n,
                                                       dist, rt),
            "optimal-one-bid": strat.optimal_one_bid(prob, args.eps, theta,
                                                     n, dist, rt),
            "optimal-two-bids": strat.optimal_two_bids(
                prob, args.eps, theta, n, dist, rt, n1=n // 2),
            "dynamic-bids": strat.DynamicBids(
                prob, args.eps, theta, dist, rt, stage1=(2, 4),
                stage2=(4, 8), switch_at=2),
        }
        strategies["dynamic-bids"].switch_at = max(
            2, int(0.4 * strategies["dynamic-bids"].total_iterations))
        costs = {}
        for name, s in strategies.items():
            def padded_bids(t, j, s=s):
                b = s.bids(t, j)
                return np.pad(b, (0, n - len(b)),
                              constant_values=dist.lo - 1) \
                    if len(b) < n else b

            class P:
                total_iterations = s.total_iterations
                bids = staticmethod(padded_bids)

            run = average_runs(lambda seed: run_spot_strategy(
                quad, w0, prob.alpha, P, mk(seed, dist), rt, seed=seed,
                batch=batch), args.reps)
            eps_emp = args.eps / 4   # bounds are conservative; measure the
            cost = run.cost_to_error(eps_emp)   # empirical target
            if not np.isfinite(cost):
                cost = float(run.costs[-1])
            costs[name] = cost
            print(f"  {name:18s} J={s.total_iterations:4d} "
                  f"cost_to_emp={cost:8.2f}  "
                  f"time={run.times[-1]:7.1f}  "
                  f"final_err={run.errors[-1]:.4f}")
        no_int = costs["no-interruptions"]
        for name, c in costs.items():
            if name != "no-interruptions" and np.isfinite(c) and \
                    np.isfinite(no_int):
                print(f"  -> {name}: {100 * (1 - c / no_int):.1f}% cheaper "
                      "than no-interruptions")


if __name__ == "__main__":
    main()
