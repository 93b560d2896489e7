"""Quickstart on the PyTorch port: the paper's pipeline in five steps.

1. Pick a model + workload shape.
2. Derive the SGD convergence constants (Theorem 1).
3. Ask the optimizer for spot bids (Theorem 2/3) under (ε, θ).
4. Run elastic SGD against the simulated spot market, on the card.
5. Read the cost/error/time report.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the card by default; without one it stops unless ``--device cpu``)
"""
import argparse

from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core import bidding, convergence as conv, strategies as strat
from repro_torch.core.cost_model import RuntimeModel, UniformPrice
from repro_torch.device import resolve_device
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.sim.spot_market import IIDPrices, SpotMarket
from repro_torch.train.trainer import ElasticTrainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    # 1. model + workload (reduced variant so this runs in seconds)
    cfg = ARCHS["qwen2-7b"].reduced()
    job = JobConfig(model=cfg, shape=InputShape("demo", seq_len=32,
                                                global_batch=8,
                                                kind="train"),
                    n_workers=4, learning_rate=0.1)

    # 2. convergence constants (here: conservative hand-set values; see
    #    examples/spot_bidding_torch.py for calibrating them from a probe)
    prob = conv.SGDProblem(alpha=0.05, c=1.0, mu=1.0, L=2.0, M=4.0, G0=10.0)
    eps, theta = 0.5, 800.0

    # 3. optimal bids for a 4-worker fleet under uniform spot prices
    dist = UniformPrice(0.2, 1.0)
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    plan = bidding.co_optimize_two_bids(prob, eps, theta, job.n_workers,
                                        dist, rt)
    print(f"two-bid plan: n1={plan.n1} b1={plan.b1:.3f} b2={plan.b2:.3f} "
          f"J={plan.J}")
    print(f"  expected cost={plan.expected_cost:.1f} "
          f"time={plan.expected_time:.1f} error≤{plan.expected_error:.3f}")

    # 4. elastic training against the simulated market
    cluster = VolatileCluster(n_workers=job.n_workers, runtime=rt,
                              market=SpotMarket(IIDPrices(dist, seed=0)))
    trainer = ElasticTrainer(job=job, cluster=cluster,
                             strategy=strat.FixedBids(plan), mode="spot",
                             device=device)
    summary = trainer.run(iterations=15)

    # 5. report
    print(f"ran {summary['iterations']} iterations on {device}; "
          f"wall-time {summary['time']:.1f}; cost {summary['cost']:.1f}; "
          f"mean active workers {summary['mean_active']:.2f}; "
          f"final loss {summary['final_loss']:.3f}")
    ys = [e.y for e in summary["log"]]
    print("active workers per iteration:", ys)


if __name__ == "__main__":
    main()
