"""End-to-end run on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps on volatile (simulated-spot) workers, with elastic
masking, cost accounting, and preemption-safe checkpointing — the full
production loop, on the card.

The default model is a 4-layer, d=512 qwen2-family LM with the full 152k
vocab (≈ 160M params, embedding-dominated — deliberate: it matches how
~100M-class LMs actually spend parameters). Use --tiny for a seconds-long
smoke run. The checkpoint goes to the temporary directory unless --ckpt
names a path.

Run: PYTHONPATH=src python examples/elastic_training_e2e_torch.py \
         [--steps 300] [--tiny] [--device cpu]
"""
import argparse
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core import convergence as conv, strategies as strat
from repro_torch.core.cost_model import RuntimeModel, UniformPrice
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.models.common import param_count
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.sim.spot_market import IIDPrices, SpotMarket
from repro_torch.train.trainer import ElasticTrainer


def build_model(tiny: bool):
    base = ARCHS["qwen2-7b"]
    if tiny:
        return base.reduced()
    return base.with_(num_layers=4, d_model=512, num_heads=8,
                      num_kv_heads=4, d_ff=1536, head_dim=64,
                      dtype="float32", param_dtype="float32")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "elastic_e2e_torch.npz"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = build_model(args.tiny)
    n_params = param_count(model_zoo.param_defs(cfg))
    print(f"model: {cfg.name}-e2e  params={n_params / 1e6:.1f}M")

    job = JobConfig(model=cfg,
                    shape=InputShape("e2e", seq_len=args.seq,
                                     global_batch=args.batch, kind="train"),
                    n_workers=args.workers, learning_rate=0.1)
    dist = UniformPrice(0.2, 1.0)
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    prob = conv.SGDProblem(alpha=0.05, c=1.0, mu=1.0, L=2.0, M=4.0, G0=10.0)
    plan = strat.optimal_two_bids(prob, 0.5, 10 * args.steps, args.workers,
                                  dist, rt, n1=args.workers // 2)
    print(f"bids: b1={plan.plan_.b1:.3f} (x{plan.plan_.n1}) "
          f"b2={plan.plan_.b2:.3f} (x{plan.plan_.n - plan.plan_.n1})")

    cluster = VolatileCluster(n_workers=args.workers, runtime=rt,
                              market=SpotMarket(IIDPrices(dist, seed=0)))
    trainer = ElasticTrainer(job=job, cluster=cluster, strategy=plan,
                             mode="spot", checkpoint_path=args.ckpt,
                             checkpoint_every=50, device=device)
    t0 = time.time()
    summary = trainer.run(iterations=args.steps)
    wall = time.time() - t0

    log = summary.pop("log")
    losses = [e.loss for e in log]
    print(json.dumps(summary, indent=1, default=float))
    print(f"wall={wall:.1f}s  steps/s={args.steps / wall:.2f} on {device}")
    print(f"loss: first10={np.mean(losses[:10]):.3f} "
          f"last10={np.mean(losses[-10:]):.3f}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "loss did not drop"
    print("checkpoint at", args.ckpt, "- resume by constructing the trainer "
          "and calling .restore()")


if __name__ == "__main__":
    main()
