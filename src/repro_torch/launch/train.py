"""Training launcher: the paper's experiment on the card.

``--batched --megabatch [--fused-update]`` trains a strategy × ``--seeds``
grid of replicas of a real model under the simulated spot market (the
full pipeline: strategy → bids → preemptions → masked SGD → cost
accounting) through ``trainer.train_batched(megabatch=True)``, and prints
the per-scenario JSON summary. The other modes of the reference launcher
(the legacy loop, the dry run, meshes, the supervisor, and with it the
bf16 zoo path behind ``--param-dtype``) come with later slices of the
port; the zoo path itself is ``trainer.train_zoo``.

Example (one H100, full-width Qwen2-7B at two layers):
  PYTHONPATH=src python -m repro_torch.launch.train --config qwen2_7b \\
      --reduce-depth 2 --param-dtype float32 --batched --megabatch \\
      --fused-update --seeds 2 --iterations 3
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core import convergence as conv
from repro_torch.core import strategies as strat
from repro_torch.core.cost_model import (RuntimeModel, TruncGaussianPrice,
                                         UniformPrice)
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.sim.spot_market import (IIDPrices, SpotMarket, TracePrices,
                                         synthetic_history)


def default_problem() -> conv.SGDProblem:
    """A conservative constant set for LM fine-tuning-scale jobs."""
    return conv.SGDProblem(alpha=0.05, c=1.0, mu=1.0, L=4.0, M=8.0, G0=10.0)


def build_strategy(name, prob, eps, theta, n, dist, rt):
    if name == "no-interruptions":
        return strat.no_interruptions(prob, eps, n, dist, rt)
    if name == "optimal-one-bid":
        return strat.optimal_one_bid(prob, eps, theta, n, dist, rt)
    if name == "optimal-two-bids":
        return strat.optimal_two_bids(prob, eps, theta, n, dist, rt)
    if name == "dynamic-bids":
        return strat.DynamicBids(prob, eps, theta, dist, rt,
                                 stage1=(n // 4, n // 2), stage2=(n // 2, n),
                                 switch_at=max(1, int(0.4 * strat.optimal_two_bids(
                                     prob, eps, theta, n // 2, dist, rt
                                 ).total_iterations)))
    raise ValueError(name)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-7b")
    ap.add_argument("--config", default=None, metavar="NAME",
                    help="alias for --arch accepting underscore spelling "
                         "(qwen2_7b == qwen2-7b)")
    ap.add_argument("--reduce-depth", type=int, default=None, metavar="N",
                    help="run the FULL arch config (real widths/vocab) at "
                         "N layers instead of the reduced smoke variant")
    ap.add_argument("--param-dtype", default=None,
                    help="override the model param/activation dtype; the "
                         "megabatch path takes float32 only (bf16 zoo "
                         "training comes with --supervise, a later slice)")
    ap.add_argument("--strategy", default="optimal-two-bids",
                    choices=["no-interruptions", "optimal-one-bid",
                             "optimal-two-bids", "dynamic-bids"])
    ap.add_argument("--price", default="uniform",
                    choices=["uniform", "gaussian", "trace"])
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--theta", type=float, default=400.0)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batched", action="store_true",
                    help="batched engine: strategy × --seeds replicas "
                         "trained together (the only mode ported so far)")
    ap.add_argument("--seeds", type=int, default=4,
                    help="number of market seeds for --batched")
    ap.add_argument("--megabatch", action="store_true",
                    help="fold the replica axis into blocked params + a "
                         "widened batch dim (requires --batched; dense "
                         "fp32 SGD models only)")
    ap.add_argument("--fused-update", action="store_true",
                    help="apply the elastic SGD update with the fused "
                         "CUDA kernel (requires --megabatch)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to train (default cuda; without a card "
                         "the run fails rather than falling back)")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.config:
        arch = args.config.replace("_", "-")
        if arch not in ARCHS:
            ap.error(f"--config {args.config!r} does not name a config "
                     f"(known: {', '.join(sorted(ARCHS))})")
        args.arch = arch
    if args.param_dtype and args.param_dtype not in ("float32", "fp32",
                                                     "f32"):
        ap.error("--param-dtype other than float32 reaches the zoo "
                 "mixed-precision program only under --supervise, which "
                 "comes with the supervisor slice of the port (in Python, "
                 "trainer.train_zoo runs it now)")
    if args.fused_update and not args.megabatch:
        ap.error("--fused-update requires --megabatch")
    if args.megabatch and not args.batched:
        ap.error("--megabatch requires --batched")
    if not (args.batched and args.megabatch):
        ap.error("only --batched --megabatch is ported so far (the legacy "
                 "loop, the vmapped path and the dry run come with later "
                 "slices)")
    return args


def build_trainer(args: argparse.Namespace):
    """The job, market, strategy and cluster the CLI flags describe, as an
    ``ElasticTrainer`` on ``args.device``."""
    from repro_torch.train.trainer import ElasticTrainer

    if args.reduce_depth:
        cfg = get_config(args.arch).with_(num_layers=args.reduce_depth)
    else:
        cfg = get_config(args.arch).reduced()
    if args.param_dtype:
        cfg = cfg.with_(dtype=args.param_dtype,
                        param_dtype=args.param_dtype)
    shape = InputShape("local", seq_len=args.seq, global_batch=args.batch,
                       kind="train")
    job = JobConfig(model=cfg, shape=shape, n_workers=args.workers)

    if args.price == "uniform":
        dist = UniformPrice(0.2, 1.0)
        proc = IIDPrices(dist, seed=args.seed)
    elif args.price == "gaussian":
        dist = TruncGaussianPrice()
        proc = IIDPrices(dist, seed=args.seed)
    else:
        trace = synthetic_history(seed=args.seed)
        proc = TracePrices(trace, step=0.05)
        dist = proc.empirical_dist()
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    prob = default_problem()

    strategy = build_strategy(args.strategy, prob, args.eps, args.theta,
                              args.workers, dist, rt)
    cluster = VolatileCluster(n_workers=args.workers, runtime=rt,
                              market=SpotMarket(proc), seed=args.seed)
    return ElasticTrainer(job=job, cluster=cluster, strategy=strategy,
                          seed=args.seed, device=args.device)


def run(args: argparse.Namespace) -> Tuple[object, Dict]:
    """Train as the flags say; returns (``BatchResult``, the summary the
    CLI prints)."""
    trainer = build_trainer(args)
    res = trainer.run_batched(seeds=args.seeds, iterations=args.iterations,
                              megabatch=args.megabatch,
                              use_fused_update=args.fused_update)
    out = {name: res.run(name).summary for name in res.names}
    out["_engine"] = {"replicas": len(res.names) * res.n_seeds,
                      "megabatch": args.megabatch,
                      "fused_update": args.fused_update,
                      "mesh": None}
    return res, out


def main(argv: Optional[Sequence[str]] = None) -> int:
    _, out = run(parse_args(argv))
    print(json.dumps(out, indent=1, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
