"""Rolling-horizon bidding-service launcher.

Streams a replayed multi-market price feed through the online estimator
and the batched candidate scorer, driving concurrent jobs to their (ε, θ)
targets and writing ``decisions.jsonl`` plus a final regret summary. Every
engine call runs on ``--device`` (``cuda`` unless asked for ``cpu``; no
fallback from one to the other).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.bidserve \\
      --jobs 4 --markets 2 --ticks 416 --horizon 32 --warmup 32 \\
      --out runs/serve0
  PYTHONPATH=src python -m repro_torch.launch.bidserve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.bidserve --trace a.npz \\
      --trace b.csv

``--mesh`` and ``--devices`` come with the mesh slice, ``--jit-cache``
with the launch slice; each raises naming its slice.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.sim.engine import not_ported


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.bidserve",
        description="rolling-horizon spot bidding service (replayed feed)")
    ap.add_argument("--jobs", type=int, default=2,
                    help="concurrent jobs, assigned round-robin to markets")
    ap.add_argument("--markets", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=416,
                    help="feed length (synthetic feeds)")
    ap.add_argument("--horizon", type=int, default=32,
                    help="feed ticks between replans")
    ap.add_argument("--warmup", type=int, default=32,
                    help="estimator-only ticks before the first plan")
    ap.add_argument("--trace", action="append", default=[],
                    help="on-disk trace (.npy/.npz/.csv/.json); one per "
                    "market, repeatable — overrides the synthetic feed")
    ap.add_argument("--eps", type=float, default=0.5,
                    help="target error; must clear the demo problem's "
                    "noise floor (~0.24 at 4 workers)")
    ap.add_argument("--theta", type=float, default=120.0,
                    help="deadline in feed-tick time units")
    ap.add_argument("--workers", type=int, default=4,
                    help="fleet size per job")
    ap.add_argument("--score-seeds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multibid", action="store_true",
                    help="add K-level multibid partitions to the slate")
    ap.add_argument("--no-provision", action="store_true",
                    help="drop the Theorem-4 preemptible candidate")
    ap.add_argument("--out", default=None,
                    help="directory for decisions.jsonl")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard candidate scoring over N devices (raises: "
                    "the mesh slice)")
    ap.add_argument("--devices", type=int, default=0,
                    help="force N virtual host devices (raises: the mesh "
                    "slice)")
    ap.add_argument("--json", action="store_true",
                    help="print the full report, not just the summary")
    ap.add_argument("--jit-cache", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="persistent compilation cache (raises: the launch "
                    "slice)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every engine call runs (default cuda)")
    return ap


def run(args) -> dict:
    if args.mesh or args.devices:
        raise not_ported("bidserve --mesh/--devices", "mesh")
    if args.jit_cache is not None:
        raise not_ported("bidserve --jit-cache", "jitcache")
    from repro_torch.core.cost_model import RuntimeModel
    from repro_torch.device import exact_float32
    from repro_torch.service import (BidServer, JobSpec, ServeConfig,
                                     feed_from_traces, synthetic_feed)
    from repro_torch.service.server import demo_problem

    exact_float32()
    if args.trace:
        feed = feed_from_traces(args.trace)
    else:
        feed = synthetic_feed(n_markets=args.markets, n_ticks=args.ticks,
                              seed=args.seed)
    quad, w0, prob = demo_problem(seed=args.seed)
    batch = 4
    jobs = [JobSpec(name=f"job{i}", market=i % feed.n_markets, eps=args.eps,
                    theta=args.theta, n_workers=args.workers)
            for i in range(args.jobs)]
    partitions = ()
    if args.multibid:
        n = args.workers
        partitions = tuple(p for p in
                           ((n // 2, n - n // 2), (n - 1, 1)) if 0 not in p)
    cfg = ServeConfig(
        horizon=args.horizon, warmup=args.warmup,
        score_seeds=args.score_seeds, seed=args.seed, batch=batch,
        multibid_partitions=partitions,
        include_provision=not args.no_provision, out_dir=args.out)
    server = BidServer(
        feed, jobs, prob=prob, quad=quad, w0=w0,
        alpha=prob.alpha, rt_true=RuntimeModel(kind="exp", lam=2.0,
                                               delta=0.05),
        cfg=cfg, device=args.device)
    return server.run()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    report = run(args)
    print(json.dumps(report if args.json else report["summary"], indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
