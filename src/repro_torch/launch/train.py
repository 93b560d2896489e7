"""Training launcher: the paper's experiment on the card.

Modes:
* ``--batched [--megabatch [--fused-update]]`` trains a strategy ×
  ``--seeds`` grid of replicas of a real model under the simulated spot
  market (the full pipeline: strategy → bids → preemptions → masked SGD →
  cost accounting) through ``trainer.train_batched`` — per cell, or
  replica-blocked with ``--megabatch`` — and prints the per-scenario JSON
  summary.
* ``--local`` runs the legacy per-iteration loop (``ElasticTrainer.run``).
* ``--supervise --run-dir D`` pins the workload as a ``WorkerSpec`` and
  runs durable training under the self-healing supervisor
  (``launch/supervisor.py``): a worker subprocess, a heartbeat watchdog,
  restarts from the newest valid checkpoint. ``--param-dtype bfloat16``
  selects the zoo's mixed-precision program there.
* with none of these, the dry run: the roofline record of one step of
  ``--arch`` at ``--shape`` over the production mesh
  (``launch.dryrun.dry_run_one``), timed on ``--card``'s peaks (default:
  the visible card's).

``--batched --mesh N [--mesh-replica M]`` shards the grid over N devices
(an N × M scenario × replica mesh with ``--mesh-replica``) through
``engine.simulate_sharded``: the first cards, or on the CPU the host
devices of ``launch.mesh.HOST_DEVICES_ENV``. The result JSON reports the
mesh's axis sizes. ``--jit-cache`` is accepted and changes nothing (the
kernels build once into ``_build/``).

Example (one H100, full-width Qwen2-7B at two layers):
  PYTHONPATH=src python -m repro_torch.launch.train --config qwen2_7b \\
      --reduce-depth 2 --param-dtype float32 --batched --megabatch \\
      --fused-update --seeds 2 --iterations 3
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs import ARCHS, SHAPES, get_config
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
    ap.add_argument("--shape", choices=sorted(SHAPES), default="train_4k",
                    help="the dry run's input shape")
    ap.add_argument("--card", default=None, metavar="NAME",
                    help="the dry run's card, whose peaks time its terms "
                         "(default: the visible card's name)")
    ap.add_argument("--config", default=None, metavar="NAME",
                    help="alias for --arch accepting underscore spelling "
                         "(qwen2_7b == qwen2-7b)")
    ap.add_argument("--reduce-depth", type=int, default=None, metavar="N",
                    help="run the FULL arch config (real widths/vocab) at "
                         "N layers instead of the reduced smoke variant; a "
                         "config's leading dense layers stay, and the cut "
                         "falls on the layers after them")
    ap.add_argument("--param-dtype", default=None,
                    help="override the model param/activation dtype (e.g. "
                         "bfloat16 — implies the zoo mixed-precision "
                         "program, which runs under --supervise)")
    ap.add_argument("--zoo", action="store_true",
                    help="train through the zoo program (trainer.train_zoo:"
                         " mixed-precision carries, bf16 checkpoints) in "
                         "the supervised worker")
    ap.add_argument("--jit-cache", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="the reference's persistent compilation cache; "
                         "the kernels already build once into _build/, so "
                         "this changes nothing")
    ap.add_argument("--local", action="store_true",
                    help="the legacy per-iteration loop "
                         "(ElasticTrainer.run) with the simulated market")
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
                         "trained together (implies --local)")
    ap.add_argument("--seeds", type=int, default=4,
                    help="number of market seeds for --batched")
    ap.add_argument("--megabatch", action="store_true",
                    help="fold the replica axis into blocked params + a "
                         "widened batch dim (requires --batched; dense "
                         "fp32 SGD models only)")
    ap.add_argument("--fused-update", action="store_true",
                    help="apply the elastic SGD update with the fused "
                         "CUDA kernel (requires --megabatch)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard the batched grid's scenario axis over N "
                         "devices via simulate_sharded (requires "
                         "--batched; bit for bit the unsharded run; on the "
                         "CPU, N host devices from "
                         "REPRO_TORCH_HOST_DEVICES)")
    ap.add_argument("--mesh-replica", type=int, default=None, metavar="M",
                    help="also shard the seed axis over M devices (2-D "
                         "N x M scenario x replica mesh; requires --mesh)")
    ap.add_argument("--supervise", action="store_true",
                    help="run durable batched training under the "
                         "self-healing supervisor (subprocess worker, "
                         "heartbeat watchdog, restart-on-crash; requires "
                         "--run-dir)")
    ap.add_argument("--run-dir", default=None,
                    help="supervisor run directory (spec, checkpoints, "
                         "heartbeat, recovery log)")
    ap.add_argument("--save-every", type=int, default=8,
                    help="durable checkpoint cadence in ticks (--supervise)")
    ap.add_argument("--n-ticks", type=int, default=64,
                    help="market-tick budget of the durable run "
                         "(--supervise)")
    ap.add_argument("--keep-last", type=int, default=3,
                    help="checkpoint steps retained by GC (--supervise)")
    ap.add_argument("--fault-plan", default=None,
                    help="chaos FaultPlan JSON to inject (--supervise)")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--hang-timeout", type=float, default=120.0)
    ap.add_argument("--devices", type=int, default=0,
                    help="show the supervised worker the first N cards")
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
        args.zoo = True           # mixed precision needs the zoo carry
    if args.supervise:
        if args.run_dir is None:
            ap.error("--supervise requires --run-dir")
        return args
    if args.zoo:
        ap.error("--param-dtype other than float32 and --zoo train the zoo "
                 "program, which the launcher runs under --supervise (in "
                 "Python, trainer.train_zoo runs it directly)")
    if args.fused_update and not args.megabatch:
        ap.error("--fused-update requires --megabatch")
    if args.megabatch and not args.batched:
        ap.error("--megabatch requires --batched")
    if args.mesh_replica and args.mesh is None:
        ap.error("--mesh-replica requires --mesh")
    if args.mesh is not None and not args.batched:
        ap.error("--mesh requires --batched")
    if args.batched:
        args.local = True
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


def supervise(args: argparse.Namespace) -> Dict:
    """--supervise: pin the workload as a WorkerSpec in the run dir and
    hand it to the self-healing supervisor; returns its summary."""
    from repro_torch.launch import supervisor as sup_mod
    from repro_torch.launch.workload import WorkerSpec

    # one two-bid fleet per strategy flavor: high/low split bids around
    # the uniform price band, matching the paper's two-bid policies
    n = args.workers
    bids = tuple(tuple([hi] * (n // 2) + [lo] * (n - n // 2))
                 for hi, lo in ((0.9, 0.5), (0.8, 0.6), (1.0, 0.4)))
    spec = WorkerSpec(arch=args.arch, n_workers=n, seq_len=args.seq,
                      global_batch=args.batch, bids=bids,
                      iterations=args.iterations or 12,
                      seeds=args.seeds, n_ticks=args.n_ticks,
                      save_every=args.save_every,
                      keep_last=args.keep_last,
                      mesh=args.mesh or 0, seed=args.seed,
                      reduce_depth=args.reduce_depth,
                      param_dtype=args.param_dtype,
                      zoo=args.zoo)
    os.makedirs(args.run_dir, exist_ok=True)
    spec.save(os.path.join(args.run_dir, sup_mod.SPEC_NAME))
    if args.fault_plan:
        from repro_torch.chaos import FaultPlan
        FaultPlan.load(args.fault_plan).save(
            os.path.join(args.run_dir, sup_mod.PLAN_NAME))

    sup = sup_mod.Supervisor(args.run_dir, sup_mod.SupervisorConfig(
        max_restarts=args.max_restarts, hang_timeout=args.hang_timeout,
        devices=args.devices, seed=args.seed, device=args.device))
    return sup.run()


def run(args: argparse.Namespace) -> Tuple[object, Dict]:
    """Train as the flags say; returns (the ``BatchResult`` of a batched
    run, else None; the summary the CLI prints)."""
    if args.jit_cache is not None:
        from repro_torch.launch.jitcache import enable_persistent_cache
        enable_persistent_cache(args.jit_cache or None)
    if args.supervise:
        return None, supervise(args)
    if not args.local:
        from repro_torch.launch.dryrun import dry_run_one
        return None, dry_run_one(args.arch, args.shape, card=args.card)
    trainer = build_trainer(args)
    if not args.batched:
        summary = trainer.run(iterations=args.iterations)
        del summary["log"]
        return None, summary
    mesh = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import (make_scenario_mesh,
                                             make_scenario_replica_mesh)
        mesh = (make_scenario_replica_mesh(args.mesh, args.mesh_replica,
                                           device=args.device)
                if args.mesh_replica else
                make_scenario_mesh(args.mesh, device=args.device))
    res = trainer.run_batched(seeds=args.seeds, iterations=args.iterations,
                              megabatch=args.megabatch,
                              use_fused_update=args.fused_update, mesh=mesh)
    out = {name: res.run(name).summary for name in res.names}
    out["_engine"] = {"replicas": len(res.names) * res.n_seeds,
                      "megabatch": args.megabatch,
                      "fused_update": args.fused_update,
                      "mesh": None if mesh is None else mesh.shape}
    return res, out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    _, out = run(args)
    print(json.dumps(out, indent=1, default=float))
    return 0 if not args.supervise or out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
