"""Multi-pod dry run: lay every (architecture × input shape) out over the
production mesh with meta tensors (no allocation, no device) and print the
roofline record of one step on the card's peaks, as JSON.

The reference lowers and compiles each step for a TPU pod and reads
XLA's analyses; the port accounts the same step from the model's
definition (`roofline.analysis.analyze_abstract`): the step's arguments
(the reference's ``lower_one`` passes the same ones) under their logical
layout, and the model FLOPs. The lowering itself and what reads its HLO
are not ported.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--card "NVIDIA H100 80GB HBM3"] [--out results/dryrun]

``--card`` names the card whose peaks time the terms; by default the
visible card's name, and on a machine without a card it must be given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import ARCHS, SHAPES, config_for_shape
from repro_torch.configs.base import (InputShape, JobConfig, ModelConfig,
                                      resolve_dtype)
from repro_torch.launch.mesh import data_parallel_workers, make_production_mesh
from repro_torch.models import model_zoo
from repro_torch.models.common import (DEFAULT_RULES, MULTI_POD_RULES,
                                       NamedSharding, P, abstract_params,
                                       param_shardings, resolve_spec,
                                       shard_bytes)
from repro_torch.roofline.analysis import analyze_abstract, card_peaks
from repro_torch.tree import tree_leaves

#: the shapes ``--all`` runs for every arch
ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _meta(shape, dtype, spec, mesh):
    return torch.empty(shape, dtype=dtype, device="meta"), \
        NamedSharding(mesh, spec)


def input_specs(cfg: ModelConfig, shape: InputShape, mesh, rules,
                n_workers: int) -> Dict[str, tuple]:
    """Every model input of one step as (meta tensor, `NamedSharding`):
    the batch split over the ``batch`` axes where it divides."""
    del n_workers
    b, s = shape.global_batch, shape.seq_len
    bspec = resolve_spec((b,), ("batch",), rules, mesh)
    bdim = bspec[0] if len(bspec) else None

    def tok(shp):
        return _meta(shp, torch.int32, P(bdim, None), mesh)

    def emb(shp):
        return _meta(shp, resolve_dtype(cfg.dtype, where="dtype"),
                     P(bdim, None, None), mesh)

    if shape.is_decode:
        return {"tokens": tok((b, 1))}
    if cfg.family == "vlm":
        text = s - cfg.vision.num_patches
        return {"tokens": tok((b, text)), "labels": tok((b, text)),
                "patches": emb((b, cfg.vision.num_patches, cfg.d_model))}
    if cfg.family == "encdec":
        return {"tokens": tok((b, s)), "labels": tok((b, s)),
                "frames": emb((b, cfg.encoder.src_len, cfg.d_model))}
    return {"tokens": tok((b, s)), "labels": tok((b, s))}


def _laid_out(defs, mesh, rules, fsdp: bool, dtype):
    """(meta tensors, shardings) of a ParamSpec nested dict."""
    return abstract_params(defs, dtype), param_shardings(defs, mesh, rules,
                                                         fsdp)


def step_arguments(cfg: ModelConfig, shape: InputShape, mesh, rules=None,
                   fsdp: bool = True) -> list:
    """The arguments of one step as the reference's dry run compiles it,
    each a (meta tree, sharding tree) pair: decode — params, caches (never
    FSDP-sharded), tokens, pos; prefill — params, batch; train — params,
    optimizer state, batch and the workers' mask. ``jax.jit`` drops the
    arguments a step never reads (``keep_unused=False``), and so do these:
    the train step's counter, the SSM decode's position and the enc-dec
    decode's encoder weights. Read the definitions under the mesh
    context (padded heads)."""
    from repro_torch.optim.sgd import get_optimizer

    rules = dict(rules if rules is not None else DEFAULT_RULES)
    n_workers = data_parallel_workers(mesh)
    defs = model_zoo.param_defs(cfg)
    batch = input_specs(cfg, shape, mesh, rules, n_workers)
    if shape.is_decode:
        caches = _laid_out(model_zoo.cache_defs(cfg, shape.global_batch,
                                                shape.seq_len),
                           mesh, rules, False, cfg.dtype)
        args = [_laid_out(_decode_reads(cfg, defs), mesh, rules, fsdp,
                          cfg.param_dtype), caches, batch["tokens"]]
        if cfg.family != "ssm":          # the SSM state ignores the position
            args.append(_meta((), torch.int32, P(), mesh))
        return args
    params = _laid_out(defs, mesh, rules, fsdp, cfg.param_dtype)
    batch = ({k: v[0] for k, v in batch.items()},
             {k: v[1] for k, v in batch.items()})
    if shape.kind == "prefill":
        return [params, batch]
    job = JobConfig(model=cfg, shape=shape, n_workers=n_workers)
    # the job's SGD keeps one momentum leaf per parameter, laid out as it
    opt_state = (get_optimizer(job.optimizer, job.momentum).init(params[0]),
                 params[1])
    mask = _meta((n_workers,), torch.float32, P(), mesh)
    # the step counter feeds only the learning-rate schedule, constant here
    return [params, opt_state, batch, mask]


def _decode_reads(cfg, defs):
    """The parameters a decode step reads: all but, for the enc-dec, the
    encoder and the cross-attention's key and value projections (the
    cross cache holds their output)."""
    if cfg.family != "encdec":
        return defs
    cross = {k: v for k, v in defs["dec_layers"]["cross_attn"].items()
             if k not in ("wk", "wv", "bk", "bv")}
    return {**{k: v for k, v in defs.items()
               if k not in ("enc_layers", "enc_ln")},
            "dec_layers": {**defs["dec_layers"], "cross_attn": cross}}


def arg_bytes(args) -> int:
    """Bytes of one device's shards of every argument."""
    return sum(shard_bytes(t.shape, t.dtype, sh)
               for metas, shs in args
               for t, sh in zip(tree_leaves(metas), tree_leaves(shs)))


def _visible_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no card is visible to read its peaks from: name "
                           "one (card=..., --card NAME), e.g. "
                           "'NVIDIA H100 80GB HBM3'")
    return torch.cuda.get_device_name(0)


def dry_run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
                fsdp: bool = True, remat: str = "full",
                rules: Optional[dict] = None, microbatch: int = 1,
                seq_parallel: bool = False,
                cfg_overrides: Optional[dict] = None, mesh=None,
                card: Optional[str] = None) -> Dict:
    """The roofline record of one (arch × shape) on the production mesh
    (abstract unless ``mesh`` is given), timed on ``card``'s peaks
    (default: the visible card's). Also printed."""
    t0 = time.perf_counter()
    shape = SHAPES[shape_name]
    overrides = dict(cfg_overrides or {})
    moe_par = overrides.pop("moe_parallelism", None)
    cfg = config_for_shape(arch, shape).with_(
        dtype="bfloat16", param_dtype="bfloat16", **overrides)
    if moe_par is not None and cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                parallelism=moe_par))
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod, abstract=True)
    rules = dict(rules if rules is not None else
                 (MULTI_POD_RULES if multi_pod else DEFAULT_RULES))
    if seq_parallel:
        # beyond-paper: shard the residual stream's sequence dim over the
        # model axis between blocks (Megatron-SP style)
        rules["residual"] = ("model",)
    peaks = card_peaks(card if card is not None else _visible_card())
    record = analyze_abstract(cfg, shape, mesh, rules, fsdp, peaks)
    record.update({
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape.values())),
        "multi_pod": multi_pod, "fsdp": fsdp, "remat": remat,
        "microbatch": microbatch, "seq_parallel": seq_parallel,
        "overrides": cfg_overrides or {},
        "account_s": time.perf_counter() - t0,
    })
    print(f"== {arch} × {shape_name} mesh={record['mesh']} ==")
    print(json.dumps(record, default=str))
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--seq-parallel", action="store_true",
                    help="shard the residual stream's seq dim over the "
                         "model axis (Megatron-SP style)")
    ap.add_argument("--kv-cache-shard", default=None,
                    choices=["heads", "seq", "none"],
                    help="decode cache sharding")
    ap.add_argument("--card", default=None, metavar="NAME",
                    help="the card whose peaks time the terms (default: "
                         "the visible card's name)")
    ap.add_argument("--out", default=None, help="JSON output path prefix")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    combos = ([(a, s) for a in sorted(ARCHS) for s in ALL_SHAPES]
              if args.all else [(args.arch, args.shape)])
    card = args.card if args.card is not None else _visible_card()
    mesh = make_production_mesh(multi_pod=args.multi_pod, abstract=True)
    results, failures = [], []
    overrides = ({"kv_cache_shard": args.kv_cache_shard}
                 if args.kv_cache_shard else None)
    for arch, shape in combos:
        try:
            results.append(dry_run_one(
                arch, shape, multi_pod=args.multi_pod,
                fsdp=not args.no_fsdp, remat=args.remat,
                microbatch=args.microbatch, seq_parallel=args.seq_parallel,
                cfg_overrides=overrides, mesh=mesh, card=card))
        except Exception as e:  # noqa: BLE001 — report all failures at end
            traceback.print_exc()
            failures.append({"arch": arch, "shape": shape, "error": str(e)})
        if args.out:
            with open(args.out + (".multipod" if args.multi_pod else "")
                      + ".json", "w") as f:
                json.dump({"results": results, "failures": failures}, f,
                          indent=1, default=str)
    print(f"\nDRY-RUN SUMMARY: {len(results)} ok, {len(failures)} failed")
    for f_ in failures:
        print("  FAIL", f_["arch"], f_["shape"], f_["error"][:200])
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
