"""Serving launcher: batched greedy decoding against the model's caches on
one device (reduced config): a chunked prefill of the prompt, then one
serve step per generated token.

Example (the reduced Mamba2 on the CPU; without ``--device`` it runs on
the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --batch 4 --prompt-len 32 --gen 32 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import exact_float32, resolve_device
from repro_torch.models import model_zoo
from repro_torch.models.common import init_params
from repro_torch.train.train_step import make_serve_step


def prefill_prompt(cfg, params, caches, tokens):
    """Chunked prefill: the whole prompt in one cached pass. Returns the
    greedy next token (B, 1) and the caches."""
    with torch.no_grad():
        logits, caches = model_zoo.prefill(params, cfg, {"tokens": tokens},
                                           caches)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
    return nxt, caches


def greedy_decode(cfg, params, caches, nxt, pos: int, steps: int):
    """``steps`` serve steps, the first feeding ``nxt`` at position
    ``pos``. Returns (tokens (B, steps + 1), ``nxt`` first, and the
    caches)."""
    step = make_serve_step(cfg)
    out = [nxt]
    for g in range(steps):
        nxt, caches = step(params, caches, nxt, pos + g)
        out.append(nxt)
    return torch.cat(out, dim=1), caches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="mamba2-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to run (default cuda; no fallback)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    exact_float32()
    cfg = get_config(args.arch).reduced()
    params = init_params(model_zoo.param_defs(cfg), args.seed, torch.float32,
                         device=device)
    cache_len = args.prompt_len + args.gen
    caches = init_params(model_zoo.cache_defs(cfg, args.batch, cache_len),
                         args.seed, torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)

    t0 = time.time()
    nxt, caches = prefill_prompt(cfg, params, caches, prompt)
    _sync(device)
    t_prefill = time.time() - t0

    t0 = time.time()
    tokens, caches = greedy_decode(cfg, params, caches, nxt,
                                   args.prompt_len, args.gen - 1)
    _sync(device)
    t_gen = time.time() - t0
    print(json.dumps({
        "arch": args.arch, "batch": args.batch, "device": str(device),
        "prefill_s": round(t_prefill, 3), "gen_s": round(t_gen, 3),
        "tok_per_s": round(args.batch * (args.gen - 1) / max(t_gen, 1e-9), 1),
        "sample": tokens[0][:16].tolist(),
    }, indent=1))


if __name__ == "__main__":
    main()
