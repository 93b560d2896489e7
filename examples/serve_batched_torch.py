"""Batched serving on the PyTorch port: prefill + greedy decode with
per-family caches (KV ring buffers, MLA latents, SSM states) through the
public serve API, on the card. The weights and the prompt come from seeded
``torch.Generator`` draws (`models.common.init_params` per leaf).

Run: PYTHONPATH=src python examples/serve_batched_torch.py --arch
mamba2-1.3b [--device cpu]
(any of the 10 assigned archs works; reduced configs)
"""
import argparse
import time

import torch

from repro_torch.configs import ARCHS
from repro_torch.device import exact_float32, resolve_device
from repro_torch.models import model_zoo
from repro_torch.models.common import init_params
from repro_torch.train.train_step import make_serve_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="mamba2-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    exact_float32()

    cfg = ARCHS[args.arch].reduced()
    seed = 0
    params = init_params(model_zoo.param_defs(cfg), seed, torch.float32,
                         device=device)
    cache_len = args.prompt_len + args.gen
    caches = init_params(model_zoo.cache_defs(cfg, args.batch, cache_len),
                         seed, torch.float32, device=device)
    step = make_serve_step(cfg)

    gen = torch.Generator(device=device).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    t0 = time.time()
    # chunked prefill: the whole prompt in ONE cached pass (all families)
    batch = {"tokens": prompt}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (args.batch, cfg.encoder.src_len, cfg.d_model), generator=gen,
            device=device) * 0.1
    with torch.no_grad():
        logits, caches = model_zoo.prefill(params, cfg, batch, caches)
    nxt = torch.argmax(logits[:, -1:], dim=-1)
    sync()
    print(f"prefill({args.prompt_len} tok, one pass): "
          f"{time.time() - t0:.2f}s on {device}")

    toks = [nxt]
    t0 = time.time()
    for g in range(args.gen - 1):
        nxt, caches = step(params, caches, nxt, args.prompt_len + g)
        toks.append(nxt)
    sync()
    dt = time.time() - t0
    out = torch.cat(toks, dim=1).cpu()
    print(f"decode: {args.batch * (args.gen - 1) / dt:.1f} tok/s "
          f"(batch={args.batch})")
    for i in range(min(2, args.batch)):
        print(f"  seq{i}: {out[i][:12].tolist()} ...")


if __name__ == "__main__":
    main()
