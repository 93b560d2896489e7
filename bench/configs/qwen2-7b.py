"""Plain float32 reference of Qwen2 (arXiv:2407.10671; the published
``Qwen/Qwen2-7B`` config.json beside this file as ``qwen2-7b.json``).

A decoder of identical layers: RMSNorm, grouped-query attention with
biases on q, k and v and rotary positions (rotate-half, base
``rope_theta``), a residual; RMSNorm, a SiLU-gated MLP, a residual; a final
RMSNorm and an untied head. The loss is the per-token cross-entropy of the
next token, averaged with the elastic row weights (`elastic_sgd`).

The leaves, their shapes and their initial scales are listed by `leaves`,
one path per leaf, with per-layer leaves as ``layers.<group>.<name>.<l>``;
the benchmark draws each from its seed and hands the same to the program
and to this reference. No departure from the published block.

`step_flops` and `attention_shape` count the model's work for the
metrics' readers (``mfu``, ``k2_roofline``)."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.reference.elastic_sgd import masked_mean
from bench.reference.precision import matmul


def sizes(conf: Dict) -> Dict:
    d = conf["hidden_size"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    return {"d": d, "layers": conf["num_hidden_layers"], "hq": hq,
            "hkv": hkv, "dh": d // hq, "f": conf["intermediate_size"],
            "vocab": conf["vocab_size"], "theta": conf["rope_theta"],
            "eps": conf["rms_norm_eps"]}


def leaves(conf: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(path, shape, init, scale) of every leaf: ``normal`` leaves are
    N(0, scale²), the others ``ones`` or ``zeros``."""
    z = sizes(conf)
    d, f, v = z["d"], z["f"], z["vocab"]
    nq, nkv = z["hq"] * z["dh"], z["hkv"] * z["dh"]
    out = [("embed", (v, d), "normal", 0.02)]
    per_layer = [("ln1", (d,), "ones", 1.0), ("ln2", (d,), "ones", 1.0),
                 ("attn.wq", (d, nq), "normal", d ** -0.5),
                 ("attn.wk", (d, nkv), "normal", d ** -0.5),
                 ("attn.wv", (d, nkv), "normal", d ** -0.5),
                 ("attn.wo", (nq, d), "normal", nq ** -0.5),
                 ("attn.bq", (nq,), "zeros", 1.0),
                 ("attn.bk", (nkv,), "zeros", 1.0),
                 ("attn.bv", (nkv,), "zeros", 1.0),
                 ("mlp.w_gate", (d, f), "normal", d ** -0.5),
                 ("mlp.w_up", (d, f), "normal", d ** -0.5),
                 ("mlp.w_down", (f, d), "normal", f ** -0.5)]
    for l in range(z["layers"]):
        out += [(f"layers.{name}.{l}", shape, init, scale)
                for name, shape, init, scale in per_layer]
    out += [("ln_f", (d,), "ones", 1.0), ("lm_head", (d, v), "normal",
                                           d ** -0.5)]
    return out


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x (B, S, H, D) at positions 0 … S-1, rotate-half."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def loss(w: Dict[str, torch.Tensor], conf: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, weights: torch.Tensor,
         precision: str = "float32") -> torch.Tensor:
    """The weighted mean next-token loss of ``tokens`` (B, S) against
    ``labels`` (B, S), token weights ``weights`` (B, S)."""
    z = sizes(conf)
    b, s = tokens.shape
    hq, hkv, dh, eps = z["hq"], z["hkv"], z["dh"], z["eps"]
    mask = torch.ones(s, s, dtype=torch.bool, device=tokens.device).tril()
    x = w["embed"][tokens]
    for l in range(z["layers"]):
        def p(name):
            return w[f"layers.{name}.{l}"]
        h = _rms(x, p("ln1"), eps)
        q = (matmul(h, p("attn.wq"), precision) + p("attn.bq")).view(
            b, s, hq, dh)
        k = (matmul(h, p("attn.wk"), precision) + p("attn.bk")).view(
            b, s, hkv, dh)
        v = (matmul(h, p("attn.wv"), precision) + p("attn.bv")).view(
            b, s, hkv, dh)
        q, k = _rope(q, z["theta"]), _rope(k, z["theta"])
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, D)
        sc = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
        att = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        o = matmul(att, v, precision).transpose(1, 2).reshape(b, s, hq * dh)
        x = x + matmul(o, p("attn.wo"), precision)
        h = _rms(x, p("ln2"), eps)
        gu = torch.nn.functional.silu(matmul(h, p("mlp.w_gate"), precision)) \
            * matmul(h, p("mlp.w_up"), precision)
        x = x + matmul(gu, p("mlp.w_down"), precision)
    h = _rms(x, w["ln_f"], eps)
    logits = matmul(h, w["lm_head"], precision)
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels[..., None])[..., 0]
    return masked_mean(nll, weights)


def matmul_params(conf: Dict) -> int:
    """The matrix parameters: per layer d·(Hq + 2·Hkv)·Dh for q, k, v,
    Hq·Dh·d for the output and 3·d·d_ff for the gated MLP; the head d·V.
    Not the embedding, which is a gather, nor biases and norms."""
    z = sizes(conf)
    d, dh = z["d"], z["dh"]
    per_layer = d * (z["hq"] + 2 * z["hkv"]) * dh + z["hq"] * dh * d \
        + 3 * d * z["f"]
    return z["layers"] * per_layer + d * z["vocab"]


def step_flops(conf: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` rows of ``seq``
    positions, D = batch·seq tokens:

        6 · N · D  +  12 · L · Hq · Dh · batch · seq(seq+1)/2

    N being `matmul_params`; the second term is the causal attention's
    scores and values, forward (4 a pair) and backward (8). Recomputation
    under remat is not model work and is not counted."""
    z = sizes(conf)
    pairs = seq * (seq + 1) // 2
    return 6.0 * matmul_params(conf) * batch * seq + \
        12.0 * z["layers"] * z["hq"] * z["dh"] * batch * pairs


def attention_shape(conf: Dict, batch: int, seq: int):
    """(B, S, Hq, Hkv, D) of one layer's causal attention."""
    z = sizes(conf)
    return (batch, seq, z["hq"], z["hkv"], z["dh"])
