"""Decoder-only transformer LM of the dense family (and the VLM family's
text stack): parameter definitions and the training forward. Layers run as
a Python loop over the stacked (L, ...) layer leaves, so gradients land in
the stacked leaves. MoE and MLA blocks come with the zoo-families slice of
the port, activation rematerialisation and the decode path with later
slices; each raises naming its slice."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamSpec, dense_spec, rms_norm,
                                       stack_specs)
from repro_torch.tree import tree_index, tree_leaves


def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_spec(d, f),
        "w_up": dense_spec(d, f),
        "w_down": dense_spec(f, d, logical=("tp", "fsdp")),
    }


def mlp_block(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def _dense_only(cfg) -> None:
    if cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(
            "MLA and MoE blocks come with the zoo-families slice of the port")


def layer_defs(cfg):
    _dense_only(cfg)
    d = cfg.d_model
    return {"ln1": ParamSpec((d,), (None,), init="ones"),
            "ln2": ParamSpec((d,), (None,), init="ones"),
            "attn": attn.attn_defs(cfg),
            "mlp": mlp_defs(cfg)}


def decoder_layer(p, cfg, x, qpos, *, cache=None, cache_pos=None,
                  kv_src=None, kv_pos=None, causal=True):
    """Pre-norm block. Returns (x, new_cache, aux)."""
    _dense_only(cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn.attention_block(
        p["attn"], cfg, h, qpos, cache=cache, cache_pos=cache_pos,
        kv_src=kv_src, kv_pos=kv_pos, causal=causal)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    m = mlp_block(p["mlp"], h)
    return x + m, new_cache, torch.zeros((), dtype=torch.float32,
                                         device=x.device)


def lm_defs(cfg):
    d, v = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": ParamSpec((v, d), ("tp", None), scale=0.02),
        "layers": stack_specs(layer_defs(cfg), cfg.num_layers),
        "ln_f": ParamSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = dense_spec(d, v)
    return defs


def scan_decoder(layers_p, cfg, x, qpos, *, caches=None, cache_pos=None,
                 kv_src=None, kv_pos=None, causal=True, remat="none"):
    """Run the stacked decoder layers in order. Returns (x, new_caches,
    aux_sum). Only ``remat="none"`` is ported: the reference's "dots" and
    "full" recompute activations in the backward, which comes with the
    remat slice of the port."""
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r} is not ported to repro_torch yet: it comes "
            "with the remat slice (activation checkpointing)")
    if caches is not None:
        raise NotImplementedError(
            "decoding against layer caches is not ported to repro_torch "
            "yet: it comes with the serving slice")
    n_layers = tree_leaves(layers_p)[0].shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(n_layers):
        x, _, a = decoder_layer(tree_index(layers_p, layer), cfg, x, qpos,
                                kv_src=kv_src, kv_pos=kv_pos, causal=causal)
        aux = aux + a
    return x, None, aux


def embed_tokens(params, cfg, tokens):
    """Gather the token rows (the reference's ``jnp.take``); its gradient
    is a dense (V, d) scatter-add, as the reference's is."""
    return F.embedding(tokens, params["embed"]).to(cfg.activation_dtype())


def unembed(params, cfg, x):
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def lm_forward(params, cfg, tokens, *, prefix_embeds=None, remat="none"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens: (B, S_text). ``prefix_embeds`` (B, P, d)
    are precomputed frontend embeddings (VLM patches) prefixed to the
    token embeddings. Returns (logits (B, S_total, V), moe_aux)."""
    x = embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    qpos = torch.arange(s, device=x.device).expand(b, s)
    x, _, aux = scan_decoder(params["layers"], cfg, x, qpos, remat=remat)
    return unembed(params, cfg, x), aux
