"""Hybrid Mamba2 + shared-attention backbone (Zamba2-style).

Layers are organized as G = num_layers // attn_every super-groups of
[attn_every Mamba2 layers + ONE shared attention/MLP block] plus a tail of
(num_layers % attn_every) Mamba2 layers. The attention/MLP block
*parameters* are shared across all G application sites (the defining
Zamba2 trick), so their gradient is the sum over the sites; each site
keeps its own KV cache. As in the reference, no per-site LoRA deltas on
the shared block. Keys and leaf order are the reference's, so its weights,
caches and checkpoint files carry across. Groups and layers run as Python
loops over the stacked (G, k, ...) leaves, the reference's ``lax.scan``s.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamSpec, rms_norm, stack_specs
from repro_torch.models.transformer import (_remat, embed_tokens, mlp_block,
                                            mlp_defs, unembed)
from repro_torch.tree import tree_index, tree_map


def _groups(cfg) -> Tuple[int, int]:
    k = cfg.attn_every
    return cfg.num_layers // k, cfg.num_layers % k


def ssm_layer_defs(cfg):
    return {
        "ln": ParamSpec((cfg.d_model,), (None,), init="ones"),
        "ssm": ssm_mod.ssm_defs(cfg),
    }


def shared_block_defs(cfg):
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), (None,), init="ones"),
        "attn": attn.attn_defs(cfg),
        "ln2": ParamSpec((d,), (None,), init="ones"),
        "mlp": mlp_defs(cfg),
    }


def hybrid_defs(cfg):
    g, tail = _groups(cfg)
    defs = {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("tp", None),
                           scale=0.02),
        "groups": stack_specs(stack_specs(ssm_layer_defs(cfg), cfg.attn_every),
                              g),
        "shared": shared_block_defs(cfg),
        "ln_f": ParamSpec((cfg.d_model,), (None,), init="ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size), ("fsdp", "tp"),
                             scale=cfg.d_model ** -0.5),
    }
    if tail:
        defs["tail"] = stack_specs(ssm_layer_defs(cfg), tail)
    return defs


def _ssm_layer(p, cfg, x, cache=None):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, new_cache = ssm_mod.ssm_block(p["ssm"], cfg, h, cache=cache)
    return x + y, new_cache


def _shared_block(p, cfg, x, qpos, cache=None, cache_pos=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn.attention_block(p["attn"], cfg, h, qpos, cache=cache,
                                        cache_pos=cache_pos)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_block(p["mlp"], h), new_cache


def _ssm_stack(layers_p, cfg, x, caches=None):
    """The stacked (L, ...) Mamba2 layers in order; with ``caches`` each
    against its own, the new caches written into fresh stacked buffers
    (``caches`` is left as it was). Returns (x, new_caches)."""
    n = layers_p["ln"].shape[0]
    new = None if caches is None else tree_map(torch.empty_like, caches)
    for i in range(n):
        x, c = _ssm_layer(tree_index(layers_p, i), cfg, x,
                          cache=None if caches is None
                          else tree_index(caches, i))
        if c is not None:
            tree_map(lambda out, v: out[i].copy_(v), new, c)
    return x, new


def hybrid_forward(params, cfg, tokens, remat="full", head=None):
    """Training forward; each super-group runs under ``_remat(remat)``,
    the tail without. Returns (``head``(params, cfg, x) of the last hidden
    states — `unembed`'s logits by default — aux = 0)."""
    x = embed_tokens(params, cfg, tokens)
    b, s, _ = x.shape
    qpos = torch.arange(s, device=x.device).expand(b, s)
    shared_p = params["shared"]

    def group_body(x, group_p):
        x, _ = _ssm_stack(group_p, cfg, x)
        y, _ = _shared_block(shared_p, cfg, x, qpos)
        return y

    group_body = _remat(group_body, remat)
    for gi in range(_groups(cfg)[0]):
        x = group_body(x, tree_index(params["groups"], gi))
    if "tail" in params:
        x, _ = _ssm_stack(params["tail"], cfg, x)
    return (head or unembed)(params, cfg, x), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def hybrid_decode(params, cfg, token, caches, pos):
    """Decode (S = 1) or chunked prefill (S > 1). caches = {"ssm_groups":
    (G, k, ...), "attn": (G, ...), "ssm_tail": (tail, ...)}; the new
    caches come back in fresh buffers."""
    x = embed_tokens(params, cfg, token)
    b, s, _ = x.shape
    qpos = pos + torch.arange(s, device=x.device).expand(b, s)
    shared_p = params["shared"]
    new_caches = {"ssm_groups": tree_map(torch.empty_like,
                                         caches["ssm_groups"]),
                  "attn": tree_map(torch.empty_like, caches["attn"])}
    for gi in range(_groups(cfg)[0]):
        x, ssm_c = _ssm_stack(tree_index(params["groups"], gi), cfg, x,
                              caches=tree_index(caches["ssm_groups"], gi))
        x, attn_c = _shared_block(shared_p, cfg, x, qpos,
                                  cache=tree_index(caches["attn"], gi),
                                  cache_pos=pos)
        tree_map(lambda out, v: out[gi].copy_(v), new_caches["ssm_groups"],
                 ssm_c)
        tree_map(lambda out, v: out[gi].copy_(v), new_caches["attn"], attn_c)
    if "tail" in params:
        x, new_caches["ssm_tail"] = _ssm_stack(params["tail"], cfg, x,
                                               caches=caches["ssm_tail"])
    return unembed(params, cfg, x), new_caches


def hybrid_cache_defs(cfg, batch: int, seq_len: int):
    g, tail = _groups(cfg)
    ssm_one = ssm_mod.ssm_cache_defs(cfg, batch)
    defs = {
        "ssm_groups": stack_specs(stack_specs(ssm_one, cfg.attn_every), g),
        "attn": stack_specs(attn.self_cache_defs(cfg, batch, seq_len), g),
    }
    if tail:
        defs["ssm_tail"] = stack_specs(ssm_one, tail)
    return defs
