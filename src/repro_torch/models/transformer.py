"""Decoder-only transformer LM covering the dense, MoE (incl. MLA) and VLM
families: parameter definitions, the training forward and the decode
against per-layer caches (a chunked prefill when S > 1). Layers run as a
Python loop over the stacked (L, ...) layer leaves, so gradients land in
the stacked leaves. An MoE config with ``first_dense_layers`` k runs a
``dense_layers`` stack of k layers (a dense MLP of width ``d_ff_dense``)
ahead of its ``layers`` stack of num_layers − k MoE layers. `_remat` is
the reference's activation rematerialisation for every family's training
forward."""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import spmd
from repro_torch.models.common import (ParamSpec, current_ctx, dense_spec,
                                       mesh_context, rms_norm, stack_specs,
                                       tp_ranks, tp_slice)
from repro_torch.tree import tree_index, tree_leaves, tree_map


def mlp_defs(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": dense_spec(d, f),
        "w_up": dense_spec(d, f),
        "w_down": dense_spec(f, d, logical=("tp", "fsdp")),
    }


def _mlp(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def mlp_block(p, x):
    """SwiGLU MLP. Under a mesh context whose model axis divides d_ff,
    each tp rank computes its slice of d_ff (columns of ``w_gate`` and
    ``w_up``, rows of ``w_down``) on its device, batch groups over the
    data ranks as `models.common.TPRanks.groups` gives them, and a psum
    joins the ranks after ``w_down``; else the block computes whole."""
    tpr = tp_ranks()
    if tpr is None or p["w_gate"].shape[1] % tpr.size:
        return _mlp(p, x)
    ys = []
    for rows, devs in tpr.groups(x.shape[0]):
        parts = []
        for r, dev in enumerate(devs):
            pr = {"w_gate": tp_slice(p["w_gate"], (None, "tp"), r),
                  "w_up": tp_slice(p["w_up"], (None, "tp"), r),
                  "w_down": tp_slice(p["w_down"], ("tp", None), r)}
            parts.append(_mlp({k: v.to(dev) for k, v in pr.items()},
                              x[rows].to(dev)))
        ys.append(spmd.psum(parts)[0].to(x.device))
    return torch.cat(ys, dim=0)


def layer_defs(cfg, dense: bool = False):
    """One layer's leaves: attention (MLA or not), and the config's MoE,
    or with ``dense`` (or no MoE) a dense MLP, ``d_ff_dense`` wide where
    that is set."""
    d = cfg.d_model
    defs = {"ln1": ParamSpec((d,), (None,), init="ones"),
            "ln2": ParamSpec((d,), (None,), init="ones")}
    if cfg.mla is not None:
        defs["mla"] = mla_mod.mla_defs(cfg)
    else:
        defs["attn"] = attn.attn_defs(cfg)
    if cfg.moe is not None and not dense:
        defs["moe"] = moe_mod.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(cfg, cfg.d_ff_dense if dense else None)
    return defs


def decoder_layer(p, cfg, x, qpos, *, cache=None, cache_pos=None,
                  kv_src=None, kv_pos=None, causal=True):
    """Pre-norm block: the MoE where ``p`` holds one, else the MLP.
    Returns (x, new_cache, aux)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = mla_mod.mla_block(p["mla"], cfg, h, qpos, cache=cache,
                                         cache_pos=cache_pos)
    else:
        a, new_cache = attn.attention_block(
            p["attn"], cfg, h, qpos, cache=cache, cache_pos=cache_pos,
            kv_src=kv_src, kv_pos=kv_pos, causal=causal)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        m, aux = moe_mod.moe_block(p["moe"], cfg, h)
    else:
        m, aux = mlp_block(p["mlp"], h), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    return x + m, new_cache, aux


def lm_defs(cfg):
    d, v = cfg.d_model, cfg.vocab_size
    k = cfg.first_dense_layers
    if k and cfg.num_layers <= k:
        raise ValueError(f"{cfg.num_layers} layers leave none after the "
                         f"{k} leading dense ones")
    defs = {"embed": ParamSpec((v, d), ("tp", None), scale=0.02)}
    if k:
        defs["dense_layers"] = stack_specs(layer_defs(cfg, dense=True), k)
    defs["layers"] = stack_specs(layer_defs(cfg), cfg.num_layers - k)
    defs["ln_f"] = ParamSpec((d,), (None,), init="ones")
    if not cfg.tie_embeddings:
        defs["lm_head"] = dense_spec(d, v)
    return defs


#: the products without batch dimensions, whose outputs "dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of the plain
    matrix products, recompute everything else (batched products
    included)."""
    del ctx, args, kwargs
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """The reference's ``_remat``: "none" runs ``fn`` as it is; "full"
    keeps only its inputs and runs it again in the backward
    (``jax.checkpoint``); "dots" keeps the outputs of products without
    batch dimensions as well and recomputes the rest
    (``dots_with_no_batch_dims_saveable``), by selective checkpointing.
    Neither changes a value."""
    if mode == "none":
        return fn
    if mode == "full":
        kw = {}
    elif mode == "dots":
        kw = {"context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)}
    else:
        raise ValueError(
            f"remat must be 'none', 'dots' or 'full', got {mode!r}")

    def run(*args):
        # the recompute runs in the backward, which autograd may run on
        # another thread: carry the forward's mesh context to it
        ctx = current_ctx()
        return ckpt.checkpoint(functools.partial(_in_ctx, ctx, fn), *args,
                               use_reentrant=False, **kw)

    return run


def _in_ctx(ctx, fn, *args):
    with mesh_context(ctx.mesh, ctx.rules):
        return fn(*args)


def scan_decoder(layers_p, cfg, x, qpos, *, caches=None, cache_pos=None,
                 kv_src=None, kv_pos=None, causal=True, remat="full",
                 dense_p=None):
    """Run the stacked decoder layers in order, those of ``dense_p`` (the
    leading dense layers) first where given. Returns (x, new_caches,
    aux_sum). With ``caches`` (stacked (L, ...) leaves over every layer)
    each layer decodes against its own, and the new caches are written
    into fresh stacked buffers; ``caches`` is left as it was. Each layer
    runs under ``_remat(remat)``."""
    def body(x, layer_p, cache):
        return decoder_layer(layer_p, cfg, x, qpos, cache=cache,
                             cache_pos=cache_pos, kv_src=kv_src,
                             kv_pos=kv_pos, causal=causal)

    body = _remat(body, remat)
    stacks = [layers_p] if dense_p is None else [dense_p, layers_p]
    order = [(st, i) for st in stacks
             for i in range(tree_leaves(st)[0].shape[0])]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = None if caches is None else tree_map(torch.empty_like,
                                                      caches)
    for layer, (st, i) in enumerate(order):
        cache = None if caches is None else tree_index(caches, layer)
        x, c, a = body(x, tree_index(st, i), cache)
        if c is not None:
            tree_map(lambda out, new: out[layer].copy_(new), new_caches, c)
        aux = aux + a
    return x, new_caches, aux


def embed_tokens(params, cfg, tokens):
    """Gather the token rows (the reference's ``jnp.take``); its gradient
    is a dense (V, d) scatter-add, as the reference's is."""
    return F.embedding(tokens, params["embed"]).to(cfg.activation_dtype())


def unembed(params, cfg, x):
    """The final norm and the LM head: logits (B, S, V). Under a mesh
    context whose model axis divides the vocab, each tp rank forms its
    vocab slice on its device (`unembed_ranks`) and the slices join in
    rank order on x's device; else the head computes whole."""
    parts = unembed_ranks(params, cfg, x)
    if parts is None:
        x = rms_norm(x, params["ln_f"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return x @ head.to(x.dtype)
    return torch.cat([torch.cat([t.to(x.device) for t in ranks], dim=-1)
                      for _, ranks in parts], dim=0)


def unembed_ranks(params, cfg, x):
    """The LM head split over the vocab (the reference's logits sharded
    ``("batch", None, "tp")``): for each batch group over the data ranks
    (`models.common.TPRanks.groups`), its rows and the tp ranks' logit
    slices (rows, S, V / tp) in rank order, each formed on its rank's
    device from the rank's columns of ``lm_head`` (its rows of ``embed``
    where the embeddings are tied). None where the head computes whole:
    no model axis, or one that does not divide the vocab."""
    tpr = tp_ranks()
    if tpr is None or cfg.vocab_size % tpr.size:
        return None
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    out = []
    for rows, devs in tpr.groups(x.shape[0]):
        ranks = []
        for r, dev in enumerate(devs):
            head = (tp_slice(params["embed"], ("tp", None), r).T
                    if cfg.tie_embeddings
                    else tp_slice(params["lm_head"], (None, "tp"), r))
            ranks.append(x[rows].to(dev) @ head.to(dev, x.dtype))
        out.append((rows, ranks))
    return out


def lm_forward(params, cfg, tokens, *, prefix_embeds=None, remat="full",
               head=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. tokens: (B, S_text). ``prefix_embeds`` (B, P, d)
    are precomputed frontend embeddings (VLM patches) prefixed to the
    token embeddings. Returns (``head``(params, cfg, x) of the last hidden
    states — `unembed`'s logits (B, S_total, V) by default — moe_aux)."""
    x = embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    qpos = torch.arange(s, device=x.device).expand(b, s)
    x, _, aux = scan_decoder(params["layers"], cfg, x, qpos, remat=remat,
                             dense_p=params.get("dense_layers"))
    return (head or unembed)(params, cfg, x), aux


def lm_decode(params, cfg, token, caches, pos):
    """Decode (S = 1) or chunked prefill (S > 1) against the caches.
    token: (B, S) written at positions pos..pos+S−1 (uniform across the
    batch). Returns (logits (B, S, V), new_caches)."""
    x = embed_tokens(params, cfg, token)
    b, s, _ = x.shape
    qpos = pos + torch.arange(s, device=x.device).expand(b, s)
    x, new_caches, _ = scan_decoder(params["layers"], cfg, x, qpos,
                                    caches=caches, cache_pos=pos,
                                    remat="none",
                                    dense_p=params.get("dense_layers"))
    return unembed(params, cfg, x), new_caches


def lm_cache_defs(cfg, batch: int, seq_len: int):
    if cfg.mla is not None:
        one = mla_mod.mla_cache_defs(cfg, batch, seq_len)
    else:
        one = attn.self_cache_defs(cfg, batch, seq_len)
    return stack_specs(one, cfg.num_layers)
