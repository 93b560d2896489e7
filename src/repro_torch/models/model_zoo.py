"""Unified model API over the families the port runs.

* ``param_defs(cfg)``   -> ParamSpec nested dict
* ``forward(params, cfg, batch)``  -> (logits, moe_aux)   [train / prefill]
* ``decode_step(params, cfg, tokens, caches, pos)`` -> (logits, caches)
* ``cache_defs(cfg, batch, seq_len)`` -> ParamSpec nested dict of caches
* ``prefill(params, cfg, batch, caches)`` -> (logits, caches)

The dense, MoE (incl. MLA) and VLM families are ported for training (a
VLM batch carries its projected patch embeddings as a prefix) and for
serving against KV caches (a VLM decodes text tokens only, as the
reference does); the SSM family (Mamba2) for training's forward and for
serving: the chunked prefill and the one-token decode. The hybrid and
enc-dec families come with the zoo-families slice. Layers run as a Python
loop over the stacked (L, ...) layer leaves, the reference's
``lax.scan``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import ParamSpec, stack_specs
from repro_torch.tree import tree_index, tree_map

_PORTED = ("dense", "moe", "vlm", "ssm")


def _family(cfg) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported to repro_torch yet: "
            "it comes with the zoo-families slice")


# ---------------------------------------------------------------- pure-SSM LM

def _ssm_lm_defs(cfg):
    return {
        "embed": ParamSpec((cfg.vocab_size, cfg.d_model), ("tp", None),
                           scale=0.02),
        "layers": stack_specs(hybrid_mod.ssm_layer_defs(cfg), cfg.num_layers),
        "ln_f": ParamSpec((cfg.d_model,), (None,), init="ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size), ("fsdp", "tp"),
                             scale=cfg.d_model ** -0.5),
    }


def _ssm_lm_forward(params, cfg, tokens, remat="none"):
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r} is not ported to repro_torch yet: it comes "
            "with the remat slice (activation checkpointing)")
    x = tf_mod.embed_tokens(params, cfg, tokens)
    for layer in range(cfg.num_layers):
        x, _ = hybrid_mod._ssm_layer(tree_index(params["layers"], layer),
                                     cfg, x)
    return tf_mod.unembed(params, cfg, x), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _ssm_lm_decode(params, cfg, token, caches, pos):
    """Every layer against its cache: a chunked prefill when ``token`` has
    S > 1 positions, a decode step when it has one. The new caches are
    written into fresh stacked buffers, layer by layer; ``caches`` is left
    as it was."""
    del pos  # the SSM state is O(1) in the position
    x = tf_mod.embed_tokens(params, cfg, token)
    new_caches = tree_map(torch.empty_like, caches)
    for layer in range(cfg.num_layers):
        x, c = hybrid_mod._ssm_layer(tree_index(params["layers"], layer), cfg,
                                     x, cache=tree_index(caches, layer))
        tree_map(lambda out, new: out[layer].copy_(new), new_caches, c)
    return tf_mod.unembed(params, cfg, x), new_caches


def _ssm_lm_cache_defs(cfg, batch, seq_len):
    del seq_len  # SSM decode state is O(1) in context length
    return stack_specs(ssm_mod.ssm_cache_defs(cfg, batch), cfg.num_layers)


# ---------------------------------------------------------------- dispatch

def param_defs(cfg):
    _family(cfg)
    if cfg.family == "ssm":
        return _ssm_lm_defs(cfg)
    return tf_mod.lm_defs(cfg)          # dense | moe | vlm


def forward(params, cfg, batch: Dict[str, torch.Tensor], remat: str = "none"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch keys: tokens (B, S); vlm additionally patches (B, P, d)."""
    _family(cfg)
    if cfg.family == "ssm":
        return _ssm_lm_forward(params, cfg, batch["tokens"], remat=remat)
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    return tf_mod.lm_forward(params, cfg, batch["tokens"],
                             prefix_embeds=prefix, remat=remat)


def decode_step(params, cfg, tokens, caches, pos):
    """tokens (B, 1) integer ids, pos the position of the first."""
    _family(cfg)
    if cfg.family == "ssm":
        return _ssm_lm_decode(params, cfg, tokens, caches, pos)
    return tf_mod.lm_decode(params, cfg, tokens, caches, pos)


def cache_defs(cfg, batch: int, seq_len: int):
    _family(cfg)
    if cfg.family == "ssm":
        return _ssm_lm_cache_defs(cfg, batch, seq_len)
    return tf_mod.lm_cache_defs(cfg, batch, seq_len)


def prefill(params, cfg, batch: Dict[str, torch.Tensor], caches, pos=0):
    """Chunked prefill: consume the whole prompt in ONE cached pass (decode
    semantics with S > 1). batch: tokens (B, S). Returns (logits (B, S, V),
    caches)."""
    return decode_step(params, cfg, batch["tokens"], caches, pos)
