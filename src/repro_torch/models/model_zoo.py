"""Unified model API over every family of the reference.

* ``param_defs(cfg)``   -> ParamSpec nested dict
* ``forward(params, cfg, batch)``  -> (logits, moe_aux)   [train / prefill]
* ``decode_step(params, cfg, tokens, caches, pos)`` -> (logits, caches)
* ``cache_defs(cfg, batch, seq_len)`` -> ParamSpec nested dict of caches
* ``prefill(params, cfg, batch, caches)`` -> (logits, caches)

Families: dense, MoE (incl. MLA) and VLM (`models.transformer`; a VLM
batch carries its projected patch embeddings as a prefix and decodes text
tokens only, as the reference does), the SSM family (Mamba2), the hybrid
(Zamba2, `models.hybrid`) and enc-dec (Whisper, `models.encdec`). Layers
run as a Python loop over the stacked (L, ...) layer leaves, the
reference's ``lax.scan``; the training forward runs each layer (each
super-group of the hybrid) under ``remat``, "full" by default, as in the
reference."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import ParamSpec, stack_specs
from repro_torch.tree import tree_index


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


def _ssm_lm_forward(params, cfg, tokens, remat="full", head=None):
    x = tf_mod.embed_tokens(params, cfg, tokens)

    def body(x, layer_p):
        y, _ = hybrid_mod._ssm_layer(layer_p, cfg, x)
        return y

    body = tf_mod._remat(body, remat)
    for layer in range(cfg.num_layers):
        x = body(x, tree_index(params["layers"], layer))
    return (head or tf_mod.unembed)(params, cfg, x), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def _ssm_lm_decode(params, cfg, token, caches, pos):
    """Every layer against its cache: a chunked prefill when ``token`` has
    S > 1 positions, a decode step when it has one. The new caches come
    back in fresh stacked buffers; ``caches`` is left as it was."""
    del pos  # the SSM state is O(1) in the position
    x = tf_mod.embed_tokens(params, cfg, token)
    x, new_caches = hybrid_mod._ssm_stack(params["layers"], cfg, x,
                                          caches=caches)
    return tf_mod.unembed(params, cfg, x), new_caches


def _ssm_lm_cache_defs(cfg, batch, seq_len):
    del seq_len  # SSM decode state is O(1) in context length
    return stack_specs(ssm_mod.ssm_cache_defs(cfg, batch), cfg.num_layers)


# ---------------------------------------------------------------- dispatch

def param_defs(cfg):
    if cfg.family == "encdec":
        return encdec_mod.encdec_defs(cfg)
    if cfg.family == "ssm":
        return _ssm_lm_defs(cfg)
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_defs(cfg)
    return tf_mod.lm_defs(cfg)          # dense | moe | vlm


def forward(params, cfg, batch: Dict[str, torch.Tensor], remat: str = "full"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch keys: tokens (B, S); encdec additionally frames (B, src, d);
    vlm additionally patches (B, P, d). Returns (logits, moe_aux)."""
    return _forward(params, cfg, batch, remat, None)


def forward_hidden(params, cfg, batch: Dict[str, torch.Tensor],
                   remat: str = "full") -> Tuple[torch.Tensor, torch.Tensor]:
    """`forward` up to the LM head: (the last hidden states (B, S, d),
    before the final norm, moe_aux), for a loss that applies the head
    itself (`train.loss.head_token_nll`)."""
    return _forward(params, cfg, batch, remat, lambda params, cfg, x: x)


def _forward(params, cfg, batch, remat, head):
    if cfg.family == "encdec":
        return encdec_mod.encdec_forward(params, cfg, batch["tokens"],
                                         batch["frames"], remat=remat,
                                         head=head)
    if cfg.family == "ssm":
        return _ssm_lm_forward(params, cfg, batch["tokens"], remat=remat,
                               head=head)
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_forward(params, cfg, batch["tokens"],
                                         remat=remat, head=head)
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    return tf_mod.lm_forward(params, cfg, batch["tokens"],
                             prefix_embeds=prefix, remat=remat, head=head)


def decode_step(params, cfg, tokens, caches, pos):
    """tokens (B, 1) integer ids, pos the position of the first."""
    if cfg.family == "encdec":
        return encdec_mod.encdec_decode(params, cfg, tokens, caches, pos)
    if cfg.family == "ssm":
        return _ssm_lm_decode(params, cfg, tokens, caches, pos)
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_decode(params, cfg, tokens, caches, pos)
    return tf_mod.lm_decode(params, cfg, tokens, caches, pos)


def cache_defs(cfg, batch: int, seq_len: int):
    if cfg.family == "encdec":
        return encdec_mod.encdec_cache_defs(cfg, batch, seq_len)
    if cfg.family == "ssm":
        return _ssm_lm_cache_defs(cfg, batch, seq_len)
    if cfg.family == "hybrid":
        return hybrid_mod.hybrid_cache_defs(cfg, batch, seq_len)
    return tf_mod.lm_cache_defs(cfg, batch, seq_len)


def prefill(params, cfg, batch: Dict[str, torch.Tensor], caches, pos=0):
    """Chunked prefill: consume the whole prompt in ONE cached pass (decode
    semantics with S > 1, every family). batch: tokens (B, S), and for
    enc-dec frames (B, src, d): the cross cache is built here. Returns
    (logits (B, S, V), caches)."""
    if cfg.family == "encdec":
        caches = dict(caches)
        caches["cross"] = encdec_mod.build_cross_cache(params, cfg,
                                                       batch["frames"])
    return decode_step(params, cfg, batch["tokens"], caches, pos)
