"""Encoder-decoder transformer (Whisper-style). The audio frontend
(mel-spectrogram + conv) is a stub, as in the reference: the encoder
consumes precomputed frame embeddings (B, src_len, d). Absolute sinusoidal
positions (rope_theta = 0). The encoder's self-attention is non-causal
(K2 with ``use_flash_attention``); the decoder's self-attention is causal
(K2 likewise, against a KV cache the plain core) and its cross-attention
always takes the plain core, as in the reference. Layers run as Python
loops over the stacked (L, ...) leaves, the reference's ``lax.scan``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamSpec, rms_norm, sinusoidal_at,
                                       sinusoidal_positions, stack_specs)
from repro_torch.models.transformer import (_remat, embed_tokens, mlp_block,
                                            mlp_defs, unembed)
from repro_torch.tree import tree_index, tree_map


def enc_layer_defs(cfg):
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), (None,), init="ones"),
        "attn": attn.attn_defs(cfg),
        "ln2": ParamSpec((d,), (None,), init="ones"),
        "mlp": mlp_defs(cfg),
    }


def dec_layer_defs(cfg):
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), (None,), init="ones"),
        "self_attn": attn.attn_defs(cfg),
        "ln_x": ParamSpec((d,), (None,), init="ones"),
        "cross_attn": attn.attn_defs(cfg, cross=True),
        "ln2": ParamSpec((d,), (None,), init="ones"),
        "mlp": mlp_defs(cfg),
    }


def encdec_defs(cfg):
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamSpec((v, d), ("tp", None), scale=0.02),
        "enc_layers": stack_specs(enc_layer_defs(cfg), cfg.encoder.num_layers),
        "enc_ln": ParamSpec((d,), (None,), init="ones"),
        "dec_layers": stack_specs(dec_layer_defs(cfg), cfg.num_layers),
        "ln_f": ParamSpec((d,), (None,), init="ones"),
        "lm_head": ParamSpec((d, v), ("fsdp", "tp"), scale=d ** -0.5),
    }


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device).expand(b, t)


def encode(params, cfg, frames, remat="full"):
    """frames: (B, src_len, d) stub embeddings -> encoder states; each
    layer runs under ``_remat(remat)``."""
    b, t, d = frames.shape
    x = frames.to(cfg.activation_dtype())
    x = x + sinusoidal_positions(t, d, device=x.device).to(x.dtype)
    pos = _positions(b, t, x.device)

    def body(x, layer_p):
        h = rms_norm(x, layer_p["ln1"], cfg.norm_eps)
        a, _ = attn.attention_block(layer_p["attn"], cfg, h, pos,
                                    causal=False)
        x = x + a
        h = rms_norm(x, layer_p["ln2"], cfg.norm_eps)
        return x + mlp_block(layer_p["mlp"], h)

    body = _remat(body, remat)
    for layer in range(cfg.encoder.num_layers):
        x = body(x, tree_index(params["enc_layers"], layer))
    return rms_norm(x, params["enc_ln"], cfg.norm_eps)


def _dec_layer(p, cfg, x, qpos, enc_out, enc_pos, *, self_cache=None,
               cross_cache=None, cache_pos=None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_self = attn.attention_block(p["self_attn"], cfg, h, qpos,
                                       cache=self_cache, cache_pos=cache_pos)
    x = x + a
    h = rms_norm(x, p["ln_x"], cfg.norm_eps)
    a, new_cross = attn.attention_block(
        p["cross_attn"], cfg, h, qpos, kv_src=enc_out, kv_pos=enc_pos,
        cache=cross_cache, causal=False, cross_cached=cross_cache is not None)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_block(p["mlp"], h), new_self, new_cross


def encdec_forward(params, cfg, tokens, frames, remat="full", head=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced training forward. Returns (``head``(params, cfg, x)
    of the last hidden states — `unembed`'s logits by default — aux =
    0)."""
    enc_out = encode(params, cfg, frames, remat=remat)
    b, t_src, d = enc_out.shape
    enc_pos = _positions(b, t_src, enc_out.device)
    x = embed_tokens(params, cfg, tokens)
    s = x.shape[1]
    x = x + sinusoidal_positions(s, d, device=x.device).to(x.dtype)
    qpos = _positions(b, s, x.device)

    def body(x, layer_p):
        y, _, _ = _dec_layer(layer_p, cfg, x, qpos, enc_out, enc_pos)
        return y

    body = _remat(body, remat)
    for layer in range(cfg.num_layers):
        x = body(x, tree_index(params["dec_layers"], layer))
    return (head or unembed)(params, cfg, x), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def build_cross_cache(params, cfg, frames, remat="none"):
    """Run the encoder and precompute every decoder layer's cross keys and
    values (by ``wk`` and ``wv`` alone, without biases, as the reference
    does) — the enc-dec prefill step, ``caches["cross"]``."""
    enc_out = encode(params, cfg, frames, remat=remat)
    b, t, _ = enc_out.shape
    dh = cfg.resolved_head_dim
    ca = params["dec_layers"]["cross_attn"]
    return {
        "k": torch.stack([(enc_out @ ca["wk"][i]).reshape(
            b, t, cfg.num_kv_heads, dh) for i in range(cfg.num_layers)]),
        "v": torch.stack([(enc_out @ ca["wv"][i]).reshape(
            b, t, cfg.num_kv_heads, dh) for i in range(cfg.num_layers)]),
        "pos": _positions(b, t, enc_out.device).to(torch.int32).expand(
            cfg.num_layers, b, t).contiguous(),
    }


def encdec_decode(params, cfg, token, caches, pos):
    """Decoder step (S = 1) or chunked prefill (S > 1). ``caches`` =
    {"self": stacked, "cross": stacked} (cross keys and values from
    `build_cross_cache`). The new self caches come back in fresh stacked
    buffers; the cross caches come back as they came."""
    x = embed_tokens(params, cfg, token)
    b, s, d = x.shape
    qpos = pos + _positions(b, s, x.device)
    x = x + sinusoidal_at(qpos, d).to(x.dtype)
    new_self = tree_map(torch.empty_like, caches["self"])
    for layer in range(cfg.num_layers):
        x, c, _ = _dec_layer(tree_index(params["dec_layers"], layer), cfg, x,
                             qpos, None, None,
                             self_cache=tree_index(caches["self"], layer),
                             cross_cache=tree_index(caches["cross"], layer),
                             cache_pos=pos)
        tree_map(lambda out, v: out[layer].copy_(v), new_self, c)
    return unembed(params, cfg, x), {"self": new_self,
                                     "cross": caches["cross"]}


def encdec_cache_defs(cfg, batch: int, seq_len: int):
    return {
        "self": stack_specs(attn.self_cache_defs(cfg, batch, seq_len),
                            cfg.num_layers),
        "cross": stack_specs(
            attn.cross_cache_defs(cfg, batch, cfg.encoder.src_len),
            cfg.num_layers),
    }
