"""Multi-head Latent Attention (DeepSeek-V2). Decoupled RoPE; the KV cache
stores only the compressed latent (kv_lora_rank + rope dims per token).
Training and the cache-free forward expand the latent to full K/V and run
the plain attention core; with a cache (prefill and decode) the block uses
the absorbed formulation: scores and context computed in latent space, in
float32, cast back to the activations' dtype."""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, _attend, _mask, cache_write
from repro_torch.models.common import ParamSpec, dense_spec, rms_norm, rope


def mla_defs(cfg):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim, \
        m.kv_lora_rank
    return {
        "wq": dense_spec(d, h * (dn + dr)),
        "w_dkv": ParamSpec((d, r + dr), ("fsdp", None), scale=d ** -0.5),
        "ckv_norm": ParamSpec((r,), (None,), init="ones"),
        "w_uk": ParamSpec((r, h, dn), (None, "tp", None), scale=r ** -0.5),
        "w_uv": ParamSpec((r, h, dv), (None, "tp", None), scale=r ** -0.5),
        "wo": dense_spec(h * dv, d, logical=("tp", "fsdp")),
    }


def _project_q(p, cfg, x, qpos):
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, rope(q_rope, qpos, cfg.rope_theta)


def _compress_kv(p, cfg, x, kpos):
    r = cfg.mla.kv_lora_rank
    ckv_full = x @ p["w_dkv"]
    c = rms_norm(ckv_full[..., :r], p["ckv_norm"], cfg.norm_eps)
    k_rope = rope(ckv_full[..., r:], kpos, cfg.rope_theta)  # one shared head
    return c, k_rope


def mla_block(p, cfg, x, qpos, *, cache=None, cache_pos=None):
    """MLA attention block. x: (B, S, d); qpos: (B, S). With a cache
    (dict ckv, krope, pos) the new latents are written at ``cache_pos``
    (modulo the cache length for sliding windows) into a new cache.
    Returns (y, new_cache); new_cache is None without a cache."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    f32 = torch.float32

    q_nope, q_rope = _project_q(p, cfg, x, qpos)
    c, k_rope = _compress_kv(p, cfg, x, qpos)

    if cache is None:
        # expanded path: full K (nope ‖ the shared rope head) and V
        k_nope = torch.einsum("btr,rhn->bthn", c, p["w_uk"])
        v = torch.einsum("btr,rhv->bthv", c, p["w_uv"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                      dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        ctx = _attend(qf, k, v, qpos, qpos, causal=True,
                      window=cfg.sliding_window)
        new_cache = None
    else:
        # absorbed path (decode s = 1, chunked prefill s > 1): w_uk folds
        # into the query and w_uv into the context, so the block attends
        # over the latent cache itself
        slot = cache_pos % cache["ckv"].shape[1] if cfg.sliding_window \
            else cache_pos
        ckv = cache_write(cache["ckv"], c, slot)
        krope = cache_write(cache["krope"], k_rope, slot)
        kpos = cache_write(cache["pos"], qpos, slot)
        new_cache = {"ckv": ckv, "krope": krope, "pos": kpos}

        q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(f32),
                             p["w_uk"].to(f32))
        scores = (torch.einsum("bshr,btr->bhst", q_abs, ckv.to(f32))
                  + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                                 krope.to(f32))) * (dn + dr) ** -0.5
        msk = _mask(qpos, kpos, True, cfg.sliding_window)   # (B, S, T)
        scores = torch.where(msk[:, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        ctx_c = torch.einsum("bhst,btr->bshr", probs, ckv.to(f32))
        ctx = torch.einsum("bshr,rhv->bshv", ctx_c,
                           p["w_uv"].to(f32)).to(x.dtype)

    return ctx.reshape(b, s, h * dv) @ p["wo"], new_cache


def mla_cache_defs(cfg, batch: int, seq_len: int):
    """ParamSpecs of one layer's latent cache: the normalized latent
    (B, W, kv_lora_rank), the rotated rope key (B, W, dr) and positions
    (−1: unwritten). ``cfg.kv_cache_shard`` "heads" puts tp on the latent,
    "seq" on the positions."""
    m = cfg.mla
    W = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    mode = cfg.kv_cache_shard
    latent = ("tp", None) if mode == "heads" else None
    seq = ("tp", None) if mode == "seq" else None
    return {
        "ckv": ParamSpec((batch, W, m.kv_lora_rank), ("batch", seq, latent),
                         init="zeros"),
        "krope": ParamSpec((batch, W, m.qk_rope_head_dim),
                           ("batch", seq, None), init="zeros"),
        "pos": ParamSpec((batch, W), ("batch", seq), init="neg_ones",
                         dtype=torch.int32),
    }
