"""Multi-head Latent Attention (DeepSeek-V2). Decoupled RoPE; the KV cache
stores only the compressed latent (kv_lora_rank + rope dims per token).
Training and the cache-free forward expand the latent to full K/V and run
the plain attention core; with a cache (prefill and decode) the block uses
the absorbed formulation: scores and context computed in latent space, in
float32, cast back to the activations' dtype. Under a mesh context the
heads split over the model axis (`mla_block`). With ``cfg.mla.yarn`` the
rope dimensions turn at YaRN's frequencies and the softmax scale gains
YaRN's mscale², as DeepSeek-V2 has them. The per-head K/V and the
attention core run under the ``mla.core`` span."""
from __future__ import annotations

import functools

import torch

from repro_torch.models import spmd
from repro_torch.models.attention import NEG_INF, _attend, _mask, cache_write
from repro_torch.models.common import (ParamSpec, dense_spec, rms_norm, rope,
                                       tp_ranks, tp_slice, yarn_inv_freq,
                                       yarn_mscale)
from repro_torch.spans import span


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


@functools.lru_cache(maxsize=None)
def _yarn_freqs(yarn, dim: int, theta: float, device: torch.device):
    return yarn_inv_freq(yarn, dim, theta, device)


def _rope(cfg, x, pos):
    """`rope` of the rope dimensions x at ``pos``, at YaRN's frequencies
    where the config scales them."""
    yarn = cfg.mla.yarn
    inv = None if yarn is None else _yarn_freqs(
        yarn, x.shape[-1], float(cfg.rope_theta), x.device)
    return rope(x, pos, cfg.rope_theta, inv)


def softmax_scale(cfg) -> float:
    """(qk_nope + qk_rope)^−½, times YaRN's mscale² where it is set."""
    m = cfg.mla
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if m.yarn is not None:
        scale = scale * yarn_mscale(m.yarn.factor, m.yarn.mscale_all_dim) ** 2
    return scale


def _project_q(p, cfg, x, qpos):
    """The query heads ``p["wq"]`` holds, split into their no-rope and
    rotated rope parts."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, -1, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, _rope(cfg, q_rope, qpos)


def _compress_kv(p, cfg, x, kpos):
    r = cfg.mla.kv_lora_rank
    ckv_full = x @ p["w_dkv"]
    c = rms_norm(ckv_full[..., :r], p["ckv_norm"], cfg.norm_eps)
    k_rope = _rope(cfg, ckv_full[..., r:], kpos)  # one shared head
    return c, k_rope


def _latent(p, cfg, x, qpos, cache, cache_pos):
    """The latents of x (every head reads them whole): (c, k_rope) of the
    new positions, and with a cache the latent cache they are written into
    (ckv, krope, pos) as the new cache, else None."""
    c, k_rope = _compress_kv(p, cfg, x, qpos)
    if cache is None:
        return (c, k_rope), None
    slot = cache_pos % cache["ckv"].shape[1] if cfg.sliding_window \
        else cache_pos
    return (c, k_rope), {"ckv": cache_write(cache["ckv"], c, slot),
                         "krope": cache_write(cache["krope"], k_rope, slot),
                         "pos": cache_write(cache["pos"], qpos, slot)}


def _mla_heads(p, cfg, x, qpos, latent, cache):
    """The block's output over the heads ``p`` holds (``wq``'s columns,
    ``w_uk`` and ``w_uv``'s heads, ``wo``'s rows), from the latents: the
    expanded path from the new positions' (c, k_rope) without a cache,
    the absorbed path over the latent ``cache`` (ckv, krope, pos) with
    one."""
    m = cfg.mla
    b, s, _ = x.shape
    h = p["w_uk"].shape[1]
    dr, dv = m.qk_rope_head_dim, m.v_head_dim
    f32 = torch.float32

    q_nope, q_rope = _project_q(p, cfg, x, qpos)
    scale = softmax_scale(cfg)
    with span("mla.core"):
        if cache is None:
            # expanded path: full K (nope ‖ the shared rope head) and V
            c, k_rope = latent
            k_nope = torch.einsum("btr,rhn->bthn", c, p["w_uk"])
            v = torch.einsum("btr,rhv->bthv", c, p["w_uv"])
            k = torch.cat([k_nope,
                           k_rope[:, :, None, :].expand(b, s, h, dr)],
                          dim=-1)
            qf = torch.cat([q_nope, q_rope], dim=-1)
            ctx = _attend(qf, k, v, qpos, qpos, causal=True,
                          window=cfg.sliding_window, scale=scale)
        else:
            # absorbed path (decode s = 1, chunked prefill s > 1): w_uk
            # folds into the query and w_uv into the context, so the block
            # attends over the latent cache itself
            ckv, krope, kpos = cache["ckv"], cache["krope"], cache["pos"]
            q_abs = torch.einsum("bshn,rhn->bshr", q_nope.to(f32),
                                 p["w_uk"].to(f32))
            scores = (torch.einsum("bshr,btr->bhst", q_abs, ckv.to(f32))
                      + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                                     krope.to(f32))) * scale
            msk = _mask(qpos, kpos, True, cfg.sliding_window)  # (B, S, T)
            scores = torch.where(msk[:, None], scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            ctx_c = torch.einsum("bhst,btr->bshr", probs, ckv.to(f32))
            ctx = torch.einsum("bshr,rhv->bshv", ctx_c,
                               p["w_uv"].to(f32)).to(x.dtype)
    return ctx.reshape(b, s, h * dv) @ p["wo"]


def mla_block(p, cfg, x, qpos, *, cache=None, cache_pos=None):
    """MLA attention block. x: (B, S, d); qpos: (B, S). With a cache
    (dict ckv, krope, pos) the new latents are written at ``cache_pos``
    (modulo the cache length for sliding windows) into a new cache.
    Returns (y, new_cache); new_cache is None without a cache.

    Under a mesh context whose model axis divides the heads, rank r
    computes its query heads (``wq``'s columns, ``w_uk``/``w_uv``'s
    heads, ``wo``'s rows) on its device and a psum joins the ranks after
    ``wo``; the latents and their cache stay whole, computed once a batch
    group (over the data ranks, `models.common.TPRanks.groups`) and read
    by every rank, as the reference leaves them. Else the block computes
    whole."""
    tpr = tp_ranks()
    if tpr is None or cfg.num_heads % tpr.size:
        latent, new_cache = _latent(p, cfg, x, qpos, cache, cache_pos)
        return _mla_heads(p, cfg, x, qpos, latent, new_cache), new_cache
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dq, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    heads = {"wq": (p["wq"].reshape(d, h, dq), (None, "tp", None)),
             "w_uk": (p["w_uk"], (None, "tp", None)),
             "w_uv": (p["w_uv"], (None, "tp", None)),
             "wo": (p["wo"].reshape(h, dv, d), ("tp", None, None))}
    ys, caches = [], []
    for rows, devs in tpr.groups(x.shape[0]):
        group = None if cache is None else {k: v[rows]
                                            for k, v in cache.items()}
        latent, new_cache = _latent(p, cfg, x[rows], qpos[rows], group,
                                    cache_pos)
        outs = []
        for r, dev in enumerate(devs):
            pr = {k: tp_slice(w, tok, r).to(dev)
                  for k, (w, tok) in heads.items()}
            pr["wq"] = pr["wq"].reshape(d, -1)
            pr["wo"] = pr["wo"].reshape(-1, d)
            outs.append(_mla_heads(
                pr, cfg, x[rows].to(dev), qpos[rows].to(dev),
                tuple(t.to(dev) for t in latent),
                None if new_cache is None
                else {k: v.to(dev) for k, v in new_cache.items()}))
        ys.append(spmd.psum(outs)[0].to(x.device))
        caches.append(new_cache)
    y = torch.cat(ys, dim=0)
    if cache is None:
        return y, None
    return y, {k: torch.cat([c[k] for c in caches], dim=0)
               for k in ("ckv", "krope", "pos")}


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
