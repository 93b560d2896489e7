"""GQA attention: parameter definitions, the full-sequence (training)
block, the KV-cache path (chunked prefill and decode, sliding-window
ring caches) and cross-attention (enc-dec: keys and values from the
encoder's states, or from a precomputed cross cache when decoding).
Causal and sliding-window masks; with ``cfg.use_flash_attention`` the
cache-free self-attention core is `kernels.ops.flash_mha` (K2 on the
card), else, and always against a cache or across, the plain core
`_attend`, as in the reference. Under a mesh context the query heads
split over the model axis (`_attention_split`), or with
``cfg.attn_seq_shard`` the query sequence (`_attention_seq_split`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import spmd
from repro_torch.models.common import (ParamSpec, dense_spec, join_runs,
                                       padded_heads, rope, tp_ranks,
                                       tp_slice)

NEG_INF = -1e30

# q-length above which the score matrix is computed in chunks (bounds the
# (B,H,S,T) temp to (B,H,CHUNK,T)), as in the reference
_Q_CHUNK = 512


def attn_defs(cfg, cross: bool = False):
    """ParamSpecs for one attention block. Under a mesh context the query
    heads are padded to a multiple of the tp degree (`padded_heads`; the
    pad heads are initialized as the others and reach the output through
    ``wo``'s padded rows); the forward reads the head count from ``wq``.
    With ``cfg.attn_seq_shard`` the query sequence is sharded instead and
    no padding happens."""
    del cross
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq = cfg.num_heads if cfg.attn_seq_shard else padded_heads(cfg.num_heads)
    hkv = cfg.num_kv_heads
    defs = {
        "wq": dense_spec(d, hq * dh),
        "wk": dense_spec(d, hkv * dh),
        "wv": dense_spec(d, hkv * dh),
        "wo": dense_spec(hq * dh, d, logical=("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamSpec((hq * dh,), ("tp",), init="zeros")
        defs["bk"] = ParamSpec((hkv * dh,), (("tp", None),), init="zeros")
        defs["bv"] = ParamSpec((hkv * dh,), (("tp", None),), init="zeros")
    return defs


def _split_heads(x, n_heads, head_dim):
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    """(..., S, T) boolean validity mask. kpos < 0 marks unwritten cache."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & (q - k < window)
    return m


def _attend(q, k, v, qpos, kpos, *, causal, window, scale=None):
    """Plain attention core (GQA by kv-head repetition, float32 scores and
    softmax, masked scores set to ``NEG_INF``), the scores scaled by
    ``scale`` (default D^−½).

    q: (B, S, H, D)   k/v: (B, T, Hkv, D), H = G·Hkv
    qpos: (B, S)      kpos: (B, T) (−1 ⇒ invalid slot)
    returns (B, S, H, D) in v's dtype
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)

    def blk(q_blk, qpos_blk):
        s = torch.einsum("bshd,bthd->bhst", q_blk.to(torch.float32),
                         k.to(torch.float32)) * scale
        m = _mask(qpos_blk, kpos, causal, window)          # (B, S, T)
        s = torch.where(m[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhst,bthd->bshd", p,
                            v.to(torch.float32)).to(v.dtype)

    S, T = q.shape[1], k.shape[1]
    if S > _Q_CHUNK and S * T >= (1 << 22) and S % _Q_CHUNK == 0:
        return torch.cat([blk(q[:, i:i + _Q_CHUNK], qpos[:, i:i + _Q_CHUNK])
                          for i in range(0, S, _Q_CHUNK)], dim=1)
    return blk(q, qpos)


def cache_write(buf, new, slot):
    """``jax.lax.dynamic_update_slice_in_dim(buf, new, slot, axis=1)``: a
    copy of ``buf`` with ``new`` written along axis 1 from ``slot``. As in
    JAX, a start that would overrun the buffer is clamped to ``W − S`` (a
    negative one to 0), where slice assignment would not clamp."""
    w, s = buf.shape[1], new.shape[1]
    if s > w:
        raise ValueError(f"{s} new positions do not fit a cache of {w}")
    start = min(max(int(slot), 0), w - s)
    out = buf.clone()
    out[:, start:start + s] = new
    return out


def attention_block(p, cfg, x, qpos, *, kv_src=None, kv_pos=None, cache=None,
                    cache_pos=None, causal=True, cross_cached=False):
    """One attention block (self- or cross-).

    x: (B, S, d) hidden states; qpos: (B, S) absolute positions.
    kv_src: (B, T, d) for cross-attention (the keys' and values' source;
      no rope, neither causal nor windowed), at ``kv_pos``.
    cache: optional dict(k, v, pos) — decode mode; the new keys, values
      and positions are written at ``cache_pos`` (modulo the cache length
      for sliding windows: a ring buffer) into a new cache, and the block
      attends over all of it; unwritten slots carry position −1. With
      ``cross_cached`` the cache holds the precomputed cross keys and
      values, is attended as it is and comes back unchanged.
    Returns (y, new_cache); new_cache is None without a cache.

    Under a mesh context whose model axis divides the query heads (and
    without ``cfg.attn_seq_shard``) the heads split over the tp ranks
    (`_attention_split`). With ``cfg.attn_seq_shard`` the query sequence
    splits instead, where the model axis divides it and there is no cache
    (`_attention_seq_split`). Else the block computes whole."""
    dh = cfg.resolved_head_dim
    hq = p["wq"].shape[1] // dh
    assert hq % cfg.num_kv_heads == 0, (hq, cfg.num_kv_heads)
    kw = dict(kv_src=kv_src, kv_pos=kv_pos, cache=cache, cache_pos=cache_pos,
              causal=causal, cross_cached=cross_cached)
    tpr = tp_ranks()
    if tpr is not None and cfg.attn_seq_shard:
        split = cache is None and x.shape[1] % tpr.size == 0
        return _attention_heads(p, cfg, x, qpos, seq_ranks=tpr if split
                                else None, **kw)
    if tpr is None or hq % tpr.size:
        return _attention_heads(p, cfg, x, qpos, **kw)
    return _attention_split(p, cfg, x, qpos, tpr, hq, **kw)


def _attention_heads(p, cfg, x, qpos, *, kv_src=None, kv_pos=None,
                     cache=None, cache_pos=None, causal=True,
                     cross_cached=False, kv_index=None, seq_ranks=None):
    """The block over the heads ``p`` holds: ``wq``'s query heads, ``wk``
    and ``wv``'s KV heads (the cache's), ``wo``'s rows. Query head h reads
    KV head h // (query heads / KV heads), or ``kv_index[h]`` when given
    (a rank whose query heads straddle KV groups). With ``seq_ranks`` (no
    cache) the attention core splits over the query sequence
    (`_attention_seq_split`)."""
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    hq = p["wq"].shape[1] // dh
    hkv = p["wk"].shape[1] // dh
    window = cfg.sliding_window

    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, hq, dh)
    use_rope = cfg.rope_theta > 0 and kv_src is None and not cross_cached
    if use_rope:
        q = rope(q, qpos, cfg.rope_theta)

    new_cache = None
    if cross_cached:
        k, v, kpos = cache["k"], cache["v"], cache["pos"]
        new_cache = cache
    else:
        src = kv_src if kv_src is not None else x
        k = src @ p["wk"]
        v = src @ p["wv"]
        if "bk" in p:
            k = k + p["bk"]
        if "bv" in p:
            v = v + p["bv"]
        k = _split_heads(k, hkv, dh)
        v = _split_heads(v, hkv, dh)
        kpos = kv_pos if kv_pos is not None else qpos
        if use_rope:
            k = rope(k, kpos, cfg.rope_theta)
        if cache is not None:
            slot = cache_pos % cache["k"].shape[1] if window is not None \
                else cache_pos
            k = cache_write(cache["k"], k, slot)
            v = cache_write(cache["v"], v, slot)
            kpos = cache_write(cache["pos"], kpos, slot)
            new_cache = {"k": k, "v": v, "pos": kpos}
    if kv_index is not None:
        k = k.index_select(2, kv_index)
        v = v.index_select(2, kv_index)

    is_cross = kv_src is not None or cross_cached
    flash = (cfg.use_flash_attention and cache is None and not is_cross
             and kv_pos is None)

    def core(q, k, v, qpos, kpos, q_offset=0):
        if flash:
            # positions come from array offsets in the kernel (query s at
            # q_offset + s, keys at 0..T-1), which is exactly this path's
            # contiguous qpos
            return ops.flash_mha(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset)
        return _attend(q, k, v, qpos, kpos, causal=causal and not is_cross,
                       window=None if is_cross else window)

    if seq_ranks is not None:
        ctx = _attention_seq_split(core, seq_ranks, q, k, v, qpos, kpos)
    else:
        ctx = core(q, k, v, qpos, kpos)
    return ctx.reshape(B, S, hq * dh) @ p["wo"], new_cache


def _attention_seq_split(core, tpr, q, k, v, qpos, kpos):
    """The attention core split over the query sequence (the reference's
    ``attn_seq_shard``): rank r takes query rows [r·S/tp, (r+1)·S/tp) with
    their positions (K2 at ``q_offset`` r·S/tp on the flash path) and every
    key and value, on its device; the rows join in rank order, with no
    psum, and ``wo`` multiplies them once. q, k and v are formed once,
    whole, so a rank's rows of them are the whole run's bits; the gradient
    of k and v sums over the ranks. ``wo`` takes the joined rows because
    cuBLAS rounds a product of a quarter of the rows otherwise than the
    whole product's same rows (measured on an H100: a 1024-row product
    against a 4096-row one), and that rounding would reach an MoE router's
    near-ties; the joined rows are the whole block's bits wherever the
    ranks' cores are. Batch groups over the data ranks as
    `models.common.TPRanks.groups` gives them."""
    b, s = q.shape[:2]
    part = s // tpr.size
    out = []
    for rows, devs in tpr.groups(b):
        for r, dev in enumerate(devs):
            seq = slice(r * part, (r + 1) * part)
            out.append(core(q[rows, seq].to(dev), k[rows].to(dev),
                            v[rows].to(dev), qpos[rows, seq].to(dev),
                            kpos[rows].to(dev), r * part).to(q.device))
    groups = [torch.cat(out[i:i + tpr.size], dim=1)
              for i in range(0, len(out), tpr.size)]
    return torch.cat(groups, dim=0)


def rank_heads(hq: int, hkv: int, tp: int, r: int):
    """Rank r's query heads [a, b) of ``hq`` split ``tp`` ways, the KV
    heads [lo, hi) they read (a contiguous run), and the index of the KV
    head each query head reads within that run, or None where the heads
    keep GQA's grouping (query heads a whole number of KV groups, or all
    in one group)."""
    g = hq // hkv
    per = hq // tp
    a, b = r * per, (r + 1) * per
    lo, hi = a // g, (b - 1) // g + 1
    aligned = (a % g == 0 and per % g == 0) or hi - lo == 1
    index = None if aligned else [h // g - lo for h in range(a, b)]
    return (a, b), (lo, hi), index


def _rank_attn_params(p, cfg, heads, kv, r, tp, dev):
    """Rank r's weights on ``dev``: its query heads' columns of wq (and
    bq) and rows of wo, cut by `tp_slice` from the head-level spec, and
    the columns of wk, wv (bk, bv) of the KV heads it reads."""
    dh = cfg.resolved_head_dim
    d = p["wq"].shape[0]
    hq = p["wq"].shape[1] // dh
    (lo, hi) = kv
    out = {"wq": tp_slice(p["wq"].reshape(d, hq, dh), (None, "tp", None),
                          r).reshape(d, -1),
           "wo": tp_slice(p["wo"].reshape(hq, dh, -1), ("tp", None, None),
                          r).reshape(-1, p["wo"].shape[1]),
           "wk": p["wk"][:, lo * dh:hi * dh],
           "wv": p["wv"][:, lo * dh:hi * dh]}
    if "bq" in p:
        out["bq"] = tp_slice(p["bq"].reshape(hq, dh), ("tp", None),
                             r).reshape(-1)
    for k in ("bk", "bv"):
        if k in p:
            out[k] = p[k][lo * dh:hi * dh]
    assert out["wq"].shape[1] == (heads[1] - heads[0]) * dh
    return {k: v.to(dev) for k, v in out.items()}


def _attention_split(p, cfg, x, qpos, tpr, hq, *, kv_src, kv_pos, cache,
                     cache_pos, causal, cross_cached):
    """The block split over the model axis: rank r computes its query
    heads, the KV heads those read (a rank's share of them where the KV
    heads divide the axis, else whichever the rank's query heads read, so
    every rank may hold them all), its rows of ``wo`` and its share of the
    cache, on its device; a psum joins the ranks' outputs after ``wo``.
    Batch groups over the data ranks as `models.common.TPRanks.groups`
    gives them. The caller's cache keeps its shape and device: the ranks'
    slices are cut from it, and the new cache is put back together from
    theirs."""
    tp = tpr.size
    plan = [rank_heads(hq, cfg.num_kv_heads, tp, r) for r in range(tp)]
    runs = [kv for _, kv, _ in plan]
    ys, caches = [], []
    for rows, devs in tpr.groups(x.shape[0]):
        outs, rank_caches = [], []
        for r, ((heads, (lo, hi), index), dev) in enumerate(zip(plan, devs)):
            pr = _rank_attn_params(p, cfg, heads, (lo, hi), r, tp, dev)
            rc = None
            if cache is not None:
                rc = {"k": cache["k"][rows, :, lo:hi].to(dev),
                      "v": cache["v"][rows, :, lo:hi].to(dev),
                      "pos": cache["pos"][rows].to(dev)}

            def part(t):
                return None if t is None else t[rows].to(dev)

            y, nc = _attention_heads(
                pr, cfg, x[rows].to(dev), qpos[rows].to(dev),
                kv_src=part(kv_src), kv_pos=part(kv_pos), cache=rc,
                cache_pos=cache_pos, causal=causal, cross_cached=cross_cached,
                kv_index=None if index is None else torch.tensor(
                    index, device=dev))
            outs.append(y)
            rank_caches.append(nc)
        ys.append(spmd.psum(outs)[0].to(x.device))
        if cache is not None and not cross_cached:
            caches.append({
                "k": join_runs([c["k"] for c in rank_caches], runs, 2),
                "v": join_runs([c["v"] for c in rank_caches], runs, 2),
                "pos": rank_caches[0]["pos"]})
    y = torch.cat(ys, dim=0)
    if cache is None:
        return y, None
    if cross_cached:
        return y, cache
    return y, {k: torch.cat([c[k].to(cache[k].device) for c in caches],
                            dim=0) for k in ("k", "v", "pos")}


def self_cache_defs(cfg, batch: int, seq_len: int):
    """ParamSpecs of one layer's decode KV cache: keys and values (zeros)
    and their positions (−1: unwritten). A sliding window keeps a ring of
    ``min(seq_len, window)`` slots. ``cfg.kv_cache_shard`` picks the
    logical layout: "heads" puts tp on the KV heads, else on the head_dim
    where the heads do not divide; "seq" on the cache's positions; "none"
    on neither."""
    dh = cfg.resolved_head_dim
    hkv = cfg.num_kv_heads
    W = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    mode = cfg.kv_cache_shard
    tp = ("tp", None) if mode == "heads" else None
    seq = ("tp", None) if mode == "seq" else None
    kv = ParamSpec((batch, W, hkv, dh), ("batch", seq, tp, tp),
                   init="zeros")
    return {
        "k": kv,
        "v": kv,
        "pos": ParamSpec((batch, W), ("batch", seq), init="neg_ones",
                         dtype=torch.int32),
    }


def cross_cache_defs(cfg, batch: int, src_len: int):
    """ParamSpecs of one decoder layer's cross cache: the encoder states'
    keys and values and their positions (zeros until
    ``encdec.build_cross_cache`` fills them)."""
    dh = cfg.resolved_head_dim
    hkv = cfg.num_kv_heads
    kv = ParamSpec((batch, src_len, hkv, dh),
                   ("batch", None, ("tp", None), ("tp", None)), init="zeros")
    return {
        "k": kv,
        "v": kv,
        "pos": ParamSpec((batch, src_len), ("batch", None), init="zeros",
                         dtype=torch.int32),
    }
