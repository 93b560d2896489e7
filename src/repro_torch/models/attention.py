"""GQA attention: parameter definitions and the full-sequence (training)
block. Causal and sliding-window masks; with ``cfg.use_flash_attention``
the attention core is `kernels.ops.flash_mha` (K2 on the card), else the
plain core `_attend`. The KV-cache decode path comes with the serving
slice of the port and cross-attention with the zoo-families slice; both
raise here."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec, dense_spec, rope

NEG_INF = -1e30

# q-length above which the score matrix is computed in chunks (bounds the
# (B,H,S,T) temp to (B,H,CHUNK,T)), as in the reference
_Q_CHUNK = 512


def attn_defs(cfg, cross: bool = False):
    """ParamSpecs for one attention block. The port runs on one device, so
    query heads are never padded for a tensor-parallel axis (the
    reference's ``padded_heads`` is the identity without a mesh)."""
    del cross
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq = cfg.num_heads
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


def _attend(q, k, v, qpos, kpos, *, causal, window):
    """Plain attention core (GQA by kv-head repetition, float32 scores and
    softmax, masked scores set to ``NEG_INF``).

    q: (B, S, H, D)   k/v: (B, T, Hkv, D), H = G·Hkv
    qpos: (B, S)      kpos: (B, T) (−1 ⇒ invalid slot)
    returns (B, S, H, D) in v's dtype
    """
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


def attention_block(p, cfg, x, qpos, *, kv_src=None, kv_pos=None, cache=None,
                    cache_pos=None, causal=True, cross_cached=False):
    """One full-sequence self-attention block.

    x: (B, S, d) hidden states; qpos: (B, S) absolute positions. Returns
    (y, None): the reference's second output is the updated decode cache,
    which this path never has."""
    if cache is not None or cache_pos is not None:
        raise NotImplementedError(
            "attention with a KV cache (decode/prefill) is not ported to "
            "repro_torch yet: it comes with the serving slice")
    if kv_src is not None or cross_cached:
        raise NotImplementedError(
            "cross-attention is not ported to repro_torch yet: it comes "
            "with the zoo-families slice (enc-dec) and the serving slice")
    B, S, _ = x.shape
    dh = cfg.resolved_head_dim
    hq = p["wq"].shape[1] // dh
    hkv = cfg.num_kv_heads
    assert hq % hkv == 0, (hq, hkv)
    window = cfg.sliding_window

    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = _split_heads(q, hq, dh)
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
    if "bv" in p:
        v = v + p["bv"]
    k = _split_heads(k, hkv, dh)
    v = _split_heads(v, hkv, dh)
    kpos = kv_pos if kv_pos is not None else qpos
    if cfg.rope_theta > 0:
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, kpos, cfg.rope_theta)

    if cfg.use_flash_attention and kv_pos is None:
        # positions come from array offsets in the kernel (query s at s,
        # keys at 0..T-1), which is exactly this path's contiguous qpos
        ctx = ops.flash_mha(q, k, v, causal=causal, window=window)
    else:
        ctx = _attend(q, k, v, qpos, kpos, causal=causal, window=window)
    ctx = ctx.reshape(B, S, hq * dh)
    return ctx @ p["wo"], None
