"""Mamba2 (SSD — state-space duality) block.

Chunked SSD forward (full sequence and prefill): intra-chunk attention-like
products plus the inter-chunk linear state recurrence, O(S·Q) work and an
O(1)-per-token state. Decode: a one-token recurrent update of the (H, P, N)
state. The chunked branches run `kernels.ops.ssd_chunked`, whose
intra-chunk terms are K3 on the card (the reference's model runs its jnp
``ssd_chunked`` instead and leaves its Pallas kernel to the tests).

Mixed dtypes: with bf16 activations and float32 parameters the reference's
``x @ w`` promotes to float32 (jnp's rule); ``torch.matmul`` refuses mixed
dtypes, so `_mm` promotes both operands first and no parameter is cast
down."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec, dense_spec, rms_norm


def ssm_defs(cfg):
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    h = d_inner // s.head_dim
    gn = s.ngroups * s.d_state
    return {
        "wz": dense_spec(d, d_inner),
        "wx": dense_spec(d, d_inner),
        "wB": ParamSpec((d, gn), ("fsdp", (("tp", None))), scale=d ** -0.5),
        "wC": ParamSpec((d, gn), ("fsdp", (("tp", None))), scale=d ** -0.5),
        "wdt": ParamSpec((d, h), ("fsdp", ("tp", None)), scale=d ** -0.5),
        "conv_x": ParamSpec((s.d_conv, d_inner), (None, "tp"), scale=0.2),
        "conv_B": ParamSpec((s.d_conv, gn), (None, ("tp", None)), scale=0.2),
        "conv_C": ParamSpec((s.d_conv, gn), (None, ("tp", None)), scale=0.2),
        "A_log": ParamSpec((h,), (("tp", None),), init="zeros"),
        "D": ParamSpec((h,), (("tp", None),), init="ones"),
        "dt_bias": ParamSpec((h,), (("tp", None),), init="zeros"),
        "norm_w": ParamSpec((d_inner,), ("tp",), init="ones"),
        "wo": dense_spec(d_inner, d, logical=("tp", "fsdp")),
    }


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as jnp's ``@``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|)),
    without ``F.softplus``'s switch to the identity above 20."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as shifts and products. u: (B, S, C), w:
    (K, C)."""
    k = w.shape[0]
    out = u * w[k - 1]
    for i in range(1, k):
        shifted = F.pad(u, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[k - 1 - i]
    return out


def _conv_step(u_t: torch.Tensor, conv_state: torch.Tensor,
               w: torch.Tensor):
    """One decode step of the causal conv. u_t: (B, C); conv_state: (B,
    K−1, C). Returns (y (B, C), the new conv state)."""
    window = torch.cat([conv_state, u_t[:, None]], dim=1)    # (B, K, C)
    y = (window * w).sum(dim=1)
    return y, window[:, 1:]


def ssd_chunked(xh, dt, a_h, bm, cm, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD.

    xh: (B, S, H, P)  dt: (B, S, H) (post-softplus)  a_h: (H,) (negative)
    bm, cm: (B, S, G, N) (G broadcast over heads); h0 (B, H, P, N).
    Returns y (B, S, H, P) and final state (B, H, P, N) [fp32]. Runs
    `kernels.ops.ssd_chunked`."""
    return ops.ssd_chunked(xh, dt, a_h, bm, cm, chunk=chunk, h0=h0)


def ssm_block(p, cfg, x, *, cache=None):
    """Full Mamba2 block. x: (B, S, d). Returns (y, new_cache): the full
    sequence without a cache, a chunked prefill with one (S > 1, starting
    from the cached state and conv context), a one-token decode step with
    one (S = 1)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_inner = s_cfg.expand * d
    h = d_inner // s_cfg.head_dim
    hd = s_cfg.head_dim
    g, n = s_cfg.ngroups, s_cfg.d_state

    z = _mm(x, p["wz"])
    xin = _mm(x, p["wx"])
    bin_ = _mm(x, p["wB"])
    cin = _mm(x, p["wC"])
    dt_raw = _mm(x, p["wdt"])

    prefill = cache is not None and s > 1
    new_cache = None
    if cache is None or prefill:
        if prefill:
            # chunked prefill: seed the causal conv with the cached context
            # (zeros for a fresh cache)
            ctx_len = cache["conv"].shape[1]
            u_all = torch.cat([xin, bin_, cin], dim=-1)
            u_ext = torch.cat([cache["conv"], u_all], dim=1)
            new_conv_state = u_ext[:, -ctx_len:].clone()  # not a view
            xin_f = _causal_conv(u_ext[..., :d_inner], p["conv_x"])
            bin_f = _causal_conv(u_ext[..., d_inner:d_inner + g * n],
                                 p["conv_B"])
            cin_f = _causal_conv(u_ext[..., d_inner + g * n:], p["conv_C"])
            xin = F.silu(xin_f[:, ctx_len:])
            bin_ = F.silu(bin_f[:, ctx_len:])
            cin = F.silu(cin_f[:, ctx_len:])
        else:
            xin = F.silu(_causal_conv(xin, p["conv_x"]))
            bin_ = F.silu(_causal_conv(bin_, p["conv_B"]))
            cin = F.silu(_causal_conv(cin, p["conv_C"]))
    else:
        u = torch.cat([xin, bin_, cin], dim=-1)[:, 0]          # (B, C)
        y_c, conv_state = _conv_step(u, cache["conv"], torch.cat(
            [p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1))
        y_c = F.silu(y_c)
        xin = y_c[:, None, :d_inner]
        bin_ = y_c[:, None, d_inner:d_inner + g * n]
        cin = y_c[:, None, d_inner + g * n:]

    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a_h = -torch.exp(p["A_log"].to(torch.float32))

    xh = xin.reshape(b, s, h, hd)
    bm = bin_.reshape(b, s, g, n)
    cm = cin.reshape(b, s, g, n)

    if cache is None or prefill:
        h0 = cache["h"] if prefill else None
        y, hfin = ssd_chunked(xh, dt, a_h, bm, cm, s_cfg.chunk_size, h0=h0)
        if prefill:
            new_cache = {"h": hfin, "conv": new_conv_state}
    else:
        h0 = cache["h"]
        da = torch.exp(dt[:, 0] * a_h)                          # (B, H)
        bmh = bm[:, 0].repeat_interleave(h // g, dim=1)         # (B, H, N)
        cmh = cm[:, 0].repeat_interleave(h // g, dim=1)
        x0 = xh[:, 0].to(torch.float32)
        hnew = (h0 * da[..., None, None]
                + dt[:, 0, :, None, None] * x0[..., None]
                * bmh[:, :, None, :])
        y = torch.einsum("bhpn,bhn->bhp", hnew,
                         cmh.to(hnew.dtype))[:, None]          # (B,1,H,P)
        y = y.to(x.dtype)
        new_cache = {"h": hnew, "conv": conv_state}

    y = y.reshape(b, s, d_inner)
    y = y + (p["D"][None, None, :, None] * xh.to(torch.float32)
             ).reshape(b, s, d_inner).to(y.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = _mm(y, p["wo"])
    return out, new_cache


def ssm_cache_defs(cfg, batch: int):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    h = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.d_state
    return {
        "h": ParamSpec((batch, h, s.head_dim, s.d_state),
                       ("batch", ("tp", None), None, None),
                       init="zeros", dtype=torch.float32),
        "conv": ParamSpec((batch, s.d_conv - 1, conv_dim),
                          ("batch", None, None), init="zeros"),
    }
