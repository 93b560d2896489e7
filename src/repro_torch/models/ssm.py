"""Mamba2 (SSD — state-space duality) block.

Chunked SSD forward (full sequence and prefill): intra-chunk attention-like
products plus the inter-chunk linear state recurrence, O(S·Q) work and an
O(1)-per-token state. Decode: a one-token recurrent update of the (H, P, N)
state.

The chunked SSD has two routes, each the counterpart of a reference
function, and `ssm_block` picks one by a single rule: when autograd is
recording and an SSD input requires a gradient (training), it runs
`ssd_chunked` here, the plain PyTorch port of the reference model's jnp
``ssd_chunked`` (``models/ssm.py``), on either device; otherwise
(serving, evaluation) it runs `kernels.ops.ssd_chunked`, the counterpart
of the reference's ``kernels.ops.ssd_chunked_pallas``, whose intra-chunk
terms are K3 on the card. K3 has no backward, nor has the reference's
Pallas kernel; the reference's model trains through its jnp function. The
two round bf16 differently by the reference's design: the training route
rounds y once, the kernel route y_intra and y_inter separately.

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
    """Chunked SSD, the training route: the reference model's jnp
    ``ssd_chunked`` in plain PyTorch with the same arithmetic (float32
    throughout, B and C repeated to the heads, the lower-triangular decay
    masked with −inf, y rounded once to xh's dtype), differentiable by
    autograd. Counts its calls in ``ssd_chunked.calls``.

    xh: (B, S, H, P)  dt: (B, S, H) (post-softplus)  a_h: (H,) (negative)
    bm, cm: (B, S, G, N) (G broadcast over heads); h0 (B, H, P, N).
    Returns y (B, S, H, P) and final state (B, H, P, N) [fp32]. Its
    (B, nc, Q, Q, H) float32 temporaries are what the reference
    materializes too."""
    ssd_chunked.calls += 1
    b, s, h, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q
    rep = h // g

    f32 = torch.float32
    xc = xh.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    bch = bm.reshape(b, nc, q, g, n).to(f32).repeat_interleave(rep, dim=3)
    cch = cm.reshape(b, nc, q, g, n).to(f32).repeat_interleave(rep, dim=3)

    a = dtc * a_h.to(f32)                                # (b,nc,q,h) ≤ 0
    cs = torch.cumsum(a, dim=2)                          # within-chunk cumsum

    # intra-chunk: Y[i] = Σ_{j≤i} exp(cs_i−cs_j)·(C_i·B_j)·dt_j·x_j
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xh.device))
    decay = torch.exp(torch.where(
        tril[None, None, :, :, None],
        cs[:, :, :, None, :] - cs[:, :, None, :, :],
        -torch.inf))                                     # (b,nc,q_i,q_j,h)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", cch, bch)
    y_intra = torch.einsum("bcqkh,bckh,bckhp->bcqhp", scores * decay, dtc,
                           xc)

    # chunk-final states: S_c = Σ_j exp(cs_last−cs_j)·dt_j·B_j⊗x_j
    last = cs[:, :, -1:, :]                              # (b,nc,1,h)
    w = torch.exp(last - cs) * dtc                       # (b,nc,q,h)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, bch, xc)
    chunk_decay = torch.exp(last[:, :, 0, :])            # (b,nc,h)

    # inter-chunk recurrence, the state entering each chunk kept
    hprev = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
             if h0 is None else h0.to(f32))
    hprevs = []
    for c in range(nc):
        hprevs.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                  # (b,nc,h,p,n)

    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cch, hprevs,
                           torch.exp(cs))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(xh.dtype), hprev


ssd_chunked.calls = 0


def ssm_block(p, cfg, x, *, cache=None):
    """Full Mamba2 block. x: (B, S, d). Returns (y, new_cache): the full
    sequence without a cache, a chunked prefill with one (S > 1, starting
    from the cached state and conv context), a one-token decode step with
    one (S = 1). The chunked SSD takes the training route `ssd_chunked`
    under the module's route rule, else `kernels.ops.ssd_chunked` (K3 on
    the card)."""
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
        # the route rule: autograd records and an SSD input needs a grad
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (xh, dt, a_h, bm, cm)):
            y, hfin = ssd_chunked(xh, dt, a_h, bm, cm, s_cfg.chunk_size,
                                  h0=h0)
        else:
            y, hfin = ops.ssd_chunked(xh, dt, a_h, bm, cm,
                                      chunk=s_cfg.chunk_size, h0=h0)
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
