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
from repro_torch.models import spmd
from repro_torch.models.attention import rank_heads
from repro_torch.models.common import (ParamSpec, dense_spec, join_runs,
                                       rms_norm, tp_ranks, tp_slice)


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
    the card).

    Under a mesh context whose model axis divides the SSD's heads, the
    heads split over the tp ranks (`_ssm_split`); else the block computes
    whole."""
    h = p["wdt"].shape[1]
    tpr = tp_ranks()
    if tpr is not None and h % tpr.size == 0:
        return _ssm_split(p, cfg, x, cache, tpr)
    yz, new_cache = _ssd_heads(p, cfg, x, cache)
    y = rms_norm(yz, p["norm_w"], cfg.norm_eps)
    return _mm(y, p["wo"]), new_cache


def _ssd_heads(p, cfg, x, cache, group_index=None):
    """The block up to its gated norm over the heads ``p`` holds: ``wx``'s
    and ``wz``'s columns, ``wdt``'s heads, the B/C groups of ``wB`` and
    ``wC`` (and the cache's). Head h reads group h // (heads / groups), or
    ``group_index[h]`` when given (a rank whose heads straddle groups).
    Returns (y·silu(z) (B, S, d_inner of p), new_cache)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    hd, n = s_cfg.head_dim, s_cfg.d_state
    d_inner = p["wx"].shape[1]
    h = d_inner // hd
    g = p["wB"].shape[1] // n

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
    if group_index is not None:
        bm = bm.index_select(2, group_index)
        cm = cm.index_select(2, group_index)
        g = h

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
    return y * F.silu(z), new_cache


def _rank_ssm_params(p, r, groups, n, dev):
    """Rank r's weights on ``dev``: the columns of ``wz``, ``wx`` and
    ``conv_x`` and the rows of ``wo`` for its heads, its entries of
    ``wdt``, ``A_log``, ``D``, ``dt_bias`` and ``norm_w`` (each cut by
    `tp_slice` from its head-level spec), and the columns of ``wB``,
    ``wC``, ``conv_B`` and ``conv_C`` of the groups [lo, hi) its heads
    read."""
    lo, hi = groups
    out = {k: tp_slice(p[k], (None, "tp"), r)
           for k in ("wz", "wx", "conv_x", "wdt")}
    out.update({k: tp_slice(p[k], ("tp",), r)
                for k in ("A_log", "D", "dt_bias", "norm_w")})
    out["wo"] = tp_slice(p["wo"], ("tp", None), r)
    out.update({k: p[k][:, lo * n:hi * n]
                for k in ("wB", "wC", "conv_B", "conv_C")})
    return {k: v.to(dev) for k, v in out.items()}


def _ssm_split(p, cfg, x, cache, tpr):
    """The block split over the model axis by the SSD's heads: rank r
    runs its heads (`_rank_ssm_params`; the B/C groups those read, whole
    on every rank when there is one group, as replicated KV heads are in
    attention) through the conv, the SSD — K3 once a rank on the card, or
    the training route — and its share of the cache, on its device. The
    gated RMSNorm normalises over the whole d_inner: each rank forms the
    float32 sum of squares of its slice, a psum gives the mean, and only
    then does a rank scale its slice. A psum joins the ranks' outputs
    after ``wo``. Batch groups over the data ranks as
    `models.common.TPRanks.groups` gives them. The caller's cache keeps
    its shape and device: a rank's state is cut by heads and its conv
    context by the columns it reads, and the new cache is put back
    together from the ranks' in head order (the B/C columns from the
    first rank holding each group)."""
    s_cfg = cfg.ssm
    tp, n, hd = tpr.size, s_cfg.d_state, s_cfg.head_dim
    d_inner = p["wx"].shape[1]
    h, g = p["wdt"].shape[1], p["wB"].shape[1] // n
    plan = [rank_heads(h, g, tp, r) for r in range(tp)]
    runs = [grp for _, grp, _ in plan]
    f32 = torch.float32
    ys, caches = [], []
    for rows, devs in tpr.groups(x.shape[0]):
        yzs, prs, rank_caches = [], [], []
        for r, (((a, b), (lo, hi), index), dev) in enumerate(zip(plan,
                                                                  devs)):
            pr = _rank_ssm_params(p, r, (lo, hi), n, dev)
            rc = None
            if cache is not None:
                conv = cache["conv"][rows]
                rc = {"h": cache["h"][rows, a:b].to(dev),
                      "conv": torch.cat(
                          [conv[..., a * hd:b * hd],
                           conv[..., d_inner + lo * n:d_inner + hi * n],
                           conv[..., d_inner + (g + lo) * n:
                                d_inner + (g + hi) * n]], dim=-1).to(dev)}
            yz, nc = _ssd_heads(pr, cfg, x[rows].to(dev), rc,
                                group_index=None if index is None
                                else torch.tensor(index, device=dev))
            yzs.append(yz)
            prs.append(pr)
            rank_caches.append(nc)
        sumsq = spmd.psum([(t.to(f32) * t.to(f32)).sum(-1, keepdim=True)
                           for t in yzs])
        outs = [_mm((yz.to(f32) * torch.rsqrt(ss / d_inner + cfg.norm_eps)
                     * pr["norm_w"].to(f32)).to(yz.dtype), pr["wo"])
                for yz, ss, pr in zip(yzs, sumsq, prs)]
        ys.append(spmd.psum(outs)[0].to(x.device))
        if cache is not None:
            caches.append(_join_ssm_cache(rank_caches, runs, n))
    y = torch.cat(ys, dim=0)
    if cache is None:
        return y, None
    return y, {k: torch.cat([c[k].to(cache[k].device) for c in caches],
                            dim=0) for k in ("h", "conv")}


def _join_ssm_cache(parts, runs, n):
    """The whole cache from the ranks' (one batch group): the states and
    the conv context's x columns in head order, its B and C columns from
    the first rank holding each group."""
    dev = parts[0]["h"].device
    conv, bc = [], []
    for c, (lo, hi) in zip(parts, runs):
        w = (hi - lo) * n
        x_part, b_part, c_part = c["conv"].split(
            [c["conv"].shape[-1] - 2 * w, w, w], dim=-1)
        conv.append(x_part.to(dev))
        bc.append(torch.stack([b_part, c_part]).unflatten(-1, (hi - lo, n)))
    bc = join_runs(bc, runs, 3).flatten(-2)                # (2, B, K-1, G·N)
    return {"h": torch.cat([c["h"].to(dev) for c in parts], dim=1),
            "conv": torch.cat(conv + [bc[0], bc[1]], dim=-1)}


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
