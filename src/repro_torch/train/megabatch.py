"""Megabatched elastic train step: the replica axis folded into blocked
parameters and a widened batch dimension.

* **Blocked flat parameters.** Every replica's parameters (and SGD momentum)
  live in one flat ``(R, P)`` buffer (`pack_state` / `unpack_state`), in
  the reference's `layout` order; each layer op is one batched matrix
  product over all replicas, with the qkv (+bias) and gate/up projections
  concatenated.
* **Hand-written backward.** The gradient of the step is written out, as in
  the reference (it is held against ``torch.autograd`` over `forward_loss`
  in the tests). Rope applies q's ``1/√d`` scale inside its precomputed
  cos/sin tables, and the softmax/CE backwards reuse forward residuals.
* **Fused elastic update.** Gradients are computed in SUM form
  (``Σ_tokens w·nll``), so Eq. (5)'s masked renormalization is a
  per-replica scalar folded into the momentum apply: one pass over the flat
  (R, P) blocks, gated on the tick running. With ``use_fused_update`` it
  is the hand-written kernel (`kernels.ops.fused_elastic_update`);
  otherwise its plain PyTorch version.

Full width (Qwen2-7B, P ≈ 1.56e9 per replica) sets the memory design: p
and v are updated in place, and each leaf's gradient is written straight
into a view of one (R, P) gradient buffer that the step allocates once and
reuses — p, v and g are the only replica-sized buffers. The embedding is a
gather forward and a scatter-add backward (a one-hot product at
V = 152064 would cost 1.2 GB and 2.2 TFLOP per replica), the gold-token
term of the cross-entropy gradient is subtracted at its index, and the
attention products are ``einsum`` calls rather than broadcast products.

Scope: the dense decoder family (rms-norm → rope GQA attention → SiLU-GLU
MLP), untied embeddings, SGD(+momentum), microbatch 1, float32 params.
`supports_megabatch` names the reason when a config falls outside.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import JobConfig, ModelConfig, resolve_dtype
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.models import common, transformer
from repro_torch.optim.sgd import constant_lr
from repro_torch.spans import span

NEG_INF = -1e30


def supports_megabatch(cfg: ModelConfig, job: JobConfig) -> Optional[str]:
    """None when the megabatch path reproduces this job's semantics, else
    the reason it cannot."""
    if cfg.family != "dense":
        return f"family {cfg.family!r} (dense only)"
    if cfg.mla is not None or cfg.moe is not None:
        return "mla/moe blocks"
    if cfg.tie_embeddings:
        return "tied embeddings"
    if resolve_dtype(cfg.param_dtype, where="param_dtype") != torch.float32:
        return f"param dtype {cfg.param_dtype} (float32 only)"
    if max(job.microbatch, 1) != 1:
        return f"microbatch {job.microbatch} (grad accumulation)"
    if job.optimizer != "sgd":
        return f"optimizer {job.optimizer!r} (sgd only)"
    return None


# --------------------------------------------------------------------------
# Flat (R, P) parameter layout
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Static description of the flat parameter block: per-leaf (name,
    layer, shape, offset) slices in a fixed, documented order."""

    names: Tuple[Tuple[str, int, Tuple[int, ...], int], ...]
    size: int


@functools.lru_cache(maxsize=64)
def layout(cfg: ModelConfig) -> _Layout:
    d, v, f = cfg.d_model, cfg.vocab_size, cfg.d_ff
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    nh = (hq + 2 * hkv) * dh
    entries: List[Tuple[str, int, Tuple[int, ...]]] = [("embed", -1, (v, d))]
    for l in range(cfg.num_layers):
        entries.append(("ln1", l, (d,)))
        entries.append(("wqkv", l, (d, nh)))
        if cfg.qkv_bias:
            entries.append(("bqkv", l, (nh,)))
        entries.append(("wo", l, (hq * dh, d)))
        entries.append(("ln2", l, (d,)))
        entries.append(("w_gu", l, (d, 2 * f)))
        entries.append(("w_down", l, (f, d)))
    entries.append(("ln_f", -1, (d,)))
    entries.append(("lm_head", -1, (d, v)))
    names, off = [], 0
    for name, l, shape in entries:
        names.append((name, l, shape, off))
        off += int(np.prod(shape))
    return _Layout(names=tuple(names), size=off)


def _flat_of(tree, cfg: ModelConfig) -> torch.Tensor:
    """One params-shaped nested dict -> its flat (..., P) concatenation in
    `layout` order."""
    la, mlp = tree["layers"]["attn"], tree["layers"]["mlp"]
    lead = tuple(tree["embed"].shape[:-2])
    segs = [tree["embed"]]
    for l in range(cfg.num_layers):
        segs.append(tree["layers"]["ln1"][..., l, :])
        segs.append(torch.cat(
            [la["wq"][..., l, :, :], la["wk"][..., l, :, :],
             la["wv"][..., l, :, :]], dim=-1))
        if cfg.qkv_bias:
            segs.append(torch.cat(
                [la["bq"][..., l, :], la["bk"][..., l, :],
                 la["bv"][..., l, :]], dim=-1))
        segs.append(la["wo"][..., l, :, :])
        segs.append(tree["layers"]["ln2"][..., l, :])
        segs.append(torch.cat(
            [mlp["w_gate"][..., l, :, :], mlp["w_up"][..., l, :, :]],
            dim=-1))
        segs.append(mlp["w_down"][..., l, :, :])
    segs.append(tree["ln_f"])
    segs.append(tree["lm_head"])
    return torch.cat([x.reshape(lead + (-1,)) for x in segs], dim=-1)


def pack_state(params, opt_state, cfg: ModelConfig, momentum: float
               ) -> Dict[str, torch.Tensor]:
    """Standard (params, opt_state) nested dicts -> {"p": (..., P),
    "v": (..., P)} flat blocked state (leaves may carry leading batch
    dims)."""
    p_flat = _flat_of(params, cfg)
    v_flat = (torch.zeros_like(p_flat) if momentum == 0.0
              else _flat_of(opt_state, cfg))
    return {"p": p_flat, "v": v_flat}


def _slices(flat: torch.Tensor, cfg: ModelConfig
            ) -> Dict[Tuple[str, int], torch.Tensor]:
    """Flat (..., P) -> {(name, layer): (..., *shape)} leaf views (no
    copies: writing to a view writes to the flat buffer)."""
    lead = tuple(flat.shape[:-1])
    out = {}
    for name, l, shape, off in layout(cfg).names:
        n = int(np.prod(shape))
        out[(name, l)] = flat[..., off:off + n].view(lead + shape)
    return out


def unpack_state(model: Dict[str, torch.Tensor], cfg: ModelConfig,
                 momentum: float):
    """{"p", "v"} flat blocked state -> standard (params, opt_state)
    nested dicts with the model-zoo leaf names/shapes (arbitrary leading
    dims; layer leaves re-stacked on their (L,) axis)."""

    def tree_of(flat):
        s = _slices(flat, cfg)
        hq, hkv, dh = (cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim)

        def stack(name):
            return torch.stack([s[(name, l)] for l in range(cfg.num_layers)],
                               dim=flat.dim() - 1)

        wqkv = stack("wqkv")
        attn = {"wq": wqkv[..., :, :hq * dh],
                "wk": wqkv[..., :, hq * dh:(hq + hkv) * dh],
                "wv": wqkv[..., :, (hq + hkv) * dh:],
                "wo": stack("wo")}
        if cfg.qkv_bias:
            bqkv = stack("bqkv")
            attn.update(bq=bqkv[..., :hq * dh],
                        bk=bqkv[..., hq * dh:(hq + hkv) * dh],
                        bv=bqkv[..., (hq + hkv) * dh:])
        w_gu = stack("w_gu")
        return {
            "embed": s[("embed", -1)],
            "layers": {"ln1": stack("ln1"), "ln2": stack("ln2"),
                       "attn": attn,
                       "mlp": {"w_gate": w_gu[..., :, :cfg.d_ff],
                               "w_up": w_gu[..., :, cfg.d_ff:],
                               "w_down": stack("w_down")}},
            "ln_f": s[("ln_f", -1)],
            "lm_head": s[("lm_head", -1)],
        }

    params = tree_of(model["p"])
    opt_state = () if momentum == 0.0 else tree_of(model["v"])
    return params, opt_state


# --------------------------------------------------------------------------
# Blocked forward + hand-written backward
# --------------------------------------------------------------------------


def _bdot_dw_into(out: torch.Tensor, x: torch.Tensor,
                  dy: torch.Tensor) -> None:
    """dW = xᵀ dy per replica, written into the gradient buffer's view
    ``out`` (R, D, H): each replica's slice is contiguous, so the product
    lands in place with no temporary of the weight's size."""
    for r in range(x.shape[0]):
        torch.mm(x[r].t(), dy[r], out=out[r])


@functools.lru_cache(maxsize=64)
def _consts_np(cfg: ModelConfig, seq_len: int):
    """Static per-(cfg, S) tables: rope cos/sin with q's 1/√d scale folded
    into the q-head rows, and the additive causal(+window) mask."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    half = dh // 2
    freqs = cfg.rope_theta ** (-np.arange(half, dtype=np.float32) / half)
    ang = np.arange(seq_len, dtype=np.float32)[:, None] * freqs
    cos, sin = np.cos(ang), np.sin(ang)                  # (S, half)
    scale = np.array([dh ** -0.5] * hq + [1.0] * hkv, np.float32)
    c_qk = (cos[None] * scale[:, None, None]).transpose(1, 0, 2)
    s_qk = (sin[None] * scale[:, None, None]).transpose(1, 0, 2)
    qpos = np.arange(seq_len)[:, None]
    kpos = np.arange(seq_len)[None, :]
    keep = kpos <= qpos
    if cfg.sliding_window:
        keep &= (qpos - kpos) < cfg.sliding_window
    cmask = np.where(keep, 0.0, NEG_INF).astype(np.float32)
    return c_qk[None, None].astype(np.float32), \
        s_qk[None, None].astype(np.float32), cmask


def _consts(cfg: ModelConfig, seq_len: int, device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in _consts_np(cfg, seq_len))


def _rope_qk(qk, c, s, half):
    x1, x2 = qk[..., :half], qk[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rope_qk_t(g, c, s, half):
    g1, g2 = g[..., :half], g[..., half:]
    return torch.cat([g1 * c + g2 * s, g2 * c - g1 * s], dim=-1)


def _rms_fwd(x, w, eps):
    inv = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    xh = x * inv
    return xh * w[:, None, :], (xh, inv)


def _rms_bwd(g, w, xh, inv):
    gw = g * w[:, None, :]
    return inv * (gw - xh * (gw * xh).mean(dim=-1, keepdim=True))


def _fwd_res(p, cfg: ModelConfig, tok2, labels2, w2, dims):
    """Blocked forward over all replicas at once, saving the residuals the
    hand-written backward consumes. Returns (nll_r, w_r, res).

    Attention tensors are laid out (R, B, K, G, S, T): kv head K, query
    head within its group G, query position S, key position T."""
    rt, b, s = dims
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g, f, t = hq // hkv, cfg.d_ff, b * s
    c_qk, s_qk, cmask = _consts(cfg, s, tok2.device)
    half = dh // 2
    eps = cfg.norm_eps

    ridx = torch.arange(rt, device=tok2.device)[:, None]
    x = p[("embed", -1)][ridx, tok2]                          # (R,T,D)
    layer_res = []
    for l in range(cfg.num_layers):
        h1, r1 = _rms_fwd(x, p[("ln1", l)], eps)
        qkv = torch.bmm(h1, p[("wqkv", l)])
        if cfg.qkv_bias:
            qkv = qkv + p[("bqkv", l)][:, None, :]
        qkv = qkv.view(rt, b, s, hq + 2 * hkv, dh)
        qk = _rope_qk(qkv[..., :hq + hkv, :], c_qk, s_qk, half)
        q = qk[..., :hq, :].reshape(rt, b, s, hkv, g, dh)
        k = qk[..., hq:, :]                                   # (R,B,S,K,D)
        v = qkv[..., hq + hkv:, :]
        sc = torch.einsum("rbskgd,rbtkd->rbkgst", q, k) + cmask
        e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        att = e / e.sum(dim=-1, keepdim=True)
        o = torch.einsum("rbkgst,rbtkd->rbskgd", att, v).reshape(
            rt, t, hq * dh)
        x1 = x + torch.bmm(o, p[("wo", l)])
        h2, r2 = _rms_fwd(x1, p[("ln2", l)], eps)
        gu = torch.bmm(h2, p[("w_gu", l)])
        sg = torch.sigmoid(gu[..., :f])
        hh = gu[..., :f] * sg * gu[..., f:]
        x2 = x1 + torch.bmm(hh, p[("w_down", l)])
        layer_res.append((h1, r1, qk, q, k, v, att, o, h2, r2, hh, sg, gu))
        x = x2
    hf, rf = _rms_fwd(x, p[("ln_f", -1)], eps)
    logits = torch.bmm(hf, p[("lm_head", -1)])               # (R,T,V)
    mx = logits.amax(dim=-1)
    gold = logits.gather(-1, labels2[..., None])[..., 0]
    e2 = (logits - mx[..., None]).exp_()
    del logits
    se = e2.sum(dim=-1)
    lse = torch.log(se) + mx
    nll_r = ((lse - gold) * w2).sum(dim=1)
    w_r = w2.sum(dim=1)
    return nll_r, w_r, [layer_res, hf, rf, e2, se]


def _bwd(p, cfg: ModelConfig, tok2, labels2, w2, res, dims, grads):
    """Hand-written gradient of Σ_r nll_r wrt the blocked params (SUM form
    — no per-replica normalization here; that is the fused update's job),
    written into ``grads``, the leaf views of the (R, P) gradient buffer.
    Consumes ``res``: the softmax residual becomes the logits gradient in
    place, and each layer's residuals are released once used."""
    rt, b, s = dims
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    f, t = cfg.d_ff, b * s
    c_qk, s_qk, _ = _consts(cfg, s, tok2.device)
    half = dh // 2
    layer_res, hf, rf, e2, se = res
    res.clear()                   # the softmax buffer dies with dlogits
    xhf, invf = rf
    # dlogits = w·(softmax − onehot(gold)), built in the softmax buffer
    dlogits = e2.div_(se[..., None])
    dlogits.scatter_add_(-1, labels2[..., None],
                         torch.full_like(dlogits[..., :1], -1.0))
    dlogits.mul_(w2[..., None])
    _bdot_dw_into(grads[("lm_head", -1)], hf, dlogits)
    dhf = torch.bmm(dlogits, p[("lm_head", -1)].transpose(1, 2))
    del dlogits, e2
    grads[("ln_f", -1)].copy_((dhf * xhf).sum(dim=1))
    dx = _rms_bwd(dhf, p[("ln_f", -1)], xhf, invf)
    for l in reversed(range(cfg.num_layers)):
        (h1, r1, qk, q, k, v, att, o, h2, r2, hh, sg, gu) = layer_res.pop()
        xh1, inv1 = r1
        xh2, inv2 = r2
        _bdot_dw_into(grads[("w_down", l)], hh, dx)
        dhh = torch.bmm(dx, p[("w_down", l)].transpose(1, 2))
        gg, uu = gu[..., :f], gu[..., f:]
        dg = dhh * uu * sg * (1 + gg * (1 - sg))
        du = dhh * gg * sg
        dgu = torch.cat([dg, du], dim=-1)
        _bdot_dw_into(grads[("w_gu", l)], h2, dgu)
        dh2 = torch.bmm(dgu, p[("w_gu", l)].transpose(1, 2))
        grads[("ln2", l)].copy_((dh2 * xh2).sum(dim=1))
        dx1 = dx + _rms_bwd(dh2, p[("ln2", l)], xh2, inv2)
        _bdot_dw_into(grads[("wo", l)], o, dx1)
        do = torch.bmm(dx1, p[("wo", l)].transpose(1, 2)).view(
            rt, b, s, hkv, hq // hkv, dh)
        datt = torch.einsum("rbskgd,rbtkd->rbkgst", do, v)
        dv = torch.einsum("rbkgst,rbskgd->rbtkd", att, do)
        dot = (datt * att).sum(dim=-1, keepdim=True)
        dsc = att * (datt - dot)
        dq = torch.einsum("rbkgst,rbtkd->rbskgd", dsc, k)
        dk = torch.einsum("rbkgst,rbskgd->rbtkd", dsc, q)
        dqk = _rope_qk_t(torch.cat(
            [dq.reshape(rt, b, s, hq, dh), dk], dim=3), c_qk, s_qk, half)
        dqkv = torch.cat([dqk, dv], dim=3).reshape(
            rt, t, (hq + 2 * hkv) * dh)
        if cfg.qkv_bias:
            grads[("bqkv", l)].copy_(dqkv.sum(dim=1))
        _bdot_dw_into(grads[("wqkv", l)], h1, dqkv)
        dh1 = torch.bmm(dqkv, p[("wqkv", l)].transpose(1, 2))
        grads[("ln1", l)].copy_((dh1 * xh1).sum(dim=1))
        dx = dx1 + _rms_bwd(dh1, p[("ln1", l)], xh1, inv1)
    g_embed = grads[("embed", -1)]
    for r in range(rt):
        # accumulate=True sorts the token ids first, so the sums run in one
        # order on every run; index_add_'s atomics on the card do not
        g_embed[r].zero_().index_put_((tok2[r],), dx[r], accumulate=True)


def _weights(masks, b: int, s: int, label_mask=None):
    """Per-token loss weights (R, B·S) from the (R, n_workers) elastic
    masks: each worker's contiguous batch slice takes its mask value."""
    rt = masks.shape[0]
    per = b // masks.shape[-1]
    w2 = masks.to(torch.float32).repeat_interleave(per, dim=-1)
    w2 = w2[:, :, None].expand(rt, b, s)
    if label_mask is not None:
        w2 = w2 * label_mask.to(torch.float32)
    return w2.reshape(rt, b * s)


def forward_loss(p_flat: torch.Tensor, cfg: ModelConfig, tokens, labels,
                 masks, label_mask=None):
    """The blocked forward alone: per-replica SUM-form loss Σ w·nll (R,)
    over flat params (R, P). Differentiable by ``torch.autograd`` — the
    yardstick the hand-written backward is held against."""
    rt, b, s = tokens.shape
    w2 = _weights(masks, b, s, label_mask)
    nll_r, _, _ = _fwd_res(_slices(p_flat, cfg), cfg,
                           tokens.reshape(rt, b * s),
                           labels.reshape(rt, b * s), w2, (rt, b, s))
    return nll_r


def sum_form_grads(p_flat: torch.Tensor, cfg: ModelConfig, tokens, labels,
                   masks, label_mask=None, out: Optional[torch.Tensor] = None
                   ):
    """Hand-written gradient of Σ_r Σ w·nll wrt the flat params, written
    into ``out`` (R, P) (allocated when None). Returns (grads, nll_r,
    w_r)."""
    rt, b, s = tokens.shape
    tok2 = tokens.reshape(rt, b * s)
    labels2 = labels.reshape(rt, b * s)
    w2 = _weights(masks, b, s, label_mask)
    if out is None:
        out = torch.empty_like(p_flat)
    with torch.no_grad():
        p = _slices(p_flat, cfg)
        with span("step.forward"):
            nll_r, w_r, res = _fwd_res(p, cfg, tok2, labels2, w2, (rt, b, s))
        with span("step.backward"):
            _bwd(p, cfg, tok2, labels2, w2, res, (rt, b, s),
                 _slices(out, cfg))
    return out, nll_r, w_r


# --------------------------------------------------------------------------
# The megabatched step
# --------------------------------------------------------------------------


def make_megabatch_step(cfg: ModelConfig, job: JobConfig,
                        lr_fn: Optional[Callable] = None,
                        use_fused_update: bool = False):
    """Returns ``step(model, tokens, labels, masks, j, running,
    label_mask=None) -> (model, loss)`` over the flat blocked state.

    model: {"p": (R, P), "v": (R, P)} float32, updated IN PLACE (the same
    dict is returned); tokens/labels (R, B, S) int64; masks (R, n_workers)
    float; j (R,) int; running (R,) bool. ``loss`` is the per-replica
    Eq.-(5) batch loss Σw·nll / max(Σw, 1e-6) (0 where Σw = 0). The update
    is gated on ``running`` element-for-element, so the engine needs no
    gating pass for this program. The step owns one (R, P) gradient
    buffer per device, allocated at its first call there and reused while
    R stays the same (shards on different cards run the step at once)."""
    reason = supports_megabatch(cfg, job)
    if reason:
        raise NotImplementedError(f"megabatch path unsupported: {reason}")
    lr_fn = lr_fn or constant_lr(job.learning_rate)
    mu = float(job.momentum)
    grad_buf: Dict[torch.device, torch.Tensor] = {}

    def step(model, tokens, labels, masks, j, running, label_mask=None):
        p_flat, v_flat = model["p"], model["v"]
        g = grad_buf.get(p_flat.device)
        if g is None or g.shape != p_flat.shape:
            grad_buf.pop(p_flat.device, None)      # freed before the new one
            g = grad_buf[p_flat.device] = torch.empty_like(p_flat)
        g, nll_r, w_r = sum_form_grads(p_flat, cfg, tokens, labels, masks,
                                       label_mask, out=g)
        with torch.no_grad(), span("step.optimizer"):
            lr = lr_fn(j)
            if use_fused_update:
                kernel_ops.fused_elastic_update(p_flat, v_flat, g, w_r,
                                                running, lr, momentum=mu)
            else:
                p_new, v_new = ref.elastic_update_reference(
                    p_flat, v_flat, g, w_r, running, lr, momentum=mu)
                p_flat.copy_(p_new)
                v_flat.copy_(v_new)
            loss = torch.where(w_r > 0, nll_r / torch.clamp(w_r, min=1e-6),
                               torch.zeros_like(nll_r))
        return model, loss

    return step


def init_megabatch_state(cfg: ModelConfig, job: JobConfig, seed: int, *,
                         device: torch.device) -> Dict[str, torch.Tensor]:
    """The flat blocked {"p", "v"} state a fresh replica starts from: the
    dense model's parameters drawn by `models.common.init_params` from
    ``seed``, packed, and zero SGD momentum."""
    del job                      # SGD momentum starts at zero either way
    params = common.init_params(transformer.lm_defs(cfg), seed,
                                cfg.resolved_param_dtype(), device=device)
    p = _flat_of(params, cfg)
    del params
    return {"p": p, "v": torch.zeros_like(p)}
