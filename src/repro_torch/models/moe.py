"""Mixture-of-Experts block with capacity-based top-k routing.

Routing is GShard-style with a static per-expert capacity
``C = ceil(T_local · top_k / E · capacity_factor)``; assignments past an
expert's capacity are dropped (their combine weight is 0), and the
load-balance aux loss keeps the router honest. Padded experts (e.g.
qwen2-moe 60→64) are masked to −inf in the router logits. Every expert
runs over its (C, d) slab of gathered tokens, and the outputs are
scatter-added back to their tokens deterministically.

Expert parallelism, as the reference's ``shard_map`` runs it, with the
ranks of the mesh as lists of per-rank tensors (`models.spmd`): experts
are split over the ``tp`` mesh axis and the batch over the ``batch`` axes
(when it divides). The psum route (``cfg.moe.parallelism == "psum"``)
gives every tp rank the same tokens; each computes its own experts'
contribution and the shared experts' share of d_ff, and one psum joins
them. The all-to-all route also splits the sequence over tp: each rank
routes its own tokens, the dispatched (E, C, d) buffers travel to the
experts' owners and back by two all-to-alls, and the shared experts run
whole on each rank's tokens. Capacity always counts a rank's own tokens.
Without a mesh the block is `_moe_device` over the experts the device
holds (the first ``cfg.moe.experts_held``; every expert by default): the
router keeps all its outputs, and the block gives the held experts' share
of the routed output plus the shared experts, as one rank of the psum
route computes it without the psum.

`_moe_device` runs its router, tables, gather and combine under the
``moe.route`` span and the held experts' products and the shared experts
under ``moe.experts``."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import spmd
from repro_torch.models.common import (ParamSpec, TPRanks, current_ctx,
                                       dense_spec)
from repro_torch.spans import span


def moe_defs(cfg):
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    defs = {
        "router": ParamSpec((d, e), (None, None), scale=d ** -0.5,
                            dtype=torch.float32),
        "w_in": ParamSpec((m.held, d, 2 * f), ("tp", "fsdp", None),
                          scale=d ** -0.5),
        "w_out": ParamSpec((m.held, f, d), ("tp", None, "fsdp"),
                           scale=f ** -0.5),
    }
    if m.num_shared_experts:
        fs = m.d_ff_shared
        defs["w_sh_gate"] = dense_spec(d, fs)
        defs["w_sh_up"] = dense_spec(d, fs)
        defs["w_sh_down"] = dense_spec(fs, d, logical=("tp", "fsdp"))
    return defs


def _route(x2d, router, moe_cfg):
    """Top-k routing over every expert, in float32 (a low-precision router
    is upcast). x2d: (T, d) -> (topi (T, k), weights (T, k), aux scalar);
    the weights are the top-k probabilities, renormalised to sum to 1
    where ``moe_cfg.norm_topk_prob``.

    ``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk``
    promises no order on the card. Ties arise only among the padded
    experts' zero probabilities, which top-k never reaches while k ≤ the
    real experts, so the two pick the same experts."""
    e, e_real, k = moe_cfg.num_experts, moe_cfg.num_experts_unpadded, \
        moe_cfg.top_k
    logits = x2d.to(torch.float32) @ router.to(torch.float32)
    if e_real < e:
        real = torch.arange(e, device=x2d.device) < e_real
        logits = torch.where(real, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    if moe_cfg.norm_topk_prob:
        topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    # Switch/GShard load-balance loss: E * sum_e f_e * p_e
    assign = torch.zeros_like(probs).scatter_(1, topi, 1.0)
    f_e = assign.mean(0)                      # fraction routed to e (×k)
    p_e = probs.mean(0)
    aux = e_real * torch.sum(f_e * p_e) / k
    return topi, topv, aux


def _dispatch_tables(topi, topv, e: int, capacity: int):
    """Build (E, C) token-index / combine-weight / validity tables. An
    assignment's slot is its rank among the expert's assignments in token
    order; one past the capacity is dropped (the reference's scatter with
    ``mode="drop"``). Empty slots point at token 0 with weight 0. One
    kernel launch on the card, the plain one-hot and cumsum on the CPU
    (`kernels.ops.moe_dispatch_tables`)."""
    return ops.moe_dispatch_tables(topi, topv, e, capacity)


def _slot_tokens(tok_tbl, val_tbl, t: int):
    """The token each slot of the (E, C) tables gathers, flat: its own
    where the slot is filled, else a filler row (the slot's index mod
    ``t``) in place of the tables' token 0. An empty slot weighs 0 either
    way; distinct fillers keep the gather's backward and the combine's
    scatter-adds from piling every empty slot onto one row, whose serial
    accumulation makes their time grow with the slots routing leaves
    empty."""
    tok = tok_tbl.reshape(-1).long()
    filler = torch.arange(tok.numel(), device=tok.device) % t
    return torch.where(val_tbl.reshape(-1), tok, filler)


def _combine(out, tok, cmb_tbl, val_tbl, t: int):
    """Weight each slot's expert output (slots, C, d) by its combine
    weight and validity and scatter-add it to its token ``tok`` (the
    slots' token ids, flat): (t, d). The scatter-add repeats its bits from
    run to run (index_put_ with accumulate sorts its indices on the card,
    where index_add_ adds by atomics in a new order each run)."""
    d = out.shape[-1]
    out = out * (cmb_tbl * val_tbl)[..., None].to(out.dtype)
    return torch.zeros((t, d), dtype=out.dtype,
                       device=out.device).index_put_(
        (tok,), out.reshape(-1, d), accumulate=True)


def _tables(x2d, router, m):
    """Route the tokens x2d (t, d) over every expert and build the (E, C)
    dispatch tables at the capacity of those t tokens; returns (tok_tbl,
    cmb_tbl, val_tbl), aux."""
    capacity = max(1, math.ceil(x2d.shape[0] * m.top_k / m.num_experts
                                * m.capacity_factor))
    topi, topv, aux = _route(x2d, router, m)
    return _dispatch_tables(topi, topv, m.num_experts, capacity), aux


def _shared(x2d, p):
    """The shared experts' SwiGLU on x2d with the weights ``p`` holds."""
    return (F.silu(x2d @ p["w_sh_gate"]) * (x2d @ p["w_sh_up"])) \
        @ p["w_sh_down"]


def _moe_device(x, p, cfg, e_start: int, e_local: int):
    """One rank's MoE over its experts ``e_start .. e_start + e_local``:
    routes its tokens x (b, S, d) over every expert, runs its own experts
    and the shared experts with the weights it holds, and returns its
    partial sum (b, S, d) — the whole output without a mesh, the share
    that the psum over tp adds up with one — and its aux loss."""
    m = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    loc = slice(e_start, e_start + e_local)
    with span("moe.route"):
        (tok_tbl, cmb_tbl, val_tbl), aux = _tables(x2d, p["router"], m)
        tok = _slot_tokens(tok_tbl[loc], val_tbl[loc], b * s)
        xg = x2d[tok].reshape(e_local, tok_tbl.shape[1], d)
    w_in = p["w_in"] if p["w_in"].shape[0] == e_local else p["w_in"][loc]
    w_out = p["w_out"] if p["w_out"].shape[0] == e_local else p["w_out"][loc]
    with span("moe.experts"):
        gate, up = torch.bmm(xg, w_in).chunk(2, dim=-1)
        out = torch.bmm(F.silu(gate) * up, w_out)
    with span("moe.route"):
        y = _combine(out, tok, cmb_tbl[loc], val_tbl[loc], b * s)
    if m.num_shared_experts:
        # with a mesh: the rank's share of d_ff, or the whole shared expert
        # where d_ff_shared does not split (then the psum counts it tp
        # times, as the reference's does)
        with span("moe.experts"):
            y = y + _shared(x2d, p)
    return y.reshape(b, s, d), aux


def _moe_device_a2a(xs, ps, cfg):
    """GShard-style expert parallelism over the tp ranks of one batch
    shard, in stages: each rank routes its sequence shard xs[r] (b, s, d)
    and dispatches to every expert, an all-to-all carries each expert's
    (C, d) slab to its owner, the owners run their experts, a second
    all-to-all brings the outputs back, and each rank combines its own
    tokens and adds the shared experts (whole weights, no psum: the
    ranks' tokens are disjoint). Returns the per-rank outputs and auxes."""
    m = cfg.moe
    stage = []
    for x, p in zip(xs, ps):
        x2d = x.reshape(-1, x.shape[-1])
        tables, aux = _tables(x2d, p["router"], m)
        xg = x2d[tables[0].reshape(-1).long()].reshape(
            tables[0].shape + (x2d.shape[1],))
        stage.append((x2d, tables, aux,
                      xg * tables[2][..., None].to(xg.dtype)))
    # dispatch: (E, C, d) -> (E/tp, tp*C, d) on the owning rank
    recv = spmd.all_to_all([st[3] for st in stage], 0, 1)
    outs = []
    for xr, p in zip(recv, ps):
        gate, up = torch.bmm(xr, p["w_in"]).chunk(2, dim=-1)
        outs.append(torch.bmm(F.silu(gate) * up, p["w_out"]))
    # return trip: (E/tp, tp*C, d) -> (E, C, d)
    back = spmd.all_to_all(outs, 1, 0)
    ys, auxes = [], []
    for (x2d, (tok_tbl, cmb_tbl, val_tbl), aux, _), out, x, p in zip(
            stage, back, xs, ps):
        y = _combine(out, tok_tbl.reshape(-1).long(), cmb_tbl, val_tbl,
                     x2d.shape[0])
        if m.num_shared_experts:
            y = y + _shared(x2d, p)
        ys.append(y.reshape(x.shape))
        auxes.append(aux)
    return ys, auxes


def _rank_params(p, cfg, r: int, tp: int, shared_split: bool, dev):
    """Rank r's weights on its device: the router whole, its experts'
    slices of w_in / w_out, and the shared experts' d_ff slice when
    ``shared_split``, else whole (views where the rank's device is the
    weights')."""
    m = cfg.moe
    e_local = m.num_experts // tp
    loc = slice(r * e_local, (r + 1) * e_local)
    out = {"router": p["router"], "w_in": p["w_in"][loc],
           "w_out": p["w_out"][loc]}
    if m.num_shared_experts:
        if shared_split:
            f = m.d_ff_shared // tp
            cols = slice(r * f, (r + 1) * f)
            out["w_sh_gate"] = p["w_sh_gate"][:, cols]
            out["w_sh_up"] = p["w_sh_up"][:, cols]
            out["w_sh_down"] = p["w_sh_down"][cols]
        else:
            for k in ("w_sh_gate", "w_sh_up", "w_sh_down"):
                out[k] = p[k]
    return {k: v.to(dev) for k, v in out.items()}


def moe_block(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (B, S, d) (global). Returns (y, aux_loss), both on
    x's device. Under a mesh context (`models.common.mesh_context`) the
    experts run split over its tp axis, as described above."""
    ctx = current_ctx()
    m = cfg.moe
    if ctx.mesh is None:
        return _moe_device(x, p, cfg, 0, m.held)
    if m.held != m.num_experts:
        raise ValueError(f"a mesh splits all {m.num_experts} experts; this "
                         f"config holds {m.held}")

    mesh = ctx.mesh
    sizes = mesh.shape
    tp_axes = tuple(a for a in ctx.rules["tp"] if a in sizes)
    dp_axes = tuple(a for a in ctx.rules["batch"] if a in sizes)
    if len(tp_axes) != 1:
        raise ValueError(f"MoE expert parallelism expects one model axis, "
                         f"the rules give {tp_axes} on {mesh!r}")
    tp_axis = tp_axes[0]
    tp = sizes[tp_axis]
    if m.num_experts % tp:
        raise ValueError(f"{m.num_experts} experts do not split over a "
                         f"{tp}-way {tp_axis!r} axis")
    e_local = m.num_experts // tp
    grid, n_other = spmd.rank_devices(mesh, dp_axes, tp_axis)
    n_dp = grid.shape[0]

    B, S, _ = x.shape
    split_batch = B % n_dp == 0
    use_a2a = m.parallelism == "alltoall" and S % tp == 0 and S > 1
    shared_split = bool(m.num_shared_experts) and \
        m.d_ff_shared % tp == 0 and not use_a2a
    s_loc = S // tp if use_a2a else S

    groups = TPRanks(tp, grid).groups(B)
    ys, auxes = [], []
    for rows, devs in groups:
        xb = x[rows]
        ps = [_rank_params(p, cfg, r, tp, shared_split, dev)
              for r, dev in enumerate(devs)]
        if use_a2a:
            parts, aux_g = _moe_device_a2a(
                [xb[:, r * s_loc:(r + 1) * s_loc].to(dev)
                 for r, dev in enumerate(devs)], ps, cfg)
            ys.append(torch.cat([y.to(x.device) for y in parts], dim=1))
        else:
            outs = [_moe_device(xb.to(dev), ps[r], cfg, r * e_local,
                                e_local) for r, dev in enumerate(devs)]
            ys.append(spmd.psum([y for y, _ in outs])[0].to(x.device))
            aux_g = [a for _, a in outs]
        auxes += aux_g
    y = torch.cat(ys, dim=0)
    # a batch that does not split is replicated over dp: every dp rank
    # holds the values computed above
    aux = spmd.pmean(auxes * (n_dp // len(groups)))[0].to(x.device)
    if not split_batch and dp_axes:
        y = spmd.pmean([y] * n_dp)[0]
    if n_other > 1:
        aux = spmd.pmean([aux] * n_other)[0]
    return y, aux
