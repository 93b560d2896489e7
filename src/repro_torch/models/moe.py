"""Mixture-of-Experts block with capacity-based top-k routing, on one
device.

Routing is GShard-style with a static per-expert capacity
``C = ceil(T · top_k / E · capacity_factor)``; assignments past an
expert's capacity are dropped (their combine weight is 0), and the
load-balance aux loss keeps the router honest. Padded experts (e.g.
qwen2-moe 60→64) are masked to −inf in the router logits. Every expert
runs over its (C, d) slab of gathered tokens, and the outputs are
scatter-added back to their tokens deterministically.

The reference's expert-parallel routes over a mesh (its psum route with
experts sharded over the model axis, and its all-to-all route) come with
the mesh slice of the port."""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec, dense_spec


def moe_defs(cfg):
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    defs = {
        "router": ParamSpec((d, e), (None, None), scale=d ** -0.5,
                            dtype=torch.float32),
        "w_in": ParamSpec((e, d, 2 * f), ("tp", "fsdp", None),
                          scale=d ** -0.5),
        "w_out": ParamSpec((e, f, d), ("tp", None, "fsdp"), scale=f ** -0.5),
    }
    if m.num_shared_experts:
        fs = m.d_ff_shared
        defs["w_sh_gate"] = dense_spec(d, fs)
        defs["w_sh_up"] = dense_spec(d, fs)
        defs["w_sh_down"] = dense_spec(fs, d, logical=("tp", "fsdp"))
    return defs


def _route(x2d, router, moe_cfg):
    """Top-k routing. x2d: (T, d) -> (topi (T, k), weights (T, k), aux
    scalar).

    ``jax.lax.top_k`` breaks ties toward the lower index and ``torch.topk``
    promises no order on the card. Ties arise only among the padded
    experts' zero probabilities, which top-k never reaches while k ≤ the
    real experts, so the two pick the same experts."""
    e, e_real, k = moe_cfg.num_experts, moe_cfg.num_experts_unpadded, \
        moe_cfg.top_k
    logits = x2d.to(torch.float32) @ router
    if e_real < e:
        real = torch.arange(e, device=x2d.device) < e_real
        logits = torch.where(real, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
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
    ``mode="drop"``): it lands in a spare column that is cut away. Empty
    slots point at token 0 with weight 0."""
    t, k = topi.shape
    flat_e = topi.reshape(-1)                                  # (T*k,)
    oh = F.one_hot(flat_e, e).to(torch.int32)
    pos = torch.cumsum(oh, dim=0) - 1
    mypos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    tok_ids = torch.arange(t, dtype=torch.int32,
                           device=topi.device).repeat_interleave(k)
    valid = mypos < capacity
    slot = (flat_e, torch.clamp_max(mypos, capacity).long())

    def table(values, dtype):
        tbl = torch.zeros((e, capacity + 1), dtype=dtype,
                          device=topi.device)
        return tbl.index_put(slot, values.to(dtype))[:, :capacity]

    tok_tbl = table(tok_ids, torch.int32)
    val_tbl = table(valid, torch.bool)
    cmb_tbl = table(torch.where(valid, topv.reshape(-1), 0.0), torch.float32)
    return tok_tbl, cmb_tbl, val_tbl


def moe_block(p, cfg, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on one device. x: (B, S, d). Returns (y, aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    capacity = max(1, math.ceil(t * m.top_k / m.num_experts
                                * m.capacity_factor))

    topi, topv, aux = _route(x2d, p["router"], m)
    tok_tbl, cmb_tbl, val_tbl = _dispatch_tables(topi, topv, m.num_experts,
                                                 capacity)
    tok = tok_tbl.reshape(-1).long()
    xg = x2d[tok].reshape(m.num_experts, capacity, d)
    gate, up = torch.bmm(xg, p["w_in"]).chunk(2, dim=-1)
    out = torch.bmm(F.silu(gate) * up, p["w_out"])
    out = out * (cmb_tbl * val_tbl)[..., None].to(out.dtype)
    # the combine: a scatter-add over tokens that repeats its bits from run
    # to run (index_put_ with accumulate sorts its indices on the card,
    # where index_add_ adds by atomics in a new order each run)
    y = torch.zeros((t, d), dtype=out.dtype, device=x.device).index_put_(
        (tok,), out.reshape(-1, d), accumulate=True)

    if m.num_shared_experts:
        hs = F.silu(x2d @ p["w_sh_gate"]) * (x2d @ p["w_sh_up"])
        y = y + hs @ p["w_sh_down"]
    return y.reshape(b, s, d), aux
