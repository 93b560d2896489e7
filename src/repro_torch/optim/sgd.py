"""Minimal optimizer library: SGD(+momentum), the paper's algorithm, and
Adam, over nested dicts of tensors, with a constant or cosine learning
rate. ``update`` is functional: it returns new parameter and state trees and
leaves its inputs untouched (the engine gates the new trees into the carry
in place). The zoo's bf16 step with SGD and momentum lands the same update
itself, in one pass (`kernels.ops.mixed_sgd_update`)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]
    # update(grads, state, params, lr) -> (new_params, new_state)


def _widened(x: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
    """``x`` in the type JAX gives ``lr * x`` (a bf16 leaf meets the
    float32 rate as float32; torch would keep bf16 for a 0-d rate)."""
    return x.to(torch.promote_types(x.dtype, lr.dtype))


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, lr):
        if momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (_widened(p, lr) - lr * g).to(p.dtype),
                params, grads)
            return new_params, state
        new_state = tree_map(lambda v, g: (momentum * v + g).to(v.dtype),
                             state, grads)
        new_params = tree_map(
            lambda p, s: (_widened(p, lr) - lr * _widened(s, lr)).to(p.dtype),
            params, new_state)
        return new_params, new_state

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
        return {"m": z, "v": tree_map(torch.zeros_like, z),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=_device_of(params))}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.to(v_.dtype) ** 2,
                     state["v"], grads)
        tf = t.to(torch.float32)
        mh = tree_map(lambda m_: m_ / (1 - b1 ** tf), m)
        vh = tree_map(lambda v_: v_ / (1 - b2 ** tf), v)

        def step(p, mh_, vh_):
            upd = mh_ / (torch.sqrt(vh_) + eps)
            return (p.to(torch.float32) - lr * upd).to(p.dtype)

        return tree_map(step, params, mh, vh), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def _device_of(tree):
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else None


def get_optimizer(name: str, momentum: float = 0.9) -> Optimizer:
    if name == "sgd":
        return sgd(momentum=momentum)
    if name == "adam":
        return adam()
    raise ValueError(name)


def constant_lr(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step -> lr`` as float32, shaped and placed like ``step`` (a
    Python int gives a 0-d tensor on the CPU)."""
    def f(step):
        step = torch.as_tensor(step)
        return torch.full(step.shape, lr, dtype=torch.float32,
                          device=step.device)
    return f



#: glibc's cosf (the ARM optimized routines' sincosf): the cosine and sine
#: polynomials in float64, c0..c4 and s1..s3
_COS_POLY = tuple(float.fromhex(c) for c in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_POLY = tuple(float.fromhex(c) for c in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_HALF_PI = float.fromhex("0x1.921FB54442D18p0")
_TWO_OVER_PI = float.fromhex("0x1.45F306DC9C883p-1")


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """The float32 cosine of float32 ``y`` (|y| < 120) bit for bit as
    XLA's CPU backend computes it, which calls glibc's ``cosf``: ``y``
    widened to float64, reduced by the nearest multiple n of π/2, a float64
    polynomial for ±cos or ±sin of the rest by n mod 4, rounded once to
    float32. torch's own float32 cosine differs from it by an ulp at some
    inputs."""
    x = y.to(torch.float64)
    n = torch.round(x * _TWO_OVER_PI)
    r = x - n * _HALF_PI
    r2 = r * r
    r4 = r2 * r2
    c0, c1, c2, c3, c4 = _COS_POLY
    cos = (c0 + r2 * c1 + r4 * c2) + r4 * r2 * (c3 + r2 * c4)
    s1, s2, s3 = _SIN_POLY
    r3 = r * r2
    sin = (r + r3 * s1) + r3 * r2 * (s2 + r2 * s3)
    quad = torch.remainder(n, 4)
    out = torch.where(quad == 0, cos, torch.where(
        quad == 1, -sin, torch.where(quad == 2, -cos, sin)))
    out = torch.where(x.abs() < 2.0 ** -12, torch.ones_like(x), out)
    return out.to(torch.float32)


def cosine_lr(lr: float, total_steps: int, warmup: int = 0,
              floor: float = 0.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step -> lr`` as float32: a linear warm-up over ``warmup`` steps,
    then a cosine decay from ``lr`` to ``floor · lr`` at ``total_steps``,
    held there after. The reference's arithmetic, in float32 throughout,
    with its cosine (`_cosf`)."""
    def f(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp_max(step / max(warmup, 1), 1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + _cosf(math.pi * prog))
        return lr * torch.where(step < warmup, warm, cos)
    return f
