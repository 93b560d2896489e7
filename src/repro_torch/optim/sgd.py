"""Minimal optimizer library: SGD(+momentum), the paper's algorithm, and
Adam, over nested dicts of tensors, with a constant learning rate.
``update`` is functional: it returns new parameter and state trees and
leaves its inputs untouched (the engine gates the new trees into the carry
in place)."""
from __future__ import annotations

import dataclasses
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

