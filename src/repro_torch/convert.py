"""Carry weights across from the reference package.

The reference initializes with threefry draws the port cannot reproduce,
so tests hand both packages the same state instead: the reference's
pytrees, as nested dicts and tuples of numpy arrays, become the port's
trees of tensors (`tree_from_reference`, `zoo_state_from_reference`,
`serve_state_from_reference`), or its flat replica-blocked ``{"p", "v"}``
(`from_reference`)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.models.common import map_specs
from repro_torch.train import megabatch
from repro_torch.tree import tree_leaves, tree_map


def _leaf(x, device) -> torch.Tensor:
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: no numpy kin
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_from_reference(tree, *, device=None):
    """A reference pytree — nested dicts, tuples and lists of numpy (or
    jax) arrays, leading layer and grid axes included — as the same tree
    of tensors on ``device`` (default ``cuda``). bfloat16 leaves keep
    their bits."""
    device = resolve_device(device)
    return tree_map(lambda x: _leaf(x, device), tree)


def _check_shapes(tree, defs, what: str, cfg: ModelConfig) -> None:
    want = tree_leaves(map_specs(lambda _, s: str(tuple(s.shape)), defs))
    got = [str(tuple(x.shape)) for x in tree_leaves(tree)]
    if got != want:
        raise ValueError(f"reference {what} {got} do not match the shapes "
                         f"of {cfg.name}: {want}")


def zoo_state_from_reference(model0, cfg: ModelConfig, *, device=None):
    """One replica's zoo carry from the reference's ``init_zoo_state``:
    ``(params, opt_state)`` for float32 configs, ``{"params", "master",
    "opt"}`` for mixed precision. Raises if the params do not have the
    shapes `model_zoo.param_defs` gives ``cfg``."""
    state = tree_from_reference(model0, device=device)
    params = state["params"] if isinstance(state, dict) else state[0]
    _check_shapes(params, model_zoo.param_defs(cfg), "params", cfg)
    return state


def serve_state_from_reference(params, caches, cfg: ModelConfig,
                               batch: int, seq_len: int, *, device=None):
    """A model's parameters and its decode caches (the reference's
    ``init_params`` of ``param_defs`` and ``cache_defs``) as the port's
    trees on ``device``. Raises if either does not have the shapes
    `model_zoo.param_defs` and `model_zoo.cache_defs` give ``cfg`` at
    ``batch`` and ``seq_len``."""
    params = tree_from_reference(params, device=device)
    caches = tree_from_reference(caches, device=device)
    _check_shapes(params, model_zoo.param_defs(cfg), "params", cfg)
    _check_shapes(caches, model_zoo.cache_defs(cfg, batch, seq_len),
                  "caches", cfg)
    return params, caches


def from_reference(params, opt_state, cfg: ModelConfig, *,
                   device=None) -> Dict[str, torch.Tensor]:
    """Reference (params, opt_state) nested dicts of numpy arrays (leaves
    may carry leading batch dims) -> flat {"p", "v"} tensors on ``device``
    (default ``cuda``), packed in `megabatch.layout` order. An empty
    ``opt_state`` (SGD without momentum) gives zero momentum."""
    device = resolve_device(device)
    p = megabatch._flat_of(tree_from_reference(params, device=device), cfg)
    if opt_state:
        v = megabatch._flat_of(
            tree_from_reference(opt_state, device=device), cfg)
    else:
        v = torch.zeros_like(p)
    return {"p": p, "v": v}
