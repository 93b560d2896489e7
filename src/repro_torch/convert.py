"""Carry weights across from the reference package.

The reference initializes with threefry draws the port cannot reproduce,
so tests hand both packages the same state instead: the reference's
(params, opt_state) pytrees, as nested dicts of numpy arrays, become the
port's flat replica-blocked ``{"p", "v"}``."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.train import megabatch


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def from_reference(params, opt_state, cfg: ModelConfig, *,
                   device=None) -> Dict[str, torch.Tensor]:
    """Reference (params, opt_state) nested dicts of numpy arrays (leaves
    may carry leading batch dims) -> flat {"p", "v"} tensors on ``device``
    (default ``cuda``), packed in `megabatch.layout` order. An empty
    ``opt_state`` (SGD without momentum) gives zero momentum."""
    device = resolve_device(device)
    p = megabatch._flat_of(_to_torch(params, device), cfg)
    if opt_state:
        v = megabatch._flat_of(_to_torch(opt_state, device), cfg)
    else:
        v = torch.zeros_like(p)
    return {"p": p, "v": v}
