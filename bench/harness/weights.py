"""The weights of a run, made from ``--seed`` on the device.

Each leaf that a configuration's reference lists is drawn by a
``torch.Generator`` on the device, seeded by a 32-bit hash of (seed, the
grid's cell, the leaf's path), in one call for the leaf, as float32. So
every replica of the grid starts from weights of its own, a leaf can be
made again on its own, and the program and the reference are handed the
same numbers."""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str, float]


def leaf_seed(seed: int, path: str, cell: int = 0) -> int:
    """32 bits, since a CPU generator keeps no more of its seed."""
    return zlib.crc32(f"{int(seed)}/{int(cell)}/{path}".encode())


def make_leaf(leaf: Leaf, seed: int, device, cell: int = 0) -> torch.Tensor:
    path, shape, init, scale = leaf
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path, cell))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(scale)


def make_all(leaves, seed: int, device, cell: int = 0
             ) -> Dict[str, torch.Tensor]:
    return {leaf[0]: make_leaf(leaf, seed, device, cell) for leaf in leaves}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """Paths to the program's nested tree: ``a.b`` → tree["a"]["b"], and
    per-layer leaves ``layers.<...>.<l>`` stacked on a leading layer axis
    in ``l``'s order."""
    tree: Dict = {}
    stacks: Dict[str, Dict[int, torch.Tensor]] = {}
    for path, x in flat.items():
        parts = path.split(".")
        if parts[0] == "layers":
            stacks.setdefault(".".join(parts[:-1]), {})[int(parts[-1])] = x
        else:
            _put(tree, parts, x)
    for path, by_layer in stacks.items():
        _put(tree, path.split("."),
             torch.stack([by_layer[l] for l in sorted(by_layer)]))
    return tree


def _put(tree, parts, x):
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = x


def flat_views(tree, lead: int) -> Dict[str, torch.Tensor]:
    """The inverse of `nest` over a tree whose leaves carry ``lead``
    leading axes (the grid's): {path: view}, per-layer leaves split on the
    axis after the leading ones."""
    out: Dict[str, torch.Tensor] = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + [k])
            return
        path = ".".join(prefix)
        if prefix[0] == "layers":
            for l in range(t.shape[lead]):
                out[f"{path}.{l}"] = t.select(lead, l)
        else:
            out[path] = t

    walk(tree, [])
    return out
