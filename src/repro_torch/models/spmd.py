"""shard_map-style execution in one process: the ranks of a mesh axis as
a Python list of per-rank tensors, in rank order, and the collectives
over such a list.

A rank's tensor lives on its rank's device (``mesh.devices[...]``), and
each collective returns one tensor per rank on that rank's device. They
are plain torch ops, so autograd carries gradients across devices. Ranks
that share a device (a `launch.mesh.Mesh` may list one card more than
once) run in turn; on different cards the launches are asynchronous
anyway. There are no threads, no process group and no ports.

The collectives sum in rank order: the reference's XLA all-reduce may
sum in another, so the two agree to rounding. The maximum is exact."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


def rank_devices(mesh, dp_axes: Sequence[str], tp_axis: str
                 ) -> Tuple[np.ndarray, int]:
    """The mesh's devices as a (data-parallel rank, tp rank) grid — the
    ``dp_axes`` raveled in their order, the first major, as a
    ``PartitionSpec`` splits a dimension over them — and the number of
    copies over the remaining axes, whose ranks compute the same values
    (their first device stands for them). Raises for a mesh without
    devices and for a card that is not visible."""
    devices = getattr(mesh, "devices", None)
    if devices is None:
        raise ValueError(f"{mesh!r} has no devices to run on (an abstract "
                         "mesh lays parameters out; it does not compute)")
    for dev in devices.flat:
        if dev.type == "cuda" and not (
                torch.cuda.is_available()
                and (dev.index or 0) < torch.cuda.device_count()):
            raise ValueError(
                f"mesh device {dev} is not visible "
                f"({torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " cards)")
    names = list(mesh.axis_names)
    other = [a for a in names if a not in dp_axes and a != tp_axis]
    order = [names.index(a) for a in list(dp_axes) + [tp_axis] + other]
    grid = np.transpose(devices, order)
    sizes = mesh.shape
    n_dp = math.prod(sizes[a] for a in dp_axes)
    n_other = math.prod(sizes[a] for a in other)
    grid = grid.reshape(n_dp, sizes[tp_axis], n_other)[..., 0]
    return grid, n_other


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the ranks' tensors, one copy per rank on its device."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return [total.to(p.device) for p in parts]


def pmax(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise maximum of the ranks' tensors, taken in rank order
    (exact, whatever the order), one copy per rank on its device."""
    top = parts[0]
    for part in parts[1:]:
        top = torch.maximum(top, part.to(top.device))
    return [top.to(p.device) for p in parts]


def pmean(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of the ranks' tensors (their sum over their number), one
    copy per rank on its device."""
    return [s / len(parts) for s in psum(parts)]


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """``jax.lax.all_to_all(..., tiled=True)`` over the ranks: rank i's
    tensor is cut into n equal chunks along ``split_axis``; rank j gets
    chunk j of every rank, concatenated along ``concat_axis`` in source
    rank order, on its own device."""
    n = len(parts)
    for p in parts:
        if p.shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of "
                             f"{tuple(p.shape)} does not split {n} ways")
    chunks = [p.chunk(n, dim=split_axis) for p in parts]
    return [torch.cat([chunks[i][j].to(parts[j].device) for i in range(n)],
                      dim=concat_axis) for j in range(n)]
