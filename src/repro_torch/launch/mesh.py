"""Device meshes for the port: the counterpart of ``repro.launch.mesh``.

A `Mesh` is a named grid of ``torch.device`` objects. The engine
(`sim.engine.simulate_sharded`) splits the scenario grid over its
``data`` axis (scenarios) and ``replica`` axis (seeds) and runs each
shard on the device at its place in the grid.

Which devices are visible depends on where the mesh is asked for:

* on the card (``device="cuda"``, the default, as for every entry point)
  the visible devices are the first ``torch.cuda.device_count()`` cards;
* on the CPU (``device="cpu"``) there are N *host devices*, all
  ``torch.device("cpu")``: the port's counterpart of XLA's
  ``--xla_force_host_platform_device_count=N``. N is the constructor's
  ``host_devices=`` argument, else the environment variable named by
  `HOST_DEVICES_ENV`, else 1.

The constructors never repeat a card. A `Mesh` built directly may list a
device more than once (two shards on one card): the shards that share a
device then run in turn, and shards on different devices at once.

Constructors are functions, so importing this module touches no device.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

#: the number of host devices a CPU mesh sees (the port's counterpart of
#: ``XLA_FLAGS=--xla_force_host_platform_device_count=N``); the supervisor
#: sets it for a CPU worker
HOST_DEVICES_ENV = "REPRO_TORCH_HOST_DEVICES"


class Mesh:
    """Named axes over an ndarray of ``torch.device`` (``devices``), whose
    shape is the mesh's shape."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            grid[idx] = torch.device(src[idx])
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(
                f"a mesh of shape {grid.shape} needs one name per axis and "
                f"at least one device, got axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated mesh axis in {axis_names}")
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def host_device_count(host_devices: Optional[int] = None) -> int:
    """Host devices a CPU mesh sees: ``host_devices``, else
    `HOST_DEVICES_ENV`, else 1."""
    n = host_devices if host_devices is not None else int(
        os.environ.get(HOST_DEVICES_ENV, "1") or 1)
    if n < 1:
        raise ValueError(f"host device count {n} must be ≥ 1")
    return int(n)


def visible_devices(device=None, host_devices: Optional[int] = None
                    ) -> list:
    """The devices a mesh on ``device`` (default ``cuda``) may use: the
    cards ``cuda:0 … cuda:{n-1}``, or the host devices (all ``cpu``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * host_device_count(host_devices)


def _make_mesh(shape: Sequence[int], axes: Sequence[str], device,
               host_devices: Optional[int]) -> Mesh:
    visible = visible_devices(device, host_devices)
    need = int(np.prod(shape))
    if need > len(visible):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {need} devices but only "
            f"{len(visible)} are visible")
    grid = np.empty(need, dtype=object)
    grid[:] = visible[:need]
    return Mesh(grid.reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         host_devices: Optional[int] = None) -> Mesh:
    """16×16 = 256 devices per pod; ``multi_pod`` adds a leading 2-pod
    axis (512). Axes ("data", "model") / ("pod", "data", "model"). Raises
    unless that many devices are visible, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device, host_devices)


def make_host_mesh(*, device=None) -> Mesh:
    """Single-device mesh (1×1, axes "data", "model") for CPU tests."""
    return _make_mesh((1, 1), ("data", "model"), device, None)


def make_scenario_mesh(n_devices: Optional[int] = None, *, device=None,
                       host_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the scenario axis of the engine's grid, axis
    ``data``. Defaults to every visible device."""
    if n_devices is None:
        n_devices = len(visible_devices(device, host_devices))
    return _make_mesh((n_devices,), ("data",), device, host_devices)


def make_scenario_replica_mesh(n_scenario: Optional[int] = None,
                               n_replica: Optional[int] = None, *,
                               device=None,
                               host_devices: Optional[int] = None) -> Mesh:
    """2-D mesh sharding scenarios over ``data`` and seeds over
    ``replica``. With only one size given, the other takes the remaining
    devices; with neither, all devices go to the scenario axis."""
    total = len(visible_devices(device, host_devices))
    if n_scenario is None and n_replica is None:
        n_scenario, n_replica = total, 1
    elif n_scenario is None:
        n_scenario = total // n_replica
    elif n_replica is None:
        n_replica = total // n_scenario
    return _make_mesh((n_scenario, n_replica), ("data", "replica"), device,
                      host_devices)


def data_parallel_workers(mesh) -> int:
    """Number of elastic worker slices = product of the batch axes."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return sizes.get("pod", 1) * sizes.get("data", 1)
