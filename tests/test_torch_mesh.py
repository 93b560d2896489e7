"""The port's device meshes (`repro_torch.launch.mesh`) against the
reference's `repro.launch.mesh`, the host-device count that stands in for
XLA's forced host platform, and the jit-cache names (`launch.jitcache`).

The reference builds its meshes with ``jax.make_mesh`` over the devices
jax sees; the port's constructors build the same axes and sizes over the
first cards, or over N host devices on the CPU, and refuse a mesh larger
than what is visible with the reference's message."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro.launch import mesh as jax_mesh
from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.launch import jitcache
from repro_torch.launch.mesh import (HOST_DEVICES_ENV, Mesh,
                                     data_parallel_workers, make_host_mesh,
                                     make_production_mesh,
                                     make_scenario_mesh,
                                     make_scenario_replica_mesh,
                                     visible_devices)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_host_override(monkeypatch):
    monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)


@pytest.mark.parametrize("make,shape", [
    (lambda: make_scenario_mesh(4, device="cpu", host_devices=8),
     {"data": 4}),
    (lambda: make_scenario_mesh(device="cpu", host_devices=8), {"data": 8}),
    (lambda: make_scenario_replica_mesh(4, 2, device="cpu", host_devices=8),
     {"data": 4, "replica": 2}),
    (lambda: make_scenario_replica_mesh(device="cpu", host_devices=8),
     {"data": 8, "replica": 1}),
    (lambda: make_scenario_replica_mesh(n_replica=2, device="cpu",
                                        host_devices=8),
     {"data": 4, "replica": 2}),
    (lambda: make_scenario_replica_mesh(2, device="cpu", host_devices=8),
     {"data": 2, "replica": 4}),
    (lambda: make_host_mesh(device="cpu"), {"data": 1, "model": 1}),
    (lambda: make_production_mesh(device="cpu", host_devices=256),
     {"data": 16, "model": 16}),
    (lambda: make_production_mesh(multi_pod=True, device="cpu",
                                  host_devices=512),
     {"pod": 2, "data": 16, "model": 16}),
])
def test_constructors_axes_and_sizes(make, shape):
    """The reference's axes and sizes (``repro/launch/mesh.py``), every
    device a host device, and ``data_parallel_workers`` equal to the
    reference's function on the same mesh."""
    m = make()
    assert m.shape == shape and list(m.shape) == list(m.axis_names)
    assert m.devices.shape == tuple(shape.values())
    assert all(d == CPU for d in m.devices.flat)
    assert data_parallel_workers(m) == jax_mesh.data_parallel_workers(m)
    assert data_parallel_workers(m) == shape.get("pod", 1) * shape["data"]


def test_data_parallel_workers_of_the_host_mesh_matches_reference():
    assert data_parallel_workers(make_host_mesh(device="cpu")) == \
        jax_mesh.data_parallel_workers(jax_mesh.make_host_mesh()) == 1


@pytest.mark.parametrize("make,need", [
    (lambda: make_scenario_mesh(9, device="cpu", host_devices=8), 9),
    (lambda: make_scenario_replica_mesh(4, 4, device="cpu", host_devices=8),
     16),
    (lambda: make_production_mesh(device="cpu", host_devices=8), 256),
    (lambda: make_production_mesh(multi_pod=True, device="cpu",
                                  host_devices=256), 512),
    (lambda: make_scenario_mesh(2, device="cpu"), 2),
])
def test_constructors_refuse_more_than_is_visible(make, need):
    """The reference's error for a mesh larger than the visible devices
    (``repro/launch/mesh.py:42-49``); one host device unless asked."""
    with pytest.raises(ValueError,
                       match=f"needs {need} devices but only"):
        make()


def test_host_device_count_comes_from_the_environment(monkeypatch):
    """The port's counterpart of
    ``--xla_force_host_platform_device_count``: the argument wins, then the
    environment, then 1."""
    assert len(visible_devices("cpu")) == 1
    monkeypatch.setenv(HOST_DEVICES_ENV, "3")
    assert make_scenario_mesh(device="cpu").shape == {"data": 3}
    assert len(visible_devices("cpu", host_devices=5)) == 5
    monkeypatch.setenv(HOST_DEVICES_ENV, "0")
    with pytest.raises(ValueError, match="≥ 1"):
        visible_devices("cpu")


def test_constructors_default_to_the_card(monkeypatch):
    """Entry points run on ``cuda`` unless asked: without a card the
    constructors raise rather than fall back to host devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (make_scenario_mesh, make_scenario_replica_mesh,
                 make_host_mesh):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_a_mesh_built_directly_may_repeat_a_device():
    """Two shards on one card: `Mesh` takes any devices, repeats included;
    it refuses a shape that does not match its axis names."""
    m = Mesh([["cuda:0", "cuda:0"]], ("data", "replica"))
    assert m.shape == {"data": 1, "replica": 2}
    assert all(d == torch.device("cuda", 0) for d in m.devices.flat)
    assert "cuda:0" in repr(m)
    with pytest.raises(ValueError, match="one name per axis"):
        Mesh(["cpu", "cpu"], ("data", "replica"))
    with pytest.raises(ValueError, match="repeated"):
        Mesh([["cpu"]], ("data", "data"))
    with pytest.raises(ValueError, match="at least one"):
        Mesh(np.empty((0,), dtype=object), ("data",))


def test_jitcache_names_the_kernel_build_directory(monkeypatch, tmp_path):
    """The reference's three functions, returning the kernels' build
    directory and changing nothing (no directory made, no setting)."""
    monkeypatch.setenv("REPRO_JIT_CACHE", str(tmp_path / "cache"))
    assert jitcache.default_cache_dir() == build.BUILD_DIR
    assert jitcache.cache_dir_for_run(str(tmp_path)) == build.BUILD_DIR
    assert jitcache.enable_persistent_cache() == build.BUILD_DIR
    assert jitcache.enable_persistent_cache(str(tmp_path), 5.0) == \
        build.BUILD_DIR
    assert not (tmp_path / "cache").exists()
    assert list(tmp_path.iterdir()) == []


def test_launch_counts_survive_concurrent_threads():
    """Shards on different cards launch from their own host threads: the
    counter loses no launch under many threads and a short switch
    interval."""
    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            kernels.count_launch(wrapper) for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per

