"""The fused elastic update (K1): its plain PyTorch version against the
reference's oracle and Pallas kernel, and the CPU dispatch of the wrapper.
The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.elastic_update import elastic_sgd_update as jax_pallas
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.elastic_update import elastic_sgd_update


def edge_inputs(r=8, p=1037, seed=0):
    """(R ≥ 6, P) inputs whose rows cover what an engine tick produces: Σw = 0
    (all preempted), 0 < Σw < 1e-6 (the clamp), fractional Σw, a replica
    that is not running, and a learning rate per replica. P is ragged (no
    multiple of any block size)."""
    rng = np.random.default_rng(seed)
    params = rng.standard_normal((r, p)).astype(np.float32)
    mom = rng.standard_normal((r, p)).astype(np.float32)
    grads = (rng.standard_normal((r, p)) * 3).astype(np.float32)
    w = rng.uniform(0.5, 40.0, r).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-8
    w[2] = 0.375
    w[3] = 2.5e-7
    running = np.ones(r, bool)
    running[4] = False
    lr = rng.uniform(0.01, 0.2, r).astype(np.float32)
    return params, mom, grads, w, running, lr


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a, copy=True)).to(device)
            for a in arrays]


@pytest.mark.parametrize("momentum", [0.9, 0.0])
@pytest.mark.parametrize("r,p", [(8, 1037), (5, 4432), (6, 1)])
def test_plain_update_bit_equal_to_reference_oracle(r, p, momentum):
    args = edge_inputs(r, p)
    ours = ref.elastic_update_reference(*_torch(*args), momentum=momentum)
    theirs = jax_ref.elastic_update_reference(
        *(jnp.asarray(a) for a in args), momentum=momentum)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _update_inputs(r, p, seed=7):
    """tests/test_kernels.py's own inputs for the Pallas kernel."""
    k = jax.random.fold_in(jax.random.PRNGKey(0), seed)
    params = jax.random.normal(k, (r, p), jnp.float32)
    mom = jax.random.normal(jax.random.fold_in(k, 1), (r, p), jnp.float32)
    grads = jax.random.normal(jax.random.fold_in(k, 2), (r, p), jnp.float32)
    w = jax.random.uniform(jax.random.fold_in(k, 3), (r,), minval=0.0,
                           maxval=4.0)
    running = jax.random.bernoulli(jax.random.fold_in(k, 4), 0.7, (r,))
    lr = jnp.full((r,), 0.1, jnp.float32)
    return params, mom, grads, w.at[0].set(0.0), running.at[-1].set(False), \
        lr


@pytest.mark.parametrize("r,p,blk", [
    (4, 4432, 512),
    (3, 517, 128),
    (1, 64, 512),
    (8, 1024, 256),
])
def test_plain_update_matches_interpreted_pallas_kernel(r, p, blk):
    """Against the interpreted Pallas kernel with the reference test's own
    tolerance (atol = rtol = 1e-6, tests/test_kernels.py): the interpreter
    rounds differently from its jnp oracle, so this check is not bit-exact
    by design."""
    inputs = _update_inputs(r, p)
    kp, kv = jax_pallas(*inputs, momentum=0.9, block_p=blk, interpret=True)
    ours = ref.elastic_update_reference(
        *_torch(*(np.asarray(x) for x in inputs)), momentum=0.9)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(kp), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(kv), atol=1e-6,
                               rtol=1e-6)


def test_plain_update_semantics():
    """Σw = 0 rows keep params and decay momentum; running=False rows are
    exact no-ops; active rows apply momentum SGD on the mean gradient."""
    params = torch.ones(3, 4)
    mom = torch.full((3, 4), 0.5)
    grads = torch.full((3, 4), 2.0)
    w = torch.tensor([0.0, 2.0, 2.0])
    running = torch.tensor([True, True, False])
    lr = torch.full((3,), 0.1)
    p2, v2 = ref.elastic_update_reference(params, mom, grads, w, running,
                                          lr, momentum=0.9)
    np.testing.assert_allclose(v2[0].numpy(), 0.45, rtol=1e-6)
    np.testing.assert_allclose(p2[0].numpy(), 1.0 - 0.1 * 0.45, rtol=1e-6)
    np.testing.assert_allclose(v2[1].numpy(), 1.45, rtol=1e-6)
    np.testing.assert_allclose(p2[1].numpy(), 1.0 - 0.145, rtol=1e-6)
    np.testing.assert_array_equal(p2[2].numpy(), 1.0)
    np.testing.assert_array_equal(v2[2].numpy(), 0.5)


def test_ops_wrapper_on_cpu_runs_plain_version_in_place():
    args = _torch(*edge_inputs(6, 333))
    params, mom = args[0], args[1]
    want = ref.elastic_update_reference(*args, momentum=0.9)
    ops.reset_launch_counts()
    got = ops.fused_elastic_update(*args, momentum=0.9)
    assert got[0] is params and got[1] is mom
    np.testing.assert_array_equal(params.numpy(), want[0].numpy())
    np.testing.assert_array_equal(mom.numpy(), want[1].numpy())
    # the plain path is not a kernel launch
    counts = ops.launch_counts()
    assert counts["elastic_sgd_update"] == 0
    assert set(counts.values()) == {0}


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        elastic_sgd_update(*_torch(*edge_inputs(6, 9)), momentum=0.9)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_build_target_names_the_source_hash():
    a = build._target("elastic_update")
    assert a.startswith(build.BUILD_DIR)
    assert a.endswith(".so") and "elastic_update-" in a
