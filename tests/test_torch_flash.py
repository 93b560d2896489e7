"""Flash attention (K2) on the CPU: the port's ``ops.flash_mha`` — its
plain path, ``ref.mha_reference`` under autograd — against the reference's
Pallas kernel in interpret mode (forward) and ``jax.grad`` of the
reference's jnp oracle (backward), on the shape sweep of
tests/test_kernels.py; and the wrapper's dispatch and argument checks.
The CUDA kernels themselves are held against the plain version on the card
by tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 rows_without_keys)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, t, h, hkv, d, seed=0):
    """q (B,S,H,D), k/v (B,T,Hkv,D) and an output gradient, float32
    numpy from a seed: both packages get the same values."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d))]


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _np(x):
    return np.asarray(x.detach().to(torch.float32).numpy())


#: tests/test_kernels.py's sweep: MHA square; GQA; ragged MQA with d 128;
#: short q against long k
SHAPES = [(1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64),
          (1, 192, 320, 4, 1, 128), (2, 64, 512, 4, 4, 64)]


def _mask(shape, causal):
    s, t = shape[1], shape[2]
    return dict(causal=causal, q_offset=t - s if causal else 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_reference_kernel(shape, causal):
    """float32 at 2e-5, the reference's own kernel-vs-oracle tolerance:
    the port sums in another order."""
    q, k, v, _ = _inputs(*shape)
    mask = _mask(shape, causal)
    want = jax_ops.flash_mha(_jax(q, jnp.float32), _jax(k, jnp.float32),
                             _jax(v, jnp.float32), interpret=True, **mask)
    got = ops.flash_mha(_torch(q, torch.float32), _torch(k, torch.float32),
                        _torch(v, torch.float32), **mask)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("window", [32, 128])
def test_forward_sliding_window(window):
    q, k, v, _ = _inputs(1, 256, 256, 4, 4, 64)
    want = jax_ops.flash_mha(_jax(q, jnp.float32), _jax(k, jnp.float32),
                             _jax(v, jnp.float32), causal=True,
                             window=window, interpret=True)
    got = ops.flash_mha(_torch(q, torch.float32), _torch(k, torch.float32),
                        _torch(v, torch.float32), causal=True, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float32, torch.float32, 2e-5),
                                          (jnp.bfloat16, torch.bfloat16,
                                           3e-2)])
def test_forward_dtypes(jdt, tdt, tol):
    """bfloat16 at 3e-2: both compute in float32 from the same bf16
    inputs, and the output rounds to bf16 (0.4 % per ulp)."""
    q, k, v, _ = _inputs(1, 128, 128, 4, 2, 64)
    want = jax_ops.flash_mha(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt),
                             causal=True, interpret=True)
    got = ops.flash_mha(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                        causal=True)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _grads_both(shape, mask, jdt=jnp.float32, tdt=torch.float32):
    q, k, v, do = _inputs(*shape, seed=1)

    def loss(qj, kj, vj):
        out = jax_ref.mha_reference(qj.transpose(0, 2, 1, 3),
                                    kj.transpose(0, 2, 1, 3),
                                    vj.transpose(0, 2, 1, 3), **mask)
        return (out.transpose(0, 2, 1, 3).astype(jnp.float32)
                * _jax(do, jnp.float32)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(_jax(q, jdt), _jax(k, jdt),
                                             _jax(v, jdt))
    leaves = [_torch(x, tdt).requires_grad_() for x in (q, k, v)]
    out = ops.flash_mha(*leaves, **mask)
    got = torch.autograd.grad(out, leaves, _torch(do, tdt))
    return got, want


@pytest.mark.parametrize("mask", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=32),
    dict(causal=True, window=128)])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_grad_of_reference(shape, mask):
    """dq, dk, dv against ``jax.grad`` of the reference's jnp oracle (the
    reference kernel has no VJP, see below), float32, rtol 1e-4: the two
    autodiffs sum the same products in other orders."""
    mask = dict(mask)
    if mask["causal"]:
        mask["q_offset"] = shape[2] - shape[1]
    got, want = _grads_both(shape, mask)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_backward_bfloat16():
    """bfloat16 inputs and gradients: both sides compute in float32 and
    round the gradients to bf16; 3e-2 as for the forward."""
    got, want = _grads_both((1, 128, 128, 4, 2, 64), dict(causal=True),
                            jnp.bfloat16, torch.bfloat16)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=3e-2, atol=3e-2, err_msg=name)


def test_reference_kernel_has_no_gradient():
    """``jax.grad`` through the reference's Pallas kernel fails (JAX 0.9),
    which is why the port's backward is held against the jnp oracle. If
    the reference gains a VJP, this test says so."""
    q, k, v, _ = (_jax(x, jnp.float32) for x in _inputs(1, 64, 64, 2, 1, 64))
    with pytest.raises(Exception):
        jax.grad(lambda q_: jax_ops.flash_mha(q_, k, v, causal=True,
                                              interpret=True).sum())(q)


def test_cpu_path_launches_nothing_and_kernel_refuses_cpu():
    """A CPU tensor takes the plain path (no launch counted); the kernel's
    own entry point refuses it rather than falling back."""
    q, k, v, _ = (_torch(x, torch.float32)
                  for x in _inputs(1, 64, 64, 4, 2, 64))
    ops.reset_launch_counts()
    ops.flash_mha(q, k, v, causal=True)
    assert set(ops.launch_counts().values()) == {0}
    assert {"flash_attention_fwd", "flash_attention_bwd_dkdv",
            "flash_attention_bwd_dq"} <= set(ops.launch_counts())
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2))


@pytest.mark.parametrize("s,t,causal,window,q_offset,bad", [
    (64, 64, True, None, 0, False),
    (64, 64, True, 1, 0, False),        # each row keeps its diagonal key
    (64, 64, True, 1, 64, True),        # rows past T: the window is empty
    (64, 64, True, None, 64, False),    # rows past T still see every key
    (64, 64, True, None, -1, True),     # row at position -1: nothing
    (77, 200, True, 32, 123, False),
    (64, 64, False, 16, 100, True),
])
def test_rows_without_keys(s, t, causal, window, q_offset, bad):
    assert rows_without_keys(s, t, causal=causal, window=window,
                             q_offset=q_offset) == bad
    qpos = np.arange(s)[:, None] + q_offset
    kpos = np.arange(t)[None, :]
    valid = np.ones((s, t), bool)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= qpos - kpos < window
    assert bad == (not valid.any(axis=1).all())
