"""The SSD of the port against the reference: K3's plain version
(``ref.ssd_chunk_reference``) against the reference's Pallas kernel
``ssd_chunk_pallas`` in interpret mode, all four outputs; the glue
``ops.ssd_chunked`` against ``ops.ssd_chunked_pallas``, the naive
recurrence ``ref.ssd_reference`` and the reference model's jnp
``ssd_chunked``, with and without an initial state; and K3's wrapper
refusing what it does not take. Then SSM training: the training route
``ssm.ssd_chunked`` (the reference model's jnp ``ssd_chunked`` ported)
against it in value and against ``jax.grad`` of it, ``ssm_block``'s route
rule, and the reduced Mamba2's loss and gradients against ``jax.grad`` of
the reference's ``make_loss_grad``. Inputs are drawn with numpy from a seed and handed to both packages.

Tolerances, and why:

* float32: both sides compute in float32 but sum in other orders (XLA's
  cumsum is an associative scan, torch's a running sum; the products
  contract in other orders), so values agree to a few float32 ulps of
  their magnitude: 5e-5 absolute and relative; cs, a running sum of up to
  256 terms of magnitude ~1, to 1e-4 absolute. Against the naive
  recurrence 5e-4, the reference's own tolerance (tests/test_kernels.py).
* bf16 inputs: y_intra is rounded to bf16 (8 bits of mantissa, 2^-8 =
  3.9e-3 relative) on both sides, from float32 values that differ in
  their last bits, so the two differ by at most one bf16 ulp: 1e-2
  relative, 1e-2 absolute (the values are O(1)). The float32 outputs keep
  the float32 tolerance. The glue rounds y_intra and y_inter separately,
  as ``ssd_chunked_pallas`` does: against it one ulp of each, 2e-2;
  against the model's jnp ``ssd_chunked``, which rounds once, and against
  the naive recurrence the reference's own bf16 tolerance, 5e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import ssm as jax_ssm
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models import ssm
from torch_parity import assert_loss_grad_match, jobs, loss_grad_both

#: (B, S, H, P, G, N): the shapes of tests/test_kernels.py's SSD sweep,
#: multi-group included
SHAPES = [(1, 256, 2, 32, 1, 32), (2, 512, 4, 64, 1, 64),
          (1, 384, 4, 64, 2, 32)]
CHUNKS = [64, 128]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_TOL = dict(rtol=5e-5, atol=5e-5)
CS_TOL = dict(rtol=5e-5, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs(shape, seed=3):
    """float32 numpy inputs: x, dt (post-softplus), a_h < 0, B, C."""
    b, s, h, p, g, n = shape
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    a_h = -np.exp(rng.standard_normal(h) * 0.2)
    bm = rng.standard_normal((b, s, g, n)) * 0.3
    cm = rng.standard_normal((b, s, g, n)) * 0.3
    return tuple(a.astype(np.float32) for a in (xh, dt, a_h, bm, cm))


def _both(shape, dtype):
    """The inputs for the reference (jax arrays) and the port (CPU
    tensors), x, B and C in ``dtype`` (rounded once, in jax, and handed
    across bit for bit)."""
    jdt, _ = DTYPES[dtype]
    xh, dt, a_h, bm, cm = _inputs(shape)
    jargs = (jnp.asarray(xh).astype(jdt), jnp.asarray(dt), jnp.asarray(a_h),
             jnp.asarray(bm).astype(jdt), jnp.asarray(cm).astype(jdt))
    return jargs, tuple(_tensor(a) for a in jargs)


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_chunk_reference_matches_pallas_kernel(shape, chunk, dtype):
    jargs, targs = _both(shape, dtype)
    want = ssd_chunk_pallas(*jargs, chunk=chunk, interpret=True)
    got = ref.ssd_chunk_reference(*targs, chunk=chunk)
    names = ("y_intra", "states", "cs", "chunk_decay")
    for name, w, g in zip(names, want, got):
        assert tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        if name == "y_intra" and dtype == "bfloat16":
            tol = dict(rtol=1e-2, atol=1e-2)
        else:
            tol = CS_TOL if name == "cs" else F32_TOL
        np.testing.assert_allclose(_np(g), _f32(w), err_msg=name, **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_glue_matches_reference_glue_and_recurrence(shape, chunk, dtype):
    jargs, targs = _both(shape, dtype)
    ops.reset_launch_counts()
    y, hfin = ops.ssd_chunked(*targs, chunk=chunk)
    assert ops.launch_counts()["ssd_chunk"] == 0      # CPU: plain version
    assert y.dtype == targs[0].dtype and hfin.dtype == torch.float32
    yp, hp = jax_ops.ssd_chunked_pallas(*jargs, chunk=chunk, interpret=True)
    yr, hr = jax_ref.ssd_reference(*jargs)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), _f32(yp), **F32_TOL)
        np.testing.assert_allclose(_np(y), _f32(yr), rtol=5e-4, atol=5e-4)
    else:
        np.testing.assert_allclose(_np(y), _f32(yp), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(_np(y), _f32(yr), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_np(hfin), _f32(hp), **F32_TOL)
    np.testing.assert_allclose(_np(hfin), _f32(hr), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES[::2])
def test_glue_matches_model_ssd_and_naive_recurrence(shape, dtype, with_h0):
    """The glue, the serving route of the model's chunked SSD; with an
    initial state (the prefill's cached one) it agrees with the reference
    model's jnp ``ssd_chunked`` and with the port's naive recurrence run
    from it."""
    b, _, h, p, _, n = shape
    jargs, targs = _both(shape, dtype)
    h0 = None
    if with_h0:
        h0 = (np.random.default_rng(5).standard_normal((b, h, p, n))
              * 0.5).astype(np.float32)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, hfin = ops.ssd_chunked(*targs, chunk=64, h0=th0)
    yj, hj = jax_ssm.ssd_chunked(*jargs, 64,
                                 h0=None if h0 is None else jnp.asarray(h0))
    yn, hn = ref.ssd_reference(*targs, h0=th0)
    y_tol = F32_TOL if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_np(y), _f32(yj), **y_tol)
    np.testing.assert_allclose(_np(hfin), _f32(hj), **F32_TOL)
    naive_tol = (dict(rtol=5e-4, atol=5e-4) if dtype == "float32"
                 else dict(rtol=5e-2, atol=5e-2))
    np.testing.assert_allclose(_np(y), _np(yn), **naive_tol)
    np.testing.assert_allclose(_np(hfin), _np(hn), rtol=5e-4, atol=5e-4)


def test_naive_recurrence_matches_reference():
    """The port's oracle against the reference's, from a zero state."""
    jargs, targs = _both(SHAPES[2], "float32")
    y, hfin = ref.ssd_reference(*targs)
    yr, hr = jax_ref.ssd_reference(*jargs)
    np.testing.assert_allclose(_np(y), _f32(yr), **F32_TOL)
    np.testing.assert_allclose(_np(hfin), _f32(hr), **F32_TOL)


def test_short_sequence_takes_one_chunk_of_its_own_length():
    """S < chunk gives Q = S, as ``min(chunk, S)`` in the reference."""
    shape = (1, 48, 2, 32, 1, 32)
    jargs, targs = _both(shape, "float32")
    want = ssd_chunk_pallas(*jargs, chunk=256, interpret=True)
    got = ref.ssd_chunk_reference(*targs, chunk=256)
    assert tuple(got[2].shape) == (1, 1, 2, 48)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _f32(w), **CS_TOL)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    _, (xh, dt, a_h, bm, cm) = _both(SHAPES[0], "float32")
    with pytest.raises(NotImplementedError, match="models.ssm.ssd_chunked"):
        ssd_scan.ssd_chunk(xh.clone().requires_grad_(), dt, a_h, bm, cm,
                           chunk=64)
    with pytest.raises(NotImplementedError, match="backward"):
        ssd_scan.ssd_chunk(xh, dt, a_h.clone().requires_grad_(), bm, cm,
                           chunk=64)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_chunk(xh, dt, a_h, bm, cm, chunk=64)
    with pytest.raises(ValueError, match="multiple"):
        ssd_scan.chunk_len(100, 250)
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_chunked(xh[:, :250], dt[:, :250], a_h, bm[:, :250],
                        cm[:, :250], chunk=100)
    assert ssd_scan.chunk_len(256, 48) == 48


def test_plain_path_keeps_autograd_on_the_cpu():
    """On CPU tensors the glue runs the plain version, which autograd can
    pass (the kernel cannot yet)."""
    _, (xh, dt, a_h, bm, cm) = _both(SHAPES[0], "float32")
    x = xh.clone().requires_grad_()
    y, _ = ops.ssd_chunked(x, dt, a_h, bm, cm, chunk=64)
    (g,) = torch.autograd.grad(y.sum(), [x])
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# ----------------------------------------------------------- SSM training


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_training_route_matches_reference_ssd_chunked(shape, dtype,
                                                      with_h0):
    """``models.ssm.ssd_chunked``, the training route, against the
    reference model's jnp ``ssd_chunked``, which it ports: float32 within
    F32_TOL; with bf16 inputs both round y once from float32 values that
    differ in their last bits, one bf16 ulp, 1e-2. One call counted."""
    b, _, h, p, _, n = shape
    jargs, targs = _both(shape, dtype)
    h0 = None
    if with_h0:
        h0 = (np.random.default_rng(5).standard_normal((b, h, p, n))
              * 0.5).astype(np.float32)
    ssm.ssd_chunked.calls = 0
    y, hfin = ssm.ssd_chunked(*targs, 64,
                              h0=None if h0 is None else torch.from_numpy(h0))
    assert ssm.ssd_chunked.calls == 1
    yj, hj = jax_ssm.ssd_chunked(*jargs, 64,
                                 h0=None if h0 is None else jnp.asarray(h0))
    assert y.dtype == targs[0].dtype and hfin.dtype == torch.float32
    y_tol = F32_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(y), _f32(yj), **y_tol)
    np.testing.assert_allclose(_np(hfin), _f32(hj), **F32_TOL)


@pytest.mark.parametrize("shape", SHAPES[::2])
def test_training_route_gradients_match_jax_grad(shape):
    """The gradients of a weighted sum of y and the final state with
    respect to x, dt, a_h, B, C and h0, by autograd through the training
    route against ``jax.grad`` of the reference's ``ssd_chunked``: float32
    summed in other orders, rtol 1e-4 and 1e-4 of each gradient's
    largest entry."""
    b, s, h, p, _, n = shape
    jargs, targs = _both(shape, "float32")
    rng = np.random.default_rng(9)
    h0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    wy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    wh = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def objective(*args):
        y, hfin = jax_ssm.ssd_chunked(*args[:5], 64, h0=args[5])
        return (y * wy).sum() + (hfin * wh).sum()

    want = jax.grad(objective, argnums=tuple(range(6)))(
        *jargs, jnp.asarray(h0))
    leaves = [t.clone().requires_grad_() for t in targs + (
        torch.from_numpy(h0),)]
    y, hfin = ssm.ssd_chunked(*leaves[:5], 64, h0=leaves[5])
    got = torch.autograd.grad(
        (y * torch.from_numpy(wy)).sum() + (hfin * torch.from_numpy(wh)).sum(),
        leaves)
    for a, w in zip(got, want):
        w = _f32(w)
        np.testing.assert_allclose(_np(a), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_ssm_block_routes_the_ssd_by_the_grad_rule():
    """Under grad with an SSD input that requires one, the block takes the
    training route; under ``torch.no_grad()``, or when nothing requires a
    gradient, it takes ``ops.ssd_chunked`` (K3 on the card). Both give the
    same float32 output within F32_TOL."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.common import init_params

    cfg = ARCHS["mamba2-1.3b"].reduced()
    p = init_params(ssm.ssm_defs(cfg), 0, device="cpu")
    x = torch.randn(2, 128, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    ssm.ssd_chunked.calls = 0
    frozen, _ = ssm.ssm_block(p, cfg, x)
    with torch.no_grad():
        served, _ = ssm.ssm_block(p, cfg, x)
    assert ssm.ssd_chunked.calls == 0
    live = {k: v.clone().requires_grad_() for k, v in p.items()}
    trained, _ = ssm.ssm_block(live, cfg, x)
    assert ssm.ssd_chunked.calls == 1
    with torch.no_grad():
        ssm.ssm_block(live, cfg, x)
    assert ssm.ssd_chunked.calls == 1
    assert torch.equal(frozen, served)
    np.testing.assert_allclose(_np(trained), _np(served), **F32_TOL)


@pytest.mark.parametrize("mask", ["full", "preempted"])
def test_mamba2_loss_grad_matches_reference(mask):
    """The reduced Mamba2 LM's loss and every gradient leaf, trained through
    the SSD's training route, against ``jax.grad`` of the reference's
    ``make_loss_grad`` (tolerances of tests/torch_parity.py)."""
    job, jjob = jobs("mamba2-1.3b")
    ssm.ssd_chunked.calls = 0
    grads, loss, jg, jl = loss_grad_both(job, jjob, mask)
    assert ssm.ssd_chunked.calls == job.model.num_layers
    assert_loss_grad_match(grads, loss, jg, jl)
