"""The port's quadratic oracle (`TorchQuadratic`, `quadratic_program`)
against the reference's (`JaxQuadratic`, its per-cell step).

Held within rtol 1e-5 on the same inputs: the error, the exact gradient,
the minibatch gradients on the same explicit sample indices, and one step
of the program under the same mask (the exact gradient, and a minibatch
step with the reference's index draw replaced by the port's indices). The
port draws its indices from its counter hash; their range, shape and
keying are checked on their own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import QuadraticProblem as JaxProblem
from repro.sim import engine as jax_engine
from repro_torch.data.synthetic import QuadraticProblem
from repro_torch.sim import engine

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quads():
    kw = dict(dim=6, n_samples=64, cond=5.0, noise=0.2, label_noise=0.5,
              seed=3)
    return (jax_engine.jax_quadratic(JaxProblem(**kw)),
            engine.torch_quadratic(QuadraticProblem(**kw), "cpu"))


def _w(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_lift_is_float32_on_the_asked_device(quads):
    jq, tq = quads
    for ours, theirs in zip(tq, jq):
        assert ours.dtype == torch.float32 and ours.device.type == "cpu"
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert tq.n_samples == jq.n_samples == 64
    prob = QuadraticProblem(dim=3, n_samples=4, seed=0)
    if torch.cuda.is_available():
        assert engine.torch_quadratic(prob).A.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            engine.torch_quadratic(prob)


@pytest.mark.parametrize("lead", [(), (5,), (3, 4)])
def test_error_and_full_grad_match_reference(quads, lead):
    jq, tq = quads
    w = _w(lead + (6,), seed=len(lead))
    err_ref = jax.vmap(jq.error) if lead else jq.error
    grad_ref = jax.vmap(jq.full_grad) if lead else jq.full_grad
    if len(lead) == 2:
        err_ref, grad_ref = jax.vmap(err_ref), jax.vmap(grad_ref)
    np.testing.assert_allclose(tq.error(torch.from_numpy(w)).numpy(),
                               np.asarray(err_ref(jnp.asarray(w))),
                               rtol=RTOL)
    np.testing.assert_allclose(tq.full_grad(torch.from_numpy(w)).numpy(),
                               np.asarray(grad_ref(jnp.asarray(w))),
                               rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("n,batch", [(1, 1), (4, 16), (8, 3)])
def test_minibatch_grads_on_the_same_indices(quads, monkeypatch, n, batch):
    jq, tq = quads
    key = jax.random.PRNGKey(n * 100 + batch)
    idx = np.array(jax.random.randint(key, (n, batch), 0, jq.n_samples))
    w = _w((6,), seed=n)
    want = np.asarray(jq.minibatch_grads(key, jnp.asarray(w), n, batch))
    got = tq.minibatch_grads_at(torch.from_numpy(idx).long(),
                                torch.from_numpy(w)).numpy()
    assert got.shape == (n, 6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    # leading grid axes: each cell on its own indices and iterate (the
    # reference's draw replaced by the cell's indices)
    idx2 = np.stack([idx, idx[::-1]])
    w2 = np.stack([w, -w])
    got2 = tq.minibatch_grads_at(torch.from_numpy(idx2).long(),
                                 torch.from_numpy(w2)).numpy()
    for cell in range(2):
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, _i=jnp.asarray(idx2[cell]), **k: _i)
        want = np.asarray(jq.minibatch_grads(key, jnp.asarray(w2[cell]), n,
                                             batch))
        monkeypatch.undo()
        np.testing.assert_allclose(got2[cell], want, rtol=RTOL, atol=1e-6)


def test_minibatch_indices_range_shape_and_keying():
    key = torch.arange(6, dtype=torch.int64).reshape(2, 3) * 7919
    idx = engine.minibatch_indices(key, 8, 16, 256)
    assert idx.shape == (2, 3, 8, 16) and idx.dtype == torch.int64
    assert idx.min() >= 0 and idx.max() < 256
    # the same key draws the same indices wherever it sits in the grid;
    # other keys, lanes and samples draw others
    again = engine.minibatch_indices(key.flip(0), 8, 16, 256)
    np.testing.assert_array_equal(again.flip(0).numpy(), idx.numpy())
    flat = idx.reshape(6, -1)
    assert len({tuple(r.tolist()) for r in flat}) == 6
    assert len(set(flat[0].tolist())) > 64
    many = engine.minibatch_indices(torch.arange(512), 4, 8, 64)
    counts = np.bincount(many.reshape(-1).numpy(), minlength=64)
    # 16384 draws over 64 values: each count ~ 256 ± 16
    assert counts.min() > 256 - 6 * 16 and counts.max() < 256 + 6 * 16


def test_one_full_gradient_step_matches_reference_step(quads):
    jq, tq = quads
    ref_step = jax_engine.quadratic_program("full", 4).step_fn
    step = engine.quadratic_program("full", 4).step_fn
    w = _w((6,), seed=7)
    mask = np.array([1, 0, 1, 1], np.float32)
    alpha = np.float32(0.05)
    w_ref, err_ref = ref_step(jnp.asarray(w), jq, jax.random.PRNGKey(0),
                              jnp.asarray(mask), 0, alpha)
    w_new, err = step(torch.from_numpy(w)[None, None], tq,
                      torch.zeros(1, 1, dtype=torch.int64),
                      torch.from_numpy(mask)[None, None],
                      torch.zeros(1, 1, dtype=torch.int64),
                      torch.tensor([[alpha]]), torch.tensor([[True]]))
    np.testing.assert_allclose(w_new[0, 0].numpy(), np.asarray(w_ref),
                               rtol=RTOL)
    np.testing.assert_allclose(err[0, 0].item(), float(err_ref), rtol=RTOL)


@pytest.mark.parametrize("mask", [[1, 0, 1, 1], [0, 0, 0, 0], [0, 1, 0, 0]])
def test_one_minibatch_step_matches_reference_step(quads, monkeypatch, mask):
    """The reference's step on the port's sample indices (its randint
    replaced by them): the mask-weighted mean over max(y, 1), then
    w − α g, and the error after it. A cell that does not run keeps its
    iterate."""
    jq, tq = quads
    batch = 5
    key = torch.tensor([[123456789, 42]], dtype=torch.int64)
    idx = engine.minibatch_indices(key, 4, batch, tq.n_samples)
    w = np.stack([_w((6,), seed=8), _w((6,), seed=9)])[None]
    mask = np.asarray(mask, np.float32)
    alpha = np.float32(0.07)
    step = engine.quadratic_program("minibatch", batch).step_fn
    w_new, err = step(torch.from_numpy(w), tq, key,
                      torch.from_numpy(np.stack([mask, mask]))[None],
                      torch.zeros(1, 2, dtype=torch.int64),
                      torch.full((1, 2), float(alpha)),
                      torch.tensor([[True, False]]))
    ref_step = jax_engine.quadratic_program("minibatch", batch).step_fn
    for cell in range(2):
        cell_idx = jnp.asarray(idx[0, cell].numpy())
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, _i=cell_idx, **k: _i)
        w_ref, err_ref = ref_step(jnp.asarray(w[0, cell]), jq,
                                  jax.random.PRNGKey(0), jnp.asarray(mask),
                                  0, alpha)
        monkeypatch.undo()
        np.testing.assert_allclose(err[0, cell].item(), float(err_ref),
                                   rtol=RTOL)
        if cell == 0:
            np.testing.assert_allclose(w_new[0, 0].numpy(),
                                       np.asarray(w_ref), rtol=RTOL,
                                       atol=1e-6)
    np.testing.assert_array_equal(w_new[0, 1].numpy(), w[0, 1])
