"""Shared set-up of the zoo parity tests (tests/test_torch_hybrid.py,
test_torch_encdec.py, test_torch_remat.py and the SSM training tests in
test_torch_ssd.py): one reduced config in both packages, the reference's
weights, batches and caches as numpy (carried across with ``convert``),
and the comparisons with their tolerances.

Tolerances: float32 at 1e-4 absolute and relative (the same products
summed in other orders); a gradient leaf at rtol 1e-4 and, for entries
near zero, within 1e-4 of the leaf's largest entry (a masked mean of
float32 sums, each leaf's rounding relative to its scale). All-bf16
(parameters, activations and caches) at 3e-2 of each leaf's largest
magnitude, as tests/test_torch_decode.py holds it: the two frameworks
round bf16 intermediates at other places."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import JobConfig as JaxJob
from repro.models import model_zoo as jax_zoo
from repro.models.common import init_params as jax_init_params
from repro.train import trainer as jax_trainer
from repro.train.train_step import make_loss_grad as jax_loss_grad
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.train.train_step import make_loss_grad
from repro_torch.tree import tree_leaves

N_W = 4
MASKS = {"full": (1, 1, 1, 1), "preempted": (1, 0, 1, 1)}
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU intra-op threads fight XLA's in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jobs(arch, b=4, s=32, act="float32", **over):
    """(port job, reference job) of the reduced ``arch``, parameters and
    activations in ``act``, ``over`` applied to both configs."""
    kw = dict(dtype=act, param_dtype=act, **over)
    cfg = ARCHS[arch].reduced().with_(**kw)
    jcfg = JAX_ARCHS[arch].reduced().with_(**kw)
    return (JobConfig(model=cfg, shape=InputShape("t", s, b, "train"),
                      n_workers=N_W),
            JaxJob(model=jcfg, shape=JaxShape("t", s, b, "train"),
                   n_workers=N_W))


def ref_params(jcfg, seed=1):
    """The reference's initial parameters (numpy) in the config's dtype."""
    return jax.tree.map(np.asarray, jax_init_params(
        jax_zoo.param_defs(jcfg), jax.random.PRNGKey(seed),
        jnp.dtype(jcfg.param_dtype)))


def ref_caches(jcfg, batch, seq):
    """A fresh reference cache tree (numpy): zeros, positions −1."""
    return jax.tree.map(np.asarray, jax_init_params(
        jax_zoo.cache_defs(jcfg, batch, seq), jax.random.PRNGKey(0),
        jnp.dtype(jcfg.param_dtype)))


def ref_batch(jjob, index=0):
    """One batch of the reference's stream (tokens, labels and, for
    enc-dec, frames), as numpy."""
    data = jax_trainer.stack_batches(jjob, index + 1, seed=0)
    return {k: np.asarray(v)[index] for k, v in data.items()}


def torch_batch(batch):
    """Token ids as int64 (torch indexes with it); frames as given."""
    return {k: torch.from_numpy(v.astype(np.int64) if np.issubdtype(
        v.dtype, np.integer) else v.copy()) for k, v in batch.items()}


def to_port(tree):
    return convert.tree_from_reference(tree, device="cpu")


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, act="float32", what=""):
    """float32 at `TOL`; bf16 within `BF16_REL` of the largest |want|."""
    want = f32(want)
    if act == "float32":
        np.testing.assert_allclose(f32(got), want, **TOL, err_msg=what)
    else:
        np.testing.assert_allclose(f32(got), want, rtol=0,
                                   atol=BF16_REL * np.abs(want).max(),
                                   err_msg=what)


def close_trees(got, want, act="float32"):
    """Every leaf of two trees in leaf order: shapes, dtypes, then values
    (integer leaves exactly)."""
    a, b = tree_leaves(got), jax.tree.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
        if not x.is_floating_point():
            np.testing.assert_array_equal(x.numpy(), y)
        else:
            close(x, y, act)


def leaf_close(a, b):
    """A gradient leaf: rtol 1e-4, entries near zero within 1e-4 of the
    leaf's largest entry."""
    b = np.asarray(b)
    assert tuple(a.shape) == b.shape
    np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                               atol=1e-4 * np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _jax_grad_step(jjob, remat):
    """The reference's jitted loss/grad step, compiled once per job and
    remat mode (the mask is an argument)."""
    return jax.jit(jax_loss_grad(jjob.model, jjob, remat=remat))


def loss_grad_both(job, jjob, mask, remat="none", jax_remat="none"):
    """The loss and gradients of one step on the reference's weights and
    batch with ``mask``: (port grads, loss; reference grads, loss)."""
    params = ref_params(jjob.model)
    batch = ref_batch(jjob)
    m = np.asarray(MASKS[mask], np.float32)
    jg, jl, _ = _jax_grad_step(jjob, jax_remat)(params, batch,
                                                jnp.asarray(m))
    grads, loss, _ = make_loss_grad(job.model, job, remat)(
        to_port(params), torch_batch(batch), torch.from_numpy(m))
    return grads, loss, jg, jl


def assert_loss_grad_match(grads, loss, jg, jl):
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    a, b = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        leaf_close(x, y)
