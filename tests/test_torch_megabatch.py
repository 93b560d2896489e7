"""The port's megabatched step against the reference's: the flat layout and
packing bit for bit, one step (fused and unfused) to the reference test's
tolerance, and the hand-written backward against ``torch.autograd``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import JobConfig as JaxJob
from repro.train import megabatch as jax_mb
from repro.train.train_step import init_train_state as jax_init
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.convert import from_reference
from repro_torch.kernels import ops
from repro_torch.train import megabatch as mb

# float tolerance for one step of the port vs the reference (the reference
# test's own): identical math, different reduction orders
RTOL, ATOL = 5e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run beside XLA's thread pool and
    other test workers, and small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jobs(num_layers=2, momentum=0.9, qkv_bias=True):
    """tests/test_megabatch.py::_job in both packages."""
    kw = dict(num_layers=num_layers, d_model=16, num_heads=2, num_kv_heads=1,
              d_ff=32, vocab_size=64, head_dim=8, qkv_bias=qkv_bias)
    jcfg = JAX_ARCHS["qwen2-7b"].reduced().with_(**kw)
    cfg = ARCHS["qwen2-7b"].reduced().with_(**kw)
    jjob = JaxJob(model=jcfg, shape=JaxShape("t", 8, 4, "train"),
                  n_workers=4, learning_rate=0.1, momentum=momentum)
    job = JobConfig(model=cfg, shape=InputShape("t", 8, 4, "train"),
                    n_workers=4, learning_rate=0.1, momentum=momentum)
    return cfg, job, jcfg, jjob


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grid(cfg, job, jcfg, jjob, r, seed=1):
    """Random replica states, batches and masks as numpy, with the edge
    rows every engine tick can produce: an all-preempted (Σw = 0) replica,
    a fractional-weight replica and a replica that is not running."""
    b, s = job.shape.global_batch, job.shape.seq_len
    rng = np.random.default_rng(seed)
    params, opt = jax_init(jcfg, jjob, jax.random.PRNGKey(0))
    flat0 = np.asarray(jax_mb.pack_state(params, opt, jcfg,
                                         jjob.momentum)["p"])
    p_dim = flat0.shape[0]
    p = (np.tile(flat0[None], (r, 1))
         + 0.01 * rng.standard_normal((r, p_dim))).astype(np.float32)
    v = (0.01 * rng.standard_normal((r, p_dim))).astype(np.float32)
    if job.momentum == 0.0:
        v = np.zeros_like(v)
    tokens = rng.integers(0, cfg.vocab_size, (r, b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (r, b, s)).astype(np.int32)
    masks = rng.integers(0, 2, (r, job.n_workers)).astype(np.float32)
    masks[0] = 0.0
    masks[1] = [0.5, 0.25, 0.0, 1.0]
    running = np.ones(r, bool)
    running[2] = False
    j = rng.integers(0, 10, r).astype(np.int32)
    return p, v, tokens, labels, masks, running, j


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("num_layers,qkv_bias", [(1, True), (3, False),
                                                 (2, True)])
def test_layout_offsets_identical_to_reference(num_layers, qkv_bias):
    cfg, _, jcfg, _ = _jobs(num_layers=num_layers, qkv_bias=qkv_bias)
    assert mb.layout(cfg).names == jax_mb.layout(jcfg).names
    assert mb.layout(cfg).size == jax_mb.layout(jcfg).size


def test_layout_full_width_qwen2_7b():
    """The slice's shape: full-width Qwen2-7B at depth 2."""
    cfg = ARCHS["qwen2-7b"].with_(num_layers=2, param_dtype="float32",
                                  dtype="float32")
    jcfg = JAX_ARCHS["qwen2-7b"].with_(num_layers=2, param_dtype="float32",
                                       dtype="float32")
    assert mb.layout(cfg).size == jax_mb.layout(jcfg).size == 1_556_113_920
    assert mb.layout(cfg).names == jax_mb.layout(jcfg).names


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_from_reference_pack_bit_equal_and_roundtrip(momentum):
    cfg, job, jcfg, jjob = _jobs(num_layers=3, momentum=momentum)
    params, opt = jax_init(jcfg, jjob, jax.random.PRNGKey(2))
    if momentum:
        # a non-zero momentum tree, so packing v is really exercised
        opt = jax.tree.map(lambda x: x + 0.5, params)
    want = jax_mb.pack_state(params, opt, jcfg, momentum)
    got = from_reference(_np_tree(params), _np_tree(opt), cfg, device="cpu")
    np.testing.assert_array_equal(got["p"].numpy(), np.asarray(want["p"]))
    np.testing.assert_array_equal(got["v"].numpy(), np.asarray(want["v"]))
    # pack/unpack round trip inside the port
    p_tree, o_tree = mb.unpack_state(got, cfg, momentum)
    again = mb.pack_state(p_tree, o_tree, cfg, momentum)
    assert torch.equal(again["p"], got["p"])
    assert torch.equal(again["v"], got["v"])
    # and unpacks to the reference's own leaves (both flatten dicts in
    # sorted-key order)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p_tree)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_supports_megabatch_names_the_reason():
    cfg, job, _, _ = _jobs()
    assert mb.supports_megabatch(cfg, job) is None
    assert "optimizer" in mb.supports_megabatch(
        cfg, dataclasses.replace(job, optimizer="adam"))
    assert "microbatch" in mb.supports_megabatch(
        cfg, dataclasses.replace(job, microbatch=2))
    assert "dtype" in mb.supports_megabatch(
        cfg.with_(param_dtype="bfloat16"), job)
    assert "tied" in mb.supports_megabatch(
        cfg.with_(tie_embeddings=True), job)


@pytest.mark.parametrize("num_layers,momentum,fused", [
    (1, 0.9, False),
    (2, 0.9, False),
    (2, 0.9, True),
    (1, 0.0, False),
])
def test_step_matches_reference_step(num_layers, momentum, fused):
    cfg, job, jcfg, jjob = _jobs(num_layers=num_layers, momentum=momentum)
    r = 8
    p, v, tokens, labels, masks, running, j = _grid(cfg, job, jcfg, jjob, r)

    jstep = jax.jit(jax_mb.make_megabatch_step(jcfg, jjob,
                                               use_fused_update=fused))
    jnew, jloss = jstep({"p": jnp.asarray(p), "v": jnp.asarray(v)},
                        jnp.asarray(tokens), jnp.asarray(labels),
                        jnp.asarray(masks), jnp.asarray(j),
                        jnp.asarray(running))

    model = {"p": _t(p), "v": _t(v)}
    step = mb.make_megabatch_step(cfg, job, use_fused_update=fused)
    ops.reset_launch_counts()
    new, loss = step(model, _t(tokens, torch.int64), _t(labels, torch.int64),
                     _t(masks), _t(j, torch.int64), _t(running))
    assert new is model                          # updated in place
    assert ops.launch_counts()["elastic_sgd_update"] == 0   # CPU: plain
    np.testing.assert_allclose(new["p"].numpy(), np.asarray(jnew["p"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(new["v"].numpy(), np.asarray(jnew["v"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=RTOL,
                               atol=ATOL)
    # the gated rows are exact no-ops, the all-preempted loss exactly 0
    np.testing.assert_array_equal(new["p"][2].numpy(), p[2])
    np.testing.assert_array_equal(new["v"][2].numpy(), v[2])
    assert loss[0].item() == 0.0


@pytest.mark.parametrize("num_layers,qkv_bias", [(1, True), (2, False)])
def test_hand_written_backward_matches_autograd(num_layers, qkv_bias):
    """The hand-written VJP against ``torch.autograd`` over the port's own
    forward, in float64 so the check measures the algebra rather than
    float32 rounding."""
    cfg, job, jcfg, jjob = _jobs(num_layers=num_layers, qkv_bias=qkv_bias)
    r = 4
    p, _, tokens, labels, masks, _, _ = _grid(cfg, job, jcfg, jjob, r)
    masks[0] = [1.0, 0.0, 1.0, 1.0]      # every replica contributes
    p64 = _t(p, torch.float64)
    args = (_t(tokens, torch.int64), _t(labels, torch.int64),
            _t(masks, torch.float64))
    got, nll, w = mb.sum_form_grads(p64, cfg, *args)
    leaf = p64.clone().requires_grad_(True)
    want, = torch.autograd.grad(mb.forward_loss(leaf, cfg, *args).sum(),
                                leaf)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-10)
    assert torch.allclose(nll, mb.forward_loss(p64, cfg, *args))


def test_all_preempted_step_moves_params_by_momentum_only():
    """Σw = 0 with the tick running: the gradient is exactly zero, so
    v' = μv and p' = p − lr·μv, and the loss is exactly 0."""
    cfg, job, jcfg, jjob = _jobs(num_layers=1)
    r = 4
    p, v, tokens, labels, masks, _, j = _grid(cfg, job, jcfg, jjob, r)
    model = {"p": _t(p), "v": _t(v)}
    step = mb.make_megabatch_step(cfg, job, use_fused_update=True)
    _, loss = step(model, _t(tokens, torch.int64), _t(labels, torch.int64),
                   torch.zeros(r, job.n_workers), _t(j, torch.int64),
                   torch.ones(r, dtype=torch.bool))
    np.testing.assert_array_equal(loss.numpy(), 0.0)
    vp = (np.float32(0.9) * v).astype(np.float32)
    np.testing.assert_array_equal(model["v"].numpy(), vp)
    np.testing.assert_array_equal(
        model["p"].numpy(), (p - np.float32(0.1) * vp).astype(np.float32))


def test_init_megabatch_state_is_seeded_and_packed():
    cfg, job, _, _ = _jobs()
    a = mb.init_megabatch_state(cfg, job, 0, device="cpu")
    b = mb.init_megabatch_state(cfg, job, 0, device="cpu")
    c = mb.init_megabatch_state(cfg, job, 1, device="cpu")
    assert a["p"].shape == (mb.layout(cfg).size,)
    assert torch.equal(a["p"], b["p"]) and not torch.equal(a["p"], c["p"])
    assert torch.count_nonzero(a["v"]) == 0
    s = mb._slices(a["p"], cfg)
    assert torch.all(s[("ln1", 0)] == 1) and torch.all(s[("bqkv", 0)] == 0)
    # embed drawn at scale 0.02, dense weights at 1/sqrt(fan_in)
    assert abs(s[("embed", -1)].std().item() - 0.02) < 0.004
    assert abs(s[("w_down", 0)].std().item() * cfg.d_ff ** 0.5 - 1) < 0.2
