"""The port's MoE and MLA blocks against the reference, on one device:
``_route`` (indices, weights and the load-balance aux, padded experts
masked), ``_dispatch_tables`` under capacity overflow (assignments past
an expert's capacity dropped, as the reference's ``mode="drop"`` scatter
drops them), ``moe_block`` at the configs' capacity factor 1.25 (drops)
and at 8.0 (none), ``mla_block`` on its expanded path (incl. the chunked
attention core at S > 512) and its absorbed latent-cache path (prefill and
decode), and ``make_loss_grad`` of the reduced Qwen2-MoE and
DeepSeek-V2-Lite: the loss, the aux and every gradient leaf.

Tolerances: float32 at 1e-4 absolute and relative, and gradients as
tests/test_torch_zoo.py holds them (rtol 1e-4, entries near zero within
1e-5 of the leaf's largest); bf16 at 3e-2 of the leaf's largest magnitude,
as tests/test_torch_decode.py argues."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import JobConfig as JaxJob
from repro.models import mla as jax_mla
from repro.models import moe as jax_moe
from repro.models.common import init_params as jax_init_params
from repro.train import trainer as jax_trainer
from repro.train.train_step import init_train_state as jax_init_train
from repro.train.train_step import make_loss_grad as jax_loss_grad
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.models import mla, moe
from repro_torch.train.train_step import make_loss_grad
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, act="float32", what=""):
    want = _f32(want)
    if act == "float32":
        np.testing.assert_allclose(_f32(got), want, **TOL, err_msg=what)
    else:
        np.testing.assert_allclose(_f32(got), want, rtol=0,
                                   atol=BF16_REL * np.abs(want).max(),
                                   err_msg=what)


def _moe_cfgs(act="float32", **moe_over):
    """The reduced Qwen2-MoE in both packages with 8 experts of which 6
    are real (the full config pads 60 to 64), top-2."""
    out = []
    for archs in (ARCHS, JAX_ARCHS):
        cfg = archs["qwen2-moe-a2.7b"].reduced().with_(dtype=act,
                                                       param_dtype=act)
        over = {"num_experts": 8, "num_experts_unpadded": 6, **moe_over}
        out.append(cfg.with_(moe=dataclasses.replace(cfg.moe, **over)))
    return tuple(out)


def _block_params(defs, jcfg, seed=1):
    return jax.tree.map(np.asarray, jax_init_params(
        defs, jax.random.PRNGKey(seed), jnp.dtype(jcfg.param_dtype)))


def _x(shape, act="float32", seed=6):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(act))


def _port(x):
    return convert.tree_from_reference(x, device="cpu")


# ------------------------------------------------------------ routing


@pytest.mark.parametrize("e_real", [8, 6])
def test_route_matches_reference(e_real):
    """Indices exactly, weights and aux at float32 tolerance; padded
    experts are never chosen and carry no probability."""
    cfg, jcfg = _moe_cfgs(num_experts_unpadded=e_real)
    x2d = np.array(_x((64, cfg.d_model)))
    router = np.random.default_rng(2).standard_normal(
        (cfg.d_model, 8)).astype(np.float32) * cfg.d_model ** -0.5
    ti, tv, ta = jax_moe._route(jnp.asarray(x2d), jnp.asarray(router),
                                jcfg.moe)
    gi, gv, ga = moe._route(torch.from_numpy(x2d), torch.from_numpy(router),
                            cfg.moe)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ti))
    _close(gv, tv)
    np.testing.assert_allclose(float(ga), float(ta), rtol=1e-6)
    assert int(gi.max()) < e_real
    np.testing.assert_allclose(gv.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("t,e,k,capacity", [
    pytest.param(32, 8, 2, 1, id="1"), pytest.param(32, 8, 2, 3, id="3"),
    pytest.param(32, 8, 2, 7, id="7"), pytest.param(32, 8, 2, 64, id="64"),
    # DeepSeek-V2-Lite's cell: 8 × 1023 tokens, top-6 of 64, capacity
    # 1.25 (960) and 1
    pytest.param(8184, 64, 6, 960, id="8184x6of64-960"),
    pytest.param(8184, 64, 6, 1, id="8184x6of64-1")])
def test_dispatch_tables_match_reference(t, e, k, capacity):
    """Token, combine-weight and validity tables bit for bit, at
    capacities that drop most, some, few and none of 32 tokens × top-2
    over 6 real experts, and at the DeepSeek cell's routing sizes."""
    e_real = 6 if e == 8 else e
    cfg, jcfg = _moe_cfgs(num_experts=e, num_experts_unpadded=e_real,
                          top_k=k)
    x2d = np.asarray(_x((t, cfg.d_model)))
    router = np.random.default_rng(3).standard_normal(
        (cfg.d_model, e)).astype(np.float32) * 0.2
    ti, tv, _ = jax_moe._route(jnp.asarray(x2d), jnp.asarray(router),
                               jcfg.moe)
    want = jax_moe._dispatch_tables(ti, tv, e, capacity)
    got = moe._dispatch_tables(_port(ti).long(), _port(tv), e, capacity)
    for g, w, name in zip(got, want, ("tok", "cmb", "val")):
        assert tuple(g.shape) == (e, capacity), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # each expert keeps its first `capacity` assignments
    per_expert = np.bincount(np.asarray(ti).reshape(-1), minlength=e)
    assert int(got[2].sum()) == int(np.minimum(per_expert, capacity).sum())
    assert (int(got[2].sum()) < t * k) == (capacity < per_expert.max())
    # a dropped assignment's weight is 0, and so is every empty slot's
    assert float(got[1][~got[2]].abs().sum()) == 0.0
    assert int(got[0][~got[2]].abs().sum()) == 0


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_block_matches_reference(cf, act):
    """``moe_block`` on 2 × 16 tokens: capacity 10 at 1.25 (assignments
    dropped), 64 at 8.0 (none). Output and aux against the reference."""
    cfg, jcfg = _moe_cfgs(act, capacity_factor=cf)
    params = _block_params(jax_moe.moe_defs(jcfg), jcfg)
    x = _x((2, 16, cfg.d_model), act)
    want, waux = jax_moe.moe_block(params, jcfg, x)
    got, gaux = moe.moe_block(_port(params), cfg, _port(np.asarray(x)))
    assert got.dtype == cfg.activation_dtype() and gaux.dtype == torch.float32
    _close(got, want, act)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)
    topi, topv, _ = moe._route(_port(np.asarray(x)).reshape(32, -1),
                               _port(params["router"]), cfg.moe)
    _, _, val = moe._dispatch_tables(topi, topv, 8, 10 if cf < 2 else 64)
    assert (int(val.sum()) < 64) == (cf < 2)


# ------------------------------------------------------------ MLA


def _mla_cfgs(act):
    return tuple(archs["deepseek-v2-lite-16b"].reduced().with_(
        dtype=act, param_dtype=act) for archs in (ARCHS, JAX_ARCHS))


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["expanded", "expanded_chunked",
                                  "absorbed_prefill", "absorbed_decode"])
def test_mla_block_matches_reference(path, act):
    """The expanded path (q of head dim dn + dr = 48 against v of 32; at
    S = 2048 the attention core runs in 512-query chunks and must return
    v's head dim) and the absorbed path into a fresh 16-slot latent cache
    (a 12-token prefill) and from the reference's prefilled cache (one
    decode step at position 12)."""
    cfg, jcfg = _mla_cfgs(act)
    params = _block_params(jax_mla.mla_defs(jcfg), jcfg)
    b, s = (1, 2048) if path == "expanded_chunked" else (2, 12)
    x = _x((b, s, cfg.d_model), act)
    qpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    cache = None
    if path.startswith("absorbed"):
        cache = jax.tree.map(np.asarray, jax_init_params(
            jax_mla.mla_cache_defs(jcfg, b, 16), jax.random.PRNGKey(0),
            jnp.dtype(act)))
    pos = 0
    if path == "absorbed_decode":
        _, cache = jax_mla.mla_block(params, jcfg, x, qpos, cache=cache,
                                     cache_pos=jnp.int32(0))
        cache = jax.tree.map(np.asarray, cache)
        x, qpos, pos = _x((b, 1, cfg.d_model), act, seed=8), qpos[:, :1] + s, s
    want, wc = jax_mla.mla_block(params, jcfg, x, qpos, cache=cache,
                                 cache_pos=None if cache is None
                                 else jnp.int32(pos))
    got, gc = mla.mla_block(_port(params), cfg, _port(np.asarray(x)),
                            _port(np.asarray(qpos)).long(),
                            cache=None if cache is None else _port(cache),
                            cache_pos=pos)
    assert tuple(got.shape) == (b, x.shape[1], cfg.d_model)
    assert got.dtype == cfg.activation_dtype()
    _close(got, want, act)
    if cache is None:
        assert gc is None
        return
    for k in ("ckv", "krope"):
        _close(gc[k], wc[k], act, k)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))


# ------------------------------------------------------------ training


def _jobs(arch, b=4, s=16, n_w=4):
    kw = dict(d_model=64, num_heads=2, num_kv_heads=1, d_ff=128,
              vocab_size=256, head_dim=32)
    cfg = ARCHS[arch].reduced().with_(**kw)
    jcfg = JAX_ARCHS[arch].reduced().with_(**kw)
    return (JobConfig(model=cfg, shape=InputShape("t", s, b, "train"),
                      n_workers=n_w, learning_rate=0.1),
            JaxJob(model=jcfg, shape=JaxShape("t", s, b, "train"),
                   n_workers=n_w, learning_rate=0.1))


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_loss_grad_matches_reference(arch, micro):
    """One loss/grad step with a preempted worker (mask 1, 0, 1, 1), whole
    and in two microbatches: loss and aux at 1e-5, each gradient leaf at
    rtol 1e-4 and, for entries near zero, within 1e-5 of the leaf's
    largest (tests/test_torch_zoo.py's rule)."""
    job, jjob = (dataclasses.replace(j, microbatch=micro) for j in _jobs(arch))
    params, _ = jax_init_train(jjob.model, jjob, jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, params)
    data = jax_trainer.stack_batches(jjob, 4, seed=0)
    batch = {k: np.asarray(v)[3] for k, v in data.items()}
    m = np.asarray([1, 0, 1, 1], np.float32)
    jg, jl, ja = jax.jit(jax_loss_grad(jjob.model, jjob, remat="none"))(
        params, batch, jnp.asarray(m))
    grads, loss, aux = make_loss_grad(job.model, job)(
        _port(params), {k: torch.from_numpy(v.astype(np.int64))
                        for k, v in batch.items()}, torch.from_numpy(m))
    assert float(aux) > 0.0
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-5, atol=1e-6)
    got, want = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())
