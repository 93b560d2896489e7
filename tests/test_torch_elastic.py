"""The port's Eq.-(5) mechanism, configs and numpy modules against the
reference: the same inputs, built with numpy from a seed, through both
packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.core import elastic as jax_elastic
from repro.core import strategies as jax_strat
from repro.core.cost_model import RuntimeModel as JaxRuntime
from repro.core.cost_model import UniformPrice as JaxUniform
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro_torch.configs import ARCHS
from repro_torch.configs.base import DtypeError, resolve_dtype
from repro_torch.core import elastic
from repro_torch.core import strategies as strat
from repro_torch.core.cost_model import RuntimeModel, UniformPrice
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch.train import build_strategy, default_problem


def _weight_cases():
    """Values on a 1/8 grid and weights in {0, ¼, ½, 1}: every partial sum
    is exact in float32, so the two frameworks' summation orders cannot
    differ and the only rounding is the final division."""
    rng = np.random.default_rng(0)
    vals = (rng.integers(-64, 64, 16) / 8).astype(np.float32)
    frac = rng.choice([0.0, 0.25, 0.5, 1.0], 16).astype(np.float32)
    yield "ones", vals, np.ones(16, np.float32)
    yield "all-preempted", vals, np.zeros(16, np.float32)
    yield "fractional", vals, frac
    yield "tiny", vals, np.full(16, 2.0 ** -30, np.float32)
    yield "mask", vals, rng.integers(0, 2, 16).astype(np.float32)


@pytest.mark.parametrize("name,vals,w", list(_weight_cases()),
                         ids=[c[0] for c in _weight_cases()])
def test_weighted_mean_matches_reference_exactly(name, vals, w):
    ours = elastic.weighted_mean(torch.from_numpy(vals), torch.from_numpy(w))
    ref = jax_elastic.weighted_mean(jnp.asarray(vals), jnp.asarray(w))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_weighted_mean_random_floats_within_summation_order():
    """Arbitrary floats: the sums may round in another order, so the
    means agree to float32 rounding (rtol 1e-6), not bit for bit."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(64).astype(np.float32)
    w = rng.uniform(0, 1, 64).astype(np.float32)
    ours = elastic.weighted_mean(torch.from_numpy(vals), torch.from_numpy(w))
    ref = jax_elastic.weighted_mean(jnp.asarray(vals), jnp.asarray(w))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_weighted_mean_zero_weight_has_exact_zero_value_and_grad():
    vals = torch.randn(8, generator=torch.Generator().manual_seed(1),
                       requires_grad=True)
    w = torch.zeros(8, requires_grad=True)
    out = elastic.weighted_mean(vals, w)
    gv, gw = torch.autograd.grad(out, (vals, w))
    assert out.item() == 0.0
    assert torch.all(gv == 0) and torch.all(gw == 0)
    assert torch.isfinite(gv).all() and torch.isfinite(gw).all()


def test_example_weights_matches_reference():
    mask = np.array([1, 0, 1, 1], np.float32)
    ours = elastic.example_weights(torch.from_numpy(mask), 12)
    ref = jax_elastic.example_weights(jnp.asarray(mask), 12)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        elastic.example_weights(torch.from_numpy(mask), 10)


#: the port's config fields that the reference lacks (DeepSeek-V2's
#: published block), each at the value that computes what the reference
#: computes
PORT_ONLY = {"first_dense_layers": 0, "d_ff_dense": 0,
             "moe": {"norm_topk_prob": True, "experts_held": None},
             "mla": {"yarn": None}}


def _without_port_only(d, extra=PORT_ONLY):
    """``d`` (a config as a dict) without the fields of ``extra``, each
    checked to hold ``extra``'s value first."""
    out = dict(d)
    for k, v in extra.items():
        if isinstance(v, dict):
            if out[k] is not None:
                out[k] = _without_port_only(out[k], v)
        else:
            assert out.pop(k) == v, k
    return out


def test_config_registry_matches_reference():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name, cfg in ARCHS.items():
        assert _without_port_only(dataclasses.asdict(cfg)) == \
            dataclasses.asdict(JAX_ARCHS[name])


@pytest.mark.parametrize("spelling,want", [
    ("float32", torch.float32), ("fp32", torch.float32),
    ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16),
    ("half", torch.float16), (torch.float64, torch.float64),
    (np.float32, torch.float32)])
def test_resolve_dtype_maps_to_torch(spelling, want):
    assert resolve_dtype(spelling) == want


@pytest.mark.parametrize("bad", ["float33", None, "int7"])
def test_resolve_dtype_names_the_bad_value(bad):
    with pytest.raises(DtypeError, match="param_dtype"):
        resolve_dtype(bad, where="param_dtype")


def test_launcher_strategy_and_plan_table_match_reference():
    """The numpy copies (convergence, bidding, provisioning, strategies)
    compile the launcher's default strategy to the same plan table."""
    from repro.launch.train import build_strategy as jax_build
    from repro.launch.train import default_problem as jax_problem

    for name in ["optimal-two-bids", "optimal-one-bid", "no-interruptions"]:
        ours = build_strategy(name, default_problem(), 0.5, 400.0, 8,
                              UniformPrice(0.2, 1.0),
                              RuntimeModel(kind="exp", lam=2.0, delta=0.05))
        ref = jax_build(name, jax_problem(), 0.5, 400.0, 8,
                        JaxUniform(0.2, 1.0),
                        JaxRuntime(kind="exp", lam=2.0, delta=0.05))
        assert ours.total_iterations == ref.total_iterations
        a, b = ours.plan_table(5, n_max=8), ref.plan_table(5, n_max=8)
        np.testing.assert_array_equal(a.bids, b.bids)
        np.testing.assert_array_equal(a.starts, b.starts)
        assert a.replan_at == b.replan_at
    assert strat.NEVER_BID == jax_strat.NEVER_BID


def test_lm_batch_matches_reference():
    cfg = ARCHS["qwen2-7b"].reduced()
    for j in range(3):
        ours, ref = lm_batch(cfg, 8, 16, j, seed=3), \
            jax_lm_batch(JAX_ARCHS["qwen2-7b"].reduced(), 8, 16, j, seed=3)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])


def test_active_fraction_matches_reference():
    mask = np.array([1, 0, 1, 1, 0, 0, 1, 1], np.float32)
    got = elastic.active_fraction(torch.from_numpy(mask))
    assert isinstance(got, torch.Tensor)
    assert float(got) == float(jax_elastic.active_fraction(jnp.asarray(mask)))


@pytest.mark.parametrize("batch,n_workers", [(8, 4), (12, 3), (16, 16),
                                             (10, 4)])
def test_worker_of_example_matches_reference(batch, n_workers):
    got = elastic.worker_of_example(batch, n_workers)
    want = jax_elastic.worker_of_example(batch, n_workers)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_workers,y", [(4, 0), (4, 3), (8, 8), (5, 7)])
def test_mask_from_active_count_matches_reference(n_workers, y):
    got = elastic.mask_from_active_count(n_workers, y)
    want = jax_elastic.mask_from_active_count(n_workers, y)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("price", [0.0, 0.3, 0.5, 0.9, 1.5])
def test_mask_from_bids_matches_reference(price):
    bids = np.random.default_rng(3).uniform(0.2, 1.0, 12)
    bids[4] = 0.5
    for b in (bids, list(bids)):
        got = elastic.mask_from_bids(b, price)
        want = jax_elastic.mask_from_bids(b, price)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("warmup,floor", [(0, 0.0), (0, 0.1), (5, 0.0),
                                          (5, 0.25), (40, 0.0)])
def test_cosine_lr_matches_reference_in_float32(warmup, floor):
    from repro.optim import sgd as jax_sgd
    from repro_torch.optim import sgd

    total = 40
    ours = sgd.cosine_lr(0.3, total, warmup=warmup, floor=floor)
    theirs = jax_sgd.cosine_lr(0.3, total, warmup=warmup, floor=floor)
    steps = np.arange(total + 3)
    got = np.array([ours(int(s)).numpy() for s in steps])
    assert got.dtype == np.float32
    want = np.array([np.asarray(theirs(int(s))) for s in steps])
    np.testing.assert_array_equal(got, want)
    # a tensor of steps at once, as the engine's tick counter gives them
    np.testing.assert_array_equal(
        ours(torch.from_numpy(steps.astype(np.int32))).numpy(), want)


def test_cosine_is_the_references_float32_cosine():
    """`sgd._cosf` against ``jnp.cos`` on the CPU, bit for bit, over the
    schedule's angles [0, π] and a wider range both signs."""
    from repro_torch.optim import sgd

    xs = np.concatenate([np.linspace(0.0, np.pi, 100001),
                         np.linspace(-100.0, 100.0, 100001),
                         [0.0, 2.0 ** -13, 2.0 ** -12, np.pi / 4]]
                        ).astype(np.float32)
    np.testing.assert_array_equal(sgd._cosf(torch.from_numpy(xs)).numpy(),
                                  np.asarray(jnp.cos(jnp.asarray(xs))))
