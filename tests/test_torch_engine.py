"""The port's scenario engine against the reference's blocked engine.

The two draw from different generators (a counter-based hash here,
threefry there), so the market is held in two ways:

* exactly, on configurations that draw nothing: tick- and time-indexed
  trace prices, a deterministic runtime, preemption with q = 0, and a
  time-latched plan table;
* statistically elsewhere: over ≥128 seeds, the port's mean price, mean
  active count and mean iteration duration lie within 4 standard errors
  of the reference's.

Both engines drive the same trivial blocked program (no model), so only
the market and the accounting are compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import engine as jax_engine
from repro_torch.launch.mesh import Mesh
from repro_torch.sim import engine

J = 12
N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run beside XLA's thread pool and
    other test workers, and small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program(mod):
    """A blocked program with no model: it records Σ mask as its metric."""

    def step_fn(model, data, key, mask, j, alpha, running):
        return model, mask.sum(-1) + 0 * alpha

    return mod.ModelProgram(step_fn=step_fn, name="count", blocked=True)


JAX_PROGRAM = _program(jax_engine)
PROGRAM = _program(engine)


def _scenarios(mod, trace):
    """RNG-free scenarios: tick-indexed and time-indexed trace replay with a
    deterministic runtime, a two-bucket plan table latched on the clock,
    and preemptible workers that are never preempted (q = 0)."""
    table = np.stack([np.tile([0.9, 0.9, 0.5, 0.5], (J, 1)),
                      np.tile([0.95, 0.7, 0.7, 0.3], (J, 1))])
    return [
        mod.Scenario(price=mod.PriceSpec.from_trace_ticks(trace), alpha=0.1,
                     bid_schedule=np.tile([0.9, 0.9, 0.5, 0.5], (J, 1)),
                     rt_kind="det", rt_const=1.0, idle_step=0.5,
                     name="tick"),
        mod.Scenario(price=mod.PriceSpec.from_trace(trace, step=0.5),
                     alpha=0.1, bid_schedule=np.tile([0.7, 0.6, 0.5, 0.4],
                                                     (J, 1)),
                     rt_kind="det", rt_const=0.7, idle_step=0.3,
                     name="time"),
        mod.Scenario(price=mod.PriceSpec.from_trace_ticks(trace[::-1]),
                     alpha=0.1, bid_table=table,
                     bucket_starts=np.array([0.0, 4.0], np.float32),
                     replan_at=3, rt_kind="det", rt_const=1.0,
                     idle_step=0.5, name="latched"),
        mod.Scenario(price=mod.PriceSpec.uniform(0.0, 1.0), alpha=0.1,
                     worker_schedule=np.array([4, 3, 2, 4, 1, 4] * 2),
                     preempt_q=0.0, on_demand_price=0.8, rt_kind="det",
                     rt_const=1.5, name="preemptible"),
    ]


def _run_both(jax_sc, sc, seeds, n_ticks):
    model0 = {"w": np.zeros(1, np.float32)}
    jres = jax_engine.simulate_program(
        jax_sc, JAX_PROGRAM, {"w": jnp.asarray(model0["w"])}, None, seeds,
        jax_engine.SimConfig(n_ticks=n_ticks))
    res = engine.simulate_program(
        sc, PROGRAM, {"w": torch.from_numpy(model0["w"])}, None, seeds,
        engine.SimConfig(n_ticks=n_ticks), device="cpu")
    return jres, res


def test_market_bit_exact_on_rng_free_configurations():
    trace = np.random.default_rng(7).uniform(0.2, 1.0, 97).astype(np.float32)
    jres, res = _run_both(_scenarios(jax_engine, trace),
                          _scenarios(engine, trace), [0, 1, 5], 3 * J)
    assert (res.iterations == J).all(), res.iterations
    for field in ["iterations", "ys", "errors", "total_time", "times",
                  "total_cost", "costs", "total_idle", "J"]:
        np.testing.assert_array_equal(getattr(res, field),
                                      getattr(jres, field), err_msg=field)


def _stat_scenarios(mod, samples):
    """Scenarios whose statistics read the market's draws: the price paid
    (all four bids cover every price, unit runtime: cost step / 4 is the
    price), the active count (spread bids), the iteration duration (all
    bids cover, exp runtime: each clock step is one duration), and the
    surviving count under preemption."""
    full = np.ones((J, N), np.float32)
    spread = np.tile([0.3, 0.5, 0.7, 0.9], (J, 1))
    det = dict(rt_kind="det", rt_const=1.0, idle_step=0.5)
    return [
        mod.Scenario(price=mod.PriceSpec.uniform(0.2, 1.0), alpha=0.1,
                     bid_schedule=full, name="uniform-price", **det),
        mod.Scenario(price=mod.PriceSpec.trunc_gaussian(0.6, 0.175, 0.2,
                                                        1.0),
                     alpha=0.1, bid_schedule=full, name="gauss-price",
                     **det),
        mod.Scenario(price=mod.PriceSpec.empirical(samples),
                     alpha=0.1, bid_schedule=full, name="emp-price", **det),
        mod.Scenario(price=mod.PriceSpec.uniform(0.2, 1.0), alpha=0.1,
                     bid_schedule=spread, rt_kind="exp", rt_lam=2.0,
                     rt_delta=0.05, idle_step=0.5, name="active"),
        mod.Scenario(price=mod.PriceSpec.uniform(0.2, 1.0), alpha=0.1,
                     bid_schedule=full, rt_kind="exp", rt_lam=2.0,
                     rt_delta=0.05, idle_step=0.5, name="duration"),
        mod.Scenario(price=mod.PriceSpec.uniform(0.0, 1.0), alpha=0.1,
                     worker_schedule=np.full(J, N), preempt_q=0.3,
                     rt_kind="det", rt_const=1.0, name="preempted"),
    ]


def _per_seed_stats(res):
    """(scenario, seed) statistic of each scenario in `_stat_scenarios`."""
    paid = np.diff(np.concatenate([np.zeros(res.costs.shape[:2] + (1,)),
                                   res.costs], axis=-1), axis=-1) / N
    step = np.diff(np.concatenate([np.zeros(res.times.shape[:2] + (1,)),
                                   res.times], axis=-1), axis=-1)
    return np.stack([paid[0].mean(-1), paid[1].mean(-1), paid[2].mean(-1),
                     res.ys[3].mean(-1), step[4].mean(-1),
                     res.ys[5].mean(-1)])


def test_market_statistics_match_reference():
    samples = np.random.default_rng(3).beta(2, 5, 400).astype(np.float32)
    n_seeds = 160
    jres, res = _run_both(_stat_scenarios(jax_engine, samples),
                          _stat_scenarios(engine, samples), n_seeds, 4 * J)
    assert res.completed.all() and jres.completed.all()
    ours, theirs = _per_seed_stats(res), _per_seed_stats(jres)
    se = np.sqrt(ours.var(-1, ddof=1) / n_seeds
                 + theirs.var(-1, ddof=1) / n_seeds)
    gap = np.abs(ours.mean(-1) - theirs.mean(-1))
    assert (gap < 4 * se).all(), (ours.mean(-1), theirs.mean(-1), se)
    # and the statistics are the distributions' own: U[0.2, 1] has mean
    # 0.6; iterations run only when ≥1 of 4 workers survives q = 0.3
    np.testing.assert_allclose(ours[0].mean(), 0.6, atol=0.02)
    np.testing.assert_allclose(ours[5].mean(), N * 0.7 / (1 - 0.3 ** N),
                               atol=0.1)


def test_runs_repeat_exactly_and_seeds_differ():
    samples = np.random.default_rng(3).beta(2, 5, 400).astype(np.float32)
    sc = _stat_scenarios(engine, samples)
    a = engine.simulate_program(sc, PROGRAM, {"w": torch.zeros(1)}, None,
                                [3, 4], engine.SimConfig(n_ticks=2 * J),
                                device="cpu")
    b = engine.simulate_program(sc, PROGRAM, {"w": torch.zeros(1)}, None,
                                [4, 3, 3], engine.SimConfig(n_ticks=2 * J),
                                device="cpu")
    # keyed by seed value, not grid position
    np.testing.assert_array_equal(a.costs[:, 0], b.costs[:, 1])
    np.testing.assert_array_equal(a.costs[:, 1], b.costs[:, 0])
    np.testing.assert_array_equal(b.costs[:, 1], b.costs[:, 2])
    assert not np.allclose(a.costs[0, 0], a.costs[0, 1])


def _fmix32_reference(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_hash_is_murmur_finalizer_in_exact_integer_arithmetic():
    xs = np.random.default_rng(0).integers(0, 2 ** 32, 512)
    got = engine._fmix32(torch.as_tensor(xs, dtype=torch.int64)).numpy()
    want = [_fmix32_reference(int(x)) for x in xs]
    np.testing.assert_array_equal(got, want)
    u = engine._uniform(engine._hash(torch.arange(4096), 7, 1, 0))
    assert 0.0 <= u.min().item() and u.max().item() < 1.0
    assert abs(u.mean().item() - 0.5) < 0.02


def test_unported_layouts_raise():
    """The per-cell layout runs (each cell's step, gated on its tick
    running), and so do the quadratic oracle, snapshots and the mesh: the
    per-cell grid in shards over three host devices is the grid run
    whole, carry and trajectories."""
    sc = _stat_scenarios(engine, np.ones(4, np.float32))

    def count(model, data, key, mask, j, alpha):
        return {"w": model["w"] + 1.0}, mask.sum()

    cells = engine.ModelProgram(step_fn=count, blocked=False)
    res = engine.simulate_program(sc, cells, {"w": torch.zeros(1)}, None, 2,
                                  engine.SimConfig(n_ticks=4), device="cpu")
    assert res.final_model["w"].shape == (len(sc), 2, 1)
    np.testing.assert_array_equal(res.final_model["w"][..., 0].numpy(),
                                  res.iterations)
    quad = engine.quadratic_program("full", 4)
    assert quad.blocked and quad is engine.quadratic_program("full", 4)
    sharded = engine.simulate_sharded(
        sc, cells, {"w": torch.zeros(1)}, None, 2,
        engine.SimConfig(n_ticks=4), mesh=Mesh(["cpu"] * 3, ("data",)))
    np.testing.assert_array_equal(sharded.final_model["w"].numpy(),
                                  res.final_model["w"].numpy())
    for field in ("iterations", "errors", "costs", "total_time"):
        np.testing.assert_array_equal(getattr(sharded, field),
                                      getattr(res, field))
    snap = engine.simulate_program(sc, PROGRAM, {"w": torch.zeros(1)}, None,
                                   2, engine.SimConfig(n_ticks=4,
                                                       snapshot_every=2),
                                   device="cpu")
    np.testing.assert_array_equal(snap.snapshot_ticks, [2, 4])
    assert snap.snapshots.t.shape == (len(sc), 2, 2)
    state, tick = engine.snapshot_state(snap, -1)
    assert tick == 4
    np.testing.assert_array_equal(state.j.numpy(), snap.iterations)
