"""The port's quadratic-oracle engine (`engine.simulate`) and evaluation
harness (`sim/evaluate.py`) against the reference's, mirroring
tests/test_engine_{parity,plans,properties}.py and tests/test_sim.py.

Three holds:
* exactly on RNG-free grids (tick-indexed or time-indexed trace prices, a
  deterministic runtime, the exact gradient): iterations, active counts,
  cost and time equal; errors within rtol 1e-5 (float32 products summed in
  another order);
* exactly where both sides are the same numpy: the legacy one-scenario
  runners, `calibrated_quadratic`, `average_runs`;
* statistically where the engine draws: over 160 seeds the port's mean
  final error and mean cost lie within 4 standard errors of the
  reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import provisioning as jax_prov
from repro.core import strategies as jax_strat
from repro.core.cost_model import (RuntimeModel as JaxRuntime,
                                   TruncGaussianPrice as JaxGauss,
                                   UniformPrice as JaxUniform)
from repro.data.synthetic import QuadraticProblem as JaxProblem
from repro.sim import engine as jax_engine
from repro.sim import evaluate as jax_evaluate
from repro.sim import spot_market as jax_market
from repro_torch.core import preemption as pe
from repro_torch.core import provisioning as prov
from repro_torch.core import strategies as strat
from repro_torch.core.cost_model import (RuntimeModel, TruncGaussianPrice,
                                         UniformPrice)
from repro_torch.data.synthetic import QuadraticProblem
from repro_torch.sim import engine, evaluate, spot_market

J, T = 80, 1200
RTOL = 1e-5
ACCOUNTING = ("iterations", "ys", "costs", "times", "total_cost",
              "total_time", "total_idle", "J")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QUAD_KW = dict(dim=6, n_samples=64, cond=5.0, noise=0.2, seed=0)


@pytest.fixture(scope="module")
def problem():
    quad, jquad = QuadraticProblem(**QUAD_KW), JaxProblem(**QUAD_KW)
    return quad, jquad, quad.w_star + 1.0, 0.4 / quad.L


def _fixed(mod, bids, iterations=J):
    """A fixed-bid strategy of ``mod`` (either package's strategies)."""

    class Fixed(mod.Strategy):
        name = "fixed"

        def bids(self, t_elapsed, j_done):
            return np.asarray(bids, float)

        @property
        def total_iterations(self):
            return iterations

    return Fixed()


def _assert_engines_agree(ours, theirs):
    for f in ACCOUNTING:
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f),
                                      err_msg=f)
    np.testing.assert_allclose(ours.errors, theirs.errors, rtol=RTOL)


def _assert_matches_legacy(res, legacy, i=0):
    np.testing.assert_allclose(res.times[i, 0, :J], legacy.times,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(res.costs[i, 0, :J], legacy.costs,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.errors[i, 0, :J], legacy.errors,
                               rtol=5e-3, atol=1e-6)
    s = res.summary()
    assert s["mean_active"][i, 0] == pytest.approx(
        legacy.summary["mean_active"], rel=1e-6)
    assert s["mean_inv_y"][i, 0] == pytest.approx(
        legacy.summary["mean_inv_y"], rel=1e-5)
    assert res.total_idle[i, 0] == pytest.approx(legacy.summary["idle"],
                                                 rel=1e-5, abs=1e-4)


PARITY = [("uniform-one-bid", (0.2, 1.0), [0.6, 0.6, 0.6]),
          ("uniform-two-bids", (0.2, 1.0), [0.8, 0.8, 0.45, 0.45]),
          ("gaussian-two-bids", (0.6, 0.175, 0.2, 1.0), [0.85, 0.5, 0.5])]


def _trace(params):
    dist = UniformPrice(*params) if len(params) == 2 else \
        TruncGaussianPrice(*params)
    return dist.sample(np.random.default_rng(7), size=T).astype(np.float32)


def _tick_scenario(mod, trace, bids, alpha):
    return mod.Scenario(price=mod.PriceSpec.from_trace_ticks(trace),
                        alpha=alpha, bid_schedule=np.tile(bids, (J, 1)),
                        rt_kind="det", rt_const=1.0, idle_step=0.5)


def test_simulate_matches_reference_and_legacy_loop_tick_indexed(problem):
    """The three tick-indexed grids of the reference's parity test, as one
    batch: equal to the reference's engine, and within the reference
    test's tolerances of the port's legacy loop."""
    quad, jquad, w0, alpha = problem
    traces = [_trace(p) for _, p, _ in PARITY]
    bids = [np.asarray(b, float) for _, _, b in PARITY]
    cfg = dict(n_ticks=400, grad="full")
    ours = engine.simulate(
        [_tick_scenario(engine, t, b, alpha) for t, b in zip(traces, bids)],
        quad, w0, [0], engine.SimConfig(**cfg), device="cpu")
    theirs = jax_engine.simulate(
        [_tick_scenario(jax_engine, t, b, alpha)
         for t, b in zip(traces, bids)],
        jquad, w0, [0], jax_engine.SimConfig(**cfg))
    assert (ours.iterations == J).all()
    _assert_engines_agree(ours, theirs)
    rt = RuntimeModel(kind="det", r_const=1.0)
    for i, (trace, b) in enumerate(zip(traces, bids)):
        legacy = evaluate.run_spot_strategy(
            quad, w0, alpha, _fixed(strat, b),
            spot_market.SpotMarket(spot_market.TickPrices(trace)), rt,
            iterations=J, grad="full", seed=3, idle_step=0.5)
        _assert_matches_legacy(ours, legacy, i)


class _ScriptedRuntime:
    """Replays a prescribed per-iteration duration sequence."""

    def __init__(self, durs):
        self.durs, self._i = list(durs), 0

    def sample(self, rng, y) -> float:
        d = self.durs[self._i]
        self._i += 1
        return float(d)


def test_fig4_trace_replay_matches_legacy_under_exp_runtimes(problem):
    """Time-indexed replay under stochastic durations: the port's engine
    runs with its own exp draws; the port's legacy loop replays those
    durations against the same wall-clock-indexed trace and must match;
    tick-indexed replay of the same trace must not."""
    quad, _, w0, alpha = problem
    step, idle = 0.5, 0.5
    bids = np.asarray([0.6, 0.6, 0.6], float)
    trace = UniformPrice(0.2, 1.0).sample(
        np.random.default_rng(11), size=T).astype(np.float32)
    kw = dict(alpha=alpha, bid_schedule=np.tile(bids, (J, 1)), rt_kind="exp",
              rt_lam=2.0, rt_delta=0.05, idle_step=idle)
    res = engine.simulate(
        [engine.Scenario(price=engine.PriceSpec.from_trace(trace, step=step),
                         **kw),
         engine.Scenario(price=engine.PriceSpec.from_trace_ticks(trace),
                         **kw)],
        quad, w0, [0], engine.SimConfig(n_ticks=600, grad="full"),
        device="cpu")
    assert res.iterations[0, 0] == J
    period = step * len(trace)
    t, durs = 0.0, []
    for j in range(J):
        while float(trace[int((t % period) / step) % len(trace)]) \
                > bids.max():
            t += idle
        end = float(res.times[0, 0, j])
        durs.append(end - t)
        t = end
    assert min(durs) > 0 and len(set(np.round(durs, 5))) > J // 2
    legacy = evaluate.run_spot_strategy(
        quad, w0, alpha, _fixed(strat, bids),
        spot_market.SpotMarket(spot_market.TracePrices(trace, step=step)),
        _ScriptedRuntime(durs), iterations=J, grad="full", seed=3,
        idle_step=idle)
    _assert_matches_legacy(res, legacy)
    assert not np.allclose(res.costs[1, 0, :J], legacy.costs, rtol=1e-3)


def test_explicit_timestamps_period_and_seed_roll_match_reference(problem):
    """`from_trace` with non-uniform timestamps and a period, and the
    per-seed index roll of time-indexed replay: equal to the reference."""
    quad, jquad, w0, alpha = problem
    trace = np.array([0.30, 0.50, 0.70, 0.40], np.float32)
    times = np.array([0.0, 1.5, 3.0, 7.0], np.float32)
    ramp = np.linspace(0.3, 0.9, 17).astype(np.float32)

    def scs(mod):
        det = dict(alpha=alpha, rt_kind="det", rt_const=1.0, idle_step=0.5)
        return [mod.Scenario(price=mod.PriceSpec.from_trace(
                    trace, times=times, period=10.0),
                    bid_schedule=np.ones((12, 1)), **det),
                mod.Scenario(price=mod.PriceSpec.from_trace(ramp),
                             bid_schedule=np.ones((20, 1)), **det)]

    ours = engine.simulate(scs(engine), quad, w0, [0, 1],
                           engine.SimConfig(n_ticks=40, grad="full"),
                           device="cpu")
    theirs = jax_engine.simulate(scs(jax_engine), jquad, w0, [0, 1],
                                 jax_engine.SimConfig(n_ticks=40,
                                                      grad="full"))
    _assert_engines_agree(ours, theirs)
    paid = np.diff(np.concatenate([[0.0], ours.costs[0, 0, :12]]))
    expect = [trace[np.searchsorted(times, t % 10.0, side="right") - 1]
              for t in np.arange(12, dtype=float)]
    np.testing.assert_allclose(paid, expect, rtol=1e-5, atol=1e-6)
    assert not np.allclose(ours.costs[1, 0], ours.costs[1, 1])


NB = strat.NEVER_BID
PJ = 10


def _table_scenario(mod, r_const, trace_price=0.55):
    table = np.empty((3, PJ, 2), np.float32)
    table[:, :4] = [0.7, 0.7]
    table[0, 4:] = [0.3, NB]
    table[1, 4:] = [0.6, NB]
    table[2, 4:] = [0.9, 0.9]
    return mod.Scenario(
        price=mod.PriceSpec.from_trace(np.full(64, trace_price, np.float32)),
        alpha=0.0, bid_table=table,
        bucket_starts=np.array([0.0, 5.0, 10.0]), replan_at=4,
        rt_kind="det", rt_const=r_const, idle_step=0.25)


@pytest.mark.parametrize("r_const,expect_iters,expect_y", [
    (1.0, 4, None), (2.0, PJ, 1.0), (3.0, PJ, 2.0),
], ids=["bucket0-dies", "bucket1-one-worker", "bucket2-two-workers"])
def test_bucket_latched_at_replan_time(problem, r_const, expect_iters,
                                       expect_y):
    quad, jquad, w0, _ = problem
    cfg = dict(n_ticks=60, grad="full")
    ours = engine.simulate([_table_scenario(engine, r_const)], quad, w0, [0],
                           engine.SimConfig(**cfg), device="cpu")
    theirs = jax_engine.simulate([_table_scenario(jax_engine, r_const)],
                                 jquad, w0, [0], jax_engine.SimConfig(**cfg))
    _assert_engines_agree(ours, theirs)
    assert ours.iterations[0, 0] == expect_iters
    if expect_y is not None:
        assert (ours.ys[0, 0, 4:PJ] == expect_y).all()
        assert ours.times[0, 0, -1] > 10.0


def test_one_bucket_table_and_stacking_leave_results_alone(problem):
    """A (1, J, n) table is the schedule it wraps; stacking a plain
    schedule beside a 3-bucket table perturbs neither."""
    quad, _, w0, alpha = problem
    sched = np.tile([0.8, 0.45], (PJ, 1)).astype(np.float32)
    kw = dict(price=engine.PriceSpec.from_trace(
        np.linspace(0.3, 0.9, 37).astype(np.float32)), alpha=alpha,
        rt_kind="det", rt_const=1.0, idle_step=0.5)
    cfg = engine.SimConfig(n_ticks=60, grad="full")
    plain = engine.Scenario(bid_schedule=sched, **kw)
    table = _table_scenario(engine, 2.0)
    both = engine.simulate([plain, engine.Scenario(bid_table=sched[None],
                                                   **kw), table],
                           quad, w0, [0], cfg, device="cpu")
    np.testing.assert_array_equal(both.costs[0], both.costs[1])
    np.testing.assert_array_equal(both.errors[0], both.errors[1])
    alone = engine.simulate([table], quad, w0, [0], cfg, device="cpu")
    np.testing.assert_array_equal(both.costs[2], alone.costs[0])
    solo = engine.simulate([plain], quad, w0, [0], cfg, device="cpu")
    np.testing.assert_array_equal(both.costs[0], solo.costs[0])


def _spot(mod, alpha, bids, J=120, **kw):
    kw.setdefault("rt_kind", "exp")
    kw.setdefault("rt_lam", 2.0)
    kw.setdefault("idle_step", 0.5)
    return mod.Scenario(price=kw.pop("price", mod.PriceSpec.uniform(0.2, 1.0)),
                        alpha=alpha, bid_schedule=np.tile(bids, (J, 1)), **kw)


def test_engine_properties(problem):
    """Monotone cost and clock, no idling when every bid covers the
    support, a truncated scenario flagged (0 iterations, NaN, not
    completed), and §V accounting (cost = price · Σ y · R)."""
    quad, _, w0, alpha = problem
    scs = [_spot(engine, alpha, [0.6, 0.6, 0.6]),
           _spot(engine, alpha, [1.0, 1.0, 1.0]),
           _spot(engine, alpha, [0.1, 0.1], J=10),
           engine.Scenario(price=engine.PriceSpec.uniform(0.0, 1.0),
                           alpha=alpha, worker_schedule=np.full(120, 8),
                           preempt_q=0.5, on_demand_price=0.7, rt_kind="det",
                           rt_const=1.0, idle_step=0.1)]
    res = engine.simulate(scs, quad, w0, 3,
                          engine.SimConfig(n_ticks=400, batch=4),
                          device="cpu")
    for i in (0, 1, 3):
        assert res.completed[i].all()
        for r in range(3):
            Ji = int(res.J[i])
            assert np.all(np.diff(res.costs[i, r, :Ji]) >= -1e-5)
            assert np.all(np.diff(res.times[i, r, :Ji]) > 0)
    assert np.all(res.total_idle[1] == 0.0)
    assert np.all(res.ys[1, :, :120] == 3)
    assert not res.completed[2].any() and (res.iterations[2] == 0).all()
    assert np.all(np.isnan(res.errors[2]))
    assert res.total_idle[2, 0] == pytest.approx(400 * 0.5)
    ys = res.ys[3, :, :120]
    assert np.mean(ys) == pytest.approx(8 * 0.5 / (1 - 0.5 ** 8), rel=0.1)
    np.testing.assert_allclose(res.total_cost[3], 0.7 * ys.sum(axis=-1),
                               rtol=1e-4)


def test_conditional_inv_y_matches_two_group_model(problem):
    quad, _, w0, alpha = problem
    dist = UniformPrice(0.2, 1.0)
    n1, n, b1, b2 = 2, 8, 0.9, 0.5
    bids = np.concatenate([np.full(n1, b1), np.full(n - n1, b2)])
    res = engine.simulate([_spot(engine, alpha, bids, J=400)], quad, w0, 6,
                          engine.SimConfig(n_ticks=900, batch=2,
                                           grad="full"), device="cpu")
    assert res.completed.all()
    gamma = float(dist.cdf(b2) / dist.cdf(b1))
    got = float(np.nanmean(1.0 / np.maximum(res.ys[0], 1.0)))
    assert got == pytest.approx(pe.inv_y_two_groups(n1, n, gamma), abs=0.02)


def _stat_grid(mod, alpha):
    return [_spot(mod, alpha, [0.6, 0.6, 0.6], J=30),
            _spot(mod, alpha, [0.9, 0.9, 0.45, 0.45], J=30,
                  price=mod.PriceSpec.trunc_gaussian(0.6, 0.175, 0.2, 1.0)),
            mod.Scenario(price=mod.PriceSpec.uniform(0.0, 1.0), alpha=alpha,
                         worker_schedule=np.full(30, 3), preempt_q=0.4,
                         rt_kind="exp", rt_lam=2.0, idle_step=0.5)]


def test_minibatch_grid_statistics_match_reference(problem):
    """Minibatch gradients, random prices, exp runtimes and preemptions:
    over 160 seeds the port's mean final error and mean total cost lie
    within 4 standard errors of the reference's, per scenario."""
    quad, jquad, w0, alpha = problem
    n_seeds = 160
    cfg = dict(n_ticks=150, batch=4)
    ours = engine.simulate(_stat_grid(engine, alpha), quad, w0, n_seeds,
                           engine.SimConfig(**cfg), device="cpu")
    theirs = jax_engine.simulate(_stat_grid(jax_engine, alpha), jquad, w0,
                                 n_seeds, jax_engine.SimConfig(**cfg))
    assert ours.completed.all() and theirs.completed.all()
    for stat in (lambda r: r.errors[:, :, -1], lambda r: r.total_cost):
        a, b = stat(ours), stat(theirs)
        se = np.sqrt(a.var(1, ddof=1) / n_seeds + b.var(1, ddof=1) / n_seeds)
        gap = np.abs(a.mean(1) - b.mean(1))
        assert (gap < 4 * se).all(), (a.mean(1), b.mean(1), se)


def test_legacy_runners_bit_for_bit(problem):
    """The numpy loops are the reference's: the same trajectories and
    summaries, bit for bit, for minibatch and full gradients, i.i.d. and
    trace markets, spot and preemptible modes."""
    quad, jquad, w0, alpha = problem
    for grad, dist, jdist in [("minibatch", UniformPrice(0.2, 1.0),
                               JaxUniform(0.2, 1.0)),
                              ("full", TruncGaussianPrice(0.6, 0.175, 0.2,
                                                          1.0),
                               JaxGauss(0.6, 0.175, 0.2, 1.0))]:
        bids = [0.7, 0.7, 0.4]
        ours = evaluate.run_spot_strategy(
            quad, w0, alpha, _fixed(strat, bids, 40),
            spot_market.SpotMarket(spot_market.IIDPrices(dist, seed=4)),
            RuntimeModel(kind="exp", lam=2.0, delta=0.05), batch=3, seed=4,
            grad=grad)
        theirs = jax_evaluate.run_spot_strategy(
            jquad, w0, alpha, _fixed(jax_strat, bids, 40),
            jax_market.SpotMarket(jax_market.IIDPrices(jdist, seed=4)),
            JaxRuntime(kind="exp", lam=2.0, delta=0.05), batch=3, seed=4,
            grad=grad)
        _assert_runs_equal(ours, theirs)
    trace = jax_market.synthetic_history(hours=48, seed=1)
    ours = evaluate.run_spot_strategy(
        quad, w0, alpha, _fixed(strat, [0.15, 0.1], 30),
        spot_market.SpotMarket(spot_market.TracePrices(trace, step=0.05)),
        RuntimeModel(kind="exp", lam=2.0, delta=0.05), seed=2)
    theirs = jax_evaluate.run_spot_strategy(
        jquad, w0, alpha, _fixed(jax_strat, [0.15, 0.1], 30),
        jax_market.SpotMarket(jax_market.TracePrices(trace, step=0.05)),
        JaxRuntime(kind="exp", lam=2.0, delta=0.05), seed=2)
    _assert_runs_equal(ours, theirs)
    cprob = evaluate.calibrated_quadratic(label_noise=1.0)[2]
    jcprob = jax_evaluate.calibrated_quadratic(label_noise=1.0)[2]
    plan = prov.optimal_n_and_j(cprob, 0.5, 2000, d=2.0)
    jplan = jax_prov.optimal_n_and_j(jcprob, 0.5, 2000, d=2.0)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    for q, ours_s, theirs_s in [
            (0.0, strat.DynamicWorkers(n0=1, eta=1.05, J=30),
             jax_strat.DynamicWorkers(n0=1, eta=1.05, J=30)),
            (0.5, strat.StaticWorkers(plan), jax_strat.StaticWorkers(jplan))]:
        ours = evaluate.run_preemptible_strategy(
            quad, w0, alpha, ours_s, q, RuntimeModel(kind="det", r_const=1.0),
            price=0.5, seed=6, iterations=30)
        theirs = jax_evaluate.run_preemptible_strategy(
            jquad, w0, alpha, theirs_s, q,
            JaxRuntime(kind="det", r_const=1.0), price=0.5, seed=6,
            iterations=30)
        _assert_runs_equal(ours, theirs)


def _assert_runs_equal(ours, theirs):
    np.testing.assert_array_equal(ours.errors, theirs.errors)
    np.testing.assert_array_equal(ours.costs, theirs.costs)
    np.testing.assert_array_equal(ours.times, theirs.times)
    assert ours.summary == theirs.summary
    for eps in (1.0, 0.1):
        assert ours.cost_to_error(eps) == theirs.cost_to_error(eps)
        assert ours.time_to_error(eps) == theirs.time_to_error(eps)


def test_calibration_and_average_runs_match_reference():
    for kw in ({}, {"label_noise": 1.0}, {"noise": 0.1, "batch": 4}):
        quad, w0, prob, batch = evaluate.calibrated_quadratic(**kw)
        jquad, jw0, jprob, jbatch = jax_evaluate.calibrated_quadratic(**kw)
        np.testing.assert_array_equal(quad.A, jquad.A)
        np.testing.assert_array_equal(w0, jw0)
        assert dataclasses.asdict(prob) == dataclasses.asdict(jprob)
        assert batch == jbatch
    quad, w0, prob, _ = evaluate.calibrated_quadratic()
    jquad, _, jprob, _ = jax_evaluate.calibrated_quadratic()

    def fn(mod, ev, q, p):
        return lambda s: ev.run_spot_strategy(
            q, w0, p.alpha, _fixed(mod, [0.9, 0.5], 10 + s),
            (spot_market if mod is strat else jax_market).SpotMarket(
                (spot_market if mod is strat else jax_market).IIDPrices(
                    (UniformPrice if mod is strat else JaxUniform)(0.2, 1.0),
                    seed=s)),
            (RuntimeModel if mod is strat else JaxRuntime)(kind="det",
                                                           r_const=1.0),
            seed=s)

    ours = evaluate.average_runs(fn(strat, evaluate, quad, prob), 3)
    theirs = jax_evaluate.average_runs(fn(jax_strat, jax_evaluate, jquad,
                                          jprob), 3)
    assert len(ours.errors) == 10
    _assert_runs_equal(ours, theirs)


def _batch_scenarios(mod, alpha):
    trace = np.random.default_rng(2).uniform(0.2, 1.0, 211).astype(
        np.float32)
    out = []
    for name, bids in [("one", [0.6, 0.6]), ("two", [0.9, 0.9, 0.4, 0.4])]:
        s = _tick_scenario(mod, trace, bids, alpha)
        s.name = f"{name}@trace"
        out.append(s)
    return out


def test_evaluate_batch_matches_reference_on_rng_free_grid(problem):
    quad, jquad, w0, alpha = problem
    kw = dict(quad=quad, w0=w0, alpha=alpha, grad="full", n_ticks=300)
    ours = evaluate.evaluate_batch({}, _batch_scenarios(engine, alpha), 3,
                                   device="cpu", **kw)
    theirs = jax_evaluate.evaluate_batch(
        {}, _batch_scenarios(jax_engine, alpha), 3,
        **dict(kw, quad=jquad))
    assert ours.names == theirs.names == ["one@trace", "two@trace"]
    assert ours.n_seeds == theirs.n_seeds == 3
    _assert_engines_agree(ours.result, theirs.result)
    for name in ours.names:
        a, b = ours.run(name), theirs.run(name)
        for key in ("reps", "completed", "cost_mean", "cost_ci", "time_mean",
                    "time_ci"):
            assert a.summary[key] == b.summary[key], key
        for key in ("final_err_mean", "final_err_ci"):
            assert a.summary[key] == pytest.approx(b.summary[key], rel=RTOL)
        np.testing.assert_array_equal(a.costs, b.costs)
        np.testing.assert_allclose(a.errors, b.errors, rtol=RTOL)
        for eps in (1.0, 0.05):
            ca, cia, per_a = ours.cost_to_error(name, eps)
            cb, cib, per_b = theirs.cost_to_error(name, eps)
            np.testing.assert_array_equal(per_a, per_b)
            assert (ca, cia) == (cb, cib)


def test_evaluate_batch_builds_the_reference_grid_and_snapshots(problem):
    """The strategy × market mapping path: the same labels and plan shapes
    as the reference, snapshots when asked, ``rt`` required."""
    quad, _, w0, alpha = problem
    dist = UniformPrice(0.2, 1.0)
    strategies = {"one": _fixed(strat, [0.6, 0.6], 12),
                  "two": _fixed(strat, [0.9, 0.4, 0.4], 15)}
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    res = evaluate.evaluate_batch(
        strategies, {"u": dist, "g": TruncGaussianPrice(0.6, 0.2, 0.2, 1.0)},
        2, quad=quad, w0=w0, alpha=alpha, rt=rt, batch=2, snapshot_every=20,
        device="cpu")
    assert res.names == ["one@u", "two@u", "one@g", "two@g"]
    assert res.result.errors.shape == (4, 2, 15)
    # the engine's default budget, 4 J_max + 64 ticks, in 20-tick snapshots
    np.testing.assert_array_equal(res.result.snapshot_ticks,
                                  20 * np.arange(1, 7))
    assert res.result.completed.all()
    with pytest.raises(ValueError, match="rt"):
        evaluate.evaluate_batch(strategies, {"u": dist}, 2, quad=quad,
                                w0=w0, alpha=alpha, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            evaluate.evaluate_batch(strategies, {"u": dist}, 2, quad=quad,
                                    w0=w0, alpha=alpha, rt=rt)
