"""The port's engine snapshots and ``tick0`` resume, mirroring
tests/test_engine_checkpoint.py.

``SimConfig.snapshot_every = k`` copies the whole carry after every k-th
tick and stacks the copies on axis 2; ``simulate_program(init_state,
tick0)`` resumes from any of them bit for bit, because every draw is keyed
by the absolute tick. The stochastic grids (uniform prices, exp runtimes,
minibatch gradients) are where a run that redrew ticks 0, 1, … on resume
would show; the reference's snapshot stream and window checks are held
against the reference itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import QuadraticProblem as JaxProblem
from repro.sim import engine as jax_engine
from repro_torch.data.synthetic import QuadraticProblem
from repro_torch.sim import engine

J = 20
FIELDS = ("errors", "costs", "times", "ys", "iterations", "total_time",
          "total_cost", "total_idle")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenarios(mod, rt_kind="exp"):
    quad_kw = dict(dim=6, n_samples=64, cond=5.0, noise=0.2, seed=0)
    L = QuadraticProblem(**quad_kw).L
    return [mod.Scenario(price=mod.PriceSpec.uniform(0.2, 1.0),
                         alpha=0.4 / L, bid_schedule=np.tile([b, b], (J, 1)),
                         rt_kind=rt_kind, rt_lam=2.0, idle_step=0.5)
            for b in (0.6, 0.9)]


@pytest.fixture(scope="module")
def setup():
    quad = QuadraticProblem(dim=6, n_samples=64, cond=5.0, noise=0.2, seed=0)
    scenarios = engine.stack_scenarios(_scenarios(engine), device="cpu")
    data = engine.torch_quadratic(quad, "cpu")
    model0 = torch.as_tensor(quad.w_star + 1.0, dtype=torch.float32)
    return scenarios, data, model0


def _run(setup, cfg, seeds=(0, 1), **kw):
    scenarios, data, model0 = setup
    program = engine.quadratic_program(cfg.grad, cfg.batch)
    return engine.simulate_program(scenarios, program, model0, data,
                                   list(seeds), cfg, device="cpu", **kw)


def _assert_same(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    np.testing.assert_array_equal(a.final_model.numpy(),
                                  b.final_model.numpy())


def test_snapshot_stream_and_remainder(setup):
    res = _run(setup, engine.SimConfig(n_ticks=50, grad="full",
                                       snapshot_every=12))
    # 50 ticks / every 12 → snapshots after ticks 12,24,36,48; the 2-tick
    # remainder still runs (final j/t move past snapshot 4's)
    np.testing.assert_array_equal(res.snapshot_ticks, [12, 24, 36, 48])
    assert res.snapshots.t.shape == (2, 2, 4)
    assert res.snapshots.err_traj.shape == (2, 2, 4, J)
    assert res.snapshots.model.shape == (2, 2, 4, 6)
    state, tick = engine.snapshot_state(res, -1)
    assert tick == 48
    assert state.t.shape == (2, 2) and state.model.shape == (2, 2, 6)
    snaps_t = res.snapshots.t.numpy()
    assert (np.diff(snaps_t, axis=-1) >= 0).all()
    assert (res.total_time >= snaps_t[..., -1]).all()
    # each snapshot is the carry after its tick: a run cut there ends in it
    cut = _run(setup, engine.SimConfig(n_ticks=24, grad="full"))
    mid, _ = engine.snapshot_state(res, 1)
    np.testing.assert_array_equal(mid.t.numpy(), cut.total_time)
    np.testing.assert_array_equal(mid.err_traj.numpy(), cut.errors)
    np.testing.assert_array_equal(mid.model.numpy(), cut.final_model.numpy())


def test_snapshot_stream_matches_reference_stream():
    """The tick list and the carry's layout are the reference's: on an
    RNG-free grid (tick-indexed prices, a deterministic runtime, the exact
    gradient) every snapshot's clock, cost and iteration count are equal
    and its error trajectory within rtol 1e-5."""
    trace = np.random.default_rng(4).uniform(0.2, 1.0, 53).astype(np.float32)
    quad_kw = dict(dim=6, n_samples=64, cond=5.0, noise=0.2, seed=0)
    jq, q = JaxProblem(**quad_kw), QuadraticProblem(**quad_kw)

    def scs(mod):
        return [mod.Scenario(price=mod.PriceSpec.from_trace_ticks(trace),
                             alpha=0.4 / q.L,
                             bid_schedule=np.tile([b, 0.5], (J, 1)),
                             rt_kind="det", rt_const=1.0, idle_step=0.5)
                for b in (0.6, 0.9)]

    cfg = dict(n_ticks=45, grad="full", snapshot_every=10)
    theirs = jax_engine.simulate(scs(jax_engine), jq, jq.w_star + 1.0, [0, 3],
                                 jax_engine.SimConfig(**cfg))
    ours = engine.simulate(scs(engine), q, q.w_star + 1.0, [0, 3],
                           engine.SimConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(ours.snapshot_ticks, theirs.snapshot_ticks)
    for f in ("t", "j", "total_cost", "total_idle", "cost_traj",
              "time_traj", "y_traj", "bucket"):
        np.testing.assert_array_equal(
            getattr(ours.snapshots, f).numpy(),
            np.asarray(getattr(theirs.snapshots, f)), err_msg=f)
    np.testing.assert_allclose(ours.snapshots.err_traj.numpy(),
                               np.asarray(theirs.snapshots.err_traj),
                               rtol=1e-5)
    np.testing.assert_allclose(ours.snapshots.model.numpy(),
                               np.asarray(theirs.snapshots.model),
                               rtol=1e-5, atol=1e-6)


def test_resume_from_snapshot_is_bitexact(setup):
    cfg = engine.SimConfig(n_ticks=60, grad="full", snapshot_every=16)
    full = _run(setup, cfg)
    state, tick = engine.snapshot_state(full, 1)          # tick 32
    resumed = _run(setup, engine.SimConfig(n_ticks=60, grad="full"),
                   init_state=state, tick0=tick)
    _assert_same(resumed, full)


@pytest.mark.parametrize("every,index", [(1, 4), (7, 1), (13, 0), (29, 0)])
def test_resume_is_bitexact_on_a_stochastic_grid(setup, every, index):
    """Uniform prices, exp runtimes and minibatch gradients: every tick
    draws. A resumed run must draw tick k's bits at tick k, not redraw
    ticks 0, 1, … from the carry."""
    n = 60
    cfg = engine.SimConfig(n_ticks=n, batch=4)
    straight = _run(setup, cfg, seeds=(0, 1, 5))
    snap = _run(setup, engine.SimConfig(n_ticks=n, batch=4,
                                        snapshot_every=every),
                seeds=(0, 1, 5))
    _assert_same(snap, straight)
    state, tick = engine.snapshot_state(snap, index)
    assert tick == every * (index + 1)
    resumed = _run(setup, cfg, seeds=(0, 1, 5), init_state=state, tick0=tick)
    _assert_same(resumed, straight)
    # the fault this guards against: the same carry replayed from tick 0
    # redraws the market and goes elsewhere
    state, _ = engine.snapshot_state(snap, index)
    replayed = _run(setup, cfg, seeds=(0, 1, 5), init_state=state, tick0=0)
    assert not np.array_equal(replayed.total_cost, straight.total_cost)


def test_resume_leaves_the_snapshot_stream_as_it_was(setup):
    cfg = engine.SimConfig(n_ticks=40, batch=4, snapshot_every=10)
    res = _run(setup, cfg)
    before = res.snapshots.err_traj.clone()
    state, tick = engine.snapshot_state(res, 0)
    _run(setup, engine.SimConfig(n_ticks=40, batch=4), init_state=state,
         tick0=tick)
    np.testing.assert_array_equal(res.snapshots.err_traj.numpy(),
                                  before.numpy())


def test_per_cell_layout_resumes_bitexact(setup):
    """The per-cell layout (`train_zoo`'s) takes tick0 and snapshots too."""
    scenarios, data, model0 = setup

    def count(model, data, key, mask, j, alpha):
        return {"w": model["w"] + (key % 7).to(torch.float32)}, mask.sum()

    cells = engine.ModelProgram(step_fn=count, blocked=False)
    cfg = engine.SimConfig(n_ticks=30, snapshot_every=11)
    full = engine.simulate_program(scenarios, cells, {"w": torch.zeros(1)},
                                   None, [0, 2], cfg, device="cpu")
    state, tick = engine.snapshot_state(full, 0)
    assert tick == 11 and state.model["w"].shape == (2, 2, 1)
    resumed = engine.simulate_program(
        scenarios, cells, None, None, [0, 2],
        engine.SimConfig(n_ticks=30), init_state=state, tick0=tick,
        device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(resumed, f), getattr(full, f))
    np.testing.assert_array_equal(resumed.final_model["w"].numpy(),
                                  full.final_model["w"].numpy())


def test_no_snapshots_by_default(setup):
    res = _run(setup, engine.SimConfig(n_ticks=8, grad="full"), seeds=(0,))
    assert res.snapshots is None and res.snapshot_ticks is None
    with pytest.raises(ValueError, match="snapshot_every"):
        engine.snapshot_state(res)


def test_tick0_validation(setup):
    with pytest.raises(ValueError, match="tick0"):
        _run(setup, engine.SimConfig(n_ticks=8, grad="full"), seeds=(0,),
             tick0=9)
    with pytest.raises(ValueError, match="tick0"):
        _run(setup, engine.SimConfig(n_ticks=8, grad="full"), seeds=(0,),
             tick0=-1)
    # tick0 == n_ticks runs nothing and hands the carry back
    scenarios, data, model0 = setup
    state = engine.initial_state(scenarios, model0, 1, device="cpu")
    res = _run(setup, engine.SimConfig(n_ticks=8, grad="full"), seeds=(0,),
               init_state=state, tick0=8)
    assert (res.iterations == 0).all() and (res.total_time == 0).all()


def test_snapshot_every_beyond_budget_raises(setup):
    """snapshot_every larger than the (remaining) tick budget would emit
    zero snapshots — silently disabling checkpointing; it must fail."""
    scenarios, data, model0 = setup
    with pytest.raises(ValueError, match="snapshot_every"):
        _run(setup, engine.SimConfig(n_ticks=8, grad="full",
                                     snapshot_every=9), seeds=(0,))
    with pytest.raises(ValueError, match="snapshot_every"):
        _run(setup, engine.SimConfig(n_ticks=8, grad="full",
                                     snapshot_every=-1), seeds=(0,))
    state = engine.initial_state(scenarios, model0, 1, device="cpu")
    with pytest.raises(ValueError, match="remaining"):
        _run(setup, engine.SimConfig(n_ticks=20, grad="full",
                                     snapshot_every=8), seeds=(0,),
             init_state=state, tick0=16)
    # the reference refuses the same windows
    with pytest.raises(ValueError, match="remaining"):
        jax_engine._check_run_window(
            jax_engine.SimConfig(n_ticks=20, snapshot_every=8), 16)
    assert engine._check_run_window(
        engine.SimConfig(n_ticks=20, snapshot_every=4), 16) == \
        jax_engine._check_run_window(
            jax_engine.SimConfig(n_ticks=20, snapshot_every=4), 16) == 4


def test_handbuilt_trace_spec_without_times_rejected():
    """A PRICE_TRACE spec not built via from_trace has no timestamps and
    would silently replay a constant price — stack_scenarios must refuse."""
    bad = engine.PriceSpec(kind=engine.PRICE_TRACE, lo=0.2, hi=0.9,
                           trace=np.linspace(0.2, 0.9, 5, dtype=np.float32))
    sc = engine.Scenario(price=bad, alpha=0.1,
                         bid_schedule=np.ones((4, 1)), name="bad-trace")
    with pytest.raises(ValueError, match="from_trace"):
        engine.stack_scenarios([sc], device="cpu")


def test_reference_resume_is_what_the_port_mirrors():
    """The reference resumes bit for bit on the same stochastic grid; the
    port's tests above hold it to the same contract."""
    quad = JaxProblem(dim=6, n_samples=64, cond=5.0, noise=0.2, seed=0)
    scenarios = jax_engine.stack_scenarios(_scenarios(jax_engine))
    program = jax_engine.quadratic_program("minibatch", 4)
    data = jax_engine.jax_quadratic(quad)
    model0 = jnp.asarray(quad.w_star + 1.0, jnp.float32)
    cfg = jax_engine.SimConfig(n_ticks=40, batch=4, snapshot_every=13)
    full = jax_engine.simulate_program(scenarios, program, model0, data,
                                       [0, 1], cfg)
    state, tick = jax_engine.snapshot_state(full, 1)
    resumed = jax_engine.simulate_program(
        scenarios, program, None, data, [0, 1],
        jax_engine.SimConfig(n_ticks=40, batch=4), init_state=state,
        tick0=tick)
    np.testing.assert_array_equal(resumed.costs, full.costs)
    np.testing.assert_array_equal(resumed.errors, full.errors)
