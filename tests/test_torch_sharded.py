"""The scenario grid in shards over a device mesh
(`repro_torch.sim.engine.simulate_sharded` and ``mesh=`` on the trainers,
the service, the launchers and the supervisor), run over host devices on
the CPU.

The reference's own sharded tests (tests/test_sharded_parity.py and
friends) cannot run here: the installed JAX's explicit sharding refuses
their gather over a ``data``-sharded operand (``ShardingTypeError``). So
the port is held to the contract the reference states for that run —
"a sharded run is bit-identical to the single-device vmapped path,
snapshots included" (``repro/sim/engine.py:1187-1190``) — in two ways:

* the port sharded against the port unsharded, bit for bit, on every
  mesh of the reference's list (d8, d4, d2, d4xr2, d2xr2) and an uneven
  three-way one, S = 11 and 5 scenarios and R = 3 seeds so that no shard
  boundary is even;
* the port sharded against the reference *unsharded*, on the RNG-free
  pins of tests/test_engine_parity.py (tick-indexed trace prices, a
  constant runtime, ``grad="full"``): the market and accounting exactly,
  a program that counts the active workers exactly, the quadratic's
  errors within tests/test_torch_evaluate.py's rtol 1e-5."""
import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import QuadraticProblem as JaxQuadraticProblem
from repro.sim import engine as jax_engine
from repro_torch.chaos import Fault, FaultPlan
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core import bidding, strategies as strat
from repro_torch.core.cost_model import RuntimeModel, UniformPrice
from repro_torch.data.synthetic import QuadraticProblem
from repro_torch.launch import supervisor as sup
from repro_torch.launch.mesh import (HOST_DEVICES_ENV, Mesh,
                                     make_scenario_mesh,
                                     make_scenario_replica_mesh)
from repro_torch.launch.workload import WorkerSpec, build_workload
from repro_torch.sim import engine
from repro_torch.sim.spot_market import synthetic_history
from repro_torch.train import checkpoint as ck
from repro_torch.train import megabatch as mb
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
RTOL = 1e-5
FIELDS = ("errors", "costs", "times", "ys", "iterations", "total_time",
          "total_cost", "total_idle")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(n_data, n_replica=None):
    def make():
        if n_replica is None:
            return make_scenario_mesh(n_data, device="cpu", host_devices=8)
        return make_scenario_replica_mesh(n_data, n_replica, device="cpu",
                                          host_devices=8)
    return make


MESHES = {"d8": _host(8), "d4": _host(4), "d2": _host(2),
          "d4xr2": _host(4, 2), "d2xr2": _host(2, 2),
          "d3": lambda: Mesh(["cpu"] * 3, ("data",))}


def _bits(x):
    x = x.detach().contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes()


def _assert_same_run(res, ref):
    """Every trajectory, the final carry and the snapshots, bit for bit."""
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f),
                                      err_msg=f)
    for name in ("final_state", "snapshots"):
        a, b = getattr(res, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                assert x.shape == y.shape and x.dtype == y.dtype, name
                assert _bits(x) == _bits(y), name
    np.testing.assert_array_equal(res.snapshot_ticks, ref.snapshot_ticks)


# ---------------------------------------------------------------------------
# the engine: fig3 / fig4 grids on every mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quad():
    q = QuadraticProblem(dim=6, n_samples=64, cond=5.0, noise=0.2, seed=0)
    return (q, engine.torch_quadratic(q, "cpu"),
            torch.from_numpy(np.asarray(q.w_star + 1.0, np.float32)))


def _fig_grids(q):
    alpha = 0.4 / q.L
    specs = [engine.PriceSpec.uniform(0.2, 1.0),
             engine.PriceSpec.trunc_gaussian(0.6, 0.175, 0.2, 1.0)]
    fig3 = [engine.Scenario(
        price=specs[i % 2], alpha=alpha,
        bid_schedule=np.tile([b, b, b], (16, 1)), rt_kind="exp",
        rt_lam=2.0, idle_step=0.5, name=f"fig3-{i}")
        for i, b in enumerate(np.linspace(0.4, 1.0, 11))]
    trace = synthetic_history(hours=24, seed=0)
    fig4 = [engine.Scenario(
        price=engine.PriceSpec.from_trace(trace, step=0.05), alpha=alpha,
        bid_schedule=np.tile([b, b, b], (16, 1)), rt_kind="exp",
        rt_lam=2.0, idle_step=0.5, name=f"fig4-{i}")
        for i, b in enumerate([0.5, 0.7, 0.9, 1.0, 0.6])]
    return {"fig3": fig3, "fig4": fig4}


FIG_CFG = engine.SimConfig(n_ticks=40, batch=4, snapshot_every=20)


@pytest.fixture(scope="module")
def fig_runs(quad):
    q, data, w0 = quad
    program = engine.quadratic_program("minibatch", 4)
    out = {}
    for tag, sc in _fig_grids(q).items():
        batch = engine.stack_scenarios(sc, device="cpu")
        out[tag] = (batch, engine.simulate_program(
            batch, program, w0, data, 3, FIG_CFG, device="cpu"))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("grid", ["fig3", "fig4"])
def test_simulate_sharded_bit_for_bit_the_unsharded_run(quad, fig_runs,
                                                        grid, mesh):
    """S = 11 (fig3: uniform and truncated-Gaussian i.i.d. prices) and S =
    5 (fig4: time-indexed trace replay) × R = 3 over every mesh: never an
    even split, some devices idle on d8. Trajectories, final iterates and
    both snapshots equal the unsharded run's bits."""
    _, data, w0 = quad
    batch, ref = fig_runs[grid]
    res = engine.simulate_sharded(batch, engine.quadratic_program(
        "minibatch", 4), w0, data, 3, FIG_CFG, mesh=MESHES[mesh]())
    assert res.errors.shape == ref.errors.shape
    assert np.isfinite(res.errors[..., 0]).all()
    _assert_same_run(res, ref)


def test_unknown_mesh_axes_are_refused(quad):
    """A mesh whose axes are not data/replica is a usage error, with the
    reference's message."""
    _, data, w0 = quad
    sc = engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0),
                         alpha=0.1, bid_schedule=np.tile([0.9], (4, 1)))
    for mesh in (Mesh(["cpu"], ("model",)),
                 Mesh([["cpu"]], ("data", "model"))):
        with pytest.raises(ValueError, match="'data'"):
            engine.simulate_sharded(
                [sc], engine.quadratic_program("full", 4), w0, data, 2,
                engine.SimConfig(n_ticks=4), mesh=mesh)


def test_shards_on_different_devices_run_at_once_and_in_order():
    """`_run_by_device`: the jobs of different devices at once (both wait
    on one barrier, which jobs run in series would never pass), the jobs of
    one device in turn, results in job order, an error re-raised."""
    barrier = threading.Barrier(2, timeout=30)
    seen = []

    def job(tag, wait):
        def run():
            if wait:
                barrier.wait()
            seen.append(tag)
            return tag
        return run

    meta, cpu = torch.device("meta"), torch.device("cpu")
    out = engine._run_by_device([(cpu, job("a", True)),
                                 (meta, job("b", True)),
                                 (cpu, job("c", False))])
    assert out == ["a", "b", "c"]
    assert seen.index("a") < seen.index("c")

    def boom():
        raise RuntimeError("shard failed")

    with pytest.raises(RuntimeError, match="shard failed"):
        engine._run_by_device([(cpu, job("a", False)), (meta, boom)])


# ---------------------------------------------------------------------------
# RNG-free pins: the port sharded against the reference unsharded
# ---------------------------------------------------------------------------

PIN_J, PIN_N = 12, 4


def _pin_scenarios(mod, trace, alpha):
    """tests/test_engine_parity.py's RNG-free regime: tick-indexed trace
    prices, a deterministic runtime; a time-latched plan table beside it."""
    table = np.stack([np.tile([0.9, 0.9, 0.5, 0.5], (PIN_J, 1)),
                      np.tile([0.95, 0.7, 0.7, 0.3], (PIN_J, 1))])
    return [
        mod.Scenario(price=mod.PriceSpec.from_trace_ticks(trace),
                     alpha=alpha, bid_schedule=np.tile(
                         [0.9, 0.9, 0.5, 0.5], (PIN_J, 1)),
                     rt_kind="det", rt_const=1.0, idle_step=0.5,
                     name="tick"),
        mod.Scenario(price=mod.PriceSpec.from_trace_ticks(trace[::-1]),
                     alpha=alpha, bid_table=table,
                     bucket_starts=np.array([0.0, 4.0], np.float32),
                     replan_at=3, rt_kind="det", rt_const=1.0,
                     idle_step=0.5, name="latched"),
        mod.Scenario(price=mod.PriceSpec.from_trace_ticks(trace[7:]),
                     alpha=alpha, bid_schedule=np.tile(
                         [0.7, 0.6, 0.5, 0.4], (PIN_J, 1)),
                     rt_kind="det", rt_const=0.7, idle_step=0.3,
                     name="spread"),
    ]


def _count_program(mod):
    """A program with no model, one call a tick over the grid: Σ mask as
    its metric (the reference calls such a program blocked)."""

    def step_fn(model, data, key, mask, j, alpha, running):
        return model, mask.sum(-1) + 0 * alpha

    if mod is jax_engine:
        return mod.ModelProgram(step_fn=step_fn, name="count", blocked=True)
    return mod.ModelProgram(step_fn=step_fn, name="count")


@pytest.fixture(scope="module")
def pins():
    """The reference's unsharded runs of the pins: the counting program,
    and the quadratic with the exact gradient."""
    trace = np.random.default_rng(7).uniform(0.2, 1.0, 97).astype(
        np.float32)
    jq = JaxQuadraticProblem(dim=6, n_samples=64, cond=5.0, noise=0.2,
                             seed=0)
    q = QuadraticProblem(dim=6, n_samples=64, cond=5.0, noise=0.2, seed=0)
    alpha = 0.4 / q.L
    w0 = np.asarray(q.w_star + 1.0, np.float32)
    seeds = [0, 1, 5]
    n_ticks = 3 * PIN_J
    cfg = engine.SimConfig(n_ticks=n_ticks, grad="full", batch=4)
    jcfg = jax_engine.SimConfig(n_ticks=n_ticks, grad="full", batch=4)
    jsc = _pin_scenarios(jax_engine, trace, alpha)
    jcount = jax_engine.simulate_program(
        jsc, _count_program(jax_engine), {"w": jnp.zeros(1)}, None, seeds,
        jcfg)
    jquad = jax_engine.simulate_program(
        jsc, jax_engine.quadratic_program("full", 4), jnp.asarray(w0),
        jax_engine.jax_quadratic(jq), seeds, jcfg)
    return dict(sc=_pin_scenarios(engine, trace, alpha), seeds=seeds,
                cfg=cfg, w0=torch.from_numpy(w0),
                data=engine.torch_quadratic(q, "cpu"), jcount=jcount,
                jquad=jquad)


@pytest.mark.parametrize("mesh", ["d8", "d2", "d4xr2", "d2xr2"])
def test_sharded_run_equals_the_reference_unsharded_on_rng_free_pins(
        pins, mesh):
    count = engine.simulate_sharded(
        pins["sc"], _count_program(engine), {"w": torch.zeros(1)}, None,
        pins["seeds"], pins["cfg"], mesh=MESHES[mesh]())
    assert (count.iterations == PIN_J).all()
    for f in FIELDS + ("J",):
        np.testing.assert_array_equal(getattr(count, f),
                                      np.asarray(getattr(pins["jcount"], f)),
                                      err_msg=f)
    quad = engine.simulate_sharded(
        pins["sc"], engine.quadratic_program("full", 4), pins["w0"],
        pins["data"], pins["seeds"], pins["cfg"], mesh=MESHES[mesh]())
    for f in ("costs", "times", "ys", "iterations", "total_time",
              "total_cost", "total_idle"):
        np.testing.assert_array_equal(getattr(quad, f),
                                      np.asarray(getattr(pins["jquad"], f)),
                                      err_msg=f)
    np.testing.assert_allclose(quad.errors, pins["jquad"].errors,
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# resume across mesh shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("save_on,resume_on", [
    ("d8", "d4"), ("d8", None), (None, "d2xr2"), ("d4xr2", "d3")])
def test_snapshot_resumes_on_another_mesh_shape(quad, tmp_path, save_on,
                                                resume_on):
    """The port of tests/test_checkpoint_sharded.py's
    test_kill_and_resume_across_mesh_shapes: a mid-run snapshot saved as 8
    shard files on one mesh (or unsharded) restores through
    ``restore_any`` and resumes on another mesh shape (or unsharded): bit
    for bit the uninterrupted run."""
    q, data, w0 = quad
    sc = [engine.Scenario(
        price=engine.PriceSpec.uniform(0.2, 1.0), alpha=0.4 / q.L,
        bid_schedule=np.tile([b, b, b], (12, 1)), rt_kind="exp",
        rt_lam=2.0, idle_step=0.5, name=f"b={b}")
        for b in [0.5, 0.6, 0.7, 0.85, 1.0]]
    batch = engine.stack_scenarios(sc, device="cpu")
    program = engine.quadratic_program("minibatch", 4)

    def run(mesh_name, cfg, **kw):
        if mesh_name is None:
            return engine.simulate_program(batch, program, w0, data, 3, cfg,
                                           device="cpu", **kw)
        return engine.simulate_sharded(batch, program, w0, data, 3, cfg,
                                       mesh=MESHES[mesh_name](), **kw)

    half = run(save_on, engine.SimConfig(n_ticks=30, snapshot_every=15))
    state, tick = engine.snapshot_state(half, 0)
    path = str(tmp_path / "grid.ckpt")
    ck.save_sharded(path, state, int(tick), n_shards=8)
    full = run(None, engine.SimConfig(n_ticks=30))
    like = engine.initial_state(batch, w0, 3, device="cpu")
    state, tick = ck.restore_any(path, like)
    assert tick == 15
    resumed = run(resume_on, engine.SimConfig(n_ticks=30), init_state=state,
                  tick0=tick)
    assert (half.snapshots.j[:, :, 0].numpy() < 12).any()
    _assert_same_run(resumed, full)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

J, N_W = 8, 4
TINY = dict(d_model=16, num_heads=2, num_kv_heads=1, d_ff=32, vocab_size=64,
            head_dim=8)


def _job():
    return JobConfig(model=ARCHS["qwen2-7b"].reduced().with_(**TINY),
                     shape=InputShape("t", 8, 4, "train"), n_workers=N_W,
                     learning_rate=0.1)


def _train_scenarios():
    def fixed(b, name):
        bids = np.asarray([b, b, 0.5, 0.5], float)
        return strat.FixedBids(bidding.BidPlan(
            n=N_W, n1=2, b1=float(b), b2=0.5, J=J, expected_cost=0,
            expected_time=0, expected_error=0), name=name)

    return [engine.scenario_from_strategy(
        fixed(b, f"g{i}"), alpha=0.1,
        rt=RuntimeModel(kind="exp", lam=2.0, delta=0.05),
        dist=UniformPrice(0.2, 1.0), n_max=N_W, idle_step=0.5,
        name=f"g{i}") for i, b in enumerate([0.9, 0.8, 0.7])]


@pytest.mark.parametrize("mesh", ["d8", "d2xr2"])
@pytest.mark.parametrize("program", ["cells", "megabatch", "fused"])
def test_train_batched_sharded_bit_for_bit(program, mesh):
    """The port of tests/test_sharded_parity.py's
    test_train_batched_sharded_bitexact: the per-cell program, the
    megabatch and the megabatch with the fused update, 3 scenarios × 3
    seeds, 14 ticks with a snapshot at 7, on the CPU: losses, snapshots,
    cost/time and every carry leaf equal the unsharded run's bits."""
    kw = {"cells": {}, "megabatch": dict(megabatch=True),
          "fused": dict(megabatch=True, use_fused_update=True)}[program]
    job = _job()
    ref = trainer.train_batched(job, _train_scenarios(), [0, 1, 2],
                                n_ticks=14, snapshot_every=7, device="cpu",
                                **kw)
    res = trainer.train_batched(job, _train_scenarios(), [0, 1, 2],
                                n_ticks=14, snapshot_every=7, device="cpu",
                                mesh=MESHES[mesh](), **kw)
    assert np.isfinite(res.errors[:, :, 0]).all()
    _assert_same_run(res, ref)


def test_train_zoo_sharded_bit_for_bit():
    """``train_zoo(mesh=)``: the zoo's per-cell program (bf16 mixed
    precision, the carry's params / masters / momentum) over a 2 × 2
    mesh, bit for bit the unsharded run."""
    job = JobConfig(
        model=ARCHS["qwen2-7b"].reduced().with_(
            dtype="bfloat16", param_dtype="bfloat16", **TINY),
        shape=InputShape("t", 8, 4, "train"), n_workers=N_W,
        learning_rate=0.1)
    sc = _train_scenarios()[:2]
    ref = trainer.train_zoo(job, sc, [0, 1, 2], n_ticks=10, snapshot_every=5,
                            device="cpu")
    res = trainer.train_zoo(job, sc, [0, 1, 2], n_ticks=10, snapshot_every=5,
                            device="cpu", mesh=MESHES["d2xr2"]())
    assert res.final_model["params"]["embed"].dtype == torch.bfloat16
    _assert_same_run(res, ref)


class _Killed(Exception):
    pass


class _KillBeforeSave:
    """Dies before the checkpoint of tick ``at``: the chunk's work lost,
    the previous checkpoint the newest."""

    def __init__(self, at):
        self.at = at

    def before_save(self, tick):
        if tick == self.at:
            raise _Killed(tick)


@pytest.mark.parametrize("resume_on", ["d2xr2", None])
def test_durable_megabatch_save_shards_resume_on_another_mesh(tmp_path,
                                                              resume_on):
    """``train_batched_durable(mesh=, save_shards=2)`` of the megabatch
    with the fused update, killed before its tick-16 save, resumed from
    the tick-8 shard files on another mesh shape or unsharded: bit for bit
    the straight unsharded run."""
    job = _job()
    sc = _train_scenarios()

    def program(n):
        return trainer.make_megabatch_train_program(job, n, True)

    def model0():
        return mb.init_megabatch_state(job.model, job, job.seed,
                                       device="cpu")

    kw = dict(n_ticks=24, save_every=8, save_shards=2, program=program,
              model0=model0, device="cpu")
    path = str(tmp_path / "ckpt")
    with pytest.raises(_Killed):
        trainer.train_batched_durable(job, sc, [0, 1, 2],
                                      checkpoint_path=path,
                                      mesh=MESHES["d8"](),
                                      hooks=_KillBeforeSave(16), **kw)
    assert ck.restore_any(path, trainer.batched_init_state(
        job, sc, [0, 1, 2], model0=model0, device="cpu"))[1] == 8
    with open(path) as f:
        assert len(json.load(f)["shards"]) == 2
    res = trainer.train_batched_durable(
        job, sc, [0, 1, 2], checkpoint_path=path,
        mesh=None if resume_on is None else MESHES[resume_on](), **kw)
    ref = trainer.train_batched(job, sc, [0, 1, 2], n_ticks=24,
                                megabatch=True, use_fused_update=True,
                                device="cpu")
    _assert_same_run(res, ref)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_train_launcher_mesh_2_by_2(monkeypatch):
    """``launch/train.py --batched --megabatch --fused-update --mesh 2
    --mesh-replica 2`` on four host devices: its result JSON reports the
    mesh's axis sizes, and each strategy's summary is the unsharded run's."""
    from repro_torch.launch import train as launch

    monkeypatch.setenv(HOST_DEVICES_ENV, "4")
    argv = ["--batched", "--megabatch", "--fused-update", "--device", "cpu",
            "--seeds", "3", "--iterations", "2", "--workers", "4",
            "--batch", "8", "--seq", "16"]
    _, plain = launch.run(launch.parse_args(argv))
    _, sharded = launch.run(launch.parse_args(
        argv + ["--mesh", "2", "--mesh-replica", "2"]))
    assert sharded.pop("_engine")["mesh"] == {"data": 2, "replica": 2}
    assert plain.pop("_engine")["mesh"] is None
    assert json.dumps(sharded, sort_keys=True, default=float) == \
        json.dumps(plain, sort_keys=True, default=float)


def _bidserve(*args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop(HOST_DEVICES_ENV, None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bidserve", "--device",
         "cpu", "--ticks", "160", "--json", *args],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rep = json.loads(out.stdout)
    for d in rep["decisions"]:
        d.pop("replan_latency_s")
    for k in ("replan_p50_ms", "replan_p95_ms", "decisions_per_sec"):
        rep["summary"].pop(k)
    return rep


def test_bidserve_devices_4_mesh_4_bit_for_bit_the_default():
    """``bidserve --devices 4 --mesh 4`` scores every slate over four host
    devices: every decision and the summary equal the default run's."""
    sharded = _bidserve("--devices", "4", "--mesh", "4")
    plain = _bidserve()
    assert sharded["decisions"]
    assert json.dumps(sharded, sort_keys=True) == \
        json.dumps(plain, sort_keys=True)


# ---------------------------------------------------------------------------
# the supervisor: kill, a truncated shard and an 8 → 4 shrink
# ---------------------------------------------------------------------------

SAVE_EVERY, N_TICKS = 6, 24


@pytest.mark.chaos
def test_supervisor_survives_kill_corrupt_and_shrink(tmp_path, monkeypatch):
    """The port of tests/test_supervisor.py's pinned scenario, on the CPU:
    ``mesh=8, save_shards=2`` over 8 host devices, a seeded plan with a
    mid-chunk SIGKILL, one truncated shard of the newest step and an 8 → 4
    device shrink. The run completes with two restarts, loses at most
    ``save_every`` ticks a fault, ends on a 4-device mesh, and its final
    carry is bit for bit the unfailed in-process run's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
    d = str(tmp_path)
    spec = WorkerSpec(
        overrides=TINY, bids=((0.9, 0.9, 0.5, 0.5), (0.8, 0.8, 0.6, 0.6),
                              (1.0, 1.0, 0.4, 0.4), (0.7, 0.7, 0.7, 0.7)),
        seeds=2, n_ticks=N_TICKS, save_every=SAVE_EVERY, keep_last=3,
        mesh=8, save_shards=2)
    spec.save(os.path.join(d, sup.SPEC_NAME))
    FaultPlan((Fault("kill", at_tick=10),
               Fault("corrupt", at_tick=16, mode="truncate_shard"),
               Fault("shrink", at_restart=2, devices=4)), seed=11).save(
        os.path.join(d, sup.PLAN_NAME))

    s = sup.Supervisor(d, sup.SupervisorConfig(
        max_restarts=6, backoff_base=0.05, backoff_cap=0.5,
        hang_timeout=600.0, devices=8, seed=11, device="cpu"))
    summary = s.run()

    assert summary["ok"], summary
    assert summary["final_tick"] == N_TICKS
    assert summary["restarts"] == 2
    assert summary["ticks_lost"] <= 2 * SAVE_EVERY
    assert summary["devices"] == 4
    rec = json.load(open(os.path.join(d, sup.RECOVERY_NAME)))
    assert [w["fault"] for w in rec["worker_events"]] == ["kill", "corrupt"]
    assert [e["devices"] for e in rec["events"]
            if e["event"] == "spawn"] == [8, 8, 4]
    qdir = os.path.join(d, sup.CKPT_DIRNAME, ck.QUARANTINE_DIRNAME)
    assert os.path.isdir(qdir) and os.listdir(qdir)
    result = json.load(open(os.path.join(d, sup.RESULT_NAME)))
    assert result["mesh_devices"] == 4 and result["device"] == "cpu"

    job, scenarios, seeds = build_workload(spec)
    like = trainer.batched_init_state(job, scenarios, seeds, device="cpu")
    state, tick, _ = ck.restore_newest(os.path.join(d, sup.CKPT_DIRNAME),
                                       like)
    assert tick == N_TICKS
    ref = trainer.train_batched(job, scenarios, seeds, n_ticks=N_TICKS,
                                device="cpu")
    for a, b in zip(tree_leaves(tuple(state)),
                    tree_leaves(tuple(ref.final_state))):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
