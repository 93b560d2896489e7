"""The port's legacy loop, per-cell batched trainer, snapshots and durable
chunk loop: the mirrors of tests/test_trainer_batched.py's parity, resume
and durable tests and of tests/test_system.py, plus the port against the
reference where both can run.

Within the port a resumed or chunked run is bit for bit the uninterrupted
one (every draw is keyed by the absolute tick). Against the reference the
grids are RNG-free (tick-replayed prices, a deterministic runtime) and
start from the reference's weights: the market trajectories (iterations,
active workers, clock, cost) are exact, losses and parameters within
float32 reduction-order tolerances. The legacy loop's cluster is numpy in
both packages, so on one seed the two loops see the same masks, clock and
cost."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import JobConfig as JaxJob
from repro.core import bidding as jax_bidding
from repro.core import strategies as jax_strat
from repro.core.cost_model import RuntimeModel as JaxRuntime
from repro.core.cost_model import UniformPrice as JaxUniform
from repro.sim import engine as jax_engine
from repro.sim.cluster import VolatileCluster as JaxCluster
from repro.sim.spot_market import IIDPrices as JaxIID
from repro.sim.spot_market import SpotMarket as JaxMarket
from repro.train import trainer as jax_trainer
from repro.train.train_step import init_train_state as jax_init
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core import bidding
from repro_torch.core import convergence as conv
from repro_torch.core import strategies as strat
from repro_torch.core.cost_model import RuntimeModel, UniformPrice
from repro_torch.sim import engine
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.sim.spot_market import (IIDPrices, SpotMarket, TickPrices)
from repro_torch.train import checkpoint as ck
from repro_torch.train import trainer
from repro_torch.train.trainer import (ElasticTrainer, restore_batched,
                                       resume_zoo, save_batched,
                                       train_batched, train_batched_durable,
                                       train_zoo)
from repro_torch.tree import tree_leaves

J = 12
N_W = 4
TINY = dict(d_model=64, num_heads=2, num_kv_heads=1, d_ff=128,
            vocab_size=256, head_dim=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_job(n_workers=N_W, b=8, s=16, **over):
    cfg = ARCHS["qwen2-7b"].reduced().with_(**TINY, **over)
    return JobConfig(model=cfg, shape=InputShape("t", s, b, "train"),
                     n_workers=n_workers, learning_rate=0.1)


def _jax_tiny_job(n_workers=N_W, b=8, s=16, **over):
    cfg = JAX_ARCHS["qwen2-7b"].reduced().with_(**TINY, **over)
    return JaxJob(model=cfg, shape=JaxShape("t", s, b, "train"),
                  n_workers=n_workers, learning_rate=0.1)


def _fixed(bids, J=J, name="fixed", mod_bidding=bidding, mod_strat=strat):
    bids = np.asarray(bids, float)
    n1 = int(np.sum(bids == bids[0]))
    return mod_strat.FixedBids(mod_bidding.BidPlan(
        n=len(bids), n1=n1, b1=float(bids[0]), b2=float(bids[-1]),
        J=J, expected_cost=0, expected_time=0, expected_error=0), name=name)


@pytest.fixture(scope="module")
def job():
    return _tiny_job()


def _bits(x):
    x = x.detach().contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes()


def _assert_results_bitexact(a, b):
    for f in ("losses", "costs", "times", "ys", "iterations", "total_time",
              "total_cost", "total_idle"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    la, lb = tree_leaves(a.final_model), tree_leaves(b.final_model)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and _bits(x) == _bits(y)


# ---------------------------------------------------------------------------
# tests/test_trainer_batched.py: the per-cell program against the loop
# ---------------------------------------------------------------------------


def test_batched_trainer_matches_legacy_loop(job):
    """Loss/cost/time trajectories of the per-cell program pinned to the
    legacy loop on a shared tick-replayed price trace."""
    dist = UniformPrice(0.2, 1.0)
    trace = dist.sample(np.random.default_rng(7), size=200).astype(
        np.float32)
    rt = RuntimeModel(kind="det", r_const=1.0)
    plan = _fixed([0.9, 0.9, 0.5, 0.5], name="two-bids")

    def make():
        return ElasticTrainer(
            job=job, strategy=plan, mode="spot", device="cpu",
            cluster=VolatileCluster(n_workers=N_W, runtime=rt,
                                    idle_step=0.5,
                                    market=SpotMarket(TickPrices(trace))))

    summary = make().run(iterations=J)
    r = make().run_batched(seeds=[0], iterations=J, n_ticks=60).result
    assert r.iterations[0, 0] == J == summary["iterations"]
    np.testing.assert_allclose(r.losses[0, 0, :J],
                               [e.loss for e in summary["log"]],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r.times[0, 0, :J],
                               [e.time for e in summary["log"]],
                               rtol=1e-5, atol=1e-4)
    assert r.total_cost[0, 0] == pytest.approx(summary["cost"], rel=1e-4)
    assert r.total_idle[0, 0] == pytest.approx(summary["idle"], rel=1e-5,
                                               abs=1e-4)
    np.testing.assert_array_equal(r.ys[0, 0, :J],
                                  [e.y for e in summary["log"]])


def test_batched_trainer_grid_multiseed(job):
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    grid = {"high": _fixed([1.0] * N_W, name="high"),
            "split": _fixed([1.0, 1.0, 0.5, 0.5], name="split")}
    tr = ElasticTrainer(
        job=job, strategy=grid["high"], mode="spot", device="cpu",
        cluster=VolatileCluster(
            n_workers=N_W, runtime=rt, idle_step=0.5,
            market=SpotMarket(IIDPrices(UniformPrice(0.2, 1.0), seed=0))))
    bres = tr.run_batched(seeds=2, iterations=J, strategies=grid,
                          n_ticks=80)
    r = bres.result
    assert r.losses.shape == (2, 2, J)
    assert (r.iterations == J).all() and np.isfinite(r.losses).all()
    assert (r.losses[:, :, -1] < r.losses[:, :, 0]).all()
    i_hi, i_sp = bres.index("high"), bres.index("split")
    assert r.total_cost[i_hi].mean() > r.total_cost[i_sp].mean()
    assert not np.allclose(r.total_cost[:, 0], r.total_cost[:, 1])
    assert tree_leaves(r.final_model)[0].shape[:2] == (2, 2)


def test_idle_ticks_are_true_noop(job):
    """Interleaving unaffordable prices changes time and idle, and leaves
    the loss trajectory and every final parameter bit for bit."""
    plan = _fixed([0.6] * N_W)
    base = np.full(J, 0.5, np.float32)
    spiky = np.ones(2 * J, np.float32) * 2.0
    spiky[1::2] = base

    def run(trace, n_ticks):
        sc = engine.Scenario(
            price=engine.PriceSpec.from_trace_ticks(trace), alpha=0.0,
            bid_schedule=np.tile(plan.plan_.bids, (J, 1)),
            rt_kind="det", rt_const=1.0, idle_step=0.25)
        return train_batched(job, [sc], seeds=[0], n_ticks=n_ticks,
                             device="cpu")

    clean, noisy = run(base, J), run(spiky, 2 * J)
    assert clean.iterations[0, 0] == noisy.iterations[0, 0] == J
    assert noisy.total_idle[0, 0] > 0 and clean.total_idle[0, 0] == 0
    np.testing.assert_array_equal(clean.losses[0, 0, :J],
                                  noisy.losses[0, 0, :J])
    for a, b in zip(tree_leaves(clean.final_model),
                    tree_leaves(noisy.final_model)):
        assert _bits(a) == _bits(b)


def test_run_batched_preemptible_pads_fleet(job):
    rt = RuntimeModel(kind="det", r_const=1.0)
    plan = strat.DynamicWorkers(n0=3, eta=1.0, J=J, name="static3")
    tr = ElasticTrainer(
        job=job, strategy=plan, mode="preemptible", device="cpu",
        cluster=VolatileCluster(n_workers=N_W, runtime=rt, preempt_q=0.3,
                                on_demand_price=0.5, idle_step=0.25))
    r = tr.run_batched(seeds=[0, 1], iterations=J, n_ticks=60).result
    assert (r.iterations == J).all()
    assert np.nanmax(r.ys[0, :, :J]) <= 3
    assert np.isfinite(r.losses[0, :, :J]).all()


def test_train_batched_rejects_fleet_mismatch(job):
    sc = engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0),
                         alpha=0.0, bid_schedule=np.tile([0.9, 0.9], (J, 1)))
    with pytest.raises(ValueError, match="fleet width"):
        train_batched(job, [sc], seeds=[0], n_ticks=4, device="cpu")


# ---------------------------------------------------------------------------
# snapshots, resume and the durable loop: bit for bit within the port
# ---------------------------------------------------------------------------


def _grid():
    return [engine.scenario_from_strategy(
        _fixed([0.9, 0.9, 0.5, 0.5], name=f"g{i}"), alpha=0.1,
        rt=RuntimeModel(kind="exp", lam=2.0, delta=0.05),
        dist=UniformPrice(0.2, 1.0), n_max=N_W, idle_step=0.5,
        name=f"g{i}") for i in range(2)]


@pytest.mark.parametrize("megabatch", [False, True])
def test_kill_and_resume_batched_is_bitexact(job, tmp_path, megabatch):
    """A grid preempted mid-run, persisted, restored and resumed ends bit
    for bit where the uninterrupted run ends (the per-cell carry and the
    megabatch one)."""
    kw = dict(megabatch=megabatch, use_fused_update=megabatch,
              device="cpu")
    scenarios, seeds, n_ticks, k = _grid(), [0, 1], 30, 8
    full = train_batched(job, scenarios, seeds=seeds, n_ticks=n_ticks,
                         snapshot_every=k, **kw)
    np.testing.assert_array_equal(full.snapshot_ticks, [8, 16, 24])
    path = str(tmp_path / "batched.npz")
    assert save_batched(path, full, index=0) == 8
    state, tick = restore_batched(path, job, scenarios, seeds,
                                  megabatch=megabatch, device="cpu")
    resumed = train_batched(job, scenarios, seeds=seeds, n_ticks=n_ticks,
                            init_state=state, tick0=tick, **kw)
    _assert_results_bitexact(resumed, full)


def test_resume_preserves_snapshot_stream(job, tmp_path):
    scenarios, seeds, n_ticks, k = _grid(), [0], 30, 10
    full = train_batched(job, scenarios, seeds=seeds, n_ticks=n_ticks,
                         snapshot_every=k, device="cpu")
    path = str(tmp_path / "batched.npz")
    save_batched(path, full, index=0)
    state, tick = restore_batched(path, job, scenarios, seeds, device="cpu")
    resumed = train_batched(job, scenarios, seeds=seeds, n_ticks=n_ticks,
                            init_state=state, tick0=tick, snapshot_every=k,
                            device="cpu")
    np.testing.assert_array_equal(resumed.snapshot_ticks, [20, 30])
    last = [engine.snapshot_state(r, -1)[0] for r in (full, resumed)]
    for a, b in zip(tree_leaves(tuple(last[0])), tree_leaves(tuple(last[1]))):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("save_shards,async_save,keep_last", [
    (None, False, None), (2, False, None), (None, True, None),
    (2, True, 2)])
def test_train_batched_durable_chunks_and_resumes(job, tmp_path,
                                                  save_shards, async_save,
                                                  keep_last):
    """Per-chunk persistence is bit for bit the single-call run, and a
    killed run (a shorter first call) resumes from the file and lands bit
    for bit — flat or sharded, synchronous or through the writer thread,
    one file or step directories."""
    scenarios, seeds, n_ticks = _grid(), [0, 1], 30
    kw = dict(save_every=7, save_shards=save_shards, async_save=async_save,
              keep_last=keep_last, device="cpu")
    full = train_batched(job, scenarios, seeds=seeds, n_ticks=n_ticks,
                         device="cpu")
    path = str(tmp_path / "durable")
    durable = train_batched_durable(job, scenarios, seeds=seeds,
                                    n_ticks=n_ticks, checkpoint_path=path,
                                    **kw)
    _assert_results_bitexact(durable, full)
    like = trainer.batched_init_state(job, scenarios, seeds, device="cpu")
    if keep_last:
        assert ck.list_steps(path) == [28, 30]
        assert ck.restore_newest(path, like)[1] == n_ticks
    else:
        assert ck.restore_any(path, like)[1] == n_ticks

    path2 = str(tmp_path / "killed")
    train_batched_durable(job, scenarios, seeds=seeds, n_ticks=14,
                          checkpoint_path=path2, **kw)
    resumed = train_batched_durable(job, scenarios, seeds=seeds,
                                    n_ticks=n_ticks, checkpoint_path=path2,
                                    **kw)
    _assert_results_bitexact(resumed, full)


def test_durable_hooks_see_every_boundary(job, tmp_path):
    """The hook protocol: one resume, then before_chunk / before_save /
    after_save at every chunk boundary, with the landed path."""
    seen = []

    class Hooks:
        def on_resume(self, tick, path):
            seen.append(("resume", tick, path))

        def before_chunk(self, tick, state):
            seen.append(("chunk", tick))

        def before_save(self, tick):
            seen.append(("computed", tick))

        def after_save(self, tick, path):
            seen.append(("saved", tick, path.endswith("ckpt")))

    root = str(tmp_path / "ckpt")
    train_batched_durable(job, _grid()[:1], seeds=[0], n_ticks=10,
                          checkpoint_path=root, save_every=5, keep_last=1,
                          hooks=Hooks(), device="cpu")
    assert seen == [("resume", 0, None), ("chunk", 0), ("computed", 5),
                    ("saved", 5, True), ("chunk", 5), ("computed", 10),
                    ("saved", 10, True)]
    assert ck.list_steps(root) == [10]


def test_elastic_trainer_run_and_resume_batched(job, tmp_path):
    rt = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    path = str(tmp_path / "trainer.npz")
    grid = {"high": _fixed([1.0] * N_W, name="high"),
            "split": _fixed([1.0, 1.0, 0.5, 0.5], name="split")}

    def make(ckpt):
        return ElasticTrainer(
            job=job, strategy=grid["high"], mode="spot",
            checkpoint_path=ckpt, device="cpu",
            cluster=VolatileCluster(
                n_workers=N_W, runtime=rt, idle_step=0.5,
                market=SpotMarket(IIDPrices(UniformPrice(0.2, 1.0)))))

    n_ticks = 24
    uninterrupted = make(None).run_batched(
        seeds=2, iterations=J, strategies=grid, n_ticks=n_ticks)
    res = make(path).run_batched(seeds=2, iterations=J, strategies=grid,
                                 n_ticks=n_ticks, snapshot_every=8)
    save_batched(path, res.result, index=0)
    resumed = make(path).resume_batched(seeds=2, iterations=J,
                                        strategies=grid, n_ticks=n_ticks)
    assert resumed.names == uninterrupted.names
    _assert_results_bitexact(resumed.result, uninterrupted.result)


# ---------------------------------------------------------------------------
# bf16 zoo runs: durable resume and resume_zoo, bit for bit
# ---------------------------------------------------------------------------


def _zoo_job():
    cfg = ARCHS["internvl2-1b"].reduced().with_(
        d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
        vocab_size=128, dtype="bfloat16", param_dtype="bfloat16",
        use_flash_attention=True)
    return JobConfig(model=cfg, shape=InputShape("t", 24, 8, "train"),
                     n_workers=8, learning_rate=0.1)


def _zoo_scenarios():
    return [engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0),
                            alpha=0.1, bid_schedule=np.tile(
                                [0.9] * 4 + [0.5] * 4, (8, 1)),
                            rt_kind="exp", rt_lam=2.0, rt_delta=0.05,
                            idle_step=0.5, name="s0")]


def test_bf16_train_zoo_durable_resume_is_bitexact(tmp_path):
    """A bf16 zoo run killed after its second chunk (a shorter first call)
    and resumed from its step directory ends bit for bit where the
    uninterrupted run ends: bf16 params, float32 masters and momentum,
    trajectories, clock and cost."""
    job, scenarios = _zoo_job(), _zoo_scenarios()
    full = train_zoo(job, scenarios, [0, 1], n_ticks=16, device="cpu")
    root = str(tmp_path / "ckpt")
    kw = dict(checkpoint_path=root, save_every=4, keep_last=2,
              device="cpu")
    train_zoo(job, scenarios, [0, 1], n_ticks=8, **kw)
    assert ck.list_steps(root) == [4, 8]
    with np.load(ck.step_path(root, 8)) as f:
        assert any("['params']" in k for k in f["__bf16__"].tolist())
    resumed = train_zoo(job, scenarios, [0, 1], n_ticks=16, **kw)
    _assert_results_bitexact(resumed, full)
    assert resumed.final_model["params"]["embed"].dtype == torch.bfloat16


def test_resume_zoo_continues_a_snapshot_bit_for_bit(tmp_path):
    job, scenarios = _zoo_job(), _zoo_scenarios()
    full = train_zoo(job, scenarios, [0], n_ticks=16, snapshot_every=4,
                     device="cpu")
    path = str(tmp_path / "zoo.npz")
    assert save_batched(path, full, index=1) == 8
    state, tick = resume_zoo(path, job, scenarios, [0], device="cpu")
    resumed = train_zoo(job, scenarios, [0], n_ticks=16, init_state=state,
                        tick0=tick, device="cpu")
    _assert_results_bitexact(resumed, full)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


TRACE = np.random.default_rng(11).uniform(0.2, 1.0, 64).astype(np.float32)
BIDS = ([0.9, 0.9, 0.5, 0.5], [0.8, 0.8, 0.8, 0.3])


def _rng_free(mod_engine):
    return [mod_engine.Scenario(
        price=mod_engine.PriceSpec.from_trace_ticks(TRACE), alpha=0.1,
        bid_schedule=np.tile(b, (8, 1)), rt_kind="det", rt_const=1.0,
        idle_step=0.5, name=f"s{i}") for i, b in enumerate(BIDS)]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's per-cell train_batched and its durable loop on the
    RNG-free grid, and its initial (params, opt_state)."""
    jjob = _jax_tiny_job()
    d = tmp_path_factory.mktemp("ref")
    full = jax_trainer.train_batched(jjob, _rng_free(jax_engine), [0],
                                     n_ticks=20, donate=False)
    durable = jax_trainer.train_batched_durable(
        jjob, _rng_free(jax_engine), [0], n_ticks=20,
        checkpoint_path=str(d / "ckpt"), save_every=6, keep_last=2)
    init = jax.tree.map(np.asarray, jax_init(
        jjob.model, jjob, jax.random.PRNGKey(jjob.seed)))
    return full, durable, init


@pytest.mark.parametrize("durable", [False, True])
def test_per_cell_training_matches_reference(tmp_path, reference_runs,
                                             durable):
    """The per-cell program (the reference's vmapped path) from the
    reference's weights on an RNG-free grid, straight and through the
    durable loop: the market exactly, losses within 1e-5 and every final
    parameter and momentum within 1e-5 (float32 reduction order)."""
    full, jdurable, init = reference_runs
    job = _tiny_job()
    model0 = convert.tree_from_reference(init, device="cpu")
    if durable:
        res = train_batched_durable(
            job, _rng_free(engine), [0], n_ticks=20, model0=model0,
            checkpoint_path=str(tmp_path / "ckpt"), save_every=6,
            keep_last=2, device="cpu")
        ref = jdurable
    else:
        res = train_batched(job, _rng_free(engine), [0], n_ticks=20,
                            model0=model0, device="cpu")
        ref = full
    assert (res.iterations == 8).all()
    for f in ("iterations", "ys", "costs", "times", "total_time",
              "total_cost", "total_idle"):
        np.testing.assert_array_equal(getattr(res, f),
                                      np.asarray(getattr(ref, f)))
    np.testing.assert_allclose(res.losses, np.asarray(ref.losses),
                               rtol=1e-5, atol=1e-5)
    a, b = tree_leaves(res.final_model), jax.tree.leaves(ref.final_model)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)


def _loop_pair(tmp_path, every=0):
    """The reference's and the port's legacy loop on one market seed, the
    port starting from the reference's weights."""
    jjob, job = _jax_tiny_job(), _tiny_job()
    jplan = _fixed([0.9, 0.9, 0.5, 0.5], mod_bidding=jax_bidding,
                   mod_strat=jax_strat)
    plan = _fixed([0.9, 0.9, 0.5, 0.5])
    jpath = str(tmp_path / "ref.npz") if every else None
    ref = jax_trainer.ElasticTrainer(
        job=jjob, strategy=jplan, mode="spot", checkpoint_path=jpath,
        checkpoint_every=every, seed=2,
        cluster=JaxCluster(n_workers=N_W, seed=4, idle_step=0.5,
                           runtime=JaxRuntime(kind="exp", lam=2.0,
                                              delta=0.05),
                           market=JaxMarket(JaxIID(JaxUniform(0.2, 1.0),
                                                   seed=3))))
    ours = ElasticTrainer(
        job=job, strategy=plan, mode="spot", seed=2, device="cpu",
        cluster=VolatileCluster(n_workers=N_W, seed=4, idle_step=0.5,
                                runtime=RuntimeModel(kind="exp", lam=2.0,
                                                     delta=0.05),
                                market=SpotMarket(IIDPrices(
                                    UniformPrice(0.2, 1.0), seed=3))))
    ours.params = convert.tree_from_reference(
        jax.tree.map(np.asarray, ref.params), device="cpu")
    ours.opt_state = convert.tree_from_reference(
        jax.tree.map(np.asarray, ref.opt_state), device="cpu")
    return ref, ours


def test_elastic_trainer_run_matches_reference_loop(tmp_path):
    """Same cluster seed, same weights: the same masks, clock and cost
    every iteration, losses and final parameters within 1e-5."""
    ref, ours = _loop_pair(tmp_path)
    a, b = ref.run(iterations=J), ours.run(iterations=J)
    for f in ("iterations", "time", "cost", "idle"):
        assert a[f] == b[f], f
    assert [e.y for e in a["log"]] == [e.y for e in b["log"]]
    np.testing.assert_allclose([e.loss for e in b["log"]],
                               [e.loss for e in a["log"]], rtol=1e-5,
                               atol=1e-5)
    for x, y in zip(tree_leaves(ours.params), jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)


def test_elastic_trainer_restores_the_reference_checkpoint(tmp_path):
    """The reference's legacy loop checkpoints at iteration 4; the port's
    trainer restores that file bit for bit and finishes the job, where
    the reference's own restored trainer lands within 1e-5."""
    ref, _ = _loop_pair(tmp_path, every=4)
    ref.run(iterations=6)
    _, ours = _loop_pair(tmp_path, every=4)
    ours.checkpoint_path, ours.checkpoint_every = ref.checkpoint_path, 0
    ours.restore()
    assert ours._j == 4
    saved, _ = jax_trainer.ckpt_mod.restore(
        ref.checkpoint_path, {"params": ref.params, "opt": ref.opt_state})
    for x, y in zip(tree_leaves(ours.params),
                    jax.tree.leaves(saved["params"])):
        assert x.numpy().tobytes() == np.asarray(y).tobytes()
    ref2, _ = _loop_pair(tmp_path)
    ref2.checkpoint_path = ref.checkpoint_path
    ref2.restore()
    for pair in (ref2, ours):
        for j in range(4):
            pair.cluster.next_iteration_spot(
                j, np.asarray(pair.strategy.bids(pair.cluster.t, j)))
    a, b = ref2.run(iterations=J), ours.run(iterations=J)
    assert (a["time"], a["cost"]) == (b["time"], b["cost"])
    np.testing.assert_allclose([e.loss for e in b["log"]],
                               [e.loss for e in a["log"]], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# tests/test_system.py: the pipeline end to end through the legacy loop
# ---------------------------------------------------------------------------

PROB = conv.SGDProblem(alpha=0.05, c=1.0, mu=1.0, L=2.0, M=4.0, G0=10.0)
RT = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
DIST = UniformPrice(0.2, 1.0)


def _sys_job(arch="internvl2-1b", n_workers=4, b=8, s=32):
    return JobConfig(model=ARCHS[arch].reduced(),
                     shape=InputShape("t", s, b, "train"),
                     n_workers=n_workers, learning_rate=0.1)


def _cluster(n, seed=0):
    return VolatileCluster(n_workers=n, runtime=RT,
                           market=SpotMarket(IIDPrices(DIST, seed=seed)),
                           seed=seed)


def test_spot_training_end_to_end():
    plan = strat.optimal_one_bid(PROB, 0.5, 2000.0, 4, DIST, RT)
    summary = ElasticTrainer(job=_sys_job(), cluster=_cluster(4),
                             strategy=plan, mode="spot",
                             device="cpu").run(iterations=12)
    assert summary["iterations"] == 12 and summary["cost"] > 0
    assert np.isfinite(summary["final_loss"])
    losses = [e.loss for e in summary["log"]]
    assert losses[-1] < losses[0] * 1.2


def test_two_bid_strategy_sees_partial_fleets():
    plan = strat.FixedBids(
        bidding.BidPlan(n=4, n1=2, b1=0.95, b2=0.4, J=40, expected_cost=0,
                        expected_time=0, expected_error=0), name="manual")
    summary = ElasticTrainer(job=_sys_job(s=24), cluster=_cluster(4, seed=3),
                             strategy=plan, mode="spot",
                             device="cpu").run(iterations=40)
    ys = {e.y for e in summary["log"]}
    assert 2 in ys and 4 in ys, ys


def test_preemptible_dynamic_workers_end_to_end():
    cluster = VolatileCluster(n_workers=8, runtime=RT, preempt_q=0.4, seed=1)
    summary = ElasticTrainer(
        job=_sys_job(arch="deepseek-7b", n_workers=8), cluster=cluster,
        strategy=strat.DynamicWorkers(n0=2, eta=1.2, J=10),
        mode="preemptible", device="cpu").run()
    assert summary["iterations"] == 10
    assert max(e.y for e in summary["log"]) <= 8
    assert np.isfinite(summary["final_loss"])


def test_dynamic_bids_reoptimizes_midjob():
    dyn = strat.DynamicBids(PROB, eps=0.5, theta=3000.0, dist=DIST, rt=RT,
                            stage1=(2, 4), stage2=(4, 8), switch_at=5)

    class PaddedDyn(strat.Strategy):
        name = "padded-dynamic"

        def bids(self, t, j):
            b = dyn.bids(t, j)
            return np.pad(b, (0, 8 - len(b)), constant_values=DIST.lo - 1)

        @property
        def total_iterations(self):
            return dyn.total_iterations

    summary = ElasticTrainer(job=_sys_job(n_workers=8, b=8),
                             cluster=_cluster(8, seed=7),
                             strategy=PaddedDyn(), mode="spot",
                             device="cpu").run(iterations=10)
    assert np.isfinite(summary["final_loss"])
    assert len(summary["log"]) == 10


def test_launcher_runs_the_legacy_loop_and_the_per_cell_grid():
    from repro_torch.launch import train as launch

    base = ["--device", "cpu", "--iterations", "2", "--workers", "4",
            "--batch", "8", "--seq", "16", "--seeds", "1"]
    _, summary = launch.run(launch.parse_args(["--local"] + base))
    assert summary["iterations"] == 2 and "log" not in summary
    res, summary = launch.run(launch.parse_args(["--batched"] + base))
    assert summary["_engine"]["megabatch"] is False
    assert dataclasses.is_dataclass(res.result)
