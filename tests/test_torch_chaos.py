"""The port's fault plans and their execution machinery
(`repro_torch.chaos`), mirroring tests/test_chaos_plan.py: JSON
round-trips, seeded determinism, checkpoint corruption that surfaces as a
named `CheckpointError`, transient-I/O injection against the writer's
retry-with-backoff, the fired-fault ledger, and the in-place NaN poison.
Plans, seeded random plans and worker specs are the reference's, byte for
byte: a file written by either package loads in the other."""
import json
import os

import numpy as np
import pytest
import torch

from repro import chaos as jax_chaos
from repro.launch import workload as jax_workload
from repro_torch.chaos import (CORRUPT_MODES, KINDS, Fault, FaultInjector,
                               FaultLedger, FaultPlan, FlakyIO,
                               corrupt_checkpoint, poison_model)
from repro_torch.launch import workload
from repro_torch.sim import engine
from repro_torch.train import checkpoint as ck


def _state(rows=8):
    return {"a": torch.arange(rows * 2, dtype=torch.float32).reshape(rows, 2),
            "b": torch.ones(rows, 3)}


def _like(rows=8):
    return {k: torch.zeros_like(v) for k, v in _state(rows).items()}


# ---------------------------------------------------------------------------
# plan construction + JSON io
# ---------------------------------------------------------------------------


def _plan():
    return FaultPlan((Fault("kill", at_tick=10),
                      Fault("corrupt", at_tick=16, mode="torn_manifest"),
                      Fault("shrink", at_restart=1, devices=4),
                      Fault("hang", at_tick=3, duration=42.0),
                      Fault("io_error", at_tick=5, count=2)), seed=7)


def test_plan_json_roundtrip(tmp_path):
    plan = _plan()
    p = str(tmp_path / "plan.json")
    plan.save(p)
    assert FaultPlan.load(p) == plan
    doc = json.loads(plan.to_json())
    assert "mode" not in doc["faults"][0]
    assert "at_tick" not in doc["faults"][2]


def test_plan_files_interchange_with_the_reference(tmp_path):
    plan = _plan()
    assert (KINDS, CORRUPT_MODES) == (jax_chaos.KINDS,
                                      jax_chaos.CORRUPT_MODES)
    ref = jax_chaos.FaultPlan(tuple(jax_chaos.Fault(**f.to_dict())
                                    for f in plan.faults), seed=plan.seed)
    assert ref.to_json() == plan.to_json()
    p = str(tmp_path / "plan.json")
    ref.save(p)
    assert FaultPlan.load(p) == plan
    plan.save(p)
    assert jax_chaos.FaultPlan.load(p) == ref


def test_plan_rejects_wrong_format_and_bad_faults():
    with pytest.raises(ValueError, match="repro-fault-plan"):
        FaultPlan.from_json('{"faults": []}')
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor", at_tick=1)
    with pytest.raises(ValueError, match="at_tick"):
        Fault("kill")
    with pytest.raises(ValueError, match="at_restart"):
        Fault("shrink", devices=4)
    with pytest.raises(ValueError, match="corrupt mode"):
        Fault("corrupt", at_tick=1, mode="gamma_ray")


@pytest.mark.parametrize("seed,kinds", [
    (5, None), (6, None), (11, ("kill", "corrupt", "nan")),
    (3, ("shrink", "io_error", "hang"))])
def test_random_plan_is_seed_deterministic(seed, kinds):
    """The same seed gives the same plan, and the reference's plan for
    that seed, JSON for JSON."""
    a = FaultPlan.random(seed=seed, n_ticks=64, save_every=8, kinds=kinds,
                         n_faults=6)
    b = FaultPlan.random(seed=seed, n_ticks=64, save_every=8, kinds=kinds,
                         n_faults=6)
    c = FaultPlan.random(seed=seed + 100, n_ticks=64, save_every=8,
                         kinds=kinds, n_faults=6)
    assert a == b and a != c
    ref = jax_chaos.FaultPlan.random(seed=seed, n_ticks=64, save_every=8,
                                     kinds=kinds, n_faults=6)
    assert a.to_json() == ref.to_json()
    for f in a.faults:
        if f.kind != "shrink":
            assert 0 < f.at_tick < 64


def test_by_kind_preserves_plan_indices():
    plan = FaultPlan((Fault("kill", at_tick=1),
                      Fault("shrink", at_restart=0, devices=2),
                      Fault("kill", at_tick=9)))
    assert plan.by_kind("kill") == [(0, plan.faults[0]),
                                    (2, plan.faults[2])]


# ---------------------------------------------------------------------------
# worker specs: the reference's format
# ---------------------------------------------------------------------------


def _spec_kw():
    return dict(arch="internvl2-1b", reduce_depth=24,
                param_dtype="bfloat16", zoo=True,
                overrides={"use_flash_attention": 1}, n_workers=8,
                global_batch=8, seq_len=1024,
                bids=((0.9, 0.9, 0.9, 0.9, 0.5, 0.5, 0.5, 0.5),),
                iterations=8, seeds=1, n_ticks=24, save_every=8,
                keep_last=2)


def test_worker_spec_files_interchange_with_the_reference(tmp_path):
    ours = workload.WorkerSpec(**_spec_kw())
    theirs = jax_workload.WorkerSpec(**_spec_kw())
    assert workload.SPEC_FORMAT == jax_workload.SPEC_FORMAT
    assert ours.to_json() == theirs.to_json()
    p = str(tmp_path / "spec.json")
    theirs.save(p)
    assert workload.WorkerSpec.load(p) == ours
    ours.save(p)
    assert jax_workload.WorkerSpec.load(p) == theirs
    assert workload.WorkerSpec().to_json() == \
        jax_workload.WorkerSpec().to_json()


def test_worker_spec_rejects_bad_documents():
    with pytest.raises(ValueError, match="repro-worker-spec"):
        workload.WorkerSpec.from_json('{"arch": "qwen2-7b"}')
    doc = json.loads(workload.WorkerSpec().to_json())
    doc["meteor"] = 1
    with pytest.raises(ValueError, match="unknown spec fields"):
        workload.WorkerSpec.from_json(json.dumps(doc))
    with pytest.raises(ValueError, match="unknown arch"):
        workload.WorkerSpec(arch="gpt-5")
    with pytest.raises(ValueError, match="n_workers"):
        workload.WorkerSpec(bids=((0.9, 0.5),))


def test_build_workload_matches_the_reference():
    """The same spec builds the same job and the same scenario grid in
    both packages."""
    ours = workload.build_workload(workload.WorkerSpec(**_spec_kw()))
    theirs = jax_workload.build_workload(
        jax_workload.WorkerSpec(**_spec_kw()))
    (job, scenarios, seeds), (jjob, jscenarios, jseeds) = ours, theirs
    assert seeds == jseeds == [0]
    cfg, jcfg = job.model, jjob.model
    for f in ("name", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "d_ff", "vocab_size", "dtype", "param_dtype",
              "use_flash_attention"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.use_flash_attention == 1
    assert (job.n_workers, job.learning_rate, job.shape.seq_len,
            job.shape.global_batch) == (jjob.n_workers, jjob.learning_rate,
                                        jjob.shape.seq_len,
                                        jjob.shape.global_batch)
    for s, js in zip(scenarios, jscenarios):
        np.testing.assert_array_equal(s.bid_schedule, js.bid_schedule)
        assert (s.name, s.alpha, s.rt_kind, s.rt_lam, s.idle_step) == \
            (js.name, js.alpha, js.rt_kind, js.rt_lam, js.idle_step)
        assert (s.price.kind, s.price.lo, s.price.hi) == \
            (js.price.kind, js.price.lo, js.price.hi)


# ---------------------------------------------------------------------------
# checkpoint corruption → named CheckpointError on restore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [None, 3])
def test_truncate_shard_breaks_restore(tmp_path, n_shards):
    p = str(tmp_path / "c.ckpt")
    if n_shards:
        ck.save_sharded(p, _state(), step=4, n_shards=n_shards)
    else:
        ck.save(p, _state(), step=4)
    detail = corrupt_checkpoint(p, "truncate_shard",
                                np.random.default_rng(0))
    assert "truncated" in detail
    with pytest.raises(ck.CheckpointError):
        ck.restore_any(p, _like())


def test_torn_manifest_breaks_restore(tmp_path):
    p = str(tmp_path / "c.ckpt")
    ck.save_sharded(p, _state(), step=4, n_shards=2)
    corrupt_checkpoint(p, "torn_manifest")
    with pytest.raises(ck.CheckpointError):
        ck.restore_any(p, _like())


def test_stale_tmp_is_harmless(tmp_path):
    p = str(tmp_path / "c.ckpt")
    ck.save_sharded(p, _state(), step=4, n_shards=2)
    corrupt_checkpoint(p, "stale_tmp")
    assert any(".tmp" in f for f in os.listdir(tmp_path))
    got, step = ck.restore_any(p, _like())
    assert step == 4
    for k in got:
        assert torch.equal(got[k], _state()[k])


# ---------------------------------------------------------------------------
# transient I/O injection vs the writer's retry-with-backoff
# ---------------------------------------------------------------------------


def test_flaky_io_is_retried_by_sync_retry_io(tmp_path):
    flaky = FlakyIO()
    flaky.arm(2)
    try:
        sleeps = []
        ck.retry_io(ck.save, str(tmp_path / "x.npz"), _state(), 3,
                    sleep=sleeps.append)
        assert sleeps == [0.05, 0.1]
        assert ck.restore_any(str(tmp_path / "x.npz"), _like())[1] == 3
        assert flaky.remaining == 0
    finally:
        flaky.disarm()


def test_flaky_io_exhausts_retries(tmp_path):
    flaky = FlakyIO()
    flaky.arm(5)
    try:
        with pytest.raises(OSError, match="disk full"):
            ck.retry_io(ck.save, str(tmp_path / "x.npz"), _state(), 3,
                        retries=2, sleep=lambda s: None)
        assert flaky.remaining == 2
    finally:
        flaky.disarm()


def test_async_writer_retries_transient_then_defers_fatal(tmp_path):
    flaky = FlakyIO()
    try:
        with ck.AsyncCheckpointWriter(retries=3, backoff=0.0) as w:
            flaky.arm(2)
            w.submit(str(tmp_path / "x.npz"), _state(), 1)
            w.wait()
            assert ck.restore_any(str(tmp_path / "x.npz"), _like())[1] == 1
        flaky.arm(10)
        w2 = ck.AsyncCheckpointWriter(retries=1, backoff=0.0)
        w2.submit(str(tmp_path / "y.npz"), _state(), 2)
        with pytest.raises(OSError, match="disk full"):
            w2.close()
    finally:
        flaky.disarm()


# ---------------------------------------------------------------------------
# ledger + injector semantics
# ---------------------------------------------------------------------------


def test_ledger_survives_garbage_and_marks_once(tmp_path):
    led = FaultLedger(str(tmp_path / "fired.json"))
    assert led.fired() == set()
    led.mark(2)
    led.mark(0)
    led.mark(2)
    assert led.fired() == {0, 2}
    with open(led.path, "w") as f:
        f.write("not json")
    assert led.fired() == set()


def test_injector_fires_each_fault_once_and_ledgers_first(tmp_path):
    plan = FaultPlan((Fault("kill", at_tick=4),
                      Fault("hang", at_tick=2, duration=7.0)))
    led = FaultLedger(str(tmp_path / "fired.json"))
    slept, died = [], []
    inj = FaultInjector(plan, led, sleep=slept.append,
                        die=lambda: died.append(True))
    inj.before_chunk(0, None)
    assert slept == [] and led.fired() == set()
    inj.before_chunk(2, None)
    assert slept == [7.0] and led.fired() == {1}
    inj.before_save(5)
    assert died == [True] and led.fired() == {0, 1}
    inj2 = FaultInjector(plan, led, sleep=slept.append,
                         die=lambda: died.append(True))
    inj2.before_chunk(10, None)
    inj2.before_save(10)
    assert slept == [7.0] and died == [True]


def test_injector_corrupts_after_save_then_dies(tmp_path):
    """``corrupt`` tears the checkpoint that just landed and dies, except
    for ``stale_tmp``, which leaves debris and lets the run go on."""
    plan = FaultPlan((Fault("corrupt", at_tick=4, mode="truncate_shard"),
                      Fault("corrupt", at_tick=8, mode="stale_tmp")))
    died = []
    inj = FaultInjector(plan, FaultLedger(str(tmp_path / "fired.json")),
                        die=lambda: died.append(True))
    root = str(tmp_path / "ckpt")
    for tick in (4, 8):
        inj.after_save(tick, ck.save_step(root, _state(), tick))
    assert died == [True]
    assert [e["fault"] for e in inj.events] == ["corrupt", "corrupt"]
    assert ck.restore_newest(root, _like())[1] == 8    # debris is harmless
    with pytest.raises(ck.CheckpointError):
        ck.restore_any(ck.step_path(root, 4), _like())


def test_poison_model_nans_only_float_leaves():
    state = engine.SimState(
        t=torch.zeros(2), j=torch.zeros(2, dtype=torch.int64),
        bucket=torch.zeros(2, dtype=torch.int64),
        total_cost=torch.zeros(2), total_idle=torch.zeros(2),
        model={"w": torch.ones(3), "h": torch.ones(2, dtype=torch.bfloat16),
               "step": torch.tensor([1, 2])},
        err_traj=torch.zeros(2, 4), cost_traj=torch.zeros(2, 4),
        time_traj=torch.zeros(2, 4), y_traj=torch.zeros(2, 4))
    w = state.model["w"]
    poisoned = poison_model(state)
    assert poisoned.model["w"] is w              # in place, as documented
    assert torch.isnan(poisoned.model["w"]).all()
    assert torch.isnan(poisoned.model["h"]).all()
    assert poisoned.model["step"].tolist() == [1, 2]
    assert (poisoned.t == 0).all()
