"""The port's self-healing supervisor (`repro_torch.launch.supervisor`),
mirroring tests/test_supervisor.py: watchdog semantics on fake workers
(crash accounting, hang detection, restart budget, degradation, the
child's visible cards), the NaN guard's rollback in process, and one real
supervised run on the CPU through a kill, a torn checkpoint, a NaN carry
and failing writes, whose final carry is bit for bit the unfailed run's.
The asynchronous writer's non-blocking property is proven with events
that hold a write back, not with a clock.

Every spawned process is bounded: fake workers by the supervisor's
``hang_timeout`` and ``max_restarts``, the real run by a subprocess
timeout around the supervisor itself."""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.chaos import (Fault, FaultInjector, FaultLedger, FaultPlan,
                               poison_model)
from repro_torch.launch import supervisor as sup
from repro_torch.launch.workload import WorkerSpec, build_workload
from repro_torch.train import checkpoint as ck
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVE_EVERY = 8
N_TICKS = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_spec(**kw):
    base = dict(
        overrides=dict(d_model=16, num_heads=2, num_kv_heads=1, d_ff=32,
                       vocab_size=64, head_dim=8),
        bids=((0.9, 0.9, 0.5, 0.5), (0.8, 0.8, 0.6, 0.6)),
        seeds=2, n_ticks=N_TICKS, save_every=SAVE_EVERY, keep_last=2)
    base.update(kw)
    return WorkerSpec(**base)


def _bits(x):
    x = x.detach().contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes()


# ---------------------------------------------------------------------------
# watchdog semantics on fake workers (no torch in the children)
# ---------------------------------------------------------------------------

_FAKE_PRELUDE = """
import json, os, sys, time
d = {run_dir!r}
def beat(tick, phase, resume=None):
    tmp = os.path.join(d, "heartbeat.json.tmp")
    hb = {{"tick": tick, "time": time.time(), "pid": os.getpid(),
           "phase": phase}}
    if resume is not None:
        hb["resume_tick"] = resume
    with open(tmp, "w") as f:
        json.dump(hb, f)
    os.replace(tmp, os.path.join(d, "heartbeat.json"))
"""


class _FakeSupervisor(sup.Supervisor):
    """Spawns scripted stand-in children instead of the worker — attempt
    k runs scripts[min(k, last)]."""

    def __init__(self, run_dir, config, scripts):
        super().__init__(run_dir, config)
        self.scripts = scripts

    def _spawn(self, attempt, devices):
        self._log("spawn", attempt=attempt, devices=devices)
        body = self.scripts[min(attempt, len(self.scripts) - 1)]
        code = _FAKE_PRELUDE.format(run_dir=self.run_dir) + body
        return subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)


def _fast_cfg(**kw):
    base = dict(max_restarts=4, backoff_base=0.01, backoff_cap=0.05,
                jitter=0.0, hang_timeout=30.0, poll_interval=0.05)
    base.update(kw)
    return sup.SupervisorConfig(**base)


_DONE = ('open(os.path.join(d, "result.json"), "w").write("{}");\n'
         'sys.exit(0)')


@pytest.mark.parametrize("resumed", ["observed", "carried"])
def test_crash_restart_and_ticks_lost_accounting(tmp_path, resumed):
    """A worker that dies at tick 5 and resumes at tick 0 costs 5 ticks —
    whether the supervisor sees the resume beat itself, or only a later
    beat that carries the resume tick (the port's heartbeat does)."""
    d = str(tmp_path)
    second = ('beat(0, "resume"); time.sleep(0.3); beat(9, "saved");\n'
              if resumed == "observed" else
              'beat(9, "saved", resume=0);\n')
    s = _FakeSupervisor(d, _fast_cfg(),
                        ['beat(5, "computed"); sys.exit(1)', second + _DONE])
    summary = s.run()
    assert summary["ok"] and summary["restarts"] == 1
    assert summary["ticks_lost"] == 5
    assert summary["mttr_s"] is not None
    assert [e["event"] for e in s.events] == ["spawn", "failure", "restart",
                                              "spawn", "done"]
    rec = json.load(open(os.path.join(d, sup.RECOVERY_NAME)))
    assert rec["summary"]["restarts"] == 1


def test_hang_is_detected_and_killed(tmp_path):
    d = str(tmp_path)
    s = _FakeSupervisor(d, _fast_cfg(hang_timeout=0.8), [
        'beat(3, "chunk"); time.sleep(300)', 'beat(3, "resume");\n' + _DONE])
    summary = s.run()
    assert summary["ok"] and summary["restarts"] == 1
    failure = [e for e in s.events if e["event"] == "failure"][0]
    assert "hang" in failure["reason"]


def test_restart_budget_gives_up(tmp_path):
    s = _FakeSupervisor(str(tmp_path), _fast_cfg(max_restarts=2),
                        ["sys.exit(3)"])
    summary = s.run()
    assert not summary["ok"] and summary["restarts"] == 2
    assert [e["event"] for e in s.events].count("spawn") == 3
    assert s.events[-1]["event"] == "gave_up"


def test_no_progress_failures_degrade_devices(tmp_path):
    s = _FakeSupervisor(str(tmp_path), _fast_cfg(max_restarts=3, devices=8,
                                                 degrade_after=1),
                        ["sys.exit(1)"])
    summary = s.run()
    assert not summary["ok"]
    assert [e["devices"] for e in s.events
            if e["event"] == "degrade"] == [4, 2]
    assert summary["devices"] == 2


def test_child_env_shows_the_first_cards(tmp_path, monkeypatch):
    """``devices`` N makes the worker see the first N cards of those this
    process may use; 0 leaves the environment's choice alone."""
    s = sup.Supervisor(str(tmp_path), sup.SupervisorConfig())
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert s._child_env(devices=4)["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"
    assert "CUDA_VISIBLE_DEVICES" not in s._child_env(devices=0)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,6,7")
    env = s._child_env(devices=2)
    assert env["CUDA_VISIBLE_DEVICES"] == "3,5"
    assert any(p.endswith("src") for p in
               env["PYTHONPATH"].split(os.pathsep))
    assert s._child_env(devices=0)["CUDA_VISIBLE_DEVICES"] == "3,5,6,7"


def test_shrink_faults_fire_once_per_ledger(tmp_path):
    d = str(tmp_path)
    FaultPlan((Fault("shrink", at_restart=0, devices=4),
               Fault("shrink", at_restart=2, devices=2))).save(
        os.path.join(d, sup.PLAN_NAME))
    s = sup.Supervisor(d, sup.SupervisorConfig())
    assert s._due_shrinks(0) == [4]
    assert s._due_shrinks(0) == []
    assert s._due_shrinks(1) == []
    assert s._due_shrinks(2) == [2]


def test_mesh_specs_and_missing_cards_are_refused(tmp_path, monkeypatch):
    """A spec sharded over a mesh raises naming the mesh slice, before any
    worker starts; a worker asked for the card raises without one."""
    d = str(tmp_path)
    _tiny_spec(mesh=8).save(os.path.join(d, sup.SPEC_NAME))
    with pytest.raises(NotImplementedError, match="mesh"):
        sup.main(["--run-dir", d, "--device", "cpu"])
    _tiny_spec().save(os.path.join(d, sup.SPEC_NAME))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        sup.worker_main(d, "cuda")
    assert not os.path.exists(os.path.join(d, sup.RESULT_NAME))


# ---------------------------------------------------------------------------
# in-process durable loop under injection: NaN rollback never reaches disk
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_nan_guard_rolls_back_and_stays_bitexact(tmp_path):
    spec = _tiny_spec(n_ticks=12, save_every=4, keep_last=2)
    job, scenarios, seeds = build_workload(spec)
    root = str(tmp_path / "ckpt")
    plan = FaultPlan((Fault("nan", at_tick=4),
                      Fault("io_error", at_tick=8, count=2)), seed=3)
    inj = FaultInjector(plan, FaultLedger(str(tmp_path / "fired.json")))
    res = trainer.train_batched_durable(
        job, scenarios, seeds, checkpoint_path=root,
        save_every=spec.save_every, n_ticks=spec.n_ticks,
        keep_last=spec.keep_last, strict_resume=False, nan_guard=True,
        hooks=inj, device="cpu")
    assert [e["fault"] for e in inj.events] == ["nan", "rollback",
                                                "io_error"]
    like = trainer.batched_init_state(job, scenarios, seeds, device="cpu")
    for tick in ck.list_steps(root):
        state, _ = ck.restore_any(ck.step_path(root, tick), like)
        assert trainer.state_is_finite(state)
    ref = trainer.train_batched(job, scenarios, seeds, n_ticks=spec.n_ticks,
                                device="cpu")
    for a, b in zip(tree_leaves(res.final_model),
                    tree_leaves(ref.final_model)):
        assert _bits(a) == _bits(b)
    np.testing.assert_array_equal(res.total_cost, ref.total_cost)


@pytest.mark.chaos
def test_nan_guard_raises_after_rollback_budget(tmp_path):
    spec = _tiny_spec(bids=((0.9, 0.9, 0.5, 0.5),), seeds=1, n_ticks=4,
                      save_every=4, keep_last=1)
    job, scenarios, seeds = build_workload(spec)

    class AlwaysPoison:
        def before_chunk(self, tick, state):
            return poison_model(state)

    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train_batched_durable(
            job, scenarios, seeds, checkpoint_path=str(tmp_path / "ckpt"),
            save_every=4, n_ticks=4, keep_last=1, nan_guard=True,
            max_rollbacks=2, hooks=AlwaysPoison(), device="cpu")


def test_rollback_point_is_a_copy():
    """The carry is updated in place, so the rollback point must not share
    its storage."""
    spec = _tiny_spec(bids=((0.9, 0.9, 0.5, 0.5),), seeds=1)
    job, scenarios, seeds = build_workload(spec)
    state = trainer.batched_init_state(job, scenarios, seeds, device="cpu")
    clean = trainer._rollback_point(state)
    poison_model(state)
    assert not trainer.state_is_finite(state)
    assert trainer.state_is_finite(clean)


# ---------------------------------------------------------------------------
# the asynchronous writer never holds the loop back: events, not clocks
# ---------------------------------------------------------------------------


def _holding_hook(entered, release):
    def hook(tmp, write_fn):
        entered.set()
        assert release.wait(timeout=60), "write never released"
        write_fn(tmp)
    return hook


def test_async_submit_returns_while_its_write_is_held(tmp_path):
    entered, release = threading.Event(), threading.Event()
    path = str(tmp_path / "a.npz")
    state = {"w": torch.arange(6.0)}
    ck._write_hook = _holding_hook(entered, release)
    try:
        with ck.AsyncCheckpointWriter() as w:
            w.submit(path, state, 1)
            # submit returned, and the write is under way but held
            assert entered.wait(timeout=60)
            assert not os.path.exists(path)
            state["w"].add_(1.0)           # the carry moves on in place
            release.set()
            w.wait()
    finally:
        ck._write_hook = None
    got, step = ck.restore(path, {"w": torch.zeros(6)})
    assert step == 1 and torch.equal(got["w"], torch.arange(6.0))


def test_async_durable_loop_runs_the_next_chunk_while_saving(tmp_path):
    """With ``async_save`` the durable loop starts the next chunk while
    the previous chunk's checkpoint is still being written, and the run
    still lands bit for bit."""
    spec = _tiny_spec(n_ticks=12, save_every=4)
    job, scenarios, seeds = build_workload(spec)
    entered, release = threading.Event(), threading.Event()
    overlapped = []

    class Hooks:
        def before_chunk(self, tick, state):
            if tick == 4:
                # the write of step 4 has begun and is held back here
                overlapped.append(entered.wait(timeout=60)
                                  and not release.is_set())
                release.set()

    ck._write_hook = _holding_hook(entered, release)
    try:
        res = trainer.train_batched_durable(
            job, scenarios, seeds, checkpoint_path=str(tmp_path / "ckpt"),
            save_every=4, n_ticks=12, keep_last=2, async_save=True,
            hooks=Hooks(), device="cpu")
    finally:
        ck._write_hook = None
    assert overlapped == [True]
    ref = trainer.train_batched(job, scenarios, seeds, n_ticks=12,
                                device="cpu")
    for a, b in zip(tree_leaves(res.final_model),
                    tree_leaves(ref.final_model)):
        assert _bits(a) == _bits(b)
    assert ck.list_steps(str(tmp_path / "ckpt")) == [8, 12]


# ---------------------------------------------------------------------------
# acceptance on the CPU: kill + torn step + NaN + failing writes
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_supervisor_survives_kill_corrupt_nan_and_io_errors(tmp_path):
    """The supervised run rides out a kill before the first save, a torn
    step 16 (then a kill), a NaN carry and two failing writes in the
    attempt that resumes from step 8: two restarts, 8 ticks lost to each
    dying fault, the torn step quarantined, and the newest step bit for
    bit the unfailed in-process run's final carry."""
    d = str(tmp_path)
    spec = _tiny_spec(arch="internvl2-1b", param_dtype="bfloat16", zoo=True,
                      overrides=dict(d_model=32, num_heads=4,
                                     num_kv_heads=2, head_dim=8, d_ff=64,
                                     vocab_size=128,
                                     use_flash_attention=1),
                      n_workers=8, global_batch=8, seq_len=24,
                      bids=((0.9,) * 4 + (0.5,) * 4,), iterations=8,
                      seeds=1)
    spec.save(os.path.join(d, sup.SPEC_NAME))
    FaultPlan((Fault("kill", at_tick=8),
               Fault("corrupt", at_tick=16, mode="truncate_shard"),
               Fault("nan", at_tick=16),
               Fault("io_error", at_tick=16, count=2)), seed=20).save(
        os.path.join(d, sup.PLAN_NAME))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.supervisor", "--run-dir",
         d, "--device", "cpu", "--max-restarts", "4", "--hang-timeout",
         "120", "--backoff-base", "0.05"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    summary = json.loads(out.stdout)
    assert summary["ok"] and summary["final_tick"] == N_TICKS
    assert summary["restarts"] == 2
    assert summary["ticks_lost"] == 2 * SAVE_EVERY
    rec = json.load(open(os.path.join(d, sup.RECOVERY_NAME)))
    assert [w["fault"] for w in rec["worker_events"]] == [
        "kill", "corrupt", "io_error", "nan", "rollback"]
    qdir = os.path.join(d, sup.CKPT_DIRNAME, ck.QUARANTINE_DIRNAME)
    assert os.listdir(qdir) == ["step_00000016"]
    result = json.load(open(os.path.join(d, sup.RESULT_NAME)))
    assert result["device"] == "cpu"
    assert set(result["launches"].values()) == {0}     # no card, no kernel
    saves = [json.loads(line) for k in range(3)
             for line in open(os.path.join(d, f"attempt_{k}.log"))
             if line.startswith('{"saved"')]
    assert [s["saved"] for s in saves] == [8, 16, 16, 24]

    job, scenarios, seeds = build_workload(spec)
    like = trainer.batched_init_state(
        job, scenarios, seeds, device="cpu",
        model0=lambda: trainer.zoo_mod.init_zoo_state(job.model, job,
                                                      job.seed,
                                                      device="cpu"))
    state, tick, _ = ck.restore_newest(os.path.join(d, sup.CKPT_DIRNAME),
                                       like)
    assert tick == N_TICKS
    ref = trainer.train_zoo(job, scenarios, seeds, n_ticks=N_TICKS,
                            device="cpu")
    for a, b in zip(tree_leaves(tuple(state)),
                    tree_leaves(tuple(ref.final_state))):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
