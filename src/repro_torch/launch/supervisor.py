"""Self-healing supervisor for durable batched training.

The paper prices preemption of *simulated* spot workers; this module makes
the training process itself survive being preempted. `Supervisor` runs the
durable loop (`trainer.train_batched_durable`) in a worker subprocess and

* watches a per-chunk heartbeat file — a crash is a dead child, a hang is
  a live child whose heartbeat stopped advancing for ``hang_timeout``;
* restarts with exponential backoff + seeded jitter under a
  ``max_restarts`` budget, each restart auto-resuming from the newest
  *valid* checkpoint (`checkpoint.restore_newest(strict=False)` inside the
  worker quarantines corrupt step dirs and falls back);
* degrades onto fewer cards when devices disappear between restarts (a
  ``shrink`` fault, or ``degrade_after`` consecutive no-progress
  failures): the worker then sees the first N cards through
  ``CUDA_VISIBLE_DEVICES``;
* emits a structured recovery log (``recovery.json``): every spawn /
  crash / hang / shrink / rollback event plus restarts, ticks lost, and
  MTTR.

Layout of a run directory::

    run_dir/
      spec.json            WorkerSpec (the workload, see launch/workload.py)
      fault_plan.json      optional chaos.FaultPlan to inject
      fired.json           fired-fault ledger (shared: worker + supervisor)
      heartbeat.json       {"tick", "time", "pid", "phase"}, atomic
      ckpt/step_*/         step-directory checkpoints (keep_last GC'd)
      result.json          written by the worker on success (with the
                           worker's device and its kernel launch counts)
      worker_events.jsonl  injected faults + NaN rollbacks, as they happen
      attempt_{k}.log      worker stdout+stderr per attempt
      recovery.json        the supervisor's structured recovery log

Worker mode (``python -m repro_torch.launch.supervisor --worker --run-dir
D --device cuda``) is what the supervisor spawns; running the module
without ``--worker`` supervises. The worker runs on ``cuda`` unless
``--device cpu`` is given, and raises without a card. `launch.train
--supervise` builds the spec from its usual training flags and delegates
here.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np

HEARTBEAT_NAME = "heartbeat.json"
SPEC_NAME = "spec.json"
PLAN_NAME = "fault_plan.json"
LEDGER_NAME = "fired.json"
RESULT_NAME = "result.json"
RECOVERY_NAME = "recovery.json"
EVENTS_NAME = "worker_events.jsonl"
CKPT_DIRNAME = "ckpt"


# ---------------------------------------------------------------------------
# Heartbeat file (written by the worker, polled by the supervisor)
# ---------------------------------------------------------------------------


def write_heartbeat(run_dir: str, tick: int, phase: str,
                    resume_tick: Optional[int] = None) -> None:
    path = os.path.join(run_dir, HEARTBEAT_NAME)
    tmp = path + ".tmp"
    beat = {"tick": int(tick), "time": time.time(), "pid": os.getpid(),
            "phase": phase}
    if resume_tick is not None:
        beat["resume_tick"] = int(resume_tick)
    with open(tmp, "w") as f:
        json.dump(beat, f)
    os.replace(tmp, path)


def read_heartbeat(run_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(run_dir, HEARTBEAT_NAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class _Heartbeat:
    """Chunk-hook adapter: every loop event refreshes the heartbeat.
    ``before_save`` carries the *computed* tick, so the supervisor's
    ticks-lost accounting sees work that died before its checkpoint; every
    beat after ``on_resume`` carries the tick this attempt resumed from, so
    the accounting holds even when the supervisor's poll misses the resume
    beat itself."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.resume_tick = None

    def _beat(self, tick, phase):
        write_heartbeat(self.run_dir, tick, phase, self.resume_tick)

    def on_resume(self, tick, path):
        self.resume_tick = tick
        self._beat(tick, "resume")

    def before_chunk(self, tick, state):
        self._beat(tick, "chunk")
        return state

    def before_save(self, tick):
        self._beat(tick, "computed")

    def after_save(self, tick, path):
        self._beat(tick, "saved")
        # one line per landed checkpoint in the attempt's log: its files
        # (a flat .npz, or a manifest and its shards) and their bytes
        nbytes = sum(os.path.getsize(f)
                     for f in glob.glob(glob.escape(path) + "*"))
        print(json.dumps({"saved": int(tick), "bytes": nbytes}),
              flush=True)


class _CompositeHooks:
    """Chains hook objects in order; ``before_chunk`` threads the carry
    through each (heartbeat first, so an injected hang leaves a stale
    heartbeat behind for the supervisor to time out on)."""

    def __init__(self, *parts):
        self.parts = [p for p in parts if p is not None]

    def _fan(self, name, *args):
        for p in self.parts:
            fn = getattr(p, name, None)
            if fn is not None:
                fn(*args)

    def on_resume(self, tick, path):
        self._fan("on_resume", tick, path)

    def before_chunk(self, tick, state):
        for p in self.parts:
            fn = getattr(p, "before_chunk", None)
            if fn is not None:
                out = fn(tick, state)
                if out is not None:
                    state = out
        return state

    def before_save(self, tick):
        self._fan("before_save", tick)

    def after_save(self, tick, path):
        self._fan("after_save", tick, path)

    def on_rollback(self, tick, reason):
        self._fan("on_rollback", tick, reason)


# ---------------------------------------------------------------------------
# Worker: the supervised subprocess
# ---------------------------------------------------------------------------


class _JsonlEvents(list):
    """Event list that also appends each entry to a .jsonl file the moment
    it happens — so events survive the SIGKILL that often follows them."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path

    def append(self, item):
        super().append(item)
        with open(self.path, "a") as f:
            f.write(json.dumps(item) + "\n")


def worker_main(run_dir: str, device: str = "cuda") -> int:
    """Run the spec'd durable training to completion inside ``run_dir`` on
    ``device``. Exit 0 ⇔ the final checkpoint is at ``spec.n_ticks``."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch.workload import WorkerSpec, build_workload
    from repro_torch.train import trainer

    spec = WorkerSpec.load(os.path.join(run_dir, SPEC_NAME))
    check_spec(spec)
    device = resolve_device(device)
    # spec.jit_cache has no effect here: the kernels are built once into
    # _build/, and a restart loads them from there
    job, scenarios, seeds = build_workload(spec)

    injector = None
    plan_path = os.path.join(run_dir, PLAN_NAME)
    if os.path.exists(plan_path):
        from repro_torch.chaos import FaultInjector, FaultLedger, FaultPlan
        injector = FaultInjector(
            FaultPlan.load(plan_path),
            FaultLedger(os.path.join(run_dir, LEDGER_NAME)))
        injector.events = _JsonlEvents(os.path.join(run_dir, EVENTS_NAME))

    hooks = _CompositeHooks(_Heartbeat(run_dir), injector)
    kw = dict(
        checkpoint_path=os.path.join(run_dir, CKPT_DIRNAME),
        save_every=spec.save_every, n_ticks=spec.n_ticks,
        save_shards=spec.save_shards, async_save=spec.async_save,
        keep_last=spec.keep_last, strict_resume=False, nan_guard=True,
        hooks=hooks, device=device)
    ops.reset_launch_counts()
    if spec.zoo:
        # the zoo program: same durable chunk loop, model program and
        # carry swapped for the (possibly mixed-precision) zoo step
        res = trainer.train_zoo(job, scenarios, seeds, **kw)
    else:
        res = trainer.train_batched_durable(job, scenarios, seeds, **kw)

    out = {"final_tick": spec.n_ticks, "mesh_devices": 0,
           "total_cost": np.asarray(res.total_cost).tolist(),
           "device": str(device), "launches": ops.launch_counts()}
    tmp = os.path.join(run_dir, RESULT_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, os.path.join(run_dir, RESULT_NAME))
    return 0


def check_spec(spec) -> None:
    """Refuse what the port cannot run yet: a spec sharded over a mesh."""
    if spec.mesh > 1:
        from repro_torch.sim import engine
        raise engine.not_ported(f"WorkerSpec(mesh={spec.mesh})", "mesh")


# ---------------------------------------------------------------------------
# Supervisor: spawn / watch / restart
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 8          # restarts, not attempts (attempts = +1)
    backoff_base: float = 0.5      # seconds; doubles per consecutive failure
    backoff_cap: float = 30.0
    jitter: float = 0.25           # ± fraction of the backoff, seeded
    hang_timeout: float = 120.0    # stale-heartbeat seconds before SIGKILL
    poll_interval: float = 0.25
    devices: int = 0               # show the child the first N cards (0 =
    #                                inherit whatever the child sees)
    degrade_after: int = 2         # consecutive no-progress failures before
    #                                halving the visible device count
    seed: int = 0
    device: str = "cuda"           # the worker's --device


class Supervisor:
    """Runs the worker to completion through crashes, hangs, corrupt
    checkpoints, and shrinking fleets. `run()` returns the recovery
    summary (also persisted to ``run_dir/recovery.json``)."""

    def __init__(self, run_dir: str,
                 config: Optional[SupervisorConfig] = None):
        self.run_dir = run_dir
        self.cfg = config or SupervisorConfig()
        self.events: List[dict] = []
        self._rng = np.random.default_rng(self.cfg.seed)

    # ------------------------------------------------------------- plumbing

    def _log(self, event: str, **kw) -> None:
        self.events.append({"time": time.time(), "event": event, **kw})

    def _child_env(self, devices: int) -> dict:
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
        if devices > 0:
            # the first N of the cards this process may use
            visible = [d for d in env.get("CUDA_VISIBLE_DEVICES", "").split(
                ",") if d.strip()] or [str(i) for i in range(devices)]
            env["CUDA_VISIBLE_DEVICES"] = ",".join(visible[:devices])
        return env

    def _spawn(self, attempt: int, devices: int) -> subprocess.Popen:
        self._log("spawn", attempt=attempt, devices=devices)
        # the child holds its own descriptor of the log; ours closes here
        with open(os.path.join(self.run_dir, f"attempt_{attempt}.log"),
                  "w") as log:
            return subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.supervisor",
                 "--worker", "--run-dir", self.run_dir,
                 "--device", self.cfg.device],
                env=self._child_env(devices), stdout=log, stderr=log,
                close_fds=True)

    def _due_shrinks(self, restarts: int) -> List[int]:
        """Unfired shrink faults due at or before restart number
        ``restarts`` → their target device counts (ledger-marked here:
        shrinks are supervisor faults, not worker faults)."""
        plan_path = os.path.join(self.run_dir, PLAN_NAME)
        if not os.path.exists(plan_path):
            return []
        from repro_torch.chaos import FaultLedger, FaultPlan
        plan = FaultPlan.load(plan_path)
        ledger = FaultLedger(os.path.join(self.run_dir, LEDGER_NAME))
        fired = ledger.fired()
        out = []
        for i, f in plan.by_kind("shrink"):
            if i not in fired and f.at_restart <= restarts:
                ledger.mark(i)
                out.append(f.devices)
                self._log("shrink", devices=f.devices, fault_index=i)
        return out

    def _backoff(self, consecutive_failures: int) -> float:
        base = min(self.cfg.backoff_cap,
                   self.cfg.backoff_base * 2 ** (consecutive_failures - 1))
        return base * (1.0 + self.cfg.jitter
                       * float(self._rng.uniform(-1.0, 1.0)))

    # ------------------------------------------------------------ main loop

    def run(self) -> dict:
        cfg = self.cfg
        devices = cfg.devices
        restarts = 0
        failures = 0               # consecutive, reset on progress
        ticks_lost = 0
        mttrs: List[float] = []
        t0 = time.monotonic()
        pending_recovery: Optional[float] = None   # monotonic failure time
        pending_death_tick: Optional[int] = None   # resolved at next resume

        while True:
            for d in self._due_shrinks(restarts):
                # a shrink can only take devices away, never give back
                devices = d if devices <= 0 else min(devices, d)
            attempt = restarts
            child = self._spawn(attempt, devices)
            hb0 = read_heartbeat(self.run_dir)
            last_tick = hb0["tick"] if hb0 else 0
            start_tick = last_tick
            last_beat = time.monotonic()
            reason = None

            while True:
                rc = child.poll()
                hb = read_heartbeat(self.run_dir)
                if hb is not None and (hb0 is None or hb != hb0):
                    hb0 = hb
                    last_beat = time.monotonic()
                    if pending_recovery is not None:
                        mttrs.append(time.monotonic() - pending_recovery)
                        pending_recovery = None
                    if pending_death_tick is not None:
                        # first heartbeat after a failure carries the tick
                        # the worker actually resumed from
                        ticks_lost += max(0, pending_death_tick
                                          - hb.get("resume_tick",
                                                   hb["tick"]))
                        pending_death_tick = None
                    if hb["tick"] > last_tick:
                        last_tick = hb["tick"]
                        failures = 0
                if rc is not None:
                    if rc == 0:
                        reason = "done"
                    else:
                        reason = f"crash (exit {rc})"
                    break
                if time.monotonic() - last_beat > cfg.hang_timeout:
                    reason = f"hang (> {cfg.hang_timeout}s silent)"
                    try:
                        child.kill()
                    except OSError:
                        pass
                    child.wait()
                    break
                time.sleep(cfg.poll_interval)

            if reason == "done":
                self._log("done", attempt=attempt, final_tick=last_tick)
                break

            failures += 1
            death_tick = last_tick
            if pending_death_tick is None:
                pending_death_tick = death_tick
            if pending_recovery is None:
                pending_recovery = time.monotonic()
            self._log("failure", attempt=attempt, reason=reason,
                      death_tick=death_tick,
                      progressed=death_tick > start_tick)

            if restarts >= cfg.max_restarts:
                self._log("gave_up", restarts=restarts)
                break
            if devices > 1 and failures > cfg.degrade_after:
                # repeated failure without progress: assume the fleet is
                # smaller than we think and show the worker fewer cards
                devices = max(1, devices // 2)
                self._log("degrade", devices=devices, failures=failures)
            delay = self._backoff(failures)
            self._log("restart", attempt=attempt + 1,
                      backoff_s=round(delay, 3))
            time.sleep(delay)
            restarts += 1

        if pending_death_tick is not None:
            # gave up before any resume heartbeat: charge against disk
            ticks_lost += max(0, pending_death_tick
                              - self._last_valid_step())
        ok = os.path.exists(os.path.join(self.run_dir, RESULT_NAME))
        summary = {
            "ok": ok,
            "restarts": restarts,
            "ticks_lost": int(ticks_lost),
            "mttr_s": (float(np.mean(mttrs)) if mttrs else None),
            "wall_s": time.monotonic() - t0,
            "final_tick": int(self._last_valid_step()),
            "devices": devices,
        }
        self._write_recovery(summary)
        return summary

    def _last_valid_step(self) -> int:
        from repro_torch.train import checkpoint as ckpt_mod
        steps = ckpt_mod.list_steps(os.path.join(self.run_dir,
                                                 CKPT_DIRNAME))
        return steps[-1] if steps else 0

    def _write_recovery(self, summary: dict) -> None:
        worker_events = []
        try:
            with open(os.path.join(self.run_dir, EVENTS_NAME)) as f:
                worker_events = [json.loads(line) for line in f
                                 if line.strip()]
        except OSError:
            pass
        doc = {"summary": summary, "events": self.events,
               "worker_events": worker_events}
        path = os.path.join(self.run_dir, RECOVERY_NAME)
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(path + ".tmp", path)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--worker", action="store_true",
                    help="run the workload itself (spawned by the "
                         "supervisor; not for direct use)")
    ap.add_argument("--spec", default=None,
                    help="WorkerSpec JSON to copy into the run dir "
                         "(supervisor mode; defaults to an existing "
                         "run_dir/spec.json)")
    ap.add_argument("--fault-plan", default=None,
                    help="chaos FaultPlan JSON to inject")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--hang-timeout", type=float, default=120.0)
    ap.add_argument("--backoff-base", type=float, default=0.5)
    ap.add_argument("--devices", type=int, default=0,
                    help="show the worker the first N cards (0 = inherit)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the worker trains (default cuda; without "
                         "a card it fails rather than falling back)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.worker:
        return worker_main(args.run_dir, args.device)

    os.makedirs(args.run_dir, exist_ok=True)
    from repro_torch.launch.workload import WorkerSpec
    if args.spec:
        WorkerSpec.load(args.spec).save(
            os.path.join(args.run_dir, SPEC_NAME))
    elif not os.path.exists(os.path.join(args.run_dir, SPEC_NAME)):
        ap.error(f"no --spec and no {SPEC_NAME} in {args.run_dir}")
    check_spec(WorkerSpec.load(os.path.join(args.run_dir, SPEC_NAME)))
    if args.fault_plan:
        from repro_torch.chaos import FaultPlan
        FaultPlan.load(args.fault_plan).save(
            os.path.join(args.run_dir, PLAN_NAME))

    sup = Supervisor(args.run_dir, SupervisorConfig(
        max_restarts=args.max_restarts, hang_timeout=args.hang_timeout,
        backoff_base=args.backoff_base, devices=args.devices,
        seed=args.seed, device=args.device))
    summary = sup.run()
    print(json.dumps(summary, indent=1))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
