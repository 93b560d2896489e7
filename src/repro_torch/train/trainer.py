"""The elastic trainer: wires the spot-market/cluster simulator, the paper's
strategies, the elastic train steps and checkpointing into one loop.

* ``ElasticTrainer.run`` — the legacy per-iteration Python loop over the
  discrete-event ``VolatileCluster``, with per-iteration checkpointing.
* ``train_batched`` / ``ElasticTrainer.run_batched`` — the paper's
  experiment as a grid: an S-strategy × R-seed grid trains real models
  end-to-end, tick by tick — price draw, bid→active-mask, the elastic
  masked train step, time/cost/idle accounting — all on the device with
  no host sync between ticks. The default program steps each (scenario,
  seed) cell (`make_train_program`); ``megabatch=True`` trains the whole
  grid in one blocked step per tick, with Eq. (5)'s masked-renormalized
  SGD update fused into one kernel under ``use_fused_update``.
* ``train_zoo`` trains a zoo config (dense and VLM families, float32 or
  bf16 mixed precision, ``use_flash_attention`` routing attention through
  K2) through the same machinery with the per-cell program of
  `train.zoo_program` swapped in.

Checkpointing: ``snapshot_every=k`` keeps the full batched carry every k
ticks, `save_batched` / `restore_batched` persist it through
`train.checkpoint`, and `train_batched_durable` (``train_zoo(
checkpoint_path=, save_every=)``) runs in chunks, saving after each, so a
killed process resumes bit for bit. The carry is updated in place, so the
durable loop's rollback point is a copy (`_rollback_point`).

Mesh: ``mesh=`` (a `launch.mesh.Mesh`) runs the grid, or each durable
chunk, through `engine.simulate_sharded`: scenarios split over the mesh's
``data`` axis and seeds over its ``replica`` axis, bit for bit the
unsharded run wherever the step's arithmetic is per cell. Checkpoints
record no mesh, so a run saved on one mesh shape resumes on another, or
unsharded.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import JobConfig
from repro_torch.core.strategies import Strategy
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import exact_float32, resolve_device
from repro_torch.sim import engine
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.spans import span
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import megabatch as megabatch_mod
from repro_torch.train import zoo_program as zoo_mod
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class TrainLogEntry:
    j: int
    time: float
    cost: float
    loss: float
    y: int


@dataclasses.dataclass
class ElasticTrainer:
    """A job, its simulated cluster and its strategy. Building one
    allocates no model: ``run`` and ``restore`` initialize
    ``params``/``opt_state`` from ``job.seed`` at first use (unless the
    caller set them), and ``run_batched`` initializes the grid's replicas
    itself, straight into their (S, R) buffers."""

    job: JobConfig
    cluster: VolatileCluster
    strategy: Strategy
    mode: str = "spot"                 # "spot" | "preemptible"
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0
    seed: int = 0
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.log: List[TrainLogEntry] = []
        self._j = 0
        self._step_fn = None

    def _ensure_model(self) -> None:
        exact_float32()
        if not hasattr(self, "params"):
            self.params, self.opt_state = init_train_state(
                self.job.model, self.job, self.job.seed, device=self.device)
        if self._step_fn is None:
            self._step_fn = make_train_step(self.job.model, self.job,
                                            remat="none")

    # ---------------------------------------------------------------- loop

    def run(self, iterations: Optional[int] = None,
            batch_fn: Optional[Callable[[int], Dict]] = None) -> Dict:
        """The legacy per-iteration loop over the discrete-event cluster:
        the strategy's bids (or provisioning) meet the cluster's market,
        and each iteration's active mask drives one elastic train step.
        With ``checkpoint_path``/``checkpoint_every`` the (params,
        opt_state) pair is saved every k iterations; `restore` resumes."""
        self._ensure_model()
        cfg = self.job.model
        total = iterations or self.strategy.total_iterations
        shape = self.job.shape
        n_w = self.job.n_workers

        for j in range(self._j, total):
            if self.mode == "spot":
                bids = self.strategy.bids(self.cluster.t, j)
                assert len(bids) == n_w, (len(bids), n_w)
                mask = self.cluster.next_iteration_spot(j, np.asarray(bids))
            else:
                prov = min(self.strategy.workers(j), n_w)
                mask = self.cluster.next_iteration_preemptible(j, prov)
                mask = np.pad(mask, (0, n_w - len(mask)))[:n_w]

            batch = batch_fn(j) if batch_fn else lm_batch(
                cfg, shape.global_batch, shape.seq_len, j, seed=self.seed)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, _batch_on(batch, self.device),
                torch.as_tensor(np.asarray(mask, np.float32),
                                device=self.device),
                torch.tensor(j, device=self.device))
            self.log.append(TrainLogEntry(
                j=j, time=self.cluster.t, cost=self.cluster.total_cost,
                loss=float(metrics["loss"]), y=int(mask.sum())))
            self._j = j + 1
            if (self.checkpoint_path and self.checkpoint_every
                    and (j + 1) % self.checkpoint_every == 0):
                ckpt_mod.save(self.checkpoint_path,
                              {"params": self.params,
                               "opt": self.opt_state}, j + 1)

        return self.summary()

    def restore(self):
        """Load ``checkpoint_path`` (as `run` saves it) into the model and
        continue from its iteration."""
        if not self.checkpoint_path:
            raise ValueError("restore needs a checkpoint_path on the trainer")
        self._ensure_model()
        state, step = ckpt_mod.restore(
            self.checkpoint_path, {"params": self.params,
                                   "opt": self.opt_state})
        self.params, self.opt_state = state["params"], state["opt"]
        self._j = step

    def summary(self) -> Dict:
        s = self.cluster.summary()
        s["final_loss"] = self.log[-1].loss if self.log else float("nan")
        s["log"] = self.log
        return s

    # ------------------------------------------------------- batched path

    def run_batched(self, seeds: Union[int, Sequence[int]] = 8,
                    iterations: Optional[int] = None,
                    strategies: Optional[Mapping[str, Strategy]] = None,
                    n_ticks: Optional[int] = None,
                    n_batches: Optional[int] = None,
                    batch_fn: Optional[Callable[[int], Dict]] = None,
                    snapshot_every: int = 0,
                    megabatch: bool = False,
                    use_fused_update: bool = False,
                    mesh=None):
        """Train a grid of strategies (default: the trainer's own) × seeds
        against the trainer's market and runtime. Every replica starts
        from the job's deterministic init (``job.seed``) and consumes the
        same deterministic batch stream (``lm_batch`` indexed by iteration,
        or ``batch_fn``). Returns a `sim.evaluate.BatchResult` whose
        per-iteration "errors" are the batch losses.

        With ``snapshot_every = k`` the run keeps the full carry every k
        ticks; with a ``checkpoint_path`` the latest snapshot is saved
        there when the run returns, and `resume_batched` restarts the grid
        from it bit for bit. To survive a kill at any moment use
        `train_batched_durable`, which saves every chunk as it runs.
        ``mesh`` shards the grid over a `launch.mesh.Mesh` (see
        `train_batched`)."""
        from repro_torch.sim.evaluate import BatchResult

        strategies = strategies or {self.strategy.name: self.strategy}
        scenarios = [self._scenario(s, iterations, name)
                     for name, s in strategies.items()]
        res = train_batched(
            self.job, scenarios, seeds, n_ticks=n_ticks,
            n_batches=n_batches, batch_fn=batch_fn, batch_seed=self.seed,
            snapshot_every=snapshot_every, megabatch=megabatch,
            use_fused_update=use_fused_update, mesh=mesh,
            device=self.device)
        if self.checkpoint_path and res.snapshots is not None:
            save_batched(self.checkpoint_path, res)
        return BatchResult(names=[s.name for s in scenarios], result=res)

    def resume_batched(self, seeds: Union[int, Sequence[int]] = 8,
                       iterations: Optional[int] = None,
                       strategies: Optional[Mapping[str, Strategy]] = None,
                       n_ticks: Optional[int] = None,
                       n_batches: Optional[int] = None,
                       batch_fn: Optional[Callable[[int], Dict]] = None,
                       snapshot_every: int = 0,
                       mesh=None):
        """Restart a preempted `run_batched` (the per-cell program) from
        ``checkpoint_path``: the whole carry (every replica's params,
        opt_state, clock, cost and the loss trajectories so far) is
        restored and the run continues from the checkpointed tick — with
        the same grid, seeds and tick budget the final state is bit for
        bit the uninterrupted run's."""
        if not self.checkpoint_path:
            raise ValueError(
                "resume_batched needs a checkpoint_path on the trainer")
        from repro_torch.sim.evaluate import BatchResult

        strategies = strategies or {self.strategy.name: self.strategy}
        scenarios = [self._scenario(s, iterations, name)
                     for name, s in strategies.items()]
        batch = engine.stack_scenarios(scenarios, device=self.device)
        state, tick = restore_batched(self.checkpoint_path, self.job, batch,
                                      seeds, device=self.device)
        res = train_batched(
            self.job, batch, seeds, n_ticks=n_ticks, n_batches=n_batches,
            batch_fn=batch_fn, batch_seed=self.seed,
            snapshot_every=snapshot_every, init_state=state, tick0=tick,
            mesh=mesh, device=self.device)
        if self.checkpoint_path and res.snapshots is not None:
            save_batched(self.checkpoint_path, res)
        return BatchResult(names=[s.name for s in scenarios], result=res)

    def _scenario(self, strategy: Strategy, iterations: Optional[int],
                  name: str) -> engine.Scenario:
        """Compile one strategy against this trainer's cluster (market,
        runtime, idle step) into a batchable Scenario."""
        cl = self.cluster
        if self.mode == "spot":
            return engine.scenario_from_strategy(
                strategy, alpha=self.job.learning_rate, rt=cl.runtime,
                price_spec=price_spec_from_market(cl.market),
                n_max=self.job.n_workers, idle_step=cl.idle_step,
                J=iterations, name=name)
        return engine.scenario_from_strategy(
            strategy, alpha=self.job.learning_rate, rt=cl.runtime,
            q=cl.preempt_q or 0.0, on_demand_price=cl.on_demand_price,
            n_max=self.job.n_workers, idle_step=cl.idle_step, J=iterations,
            name=name)


def price_spec_from_market(market) -> engine.PriceSpec:
    """Map a legacy SpotMarket's price process onto a batchable PriceSpec:
    IIDPrices → its distribution; TracePrices → *time-indexed* replay at
    the trace's resolution; TickPrices → tick-indexed replay (one entry
    per engine tick)."""
    from repro_torch.sim.spot_market import TickPrices, TracePrices

    proc = market.process
    if hasattr(proc, "dist"):
        return engine.PriceSpec.from_dist(proc.dist)
    if isinstance(proc, TracePrices):
        return engine.PriceSpec.from_trace(proc.trace, step=proc.step)
    if isinstance(proc, TickPrices):
        return engine.PriceSpec.from_trace_ticks(proc.trace)
    raise TypeError(f"no batchable PriceSpec for {type(proc).__name__}")


def make_train_program(job: JobConfig, n_batches: int
                       ) -> engine.ModelProgram:
    """The elastic masked train step as a per-cell engine ModelProgram.

    model = (params, opt_state); data = the batch stream stacked on a
    leading (n_batches,) axis, indexed by ``j % n_batches`` on the device
    (deterministic — matches the legacy loop's ``lm_batch(..., index=j)``
    when ``n_batches >= J``). The scenario's ``alpha`` is ignored: the LR
    comes from the job, exactly as in ``ElasticTrainer.run``."""
    step = make_train_step(job.model, job, remat="none")

    def step_fn(model, data, key, mask, j, alpha):
        del key, alpha
        params, opt_state = model
        idx = (j % n_batches).reshape(1)
        batch = {k: x.index_select(0, idx)[0] for k, x in data.items()}
        new_params, new_opt, metrics = step(params, opt_state, batch, mask,
                                            j)
        return (new_params, new_opt), metrics["loss"]

    return engine.ModelProgram(step_fn=step_fn,
                               name=f"train-{job.model.name}-{n_batches}")


def make_megabatch_train_program(job: JobConfig, n_batches: int,
                                 use_fused_update: bool = False
                                 ) -> engine.ModelProgram:
    """The megabatched elastic train step as a *blocked* engine program.

    model = ``train.megabatch``'s flat replica-blocked state ({"p", "v"}
    (S, R, P) tensors, updated in place); per tick the whole (S, R) grid
    trains in ONE step call — each replica's batch gathered by its own
    ``j % n_batches``, the grid flattened to one replica axis, and Eq.
    (5)'s renormalization + the gated SGD apply fused over the flat
    blocks (through the kernel when ``use_fused_update``). Raises
    NotImplementedError for configs outside the megabatch envelope.
    The program owns its step's (R, P) gradient buffer, so build one per
    run rather than caching it."""
    cfg = job.model
    reason = megabatch_mod.supports_megabatch(cfg, job)
    if reason:
        raise NotImplementedError(f"megabatch path unsupported: {reason}")
    step = megabatch_mod.make_megabatch_step(
        cfg, job, use_fused_update=use_fused_update)

    def step_fn(model, data, key, mask, j, alpha, running):
        del key, alpha
        s, r = j.shape
        rt = s * r
        b = (j % n_batches).reshape(rt)
        tokens = data["tokens"][b]
        labels = data["labels"][b]
        label_mask = data.get("label_mask")
        if label_mask is not None:
            label_mask = label_mask[b]
        flat = {k: x.view((rt,) + tuple(x.shape[2:]))
                for k, x in model.items()}
        _, loss = step(flat, tokens, labels, mask.reshape(rt, -1),
                       j.reshape(rt), running.reshape(rt), label_mask)
        return model, loss.view(s, r)

    name = f"train-mega-{job.model.name}-{n_batches}"
    if use_fused_update:
        name += "-fused"
    return engine.ModelProgram(step_fn=step_fn, name=name, blocked=True)


def unpack_batched_model(final_model, job: JobConfig):
    """A megabatched run's ``EngineResult.final_model`` ({"p", "v"} flat
    (S, R, P) tensors) back to the standard (params, opt_state) nested
    dicts with (S, R, ...) leading axes."""
    return megabatch_mod.unpack_state(final_model, job.model,
                                      float(job.momentum))


def stack_batches(job: JobConfig, n_batches: int, seed: int = 0,
                  batch_fn: Optional[Callable[[int], Dict]] = None, *,
                  device=None) -> Dict[str, torch.Tensor]:
    """The first ``n_batches`` training batches stacked on a leading axis
    on ``device`` (default ``cuda``) — the data the tick loop indexes by
    iteration."""
    device = resolve_device(device)
    shape = job.shape
    batches = [batch_fn(j) if batch_fn else
               lm_batch(job.model, shape.global_batch, shape.seq_len, j,
                        seed=seed)
               for j in range(n_batches)]
    return _batch_on({k: np.stack([np.asarray(b[k]) for b in batches])
                      for k in batches[0]}, device)


def _batch_on(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on ``device`` (integers as int64,
    which torch indexes with)."""
    out = {}
    for k, x in batch.items():
        arr = np.asarray(x)
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out




def train_batched(job: JobConfig,
                  scenarios: Union[engine.ScenarioBatch,
                                   Sequence[engine.Scenario]],
                  seeds: Union[int, Sequence[int]] = 8, *,
                  n_ticks: Optional[int] = None,
                  n_batches: Optional[int] = None,
                  batch_fn: Optional[Callable[[int], Dict]] = None,
                  batch_seed: int = 0,
                  snapshot_every: int = 0,
                  init_state: Optional[engine.SimState] = None,
                  tick0: int = 0,
                  megabatch: bool = False,
                  use_fused_update: bool = False,
                  mesh=None,
                  program=None,
                  model0=None,
                  device=None) -> engine.EngineResult:
    """Train a real model under every scenario × seed on ``device``
    (default ``cuda``).

    The default program is the per-cell elastic train step
    (`make_train_program`, the reference's vmapped path): each (scenario,
    seed) cell carries its own ``(params, opt_state)``. ``megabatch=True``
    runs the replica-blocked program of `train.megabatch` instead: every
    replica's params and momentum in flat (S, R, P) buffers updated in
    place, one blocked step per tick over the whole grid, and with
    ``use_fused_update`` the elastic SGD apply through the fused kernel
    (`kernels.ops.fused_elastic_update`).

    ``program`` / ``model0`` swap in a caller-built ModelProgram factory
    (``n_batches -> ModelProgram``) and the matching initial carry of one
    replica — the hook `train_zoo` uses; ``program`` takes precedence over
    ``megabatch``. ``model0`` may also be a zero-argument callable that
    builds the carry, so that no caller holds a replica-sized tree while
    the grid's copies are made. For the default and megabatch programs
    ``model0`` replaces the job's own init from ``job.seed``.

    Checkpointing: ``snapshot_every = k`` copies the full carry (model,
    clock, cost, trajectories — everything) every k ticks into
    ``EngineResult.snapshots``; ``init_state``/``tick0`` resume from a
    restored snapshot (same scenarios, seeds and tick budget), bit for
    bit. The run updates ``init_state`` in place. See `save_batched` /
    `restore_batched`.

    ``mesh`` (a `launch.mesh.Mesh`) runs the grid through
    `engine.simulate_sharded`: the scenarios shard over the mesh's
    ``data`` axis and the seeds over its ``replica`` axis, each shard on
    its own device (shards sharing a device in turn), the carry made once
    on ``device`` and each shard stepping its own rows of it. The
    scenarios are stacked once, so every shard keeps the grid's padded
    widths that the draws are shaped by.

    Returns an EngineResult whose ``errors``/``losses`` trajectory holds
    the per-iteration batch loss and whose ``final_model`` holds the
    grid's carry ((S, R, ...) leaves); for the megabatch program the flat
    {"p", "v"} tensors, which `unpack_batched_model` converts back."""
    if program is not None and model0 is None and init_state is None:
        raise ValueError("train_batched(program=...) needs the matching "
                         "model0= carry")
    device = resolve_device(device)
    exact_float32()
    scenarios, program, data, n_ticks = _prepare_batched(
        job, scenarios, n_ticks=n_ticks, n_batches=n_batches,
        batch_fn=batch_fn, batch_seed=batch_seed, megabatch=megabatch,
        use_fused_update=use_fused_update, program=program, device=device)
    if init_state is None:
        init_state = batched_init_state(job, scenarios, seeds,
                                        megabatch=megabatch, model0=model0,
                                        device=device)
    return _simulate(scenarios, program, data, seeds,
                     engine.SimConfig(n_ticks=n_ticks,
                                      snapshot_every=snapshot_every),
                     init_state, tick0, mesh, device)


def _simulate(scenarios, program, data, seeds, cfg: engine.SimConfig,
              init_state, tick0: int, mesh, device) -> engine.EngineResult:
    """One engine call of the trainers, sharded over ``mesh`` if given."""
    if mesh is not None:
        return engine.simulate_sharded(scenarios, program, None, data, seeds,
                                       cfg, mesh=mesh, init_state=init_state,
                                       tick0=tick0)
    return engine.simulate_program(scenarios, program, None, data, seeds,
                                   cfg, init_state=init_state, tick0=tick0,
                                   device=device)


def _prepare_batched(job: JobConfig, scenarios, *, n_ticks, n_batches,
                     batch_fn, batch_seed, megabatch: bool = False,
                     use_fused_update: bool = False, program=None, device):
    """Shared setup of `train_batched` and `train_batched_durable` (which
    must stay bit-exact equivalents): stack + fleet-width check, batch
    stream, program (``program``, a factory ``n_batches ->
    ModelProgram``; else the megabatch program; else the per-cell one),
    tick-budget default."""
    with span("train.prepare"):
        if not isinstance(scenarios, engine.ScenarioBatch):
            scenarios = engine.stack_scenarios(scenarios, device=device)
        if scenarios.n_max != job.n_workers:
            raise ValueError(
                f"scenario fleet width {scenarios.n_max} != job.n_workers "
                f"{job.n_workers}: the elastic mask must cover every worker "
                "slice")
        j_max = scenarios.j_max
        n_batches = n_batches or j_max
        data = stack_batches(job, n_batches, seed=batch_seed,
                             batch_fn=batch_fn, device=device)
        if program is not None:
            program = program(n_batches)
        elif megabatch:
            program = make_megabatch_train_program(job, n_batches,
                                                   use_fused_update)
        else:
            program = make_train_program(job, n_batches)
        return scenarios, program, data, n_ticks or default_n_ticks(j_max)


def default_n_ticks(j_max: int) -> int:
    """The tick budget of a run whose longest plan has ``j_max``
    iterations, when the caller names none."""
    return 2 * j_max + 16


def batched_init_state(job: JobConfig,
                       scenarios: Union[engine.ScenarioBatch,
                                        Sequence[engine.Scenario]],
                       seeds: Union[int, Sequence[int]],
                       megabatch: bool = False,
                       model0=None, *, device=None) -> engine.SimState:
    """The (S, R) initial carry a batched training run starts from on
    ``device`` — and therefore the *restore template* of
    `checkpoint.restore` (same model init from ``job.seed``, same
    trajectory shapes). ``megabatch`` / ``model0`` (a carry or a callable
    building one) must match the run being restored: the flat
    replica-blocked carry, the (params, opt_state) tree and a zoo
    mixed-precision carry are all different trees."""
    device = resolve_device(device)
    n_seeds = int(seeds) if np.isscalar(seeds) else len(seeds)
    with span("train.prepare"):
        if callable(model0):
            model0 = model0()
        elif model0 is None and megabatch:
            model0 = megabatch_mod.init_megabatch_state(
                job.model, job, job.seed, device=device)
        elif model0 is None:
            model0 = init_train_state(job.model, job, job.seed,
                                      device=device)
        return engine.initial_state(scenarios, model0, n_seeds,
                                    device=device)


def save_batched(path: str, result: engine.EngineResult,
                 index: int = -1, *, shards: Optional[int] = None,
                 writer: Optional[ckpt_mod.AsyncCheckpointWriter] = None
                 ) -> int:
    """Persist one snapshot of a ``snapshot_every`` run as a durable
    checkpoint; returns the snapshot's absolute tick count (the ``tick0``
    a resume passes back).

    ``shards=n`` writes a *sharded* checkpoint — n per-scenario-slice
    .npz files plus a JSON manifest at ``path`` (`checkpoint.save_sharded`)
    instead of one flat .npz. Either format restores through
    `restore_batched`, bit for bit. ``writer`` hands the write to an
    `AsyncCheckpointWriter` background thread, which takes its host copy
    before this returns."""
    state, tick = engine.snapshot_state(result, index)
    if writer is not None:
        writer.submit(path, state, tick, n_shards=shards)
    elif shards:
        ckpt_mod.save_sharded(path, state, tick, shards)
    else:
        ckpt_mod.save(path, state, tick)
    return tick


def restore_batched(path: str, job: JobConfig,
                    scenarios: Union[engine.ScenarioBatch,
                                     Sequence[engine.Scenario]],
                    seeds: Union[int, Sequence[int]],
                    megabatch: bool = False,
                    model0=None, *, device=None):
    """Load a `save_batched` checkpoint back into a batched carry on
    ``device``. Returns ``(state, tick)`` for ``train_batched(
    init_state=state, tick0=tick)``; raises a key-naming ValueError if the
    job/scenario grid drifted from the one that was checkpointed. Pass
    ``megabatch=True`` for checkpoints written by a megabatched run (flat
    replica-blocked carry), or ``model0`` for a caller-built carry (zoo
    runs — see `resume_zoo`). Both checkpoint formats are accepted (flat
    .npz or sharded manifest, sniffed by `checkpoint.restore_any`), as
    are the reference package's files of the same grid."""
    like = batched_init_state(job, scenarios, seeds, megabatch=megabatch,
                              model0=model0, device=device)
    return ckpt_mod.restore_any(path, like)


def state_is_finite(state: engine.SimState) -> bool:
    """The NaN guard's predicate: every float leaf of the carry's model,
    plus the cost/clock accumulators, is finite. (Trajectory buffers are
    excluded — their not-yet-run entries are NaN by design.)"""
    for leaf in tree_leaves(state.model):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            return False
    return bool(torch.isfinite(state.total_cost).all()
                and torch.isfinite(state.t).all())


def _rollback_point(state: engine.SimState) -> engine.SimState:
    """A copy of the carry to roll back to. The chunk (and a fault hook)
    update the carry in place, so the rollback point cannot be the carry
    itself, as it is in the reference: the copy stays on the device when
    it takes at most a quarter of the device's free memory, and goes to
    the host otherwise."""
    dev = state.t.device
    if dev.type == "cuda":
        nbytes = sum(x.numel() * x.element_size()
                     for x in tree_leaves(tuple(state)))
        if nbytes > torch.cuda.mem_get_info(dev)[0] // 4:
            return engine._map_state(lambda x: x.to("cpu", copy=True),
                                     state)
    return engine._map_state(torch.clone, state)


def train_batched_durable(job: JobConfig,
                          scenarios: Union[engine.ScenarioBatch,
                                           Sequence[engine.Scenario]],
                          seeds: Union[int, Sequence[int]] = 8, *,
                          checkpoint_path: str,
                          save_every: int,
                          n_ticks: Optional[int] = None,
                          n_batches: Optional[int] = None,
                          batch_fn: Optional[Callable[[int], Dict]] = None,
                          batch_seed: int = 0,
                          resume: bool = True,
                          mesh=None,
                          save_shards: Optional[int] = None,
                          async_save: bool = False,
                          keep_last: Optional[int] = None,
                          strict_resume: bool = True,
                          nan_guard: bool = False,
                          max_rollbacks: int = 3,
                          hooks=None,
                          program=None,
                          model0=None,
                          device=None) -> engine.EngineResult:
    """Preemption-*durable* batched training: the tick loop runs in
    ``save_every``-tick chunks, persisting the full batched carry to
    ``checkpoint_path`` after every chunk — so a process killed at any
    moment loses at most ``save_every`` ticks of work, and rerunning the
    same call (``resume=True``) picks up from the file.

    Every draw is keyed by the absolute tick, so the chunked run is bit for
    bit the single-call ``train_batched(job, scenarios, seeds,
    n_ticks=n_ticks)``, whose result it returns. ``mesh`` runs each chunk
    through `engine.simulate_sharded`, as `train_batched` does; the files
    it writes restore on any mesh shape, or unsharded.

    ``save_shards=n`` writes each checkpoint as n per-shard files +
    manifest (`checkpoint.save_sharded`) instead of one flat .npz;
    ``async_save=True`` hands serialization to a background
    `AsyncCheckpointWriter` thread (which takes its host copy of the carry
    before the next chunk starts) — the last write is always joined, and
    its errors surfaced, before the function returns.

    ``keep_last=n`` switches checkpointing to *step-directory* mode:
    ``checkpoint_path`` names a root directory holding one
    ``step_{tick:08d}/`` per retained checkpoint (`checkpoint.save_step`),
    GC'd to the newest n. Resume then goes through
    `checkpoint.restore_newest` — with ``strict_resume=False`` a corrupt
    newest step is quarantined and the previous valid one used instead.

    ``nan_guard=True`` validates the carry after every chunk
    (`state_is_finite`): a non-finite model/cost rolls the carry back to
    a copy taken at the chunk's start (`_rollback_point`) and re-runs it,
    never checkpointing poison; more than ``max_rollbacks`` consecutive
    failures raise ``FloatingPointError``.

    ``hooks`` is an optional object observing (and, for fault injection,
    perturbing) the chunk loop; all methods are optional and resolved by
    ``getattr``: ``on_resume(tick, path)``, ``before_chunk(tick, state)
    -> state|None``, ``before_save(tick)``, ``after_save(tick, path)``,
    ``on_rollback(tick, reason)``. `chaos.FaultInjector` implements this
    protocol; the supervisor's heartbeat writer piggybacks on it too."""
    if save_every < 1:
        raise ValueError(f"save_every={save_every} must be ≥ 1")
    if keep_last is not None and keep_last < 1:
        raise ValueError(f"keep_last={keep_last} must be ≥ 1")
    device = resolve_device(device)
    exact_float32()
    scenarios, program, data, n_ticks = _prepare_batched(
        job, scenarios, n_ticks=n_ticks, n_batches=n_batches,
        batch_fn=batch_fn, batch_seed=batch_seed, program=program,
        device=device)

    def hook(name, *args):
        fn = getattr(hooks, name, None) if hooks is not None else None
        return fn(*args) if fn is not None else None

    def template():
        return batched_init_state(job, scenarios, seeds, model0=model0,
                                  device=device)

    step_mode = keep_last is not None
    resumed_from = None
    if resume and step_mode and ckpt_mod.list_steps(checkpoint_path):
        state, tick, resumed_from = ckpt_mod.restore_newest(
            checkpoint_path, template(), strict=strict_resume)
    elif resume and not step_mode and os.path.exists(checkpoint_path):
        state, tick = ckpt_mod.restore_any(checkpoint_path, template())
        resumed_from = checkpoint_path
    else:
        state, tick = template(), 0
    if tick > n_ticks:
        raise ValueError(
            f"checkpoint {resumed_from} is at tick {tick}, beyond "
            f"this run's n_ticks={n_ticks}")
    hook("on_resume", tick, resumed_from)

    def run_chunk(end, state, tick):
        return _simulate(scenarios, program, data, seeds,
                         engine.SimConfig(n_ticks=end), state, tick, mesh,
                         device)

    def save(state, tick):
        # sync writes get the same transient-OSError retry the async
        # writer applies
        if step_mode:
            path = ckpt_mod.step_path(checkpoint_path, tick)
            if writer is not None:
                writer.submit_step(checkpoint_path, state, tick,
                                   n_shards=save_shards,
                                   keep_last=keep_last)
            else:
                ckpt_mod.retry_io(ckpt_mod.save_step, checkpoint_path,
                                  state, tick, save_shards, keep_last)
            return path
        if writer is not None:
            writer.submit(checkpoint_path, state, tick,
                          n_shards=save_shards)
        elif save_shards:
            ckpt_mod.retry_io(ckpt_mod.save_sharded, checkpoint_path,
                              state, tick, save_shards)
        else:
            ckpt_mod.retry_io(ckpt_mod.save, checkpoint_path, state, tick)
        return checkpoint_path

    has_after_save = hooks is not None and \
        getattr(hooks, "after_save", None) is not None
    writer = ckpt_mod.AsyncCheckpointWriter() if async_save else None
    rollbacks = 0
    try:
        res = None
        while tick < n_ticks:
            clean = _rollback_point(state) if nan_guard else None
            hooked = hook("before_chunk", tick, state)
            if hooked is not None:
                state = hooked
            end = min(tick + save_every, n_ticks)
            res = run_chunk(end, state, tick)
            # the chunk's final carry; persisted before advancing (atomic
            # write; a kill between chunks re-runs at most this chunk)
            if nan_guard and not state_is_finite(res.final_state):
                rollbacks += 1
                hook("on_rollback", tick,
                     f"non-finite carry after chunk ending at tick "
                     f"{end} (rollback {rollbacks}/{max_rollbacks})")
                if rollbacks > max_rollbacks:
                    raise FloatingPointError(
                        f"carry still non-finite after {max_rollbacks} "
                        f"rollbacks of the chunk starting at tick {tick}")
                res = None
                state = engine._map_state(lambda x: x.to(device), clean)
                continue
            rollbacks = 0
            clean = None
            state, tick = res.final_state, end
            hook("before_save", tick)
            path = save(state, tick)
            if has_after_save:
                if writer is not None:
                    writer.wait()        # hook must see the landed file
                hook("after_save", tick, path)
        if res is None:
            # checkpoint already at n_ticks (or the last chunk rolled
            # back): the result from the carry with a zero-tick call
            res = run_chunk(n_ticks, state, tick)
    finally:
        if writer is not None:
            writer.close()
    return res


def _zoo_setup(job: JobConfig, remat: str, device):
    """(program factory, initial-carry builder) for a zoo run — the two
    hooks that turn `train_batched` into full-zoo training."""
    cfg = job.model

    def program(n_batches: int) -> engine.ModelProgram:
        return zoo_mod.make_zoo_program(cfg, job, n_batches, remat)

    def model0():
        return zoo_mod.init_zoo_state(cfg, job, job.seed, device=device)

    return program, model0


def train_zoo(job: JobConfig,
              scenarios: Union[engine.ScenarioBatch,
                               Sequence[engine.Scenario]],
              seeds: Union[int, Sequence[int]] = 8, *,
              remat: str = "none",
              checkpoint_path: Optional[str] = None,
              save_every: Optional[int] = None,
              model0=None,
              device=None,
              **kw) -> engine.EngineResult:
    """Train ``job.model`` — any zoo config (dense, MoE, VLM, SSM, hybrid,
    enc-dec), full width or reduced, float32 or bf16 mixed precision —
    under every scenario × seed on ``device`` (default ``cuda``), each
    step's forward under ``remat`` ("none" by default, as the reference's;
    "dots" or "full" recompute activations in the backward, the same
    values).

    A thin front over `train_batched` (and, when ``checkpoint_path`` +
    ``save_every`` are given, over `train_batched_durable` — the same
    durable chunk loop, step-directory GC, async writer, NaN guard and
    chaos hooks all apply) with the model program swapped for
    `zoo_program.make_zoo_program` (per cell, gated by the engine) and the
    initial carry for `zoo_program.init_zoo_state` from ``job.seed``, or
    ``model0`` (one replica's carry, e.g. the reference's weights carried
    over by `convert.zoo_state_from_reference`). With
    ``job.model.use_flash_attention`` the attention runs through K2 on the
    card. Mixed-precision checkpoints carry bf16 leaves (see
    `checkpoint`'s bit-view encoding). Remaining keyword arguments pass
    through (``n_ticks``, ``n_batches``, ``batch_fn``, ``batch_seed``,
    ``snapshot_every``, ``init_state``/``tick0``, ``keep_last``,
    ``nan_guard`` ...). ``final_model`` holds the grid's carry:
    ``(params, opt_state)`` for float32, ``{"params", "master", "opt"}``
    for mixed precision, leaves (S, R, ...)."""
    device = resolve_device(device)
    program, init = _zoo_setup(job, remat, device)
    model0 = init if model0 is None else model0
    if checkpoint_path is not None:
        if not save_every:
            raise ValueError(
                "train_zoo(checkpoint_path=...) needs save_every ≥ 1")
        return train_batched_durable(
            job, scenarios, seeds, checkpoint_path=checkpoint_path,
            save_every=save_every, program=program, model0=model0,
            device=device, **kw)
    return train_batched(job, scenarios, seeds, program=program,
                         model0=model0, device=device, **kw)


def resume_zoo(path: str, job: JobConfig,
               scenarios: Union[engine.ScenarioBatch,
                                Sequence[engine.Scenario]],
               seeds: Union[int, Sequence[int]],
               remat: str = "none", *, device=None):
    """Load a zoo run's checkpoint back into its (possibly mixed-precision)
    carry on ``device``: ``(state, tick)`` for ``train_zoo(...,
    init_state=state, tick0=tick)``. The restore template is rebuilt from
    the job exactly as `train_zoo` built it, so structure drift is named,
    not silent."""
    del remat                     # template depends only on the carry shape
    _, model0 = _zoo_setup(job, "none", resolve_device(device))
    return restore_batched(path, job, scenarios, seeds, model0=model0,
                           device=device)
