"""The elastic trainer: wires the spot-market/cluster simulator, the paper's
strategies and the elastic train steps into one loop.

``train_batched(megabatch=True)`` / ``ElasticTrainer.run_batched`` run the
paper's experiment: an S-strategy × R-seed grid trains real models
end-to-end, tick by tick — price draw, bid→active-mask, the blocked
forward/backward over every replica, Eq. (5)'s masked-renormalized SGD
update (fused into one kernel with ``use_fused_update``) and
time/cost/idle accounting, all on the device with no host sync between
ticks.

``train_zoo`` trains a zoo config (dense and VLM families, float32 or
bf16 mixed precision, ``use_flash_attention`` routing attention through
K2) through the same machinery with the per-cell program of
`train.zoo_program` swapped in through ``train_batched``'s ``program`` and
``model0`` hooks.

Ported so far: these two paths. The vmapped per-replica path
(``train_batched(megabatch=False)`` with the reference's
``make_train_program``) and the legacy per-iteration loop
(``ElasticTrainer.run``), snapshots and checkpointing, durable runs and the
mesh raise ``NotImplementedError`` naming the slice they come with.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import JobConfig
from repro_torch.core.strategies import Strategy
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import exact_float32, resolve_device
from repro_torch.sim import engine
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.train import megabatch as megabatch_mod
from repro_torch.train import zoo_program as zoo_mod


@dataclasses.dataclass
class ElasticTrainer:
    """A job, its simulated cluster and its strategy. Building one
    allocates no model: ``run_batched`` initializes the grid's replicas
    itself, straight into their flat blocked buffers."""

    job: JobConfig
    cluster: VolatileCluster
    strategy: Strategy
    mode: str = "spot"                 # "spot" | "preemptible"
    seed: int = 0
    device: Union[str, torch.device, None] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def run(self, iterations: Optional[int] = None,
            batch_fn: Optional[Callable[[int], Dict]] = None) -> Dict:
        raise engine.not_ported("ElasticTrainer.run (the legacy loop)",
                                "vmapped")

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
        per-iteration "errors" are the batch losses."""
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
    out = {}
    for k in batches[0]:
        arr = np.stack([np.asarray(b[k]) for b in batches])
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.int64)    # torch indexes with int64
        out[k] = torch.from_numpy(arr).to(device)
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

    ``megabatch=True`` runs the replica-blocked program of
    `train.megabatch`: every replica's params and momentum in flat (S, R,
    P) buffers updated in place, one blocked step per tick over the whole
    grid, and with ``use_fused_update`` the elastic SGD apply through the
    fused kernel (`kernels.ops.fused_elastic_update`). ``model0`` (a flat
    {"p", "v"} state of one replica) replaces the job's own init
    (`megabatch.init_megabatch_state` from ``job.seed``) — the hook tests
    use to start both packages from the same weights.

    ``program`` / ``model0`` swap in a caller-built ModelProgram factory
    (``n_batches -> ModelProgram``) and the matching initial carry of one
    replica — the hook `train_zoo` uses; ``program`` takes precedence over
    ``megabatch``. ``model0`` may also be a zero-argument callable that
    builds the carry, so that no caller holds a replica-sized tree while
    the grid's copies are made.

    Returns an EngineResult whose ``errors``/``losses`` trajectory holds
    the per-iteration batch loss and whose ``final_model`` holds the
    grid's carry ((S, R, ...) leaves); for the megabatch program the flat
    {"p", "v"} tensors, which `unpack_batched_model` converts back."""
    if program is None and not megabatch:
        raise engine.not_ported("train_batched(megabatch=False)",
                                "vmapped")
    if program is not None and model0 is None:
        raise ValueError("train_batched(program=...) needs the matching "
                         "model0= carry")
    if mesh is not None:
        raise engine.not_ported("train_batched(mesh=...)", "mesh")
    if snapshot_every or init_state is not None or tick0:
        raise engine.not_ported("snapshot_every / init_state / tick0",
                                "snapshots")
    device = resolve_device(device)
    exact_float32()
    scenarios, program, data, n_ticks = _prepare_batched(
        job, scenarios, n_ticks=n_ticks, n_batches=n_batches,
        batch_fn=batch_fn, batch_seed=batch_seed,
        use_fused_update=use_fused_update, program=program, device=device)
    if callable(model0):
        model0 = model0()
    if model0 is None:
        model0 = megabatch_mod.init_megabatch_state(
            job.model, job, job.seed, device=device)
    n_seeds = int(seeds) if np.isscalar(seeds) else len(seeds)
    state = engine.initial_state(scenarios, model0, n_seeds, device=device)
    del model0                   # the grid holds its own copies
    return engine.simulate_program(scenarios, program, None, data, seeds,
                                   engine.SimConfig(n_ticks=n_ticks),
                                   init_state=state, device=device)


def _prepare_batched(job: JobConfig, scenarios, *, n_ticks, n_batches,
                     batch_fn, batch_seed, use_fused_update: bool,
                     program=None, device):
    """Stack + fleet-width check, batch stream, program (``program``, a
    factory ``n_batches -> ModelProgram``, else the megabatch program),
    tick-budget default."""
    if not isinstance(scenarios, engine.ScenarioBatch):
        scenarios = engine.stack_scenarios(scenarios, device=device)
    if scenarios.n_max != job.n_workers:
        raise ValueError(
            f"scenario fleet width {scenarios.n_max} != job.n_workers "
            f"{job.n_workers}: the elastic mask must cover every worker "
            "slice")
    j_max = scenarios.j_max
    n_batches = n_batches or j_max
    data = stack_batches(job, n_batches, seed=batch_seed, batch_fn=batch_fn,
                         device=device)
    if program is not None:
        program = program(n_batches)
    else:
        program = make_megabatch_train_program(job, n_batches,
                                               use_fused_update)
    return scenarios, program, data, n_ticks or default_n_ticks(j_max)


def default_n_ticks(j_max: int) -> int:
    """The tick budget of a run whose longest plan has ``j_max``
    iterations, when the caller names none."""
    return 2 * j_max + 16


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
    """Train ``job.model`` — a dense or VLM zoo config, full width or
    reduced, float32 or bf16 mixed precision — under every scenario × seed
    on ``device`` (default ``cuda``).

    A thin front over `train_batched` with the model program swapped for
    `zoo_program.make_zoo_program` (per cell, gated by the engine) and the
    initial carry for `zoo_program.init_zoo_state` from ``job.seed``, or
    ``model0`` (one replica's carry, e.g. the reference's weights carried
    over by `convert.zoo_state_from_reference`). With
    ``job.model.use_flash_attention`` the attention runs through K2 on the
    card. Remaining keyword arguments pass through (``n_ticks``,
    ``n_batches``, ``batch_fn``, ``batch_seed``). ``final_model`` holds the
    grid's carry: ``(params, opt_state)`` for float32, ``{"params",
    "master", "opt"}`` for mixed precision, leaves (S, R, ...).

    ``checkpoint_path`` / ``save_every`` (the reference's durable runs)
    raise: they come with the snapshots slice."""
    if checkpoint_path is not None or save_every is not None:
        raise engine.not_ported("train_zoo(checkpoint_path=, save_every=)",
                                "snapshots")
    device = resolve_device(device)
    program, init = _zoo_setup(job, remat, device)
    return train_batched(job, scenarios, seeds, program=program,
                         model0=init if model0 is None else model0,
                         device=device, **kw)
