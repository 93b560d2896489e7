"""Vectorized scenario engine: simulate markets × strategies × seeds, tick
by tick, with every (scenario, seed) cell's state in (S, R) tensors on the
device.

Per tick: price draw → plan-table bucket latch → bid/preemption active mask
→ runtime and cost accounting (`_market_tick`, vectorized over the whole
(S, R) grid) → the model program (one call over the whole grid, which
lands its update where the tick runs) → clock, cost, idle time and
trajectory updates.
The tick loop is a Python loop that never reads a value back to the host;
the one sync is at the end, when the trajectories become numpy arrays.

Time model (§III-C): each tick queries the price prevailing at the current
wall clock; if ≥1 worker is active an SGD iteration runs and the clock
advances by the sampled runtime R(y), else the clock advances by
``idle_step`` (idle time, no iteration). A scenario stops accumulating once
it has completed its ``J`` iterations. Active workers pay the *price*, not
the bid (§IV).

Randomness is a counter-based hash (`_hash`), keyed by (seed value,
absolute tick, stream, worker lane) — never by device or grid position — so
runs repeat exactly and the CPU and the card draw the same bits. It is not
the reference's threefry: against ``repro.sim.engine`` the market is held
exactly only where it draws nothing (tick-indexed trace prices with a
deterministic runtime), and statistically elsewhere.

Programs: a ``ModelProgram``'s step is called once a tick over the whole
(S, R) grid and lands its own update where the tick runs. The megabatch
trainer of ``train_batched(megabatch=True)`` and the quadratic oracle of
``quadratic_program``/``simulate`` step the grid in one call; `per_cell`
builds such a step from one written for one (scenario, seed) cell, the
layout of the reference's ``_sim_one`` that ``train_zoo`` runs (the
reference vmaps it over the grid; here each cell's step is a call of its
own, every tick, running or not). The reference steps the quadratic per
cell; here it steps the grid, with the same arithmetic per cell.
``SimConfig.snapshot_every`` stacks the whole carry every k ticks
(``snapshot_state``), and ``simulate_program(init_state=, tick0=)``
resumes from it bit for bit: every draw is keyed by the absolute
tick. ``simulate_sharded`` runs the grid in shards over a
``launch.mesh.Mesh`` (scenarios over ``data``, seeds over ``replica``),
bit for bit the unsharded run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.strategies import NEVER_BID
from repro_torch.device import resolve_device
from repro_torch.sim.market_core import (BID_EPS, iteration_cost,  # noqa: F401
                                         preemptible_active,
                                         spot_active_mask)
from repro_torch.spans import span
from repro_torch.tree import tree_index, tree_map

# Modes / price kinds (ints so they stack as data).
SPOT, PREEMPTIBLE = 0, 1
PRICE_UNIFORM, PRICE_TRUNC_GAUSS, PRICE_TRACE, PRICE_EMPIRICAL = 0, 1, 2, 3
PRICE_TRACE_TICK = 4

# --------------------------------------------------------------------------
# Scenario specification
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PriceSpec:
    """Batchable price-distribution parameters (one scenario).

    kind=PRICE_UNIFORM:      U[lo, hi].
    kind=PRICE_TRUNC_GAUSS:  N(mu, sigma²) truncated to [lo, hi] (exact
                             inverse-CDF via ndtri — no bisection).
    kind=PRICE_TRACE:        *time-indexed* trace replay: the price at wall
                             clock ``t`` is the trace entry whose timestamp
                             is the last one ≤ ``t mod period``. Per-seed
                             variation comes from a deterministic index
                             offset (seed 0 replays verbatim).
    kind=PRICE_TRACE_TICK:   legacy *tick-indexed* replay: one entry per
                             engine tick regardless of the clock — matches
                             ``TickPrices`` (call-counting).
    kind=PRICE_EMPIRICAL:    i.i.d. draws from the empirical quantile of
                             ``trace`` (must be sorted).
    """

    kind: int
    lo: float
    hi: float
    mu: float = 0.0
    sigma: float = 1.0
    trace: Optional[np.ndarray] = None
    times: Optional[np.ndarray] = None     # (L,) ascending, times[0] == 0
    period: Optional[float] = None         # wrap length, > times[-1]

    @classmethod
    def uniform(cls, lo: float, hi: float) -> "PriceSpec":
        return cls(kind=PRICE_UNIFORM, lo=lo, hi=hi)

    @classmethod
    def trunc_gaussian(cls, mu: float, sigma: float, lo: float,
                       hi: float) -> "PriceSpec":
        return cls(kind=PRICE_TRUNC_GAUSS, lo=lo, hi=hi, mu=mu, sigma=sigma)

    @classmethod
    def from_trace(cls, trace: np.ndarray, times: Optional[np.ndarray] = None,
                   step: float = 1.0,
                   period: Optional[float] = None) -> "PriceSpec":
        """Time-indexed trace replay (the ``TracePrices`` analogue).
        ``times`` default to ``step * arange(len(trace))`` and ``period``
        to ``len(trace) * step``; validation is shared with every other
        trace consumer via ``sim.traces.PriceTrace``."""
        from repro_torch.sim.traces import PriceTrace
        if isinstance(trace, PriceTrace):
            pt = trace
        else:
            trace = np.asarray(trace, np.float32)
            if times is None:
                # default timestamps in f32 arithmetic, as the reference
                # computes them
                times = np.float32(step) * np.arange(len(trace),
                                                     dtype=np.float32)
                if period is None:
                    period = float(step) * len(trace)
            pt = PriceTrace.from_arrays(trace, times=np.asarray(times, float),
                                        step=step, period=period)
        trace = np.asarray(pt.values, np.float32)
        return cls(kind=PRICE_TRACE, lo=float(trace.min()),
                   hi=float(trace.max()), trace=trace,
                   times=np.asarray(pt.times, np.float32),
                   period=float(pt.period))

    @classmethod
    def from_trace_ticks(cls, trace: np.ndarray) -> "PriceSpec":
        """Legacy tick-indexed replay: one entry per engine tick
        (wrapping), regardless of the wall clock."""
        trace = np.asarray(trace, np.float32)
        return cls(kind=PRICE_TRACE_TICK, lo=float(trace.min()),
                   hi=float(trace.max()), trace=trace)

    @classmethod
    def empirical(cls, samples: np.ndarray) -> "PriceSpec":
        samples = np.sort(np.asarray(samples, np.float32))
        return cls(kind=PRICE_EMPIRICAL, lo=float(samples[0]),
                   hi=float(samples[-1]), trace=samples)

    @classmethod
    def from_dist(cls, dist) -> "PriceSpec":
        """Map a core.cost_model.PriceDist onto a batchable spec."""
        from repro_torch.core.cost_model import (EmpiricalPrice,
                                                 TruncGaussianPrice,
                                                 UniformPrice)
        if isinstance(dist, UniformPrice):
            return cls.uniform(dist.lo, dist.hi)
        if isinstance(dist, TruncGaussianPrice):
            return cls.trunc_gaussian(dist.mu, dist.sigma, dist.lo, dist.hi)
        if isinstance(dist, EmpiricalPrice):
            return cls.empirical(dist.samples)
        raise TypeError(f"no batchable spec for {type(dist).__name__}")


@dataclasses.dataclass
class Scenario:
    """One simulation scenario = market × strategy-plan × runtime model.

    Exactly one of ``bid_schedule`` (mode=SPOT: per-iteration per-worker
    bids, shape (J, n)), ``bid_table`` (mode=SPOT, adaptive: per-time-bucket
    bid schedules, shape (B, J, n) — see ``bucket_starts``/``replan_at``) or
    ``worker_schedule`` (mode=PREEMPTIBLE: provisioned worker counts, shape
    (J,)) must be given. At the first tick of iteration ``replan_at`` the
    engine latches the ``bucket_starts`` bucket containing the wall clock
    and uses that table slice for the rest of the run.
    """

    price: PriceSpec
    alpha: float                            # SGD step size
    bid_schedule: Optional[np.ndarray] = None
    worker_schedule: Optional[np.ndarray] = None
    bid_table: Optional[np.ndarray] = None
    bucket_starts: Optional[np.ndarray] = None
    replan_at: Optional[int] = None
    J_target: Optional[int] = None  # stop after this many iterations even
    #                                 though the plan arrays are wider
    n_fleet: Optional[int] = None  # preemptible: mask width override
    preempt_q: float = 0.0
    on_demand_price: float = 1.0
    rt_kind: str = "exp"                    # "exp" | "det"
    rt_lam: float = 1.0
    rt_delta: float = 0.05
    rt_const: float = 1.0
    idle_step: float = 0.1
    name: str = ""

    def __post_init__(self):
        given = sum(x is not None for x in
                    (self.bid_schedule, self.bid_table,
                     self.worker_schedule))
        if given != 1:
            raise ValueError("give exactly one of bid_schedule / bid_table "
                             "/ worker_schedule")
        if self.bid_schedule is not None:
            self.bid_schedule = np.atleast_2d(
                np.asarray(self.bid_schedule, np.float32))
            # a plain schedule is a 1-bucket table
            self.bid_table = self.bid_schedule[None]
        if self.bid_table is not None:
            self.bid_table = np.asarray(self.bid_table, np.float32)
            if self.bid_table.ndim != 3:
                raise ValueError(f"bid_table must be (B, J, n), got shape "
                                 f"{self.bid_table.shape}")
            if self.bucket_starts is None:
                self.bucket_starts = np.zeros(self.bid_table.shape[0],
                                              np.float32)
            self.bucket_starts = np.asarray(self.bucket_starts, np.float32)
            if len(self.bucket_starts) != self.bid_table.shape[0]:
                raise ValueError(
                    f"{len(self.bucket_starts)} bucket_starts for "
                    f"{self.bid_table.shape[0]} table buckets")
            if (self.bucket_starts[0] != 0.0
                    or np.any(np.diff(self.bucket_starts) < 0)):
                raise ValueError("bucket_starts must ascend from 0, got "
                                 f"{self.bucket_starts}")
            if self.bid_table.shape[0] > 1 and self.replan_at is None:
                raise ValueError(
                    "a multi-bucket bid_table needs replan_at (the "
                    "iteration at which the engine latches the bucket) — "
                    "without it only bucket 0 would ever be used")
        if self.J_target is not None:
            if not 1 <= int(self.J_target) <= self.plan_width:
                raise ValueError(
                    f"J_target={self.J_target} must lie in [1, "
                    f"{self.plan_width}] (the plan width)")

    @property
    def mode(self) -> int:
        return SPOT if self.bid_table is not None else PREEMPTIBLE

    @property
    def n_buckets(self) -> int:
        return 1 if self.bid_table is None else int(self.bid_table.shape[0])

    @property
    def plan_width(self) -> int:
        """Rows in the plan arrays (≥ J when J_target overrides)."""
        if self.bid_table is not None:
            return int(self.bid_table.shape[1])
        return int(np.shape(self.worker_schedule)[0])

    @property
    def J(self) -> int:
        if self.J_target is not None:
            return int(self.J_target)
        return self.plan_width

    @property
    def n_workers(self) -> int:
        if self.bid_table is not None:
            return int(self.bid_table.shape[2])
        return max(int(np.max(self.worker_schedule)), self.n_fleet or 0)

    @classmethod
    def from_runtime(cls, rt, **kw) -> "Scenario":
        """Fill the runtime fields from a core.cost_model.RuntimeModel."""
        return cls(rt_kind=rt.kind, rt_lam=rt.lam, rt_delta=rt.delta,
                   rt_const=rt.r_const, **kw)


class ScenarioBatch(NamedTuple):
    """Stacked scenarios (leading axis S), one tensor per field."""

    bid_table: torch.Tensor        # (S, B_max, J_max, N) f32, NEVER_BID-pad
    bucket_starts: torch.Tensor    # (S, B_max) f32, +inf-padded
    replan_at: torch.Tensor        # (S,) i32 (J_max+1 => never latch)
    worker_schedule: torch.Tensor  # (S, J_max) i32
    mode: torch.Tensor             # (S,) i32
    price_kind: torch.Tensor       # (S,) i32
    price_lo: torch.Tensor         # (S,) f32
    price_hi: torch.Tensor
    price_mu: torch.Tensor
    price_sigma: torch.Tensor
    trace: torch.Tensor            # (S, L_tr) f32 (zeros when unused)
    trace_len: torch.Tensor        # (S,) i32
    trace_times: torch.Tensor      # (S, L_tr) f32 timestamps, +inf-padded
    trace_period: torch.Tensor     # (S,) f32 wrap length (1 when unused)
    preempt_q: torch.Tensor        # (S,) f32
    on_demand_price: torch.Tensor
    rt_kind: torch.Tensor          # (S,) i32: 0 exp, 1 det
    rt_lam: torch.Tensor
    rt_delta: torch.Tensor
    rt_const: torch.Tensor
    alpha: torch.Tensor
    J: torch.Tensor                # (S,) i32 target iterations
    idle_step: torch.Tensor

    @property
    def n_scenarios(self) -> int:
        return self.mode.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.bid_table.shape[1]

    @property
    def j_max(self) -> int:
        return self.bid_table.shape[2]

    @property
    def n_max(self) -> int:
        return self.bid_table.shape[3]

    def to(self, device) -> "ScenarioBatch":
        return ScenarioBatch(*(x.to(device) for x in self))


def stack_scenarios(scenarios: Sequence[Scenario], *,
                    device=None) -> ScenarioBatch:
    """Pad and stack heterogeneous scenarios into one ScenarioBatch on
    ``device`` (default ``cuda``).

    Bid tables are padded to (B_max, J_max, N_max): extra workers get
    NEVER_BID, iterations past a scenario's own J repeat its last row and
    buckets past its own B repeat its last bucket (neither is ever selected
    — the engine stops at J, and padded bucket starts are +inf — the repeat
    just keeps gathers in-bounds).
    """
    device = resolve_device(device)
    S = len(scenarios)
    b_max = max(s.n_buckets for s in scenarios)
    j_max = max(s.plan_width for s in scenarios)
    n_max = max(s.n_workers for s in scenarios)
    l_tr = max([len(s.price.trace) for s in scenarios
                if s.price.trace is not None] or [1])

    bid = np.full((S, b_max, j_max, n_max), NEVER_BID, np.float32)
    starts = np.full((S, b_max), np.inf, np.float32)
    starts[:, 0] = 0.0
    replan = np.full(S, j_max + 1, np.int32)
    wrk = np.zeros((S, j_max), np.int32)
    trc = np.zeros((S, l_tr), np.float32)
    tln = np.ones(S, np.int32)
    # timestamps: +inf past a scenario's own trace so a right-bisect of any
    # finite clock value lands inside the real entries; row 0 stays 0 so the
    # lookup index is never negative
    tms = np.full((S, l_tr), np.inf, np.float32)
    tms[:, 0] = 0.0
    period = np.ones(S, np.float32)
    cols: Dict[str, np.ndarray] = {
        k: np.zeros(S, np.float32) for k in
        ["price_lo", "price_hi", "price_mu", "price_sigma", "preempt_q",
         "on_demand_price", "rt_lam", "rt_delta", "rt_const", "alpha",
         "idle_step"]}
    mode = np.zeros(S, np.int32)
    pk = np.zeros(S, np.int32)
    rtk = np.zeros(S, np.int32)
    J = np.zeros(S, np.int32)

    for i, s in enumerate(scenarios):
        J[i] = s.J
        mode[i] = s.mode
        pk[i] = s.price.kind
        rtk[i] = 0 if s.rt_kind == "exp" else 1
        if s.bid_table is not None:
            b = s.bid_table                       # (B, J, n)
            bid[i, :b.shape[0], :b.shape[1], :b.shape[2]] = b
            bid[i, :b.shape[0], b.shape[1]:, :b.shape[2]] = b[:, -1:]
            bid[i, b.shape[0]:] = bid[i, b.shape[0] - 1]
            starts[i, :len(s.bucket_starts)] = s.bucket_starts
            if s.replan_at is not None:
                replan[i] = s.replan_at
        else:
            w = np.asarray(s.worker_schedule, np.int32)
            wrk[i, :len(w)] = w
            wrk[i, len(w):] = w[-1]
        if s.price.trace is not None:
            tr = np.asarray(s.price.trace, np.float32)
            reps = int(np.ceil(l_tr / len(tr)))
            trc[i] = np.tile(tr, reps)[:l_tr]
            tln[i] = len(tr)
        if s.price.kind == PRICE_TRACE:
            if s.price.times is None or s.price.period is None:
                raise ValueError(
                    f"scenario {i} ({s.name!r}): a PRICE_TRACE spec needs "
                    "timestamps and a period — build it with "
                    "PriceSpec.from_trace (or use from_trace_ticks for "
                    "tick-indexed replay)")
            tms[i, :len(s.price.times)] = s.price.times
            period[i] = s.price.period
        for k, v in [("price_lo", s.price.lo), ("price_hi", s.price.hi),
                     ("price_mu", s.price.mu),
                     ("price_sigma", s.price.sigma),
                     ("preempt_q", s.preempt_q),
                     ("on_demand_price", s.on_demand_price),
                     ("rt_lam", s.rt_lam), ("rt_delta", s.rt_delta),
                     ("rt_const", s.rt_const), ("alpha", s.alpha),
                     ("idle_step", s.idle_step)]:
            cols[k][i] = v

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return ScenarioBatch(
        bid_table=dev(bid), bucket_starts=dev(starts),
        replan_at=dev(replan), worker_schedule=dev(wrk), mode=dev(mode),
        price_kind=dev(pk), trace=dev(trc), trace_len=dev(tln),
        trace_times=dev(tms), trace_period=dev(period), rt_kind=dev(rtk),
        J=dev(J), **{k: dev(v) for k, v in cols.items()})


# --------------------------------------------------------------------------
# The Theorem-1 quadratic oracle
# --------------------------------------------------------------------------


class TorchQuadratic(NamedTuple):
    """Device-side view of data.synthetic.QuadraticProblem (the reference's
    ``JaxQuadratic``). The quadratic is exact, so error = G(w) − G* =
    ½ (w−w*)ᵀ H (w−w*). Every method takes iterates with any leading
    axes, ``w`` (..., d).

    Every contraction is an elementwise product summed over one axis,
    never a matrix product: a matrix product over the grid folds the cells
    into its rows, and BLAS picks its kernel, and so its order of
    summation, by the number of rows. Summed this way a cell's bits do not
    depend on how many cells share the call, so a grid run in shards
    (`simulate_sharded`) is bit for bit the grid run whole."""

    A: torch.Tensor          # (n_samples, d, d) f32
    b: torch.Tensor          # (n_samples, d)
    H: torch.Tensor          # (d, d) average Hessian
    w_star: torch.Tensor     # (d,)

    @property
    def n_samples(self) -> int:
        return self.A.shape[0]

    def to(self, device) -> "TorchQuadratic":
        return TorchQuadratic(*(x.to(device) for x in self))

    def error(self, w: torch.Tensor) -> torch.Tensor:
        d = w - self.w_star
        return 0.5 * (d * _matvec(self.H, d)).sum(-1)

    def full_grad(self, w: torch.Tensor) -> torch.Tensor:
        return _matvec(self.H, w - self.w_star)

    def minibatch_grads_at(self, idx: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
        """Per-worker minibatch gradients on explicit sample indices
        ``idx`` (..., n_workers, batch) -> (..., n_workers, d)."""
        a = self.A[idx]                                  # (..., n, b, d, d)
        r = _matvec(a, w[..., None, None, :]) - self.b[idx]
        return (a * r[..., :, None]).sum(-2).sum(-2) / idx.shape[-1]

    def minibatch_grads(self, key: torch.Tensor, w: torch.Tensor,
                        n_workers: int, batch: int) -> torch.Tensor:
        """Per-worker minibatch gradients, (..., n_workers, d), on the
        indices `minibatch_indices` draws from ``key`` (...)."""
        return self.minibatch_grads_at(
            minibatch_indices(key, n_workers, batch, self.n_samples), w)


def _matvec(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m (..., d, d) @ x (..., d) -> (..., d), cell by cell (see
    `TorchQuadratic`)."""
    return (m * x[..., None, :]).sum(-1)


def torch_quadratic(quad, device=None) -> TorchQuadratic:
    """Lift a numpy QuadraticProblem onto ``device`` (default ``cuda``)."""
    device = resolve_device(device)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return TorchQuadratic(A=dev(quad.A), b=dev(quad.b), H=dev(quad.H),
                          w_star=dev(quad.w_star))


def minibatch_indices(key: torch.Tensor, n_workers: int, batch: int,
                      n_samples: int) -> torch.Tensor:
    """(..., n_workers, batch) sample indices in [0, n_samples), hashed
    from each cell's tick word ``key`` (...), the worker lane and the
    sample: the same bits on every device."""
    dev = key.device
    lane = torch.arange(n_workers, device=dev)[:, None]
    sample = torch.arange(batch, device=dev)[None, :]
    return _hash(key[..., None, None], lane, sample) % n_samples


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Engine configuration."""

    n_ticks: int                 # market ticks to run (≥ J + idle budget)
    batch: int = 16              # per-worker minibatch size (quad program)
    grad: str = "minibatch"      # "minibatch" | "full" (deterministic)
    snapshot_every: int = 0      # stack the full carry every k ticks
    #                              (0 = off) — the resumable checkpoints


@dataclasses.dataclass(frozen=True, eq=False)
class ModelProgram:
    """Pluggable model under the engine's tick loop: ``step_fn`` is called
    ONCE per tick over the whole grid, with leading (S, R) axes on every
    argument::

        step_fn(model, data, key, mask, j, alpha, running)
            model: the carry, a nested dict/tuple of (S, R, ...) tensors
            key: (S, R) int64 hash;  mask: (S, R, n_max) f32
            j: (S, R) int64 iterations done;  alpha: (S, R) f32 step size
            running: (S, R) bool, the iteration runs
            -> (model, metric (S, R))

    The step runs for every cell on every tick, running or not, and writes
    the carry in place wherever ``running`` holds and nowhere else, so
    idle and finished ticks are true no-ops on every leaf; the engine keeps
    the model it returns. ``data`` is an arbitrary object shared by all
    cells (stacked batches, a `TorchQuadratic`). `per_cell` builds a
    program from a step written for one cell; `gate_model` lands a step's
    new trees under ``running``.
    """

    step_fn: Callable[..., Any]
    name: str = "program"


def per_cell(step_fn: Callable[..., Any], name: str = "program"
             ) -> ModelProgram:
    """A program that runs ``step_fn`` for one (scenario, seed) cell at a
    time::

        step_fn(cell, data, key, mask, j, alpha, running) -> (cell, metric)

    with views of the cell's carry (`tree_index`), its 0-d ``key``,
    ``j``, ``alpha`` and ``running`` and its (n_max,) ``mask``; the step
    lands its update in those views where ``running`` holds (in place, or
    through `gate_model`). Its metric is cast to float32."""

    def grid_step(model, data, key, mask, j, alpha, running):
        s_dim, r_dim = j.shape
        metric = torch.empty((s_dim, r_dim), dtype=torch.float32,
                             device=j.device)
        for s in range(s_dim):
            for r in range(r_dim):
                _, met = step_fn(tree_index(model, (s, r)), data, key[s, r],
                                 mask[s, r], j[s, r], alpha[s, r],
                                 running[s, r])
                metric[s, r] = met
        return model, metric

    return ModelProgram(step_fn=grid_step, name=name)


def gate_model(running: torch.Tensor, stepped, old) -> None:
    """Land the stepped model in ``old`` only where ``running`` holds,
    leaf by leaf and in place: each stepped leaf is cast to the carry
    leaf's dtype (a mixed-precision step that returns a promoted leaf
    cannot change the carry's dtypes) and written once under ``running``,
    a device bool (0-d for one cell), so the host never learns whether
    the tick ran. An idle tick writes every leaf's own bits back."""
    with span("engine.gate"):
        tree_map(lambda new, o: torch.where(running, new.to(o.dtype), o,
                                            out=o), stepped, old)


class SimState(NamedTuple):
    """(S, R) carry of the tick loop."""

    t: torch.Tensor              # wall clock f32
    j: torch.Tensor              # iterations completed (int64)
    bucket: torch.Tensor         # latched plan-table bucket (int64, -1=unset)
    total_cost: torch.Tensor     # f32
    total_idle: torch.Tensor     # f32
    model: Any                   # nested dict/tuple of (S, R, ...) tensors
    err_traj: torch.Tensor       # (S, R, J_max) program metric after iter j
    cost_traj: torch.Tensor      # (S, R, J_max) cumulative cost
    time_traj: torch.Tensor      # (S, R, J_max) wall clock
    y_traj: torch.Tensor         # (S, R, J_max) active workers


def initial_state(scenarios: "ScenarioBatch | Sequence[Scenario]", model0,
                  n_seeds: int, *, device=None) -> SimState:
    """The (S, R) initial carry on ``device`` (default ``cuda``): every
    (scenario, seed) replica starts from ``model0`` (a nested dict/tuple of
    tensors or arrays, each leaf copied into a contiguous (S, R, ...)
    buffer) at t=0 with empty trajectories."""
    device = resolve_device(device)
    if not isinstance(scenarios, ScenarioBatch):
        scenarios = stack_scenarios(scenarios, device=device)
    grid = (scenarios.n_scenarios, int(n_seeds))
    j_max = scenarios.j_max
    model = tree_map(
        lambda x: torch.as_tensor(x, device=device).expand(
            grid + tuple(x.shape)).clone(
                memory_format=torch.contiguous_format), model0)

    def nan_traj():
        return torch.full(grid + (j_max,), float("nan"), dtype=torch.float32,
                          device=device)

    def zeros(dtype):
        return torch.zeros(grid, dtype=dtype, device=device)

    return SimState(
        t=zeros(torch.float32), j=zeros(torch.int64),
        bucket=torch.full(grid, -1, dtype=torch.int64, device=device),
        total_cost=zeros(torch.float32), total_idle=zeros(torch.float32),
        model=model, err_traj=nan_traj(), cost_traj=nan_traj(),
        time_traj=nan_traj(), y_traj=nan_traj())


@dataclasses.dataclass
class EngineResult:
    """Stacked trajectories, shape (S, R, J_max); invalid entries are NaN
    (iterations a scenario never ran within the tick budget)."""

    errors: np.ndarray
    costs: np.ndarray
    times: np.ndarray
    ys: np.ndarray
    iterations: np.ndarray       # (S, R) completed iterations
    total_time: np.ndarray       # (S, R) final wall clock (incl. idle)
    total_cost: np.ndarray       # (S, R)
    total_idle: np.ndarray       # (S, R)
    J: np.ndarray                # (S,) per-scenario targets
    final_model: Any = None      # device tensors, leaves stacked (S, R, ...)
    snapshots: Any = None        # SimState on the device, leaves
    #                              (S, R, n_snap, ...): the full carry every
    #                              cfg.snapshot_every ticks (None when off)
    snapshot_ticks: Optional[np.ndarray] = None  # (n_snap,): snapshot i is
    #                              the carry after tick snapshot_ticks[i]
    #                              (resume passes it as tick0)
    final_state: Optional["SimState"] = None  # the final carry itself, on
    #                              the device: a resume from the end of
    #                              this run needs no snapshot copy

    @property
    def losses(self) -> np.ndarray:
        """Alias: for real-model programs the metric trajectory is the
        per-iteration batch loss, not a suboptimality gap."""
        return self.errors

    @property
    def completed(self) -> np.ndarray:
        """(S, R) bool: scenario finished all J iterations within n_ticks."""
        return self.iterations >= self.J[:, None]

    def summary(self) -> Dict[str, np.ndarray]:
        import warnings

        ys = np.where(np.isnan(self.ys), np.nan, np.maximum(self.ys, 1.0))
        with warnings.catch_warnings(), np.errstate(invalid="ignore"):
            warnings.simplefilter("ignore", RuntimeWarning)
            return {
                "iterations": self.iterations,
                "time": self.total_time,
                "cost": self.total_cost,
                "idle": self.total_idle,
                "mean_active": np.nanmean(self.ys, axis=-1),
                "mean_inv_y": np.nanmean(1.0 / ys, axis=-1),
            }


# ----------------------------------------------------------------- RNG

_M32 = 0xFFFFFFFF
STREAM_PRICE, STREAM_DUR, STREAM_GRAD, STREAM_UP = 0, 1, 2, 3


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for x in [0, 2³²) held in int64, without ever
    leaving int64's range (c is split into 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer: a bijection that avalanches."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash(*words) -> torch.Tensor:
    """32-bit hash (in int64) of broadcastable int64 words: the engine's
    counter-based generator. The same words give the same bits on every
    device."""
    h = None
    for i, w in enumerate(words):
        w = torch.as_tensor(w, dtype=torch.int64)
        x = _fmix32((w + 0x9E3779B9 * (i + 1)) & _M32)
        h = x if h is None else _fmix32(h ^ x)
    return h


def _uniform(h: torch.Tensor) -> torch.Tensor:
    """float32 uniform on [0, 1) from the top 24 bits of a hash."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


# --------------------------------------------------------------- ticks


class TickMarket(NamedTuple):
    """The grid's market outcome for one tick, (S, R) leading axes."""

    mask: torch.Tensor           # (S, R, n_max) bool active-worker mask
    y: torch.Tensor              # Σ mask (f32)
    running: torch.Tensor        # bool: the iteration actually runs
    idling: torch.Tensor         # bool: alive but all-preempted
    bucket: torch.Tensor         # updated plan-table bucket
    cost_inc: torch.Tensor       # cost of this tick (0 unless running)
    idle_inc: torch.Tensor       # idle-time increment (0 unless idling)
    dt: torch.Tensor             # wall-clock advance
    k_grad: torch.Tensor         # the model step's random word


def _col(x: torch.Tensor) -> torch.Tensor:
    """(S,) per-scenario field -> (S, 1) to broadcast over seeds."""
    return x[:, None]


def _draw_price(sc: ScenarioBatch, u, k: int, seeds, t) -> torch.Tensor:
    """The (S, R) price prevailing at tick ``k`` / wall clock ``t``; every
    kind is computed and each scenario's is picked (all are cheap)."""
    lo, hi = _col(sc.price_lo), _col(sc.price_hi)
    mu, sigma = _col(sc.price_mu), _col(sc.price_sigma)
    n_tr = _col(sc.trace_len).to(torch.int64)
    p_unif = lo + u * (hi - lo)
    lo_z = torch.special.ndtr((lo - mu) / sigma)
    hi_z = torch.special.ndtr((hi - mu) / sigma)
    p_gauss = torch.minimum(torch.maximum(
        mu + sigma * torch.special.ndtri(lo_z + u * (hi_z - lo_z)), lo), hi)
    # per-seed trace variation = deterministic index offset; seed 0
    # replays the trace verbatim
    roll = seeds[None, :] * 1013
    # time-indexed replay: the entry whose timestamp is the last one ≤ the
    # wrapped wall clock (fmod is exact, as the reference's jnp.mod is)
    t_eff = torch.fmod(t, _col(sc.trace_period))
    idx_t = torch.searchsorted(sc.trace_times, t_eff.contiguous(),
                               right=True) - 1
    idx_t = torch.minimum(torch.clamp(idx_t, min=0), n_tr - 1)
    p_time = sc.trace.gather(1, (idx_t + roll) % n_tr)
    p_tick = sc.trace.gather(1, ((k + roll) % n_tr).expand_as(idx_t))
    # empirical quantile: samples[int(u·len)] on the sorted trace
    idx_e = torch.minimum((u * n_tr.to(torch.float32)).to(torch.int64),
                          n_tr - 1)
    p_emp = sc.trace.gather(1, idx_e.expand_as(idx_t))
    kind = _col(sc.price_kind)
    return torch.where(
        kind == PRICE_EMPIRICAL, p_emp,
        torch.where(kind == PRICE_TRACE, p_time,
                    torch.where(kind == PRICE_TRACE_TICK, p_tick,
                                torch.where(kind == PRICE_TRUNC_GAUSS,
                                            p_gauss, p_unif))))


def _market_tick(sc: ScenarioBatch, seeds, t, j, bucket0,
                 k: int) -> TickMarket:
    """Market/accounting logic for the whole (S, R) grid at absolute tick
    ``k``: price draw, plan-table bucket latch, bid/preemption mask,
    runtime and cost. ``seeds`` (R,) int64 seed values; t/j/bucket0
    (S, R). Cells that share a seed share its random words, as in the
    reference, where each cell's key folds in only its seed."""
    s_dim, r_dim = t.shape
    j_max, n_max = sc.bid_table.shape[2], sc.bid_table.shape[3]
    dev = t.device
    lane = torch.arange(n_max, device=dev)
    sd = seeds[:, None]
    u_price = _uniform(_hash(seeds, k, STREAM_PRICE, 0))[None, :]
    u_dur = _uniform(_hash(sd, k, STREAM_DUR, lane))[None]     # (1,R,N)
    u_up = _uniform(_hash(sd, k, STREAM_UP, lane))[None]
    k_grad = _hash(seeds, k, STREAM_GRAD, 0)[None, :].expand(s_dim, r_dim)
    price = _draw_price(sc, u_price, k, seeds, t)

    # plan-table bucket: latched from the wall clock at the first tick of
    # iteration `replan_at`, 0 (the t=0 plan) before that
    cur_bucket = (t[..., None] >= sc.bucket_starts[:, None, :]).sum(-1) - 1
    bucket = torch.where((bucket0 < 0) & (j >= _col(sc.replan_at)),
                         cur_bucket, bucket0)
    row = torch.clamp(j, max=j_max - 1)
    si = torch.arange(s_dim, device=dev)[:, None]
    bids = sc.bid_table[si, torch.clamp(bucket, min=0), row]  # (S,R,N)
    mask_spot = spot_active_mask(bids, price[..., None])
    prov = sc.worker_schedule[si, row]
    mask_pre = (lane < prov[..., None]) & preemptible_active(
        u_up, sc.preempt_q[:, None, None])
    mask = torch.where(sc.mode[:, None, None] == PREEMPTIBLE, mask_pre,
                       mask_spot)
    y = mask.to(torch.float32).sum(-1)

    done = j >= _col(sc.J)
    running = (y >= 1.0) & ~done
    idling = ~running & ~done

    # runtime R(y): max of the active workers' exp(λ) draws + Δ, or R
    draws = -torch.log1p(-u_dur) / sc.rt_lam[:, None, None]
    dur_exp = torch.where(mask, draws, 0.0).amax(-1) + _col(sc.rt_delta)
    dur = torch.where(_col(sc.rt_kind) == 1, _col(sc.rt_const), dur_exp)
    price_paid = torch.where(_col(sc.mode) == PREEMPTIBLE,
                             _col(sc.on_demand_price), price)
    zero = torch.zeros_like(y)
    cost_inc = torch.where(running, iteration_cost(y, price_paid, dur), zero)
    idle_inc = torch.where(idling, _col(sc.idle_step).expand_as(y), zero)
    dt = torch.where(running, dur, idle_inc)
    return TickMarket(mask=mask, y=y, running=running, idling=idling,
                      bucket=bucket, cost_inc=cost_inc, idle_inc=idle_inc,
                      dt=dt, k_grad=k_grad)


def _put(traj: torch.Tensor, idx: torch.Tensor, running: torch.Tensor,
         val: torch.Tensor) -> None:
    """traj[s, r, idx[s, r]] = val where running (in place)."""
    cur = traj.gather(2, idx[..., None])[..., 0]
    traj.scatter_(2, idx[..., None],
                  torch.where(running, val, cur)[..., None])


def _advance(state: SimState, m: TickMarket, metric: torch.Tensor,
             model, j_max: int) -> SimState:
    """Clock, cost, idle time and trajectories after one tick; the
    trajectories are written in place."""
    t_new = state.t + m.dt
    cost_new = state.total_cost + m.cost_inc
    idx = torch.clamp(state.j, max=j_max - 1)
    _put(state.err_traj, idx, m.running, metric.to(torch.float32))
    _put(state.cost_traj, idx, m.running, cost_new)
    _put(state.time_traj, idx, m.running, t_new)
    _put(state.y_traj, idx, m.running, m.y)
    return state._replace(
        t=t_new, j=state.j + m.running.to(torch.int64), bucket=m.bucket,
        total_cost=cost_new, total_idle=state.total_idle + m.idle_inc,
        model=model)


def _tick(batch: ScenarioBatch, data, seeds, program: ModelProgram,
          grid) -> Callable[[SimState, int], SimState]:
    """One tick: the market logic runs over the whole (S, R) grid, then
    the program's step trains every cell in one call over (S, R)-leading
    leaves."""
    alpha2 = _col(batch.alpha).expand(grid)

    def tick(state: SimState, k: int) -> SimState:
        with span("engine.market"):
            m = _market_tick(batch, seeds, state.t, state.j, state.bucket, k)
        model, metric = program.step_fn(
            state.model, data, m.k_grad, m.mask.to(torch.float32), state.j,
            alpha2, m.running)
        return _advance(state, m, metric, model, batch.j_max)

    return tick


def _map_state(fn, state: SimState, *rest: SimState) -> SimState:
    """``fn`` over every tensor of a carry (and the matching tensors of
    ``rest``), the model's leaves included."""
    return SimState(*(tree_map(fn, f, *(r[i] for r in rest))
                      for i, f in enumerate(state)))


def _run_ticks(tick, state: SimState, tick0: int, n_run: int,
               k_snap: int):
    """Ticks ``tick0 … tick0+n_run-1`` from carry ``state``; every draw is
    keyed by the absolute tick, so a run resumed at ``tick0`` from a carry
    repeats the uninterrupted run bit for bit. With ``k_snap > 0`` the
    carry after every k_snap-th tick is copied and the copies are stacked
    on axis 2, as the reference's snapshots are (S, R, n_snap, ...); the
    remainder ticks run unsnapshotted. Nothing is read back to the host."""
    snaps = []
    for i in range(n_run):
        with span("engine.tick"):
            state = tick(state, tick0 + i)
        if k_snap and (i + 1) % k_snap == 0:
            snaps.append(_map_state(torch.clone, state))
    if not snaps:
        return state, None
    return state, _map_state(lambda *xs: torch.stack(xs, dim=2), *snaps)


def _check_run_window(cfg: SimConfig, tick0: int) -> int:
    """Validate the (tick0, n_ticks, snapshot_every) window; returns the
    number of ticks left to run."""
    if not 0 <= tick0 <= cfg.n_ticks:
        raise ValueError(f"tick0={tick0} outside [0, n_ticks={cfg.n_ticks}]")
    n_run = cfg.n_ticks - tick0
    if cfg.snapshot_every < 0:
        raise ValueError(f"snapshot_every={cfg.snapshot_every} must be ≥ 0")
    if cfg.snapshot_every and cfg.snapshot_every > n_run:
        # silently returning snapshots=None here would defeat the caller's
        # checkpointing intent — fail loudly instead
        raise ValueError(
            f"snapshot_every={cfg.snapshot_every} exceeds the remaining "
            f"tick budget ({n_run} ticks from tick0={tick0}): no snapshot "
            "would ever be emitted")
    return n_run


def simulate_program(scenarios, program: ModelProgram, model0, data, seeds,
                     cfg: SimConfig, *, init_state: Optional[SimState] = None,
                     tick0: int = 0, device=None) -> EngineResult:
    """Run S scenarios × R seeds of a ModelProgram on ``device`` (default
    ``cuda``), ticks ``tick0 … cfg.n_ticks-1``.

    model0: initial model (nested dict/tuple of tensors), shared by every
    (scenario, seed) replica (``initial_state`` fans it out; ignored when
    ``init_state`` is given: a carry on the device, such as
    ``snapshot_state`` returns, which the run updates in place); data:
    passed to every step (stacked batches, a `TorchQuadratic`); seeds: int
    count or explicit sequence.

    Checkpointing: ``cfg.snapshot_every = k`` stacks the full carry every
    k ticks into ``EngineResult.snapshots`` (+ ``snapshot_ticks``), left on
    the device; ``init_state``/``tick0`` resume a run from such a snapshot
    (same scenarios, seeds and cfg), bit for bit.

    Returns stacked (S, R, J_max) trajectories plus the per-replica final
    model (tensors (S, R, ...) on the device)."""
    tick0 = int(tick0)
    n_run = _check_run_window(cfg, tick0)
    device = resolve_device(device)
    if isinstance(scenarios, ScenarioBatch):
        scenarios = scenarios.to(device)
    else:
        scenarios = stack_scenarios(scenarios, device=device)
    if np.isscalar(seeds):
        seeds = np.arange(int(seeds))
    seeds = torch.as_tensor(np.asarray(seeds, np.int64), device=device)
    if init_state is None:
        init_state = initial_state(scenarios, model0, len(seeds),
                                   device=device)
    grid = tuple(init_state.t.shape)
    final, snaps = _run_ticks(_tick(scenarios, data, seeds, program, grid),
                              init_state, tick0, n_run, cfg.snapshot_every)
    return _engine_result(final, snaps, scenarios, cfg, tick0, n_run)


def _engine_result(final: SimState, snaps: Optional[SimState],
                   scenarios: ScenarioBatch, cfg: SimConfig, tick0: int,
                   n_run: int) -> EngineResult:
    def host(x):
        return x.cpu().numpy()

    snap_ticks = None
    if snaps is not None:
        n_snap = n_run // cfg.snapshot_every
        snap_ticks = tick0 + cfg.snapshot_every * np.arange(1, n_snap + 1)
    with span("engine.readback"):
        return EngineResult(
            errors=host(final.err_traj), costs=host(final.cost_traj),
            times=host(final.time_traj), ys=host(final.y_traj),
            iterations=host(final.j).astype(np.int32),
            total_time=host(final.t), total_cost=host(final.total_cost),
            total_idle=host(final.total_idle),
            J=host(scenarios.J), final_model=final.model, snapshots=snaps,
            snapshot_ticks=snap_ticks, final_state=final)


@functools.lru_cache(maxsize=None)
def quadratic_program(grad: str, batch: int) -> ModelProgram:
    """The Theorem-1 quadratic oracle as a ModelProgram: model =
    the (S, R, d) SGD iterates, data = a `TorchQuadratic`, metric = the
    error after the update. Per cell it is the reference's step: the
    exact gradient (``grad="full"``), or the mask-weighted mean of the
    n_max workers' minibatch gradients over max(y, 1); then w − α g,
    landed only where the iteration runs."""

    def step_fn(w, quad: TorchQuadratic, key, mask, j, alpha, running):
        del j
        if grad == "full":
            g = quad.full_grad(w)
        else:
            y = mask.sum(-1)
            gw = quad.minibatch_grads(key, w, mask.shape[-1], batch)
            g = (gw * mask[..., None]).sum(-2) \
                / torch.clamp(y, min=1.0)[..., None]
        w_new = w - alpha[..., None] * g
        return torch.where(running[..., None], w_new, w), quad.error(w_new)

    return ModelProgram(step_fn=step_fn, name=f"quadratic-{grad}-{batch}")


def simulate(scenarios, quad, w0, seeds, cfg: SimConfig, *,
             device=None) -> EngineResult:
    """Run S scenarios × R seeds on the quadratic oracle on ``device``
    (default ``cuda``): the original engine entry point; `simulate_program`
    is the general form.

    scenarios: ScenarioBatch or list[Scenario]; quad: QuadraticProblem or
    TorchQuadratic; seeds: int count or explicit sequence. Returns stacked
    (S, R, J_max) trajectories."""
    device = resolve_device(device)
    quad = (quad.to(device) if isinstance(quad, TorchQuadratic)
            else torch_quadratic(quad, device))
    w0 = torch.as_tensor(np.asarray(w0, np.float32), device=device)
    return simulate_program(
        scenarios, quadratic_program(cfg.grad, cfg.batch), w0, quad, seeds,
        cfg, device=device)


# --------------------------------------------------------------------------
# Mesh execution: the (S, R) grid in shards over devices
# --------------------------------------------------------------------------


def _shard_bounds(n: int, shards: int) -> List[Tuple[int, int]]:
    """[lo, hi) row ranges of ``n`` rows over ``shards`` shards, in order,
    sizes differing by at most one (empty when n < shards)."""
    q, r = divmod(n, shards)
    bounds, lo = [], 0
    for i in range(shards):
        hi = lo + q + (i < r)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _data_on(data, device):
    """The program's ``data`` (None, a tensor, a `TorchQuadratic`, or a
    dict of them) on ``device``; no copy where it is there already."""
    if data is None:
        return None
    if isinstance(data, dict):
        return {k: _data_on(v, device) for k, v in data.items()}
    return data.to(device)


def _run_by_device(jobs: Sequence[Tuple[torch.device, Callable]]) -> list:
    """Run ``fn()`` for every (device, fn), returning the results in order.
    Jobs on one device run in turn; jobs on different devices run at once,
    one host thread per device (the tick loop is host-bound, so in one
    thread they would run in series)."""
    by_dev: Dict[torch.device, List[int]] = {}
    for i, (dev, _) in enumerate(jobs):
        by_dev.setdefault(dev, []).append(i)
    out: list = [None] * len(jobs)

    def run_device(dev, idxs):
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            for i in idxs:
                out[i] = jobs[i][1]()

    if len(by_dev) == 1:
        run_device(*next(iter(by_dev.items())))
        return out
    with ThreadPoolExecutor(max_workers=len(by_dev)) as pool:
        for fut in [pool.submit(run_device, dev, idxs)
                    for dev, idxs in by_dev.items()]:
            fut.result()
    return out


def _gather(bounds, parts, grid, device) -> torch.Tensor:
    """Shards' leaves (rows ``bounds[i]`` = (s0, s1, r0, r1) of the grid)
    -> one (S, R, ...) tensor on ``device``."""
    out = torch.empty(grid + tuple(parts[0].shape[2:]),
                      dtype=parts[0].dtype, device=device)
    for (s0, s1, r0, r1), part in zip(bounds, parts):
        out[s0:s1, r0:r1].copy_(part)
    return out


def _join_leaf(full: torch.Tensor, bounds, inputs, finals,
               grid) -> torch.Tensor:
    """One carry leaf of the whole grid from its shards' final leaves.

    Shard i covers rows ``bounds[i]`` and ran from ``inputs[i]`` to
    ``finals[i]``. A leaf every shard's step updated in place (the final
    leaf IS its input) stays the caller's ``full`` leaf, as in the
    unsharded run: shards that ran on a copy (on another device, or rows
    that were not contiguous) are copied back into their rows. A leaf the
    steps replaced is gathered into a new tensor on ``full``'s device."""
    if not all(fin is inp for inp, fin in zip(inputs, finals)):
        return _gather(bounds, finals, grid, full.device)
    for (s0, s1, r0, r1), fin in zip(bounds, finals):
        dst = full[s0:s1, r0:r1]
        if fin.data_ptr() != dst.data_ptr():
            dst.copy_(fin)
    return full


def simulate_sharded(scenarios, program: ModelProgram, model0, data, seeds,
                     cfg: SimConfig, *, mesh=None, donate: bool = False,
                     init_state: Optional[SimState] = None, tick0: int = 0,
                     device=None) -> EngineResult:
    """`simulate_program` over a device mesh: the scenario axis of the
    stacked grid is split over the mesh's ``data`` axis and the seed axis
    over its ``replica`` axis (when present), and each shard — its rows
    of the stacked batch, of the carry and of the seeds — runs through
    `simulate_program` on the device at its place in the mesh. Shards on
    one device run in turn, shards on different devices at once (one host
    thread per device). The finals and snapshots are joined into one
    `EngineResult` on the mesh's first device, with the unsharded run's
    shapes.

    Bit-exactness: every draw is keyed by the seed value, the absolute
    tick, the stream and the worker lane — never by a device or a shard
    position — and the scenarios are stacked ONCE, so every shard keeps
    the grid's padded widths (workers, plan rows, trace length) that the
    draws are shaped by. Shards are contiguous row blocks whose sizes
    differ by at most one; a mesh axis longer than the grid leaves some
    devices idle (no padding: per cell the port's arithmetic does not
    depend on how many cells share a call). A sharded run is then bit for
    bit the unsharded one, snapshots included, wherever the program's
    step keeps each cell's arithmetic independent of its neighbours (the
    engine's market and accounting, the quadratic oracle and `per_cell`
    programs do; the megabatch step's batched products are held on each
    device by its tests).

    ``mesh``: a `launch.mesh.Mesh` whose axes are ``data`` and/or
    ``replica``; default `launch.mesh.make_scenario_mesh` over every
    visible device of ``device`` (default ``cuda``), which is otherwise
    unused. ``init_state``/``tick0`` resume as in `simulate_program`, from
    a carry of any mesh's run or none (checkpoints record no mesh); the
    carry is updated in place where the step updates it in place. The
    port has no ``donate``: it is accepted and ignored.
    """
    from repro_torch.launch.mesh import make_scenario_mesh

    del donate
    if mesh is None:
        mesh = make_scenario_mesh(device=device)
    bad = [a for a in mesh.axis_names if a not in ("data", "replica")]
    if bad:
        raise ValueError(
            f"mesh axes {bad} are not understood by the engine: the "
            "scenario grid shards over axes named 'data' (scenarios) "
            "and/or 'replica' (seeds) — build the mesh with "
            "repro_torch.launch.mesh.make_scenario_mesh / "
            "make_scenario_replica_mesh")
    tick0 = int(tick0)
    _check_run_window(cfg, tick0)
    # the devices as a (data, replica) grid, whichever axes the mesh has
    present = [a for a in ("data", "replica") if a in mesh.axis_names]
    devs = np.transpose(mesh.devices, [mesh.axis_names.index(a)
                                       for a in present]).reshape(
        mesh.shape.get("data", 1), mesh.shape.get("replica", 1))
    home = devs[0, 0]
    if isinstance(scenarios, ScenarioBatch):
        batch = scenarios.to(home)
    else:
        batch = stack_scenarios(scenarios, device=home)
    if np.isscalar(seeds):
        seeds = np.arange(int(seeds))
    seeds = np.asarray(seeds, np.int64)
    grid = (batch.n_scenarios, len(seeds))
    if init_state is None:
        init_state = initial_state(batch, model0, len(seeds), device=home)
    elif tuple(init_state.t.shape) != grid:
        raise ValueError(f"init_state grid {tuple(init_state.t.shape)} is "
                         f"not the run's (S, R) = {grid}")

    def rows(x, s0, s1, r0, r1, dev):
        # a view where it can be (the step updates it in place), a copy
        # on another device or where the rows are not contiguous
        return x[s0:s1, r0:r1].to(dev).contiguous()

    shards, jobs = [], []
    for i, (s0, s1) in enumerate(_shard_bounds(grid[0], devs.shape[0])):
        for k, (r0, r1) in enumerate(_shard_bounds(grid[1],
                                                   devs.shape[1])):
            if s0 == s1 or r0 == r1:
                continue
            dev = devs[i, k]
            state = _map_state(functools.partial(
                rows, s0=s0, s1=s1, r0=r0, r1=r1, dev=dev), init_state)
            part = ScenarioBatch(*(x[s0:s1] for x in batch)).to(dev)
            shards.append(((s0, s1, r0, r1), state))
            jobs.append((dev, functools.partial(
                simulate_program, part, program, None, _data_on(data, dev),
                seeds[r0:r1], cfg, init_state=state, tick0=tick0,
                device=dev)))
    results = _run_by_device(jobs)

    n = len(shards)
    bounds = [b for b, _ in shards]
    final = _map_state(
        lambda full, *xs: _join_leaf(full, bounds, xs[:n], xs[n:], grid),
        init_state, *[st for _, st in shards],
        *[res.final_state for res in results])
    snaps = None
    if results[0].snapshots is not None:
        snaps = _map_state(lambda *parts: _gather(bounds, parts, grid, home),
                           *[res.snapshots for res in results])
    return _engine_result(final, snaps, batch, cfg, tick0,
                          cfg.n_ticks - tick0)


def snapshot_state(result: EngineResult, index: int = -1):
    """One snapshot of a snapshotting run as a ``SimState`` on the device
    (leaves (S, R, ...), copied out of the stack, so a run resumed from it
    leaves ``result`` as it was) plus its absolute tick count: the pair
    ``simulate_program(init_state=..., tick0=...)`` resumes from."""
    if result.snapshots is None:
        raise ValueError("run had no snapshots: set SimConfig.snapshot_every")
    tick = int(result.snapshot_ticks[index])
    state = _map_state(
        lambda x: x[:, :, index].clone(memory_format=torch.contiguous_format),
        result.snapshots)
    return state, tick


# --------------------------------------------------------------------------
# Strategy → Scenario builders
# --------------------------------------------------------------------------


def scenario_from_strategy(strategy, *, alpha: float, rt,
                           dist=None, q: Optional[float] = None,
                           on_demand_price: float = 1.0,
                           n_max: Optional[int] = None,
                           idle_step: Optional[float] = None,
                           J: Optional[int] = None,
                           price_spec: Optional[PriceSpec] = None,
                           name: str = "") -> Scenario:
    """Compile a core.strategies.Strategy into a batchable Scenario.

    Spot strategies (``bids``) become a precomputed plan table against the
    price distribution ``dist`` (or an explicit ``price_spec``) —
    time-adaptive strategies resolve to one bid schedule per coarse
    elapsed-time bucket, latched by the engine at replan time; provisioning
    strategies (``workers``) become a worker schedule under exogenous
    preemption probability ``q``.
    """
    J = J or strategy.total_iterations
    name = name or getattr(strategy, "name", "")
    if q is None:
        table = strategy.plan_table(J, n_max=n_max)
        if idle_step is None:
            idle_step = rt.expected(max(table.bids.shape[2], 1))
        return Scenario.from_runtime(
            rt, price=price_spec or PriceSpec.from_dist(dist), alpha=alpha,
            bid_table=table.bids, bucket_starts=table.starts,
            replan_at=table.replan_at, idle_step=idle_step, name=name)
    wsched = strategy.worker_schedule(J)
    if n_max is not None:
        # match the legacy loop: provisioning never exceeds the fleet, and
        # the active mask is padded to the full fleet width
        wsched = np.minimum(wsched, n_max)
    return Scenario.from_runtime(
        rt, price=PriceSpec.uniform(0.0, 1.0), alpha=alpha,
        worker_schedule=wsched, preempt_q=q, n_fleet=n_max,
        on_demand_price=on_demand_price,
        idle_step=idle_step if idle_step is not None else rt.expected(1),
        name=name)
