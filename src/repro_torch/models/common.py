"""Shared model infrastructure: the logical-axis mesh context, the
declarative ``ParamSpec`` and its materialization, and the numerics
helpers (RMSNorm, RoPE, SwiGLU, the sinusoidal positions).

* ``mesh_context`` / ``resolve_spec`` / ``shard`` — logical sharding: a
  logical token ("batch", "fsdp", "tp", ...) maps to mesh axes through
  the rules, and is dropped where the dimension does not divide (14 heads
  over a 16-way model axis). ``resolve_spec`` reads only the mesh's axis
  names and sizes, so it takes a `launch.mesh.Mesh` or an
  `launch.mesh.AbstractMesh` (the dry run's 256 and 512 devices).
* ``tp_ranks`` / ``tp_slice`` / ``join_runs`` — tensor parallelism over
  the model axis (the dense layers, the SSM's heads, the vocab, the query
  sequence): the installed mesh's model axis as ranks on their devices,
  with the batch groups over the data ranks, a leaf cut to one rank's
  slice by the spec ``resolve_spec`` gives its tp token, and an axis put
  back together from the runs of it the ranks hold.
* ``ParamSpec`` is the single source of truth for every parameter: shape,
  dtype, logical sharding tokens, initializer. It is materialized three
  ways: ``init_params`` (tensors on a device, each leaf drawn from its own
  seeded ``torch.Generator``; the values differ from the reference's
  threefry draws, so tests hand both packages the same weights through
  ``convert``), ``abstract_params`` (tensors on the ``meta`` device, the
  counterpart of ``jax.ShapeDtypeStruct``) and ``param_shardings``
  (a `NamedSharding` per leaf)."""
from __future__ import annotations

import dataclasses
import math
import threading
import zlib
from contextlib import contextmanager
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import resolve_dtype
from repro_torch.models import spmd
from repro_torch.tree import tree_leaves

# --------------------------------------------------------------------------
# Mesh / logical-axis context
# --------------------------------------------------------------------------

#: logical token -> tuple of mesh axis names. ``fsdp`` carries ZeRO-3 param
#: sharding, ``batch`` the (elastic) data-parallel batch, ``tp`` tensor/expert
#: parallelism.
DEFAULT_RULES = {
    "batch": ("data",),
    "fsdp": ("data",),
    "tp": ("model",),
}

MULTI_POD_RULES = {
    # batch over pod+data; params FSDP within a pod only (cross-pod traffic
    # is the gradient all-reduce alone)
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tp": ("model",),
}


class PartitionSpec(tuple):
    """The counterpart of ``jax.sharding.PartitionSpec``: one entry per
    leading dimension — a mesh axis name, a tuple of names (the dimension
    split over their product, the first major), or None (replicated).
    Trailing dimensions left out are replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: its `PartitionSpec` over ``mesh``'s axes (the
    counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shape of one device's shard: each split dimension divided
        by the product of its axes' sizes, rounded up."""
        sizes = self.mesh.shape
        out = list(shape)
        for i, dim in enumerate(self.spec):
            if dim is None:
                continue
            axes = dim if isinstance(dim, tuple) else (dim,)
            n = math.prod(sizes[a] for a in axes)
            out[i] = -(-shape[i] // n)
        return tuple(out)


@dataclasses.dataclass
class MeshContext:
    mesh: Any
    rules: dict


_TLS = threading.local()


def current_ctx() -> MeshContext:
    ctx = getattr(_TLS, "ctx", None)
    return ctx if ctx is not None else MeshContext(None, dict(DEFAULT_RULES))


@contextmanager
def mesh_context(mesh, rules: Optional[dict] = None):
    """Install a mesh + logical-axis rules for this thread (parameter
    layout, and the MoE block's expert parallelism); the previous context
    comes back on exit."""
    old = getattr(_TLS, "ctx", None)
    _TLS.ctx = MeshContext(mesh, dict(rules if rules is not None
                                      else DEFAULT_RULES))
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = old


def axis_size(token: str) -> int:
    """Product of mesh-axis sizes behind a logical token (1 with no mesh)."""
    ctx = current_ctx()
    if ctx.mesh is None:
        return 1
    sizes = ctx.mesh.shape
    return math.prod(sizes[a] for a in ctx.rules.get(token, ()))


def resolve_spec(shape: Tuple[int, ...], tokens, rules, mesh) -> PartitionSpec:
    """Map logical tokens to a PartitionSpec, dropping non-divisible dims.

    A token may be a tuple of candidate tokens: the first divisible
    candidate wins (e.g. ``("tp", None)`` — shard over the model axis if it
    divides, else leave replicated). A mesh axis is used at most once."""
    sizes = mesh.shape
    dims = []
    used = set()
    for i, tok in enumerate(tokens):
        cands = tok if isinstance(tok, tuple) else (tok,)
        picked = None
        for cand in cands:
            if cand is None:
                continue
            axes = tuple(a for a in rules.get(cand, ()) if a in sizes)
            n = math.prod(sizes[a] for a in axes) if axes else 1
            if (axes and n > 1 and shape[i] % n == 0
                    and not (set(axes) & used)):
                picked = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
        dims.append(picked)
    while dims and dims[-1] is None:
        dims.pop()
    return PartitionSpec(*dims)


def shard(x: torch.Tensor, *tokens) -> torch.Tensor:
    """A logical sharding constraint. With a mesh installed it resolves
    the spec and checks the rank, as the reference does; it then returns
    ``x`` itself. The reference's ``with_sharding_constraint`` changes
    where a value lives, never the value, and the port keeps activations
    whole on the device that computes them, so the values agree."""
    ctx = current_ctx()
    if ctx.mesh is None:
        return x
    assert len(tokens) == x.dim(), (tokens, tuple(x.shape))
    resolve_spec(tuple(x.shape), tokens, ctx.rules, ctx.mesh)
    return x


@dataclasses.dataclass(frozen=True)
class TPRanks:
    """The installed mesh's model axis as ``size`` ranks, its devices as a
    (data-parallel rank, tp rank) grid (`spmd.rank_devices`)."""

    size: int
    grid: Any

    def groups(self, batch: int):
        """The batch's groups over the data ranks, as `moe.moe_block`
        splits it: one group a data rank where ``batch`` divides, else one
        group of the whole batch (replicated over data). Returns a list of
        (rows, the devices of the group's tp ranks in rank order)."""
        n_dp = self.grid.shape[0]
        n = n_dp if batch % n_dp == 0 else 1
        rows = batch // n
        return [(slice(g * rows, (g + 1) * rows), list(self.grid[g]))
                for g in range(n)]


def tp_ranks() -> Optional[TPRanks]:
    """The model axis of the installed mesh as ranks, or None where the
    dense layers compute whole: no mesh, no model axis among the rules'
    ``tp`` axes, or one of size 1. Raises for a mesh without devices and
    for a card that is not visible (`spmd.rank_devices`)."""
    ctx = current_ctx()
    if ctx.mesh is None:
        return None
    sizes = ctx.mesh.shape
    tp_axes = [a for a in ctx.rules.get("tp", ()) if a in sizes]
    if len(tp_axes) != 1 or sizes[tp_axes[0]] == 1:
        return None
    dp_axes = tuple(a for a in ctx.rules.get("batch", ()) if a in sizes)
    grid, _ = spmd.rank_devices(ctx.mesh, dp_axes, tp_axes[0])
    return TPRanks(sizes[tp_axes[0]], grid)


def tp_slice(x: torch.Tensor, tokens, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the leaf ``x`` over the model axis: the
    spec `resolve_spec` gives ``tokens`` under the installed rules, with
    every token but ``tp`` left out (the other axes keep the leaf whole);
    a dimension the spec splits over the model axis is cut into equal
    parts and the rank keeps its part, and one that does not divide stays
    whole, as the reference's rule drops it. A view of ``x``."""
    ctx = current_ctx()
    spec = resolve_spec(tuple(x.shape), tokens,
                        {"tp": ctx.rules.get("tp", ())}, ctx.mesh)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = math.prod(ctx.mesh.shape[a] for a in (
            axes if isinstance(axes, tuple) else (axes,)))
        part = x.shape[dim] // n
        x = x.narrow(dim, rank * part, part)
    return x


def join_runs(parts, runs, dim: int) -> torch.Tensor:
    """The whole axis ``dim`` from the ranks' runs [lo, hi) of it (the KV
    heads a rank read, the SSM groups), on the first part's device: each
    index taken from the first rank that holds it."""
    pieces, done = [], 0
    for t, (lo, hi) in zip(parts, runs):
        if hi > done:
            pieces.append(t.narrow(dim, done - lo, hi - done).to(
                parts[0].device))
            done = hi
    return torch.cat(pieces, dim=dim) if len(pieces) > 1 else pieces[0]


def data_axis_names() -> Tuple[str, ...]:
    """Mesh axes carrying the batch (the elastic worker axes)."""
    return tuple(current_ctx().rules.get("batch", ("data",)))


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter leaf."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | neg_ones
    scale: float = 1.0            # stddev for "normal"
    dtype: Any = None             # None -> model param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def dense_spec(d_in: int, d_out: int, logical=("fsdp", "tp"), scale=None,
               dtype=None) -> ParamSpec:
    """Standard dense-matrix spec with 1/sqrt(fan_in) init."""
    return ParamSpec((d_in, d_out), logical,
                     scale=(scale if scale is not None else d_in ** -0.5),
                     dtype=dtype)


def is_spec_leaf(x) -> bool:
    return isinstance(x, ParamSpec)


def map_specs(fn, defs, path: str = ""):
    """Apply ``fn(path, spec)`` to every ParamSpec of a nested dict; the
    path is spelled as the reference's key paths are (``['a']['b']``)."""
    if isinstance(defs, ParamSpec):
        return fn(path, defs)
    return {k: map_specs(fn, v, f"{path}[{k!r}]") for k, v in defs.items()}


def tree_map_specs(fn, defs):
    """Apply ``fn(spec)`` to every ParamSpec of a nested dict."""
    return map_specs(lambda _, s: fn(s), defs)


def stack_specs(defs, n: int, logical0: Optional[str] = None):
    """Add a leading layer dimension to every leaf."""
    return map_specs(
        lambda _, s: ParamSpec((n,) + s.shape, (logical0,) + s.logical,
                               init=s.init, scale=s.scale, dtype=s.dtype),
        defs)


def init_params(defs, seed: int, param_dtype=torch.float32, *,
                device: torch.device):
    """Materialize real parameter tensors on ``device`` from a ParamSpec
    nested dict. A "normal" leaf draws from a ``torch.Generator`` on the
    device seeded by a 32-bit hash of (``seed``, its key path), so every
    leaf is reproducible on its own and independent of the order of the
    others."""
    param_dtype = resolve_dtype(param_dtype, where="init_params")
    device = torch.device(device)

    def make(path, spec: ParamSpec):
        dtype = resolve_dtype(spec.dtype, where=f"ParamSpec{path}") \
            if spec.dtype is not None else param_dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if spec.init == "neg_ones":
            return torch.full(spec.shape, -1, dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        # the CPU generator keeps only 32 bits of its seed: fold the key
        # path into the run's seed with crc32 (a bijection of the seed)
        gen.manual_seed(zlib.crc32(path.encode(), seed & 0xFFFFFFFF))
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(spec.scale).to(dtype)

    return map_specs(make, defs)


def abstract_params(defs, param_dtype=torch.bfloat16):
    """Tensors on the ``meta`` device (shape and dtype, no storage): the
    counterpart of the reference's ``ShapeDtypeStruct`` tree for the dry
    run. ``param_dtype`` accepts config dtype strings (see
    `init_params`)."""
    param_dtype = resolve_dtype(param_dtype, where="abstract_params")
    return map_specs(lambda path, s: torch.empty(
        s.shape, device="meta",
        dtype=resolve_dtype(s.dtype, where=f"ParamSpec{path}")
        if s.dtype is not None else param_dtype), defs)


def _layout_rules(rules, fsdp: bool) -> dict:
    rules = dict(rules if rules is not None else DEFAULT_RULES)
    if not fsdp:
        rules["fsdp"] = ()
    return rules


def param_pspecs(defs, mesh, rules=None, fsdp: bool = True):
    """PartitionSpec nested dict for a ParamSpec nested dict."""
    rules = _layout_rules(rules, fsdp)
    return tree_map_specs(
        lambda spec: resolve_spec(spec.shape, spec.logical, rules, mesh),
        defs)


def param_shardings(defs, mesh, rules=None, fsdp: bool = True):
    """A `NamedSharding` per leaf of a ParamSpec nested dict."""
    rules = _layout_rules(rules, fsdp)
    return tree_map_specs(lambda spec: NamedSharding(mesh, resolve_spec(
        spec.shape, spec.logical, rules, mesh)), defs)


def param_count(defs) -> int:
    """Parameters of a ParamSpec nested dict."""
    return sum(math.prod(s.shape) for s in tree_leaves(defs))


def shard_bytes(shape: Tuple[int, ...], dtype: torch.dtype,
                sharding: NamedSharding) -> int:
    """Bytes of one device's shard of a ``shape`` leaf of ``dtype``."""
    return math.prod(sharding.shard_shape(tuple(shape))) * dtype.itemsize


def spec_dtypes(defs, param_dtype):
    """Each leaf's dtype: its ParamSpec override, else ``param_dtype``."""
    param_dtype = resolve_dtype(param_dtype, where="spec_dtypes")
    return map_specs(
        lambda path, s: resolve_dtype(s.dtype, where=f"ParamSpec{path}")
        if s.dtype is not None else param_dtype, defs)


# --------------------------------------------------------------------------
# Numerics
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * weight.to(torch.float32)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D) or (..., S, D); positions:
    (..., S). Computed in float32, cast back to ``x``'s dtype."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    half = d // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device),
                      -torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs      # (..., S, half)
    if x.dim() == positions.dim() + 2:                        # head dim
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings at given positions, in
    float32. positions: (...,) integers -> (..., d)."""
    half = d // 2
    dev = positions.device
    freqs = torch.exp(-torch.tensor(math.log(10000.0), dtype=torch.float32,
                                    device=dev)
                      * torch.arange(half, dtype=torch.float32, device=dev)
                      / max(half - 1, 1))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(length: int, d: int, *, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings (length, d)."""
    return sinusoidal_at(torch.arange(length, device=device), d)


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    return F.silu(gate) * up


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_heads(num_heads: int) -> int:
    """Pad the query-head count so it shards over the tp axes (the pad
    heads are initialized as any other; their compute is waste the
    roofline's model FLOPs leave out)."""
    tp = axis_size("tp")
    return ceil_to(num_heads, tp) if tp > 1 else num_heads
