"""Shared model infrastructure: the declarative ``ParamSpec`` and its
materialization, and the numerics helpers (RMSNorm, RoPE, SwiGLU).

``ParamSpec`` is the single source of truth for every parameter: shape,
dtype, logical sharding tokens (kept as data so the definitions read as in
the reference), initializer. ``init_params`` materializes a nested dict of
specs into tensors on a given device, each leaf drawn from its own seeded
``torch.Generator``. The values differ from the reference's threefry draws;
tests hand both packages the same weights instead (``convert``)."""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import resolve_dtype


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


def map_specs(fn, defs, path: str = ""):
    """Apply ``fn(path, spec)`` to every ParamSpec of a nested dict; the
    path is spelled as the reference's key paths are (``['a']['b']``)."""
    if isinstance(defs, ParamSpec):
        return fn(path, defs)
    return {k: map_specs(fn, v, f"{path}[{k!r}]") for k, v in defs.items()}


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


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    return F.silu(gate) * up
