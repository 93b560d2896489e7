"""Mamba2 SSD chunk kernel on the card (K3): the intra-chunk terms of the
chunked SSD scan, per (batch, head, chunk of Q positions).

    cs      = cumsum(dt·a) within the chunk
    y_intra = ((C·Bᵀ) ∘ exp(cs_i − cs_j) ∘ dt_j)_{j≤i} · x
    state   = (B ∘ exp(cs_last − cs)·dt)ᵀ · x                     (N, P)
    decay   = exp(cs_last)

B and C are group-mapped: head h reads group h // (H / G). Inputs are the
model's own layouts, read in place through their strides: xh (B, S, H, P),
dt (B, S, H), bm and cm (B, S, G, N). Outputs: y_intra (B, S, H, P) in
xh's dtype; states (B, nc, H, N, P), cs (B, nc, H, Q) and the chunk decay
(B, nc, H), all float32 — the outputs of the reference's
``ssd_chunk_pallas`` in its layouts.

The kernel is CUDA C++ for the tensor cores in ``csrc/ssd_scan_sm90.cu``
(`ssd_chunk`): the scores C·Bᵀ once per slab of heads of one group, every
product float32-accurate through 3xTF32, tiles staged by double-buffered
``cp.async``. The source's header says what bounds it and how it is laid
out. It has no backward, as the reference's Pallas kernel has none, and
refuses inputs that require a gradient: the model trains through
``models.ssm.ssd_chunked``, the reference model's jnp route. Its plain
version is ``kernels.ref.ssd_chunk_reference``; ``kernels.ops.ssd_chunked``
picks between the two by the device of the tensors and runs the
inter-chunk recurrence around them."""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_Q, MAX_N, MAX_P = 256, 128, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: heads per block of the tensor-core kernel: the scores are formed once
#: per slab, so a wider slab forms them fewer times; at the serving path's
#: shape (64 heads of one group, B 8, 8 chunks) 16 gives 1536 blocks,
#: almost six waves of two blocks on each of 132 SMs
SLAB_HEADS = 16

# dtype, async_copy, slab, x, dt, a_h, bm, cm, y, states, cs, decay,
# strides, B, S, H, G, P, N, Q, stream
_TC_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _bind(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def chunk_len(chunk: int, s: int) -> int:
    """The chunk the scan uses, ``min(chunk, S)``, which must divide S."""
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD "
                         f"chunk {q}")
    return q


def _check(xh, dt, a_h, bm, cm, q) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, dt, a_h, bm, cm)):
        raise NotImplementedError(
            "the SSD chunk kernel (K3) has no backward, as the reference's "
            "Pallas kernel has none: training takes models.ssm.ssd_chunked "
            "(the reference model's jnp route); run K3 under "
            "torch.no_grad()")
    dev = xh.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunk runs on CUDA tensors, got {dev}; CPU "
                         "tensors take kernels.ops' plain path")
    if xh.dtype not in _DTYPES:
        raise ValueError(f"ssd_chunk takes float32 or bfloat16 xh, got "
                         f"{xh.dtype}")
    for name, t, dims, dtype in (("xh", xh, 4, xh.dtype),
                                 ("dt", dt, 3, torch.float32),
                                 ("a_h", a_h, 1, torch.float32),
                                 ("bm", bm, 4, xh.dtype),
                                 ("cm", cm, 4, xh.dtype)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xh on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dims:
            raise ValueError(f"{name} must be {dims}-d, got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"dimension, got strides {t.stride()}")
    b, s, h, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(a_h.shape) != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} and a_h {tuple(a_h.shape)} "
                         f"must be (B={b}, S={s}, H={h}) and (H,)")
    if tuple(bm.shape) != (b, s, g, n) or tuple(cm.shape) != (b, s, g, n):
        raise ValueError(f"bm {tuple(bm.shape)} and cm {tuple(cm.shape)} "
                         f"must both be (B={b}, S={s}, G, N)")
    if g < 1 or h % g:
        raise ValueError(f"{h} heads do not group over {g} B/C groups")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and q <= MAX_Q):
        raise ValueError(f"ssd_chunk takes P <= {MAX_P}, N <= {MAX_N} and "
                         f"Q <= {MAX_Q}, got P={p}, N={n}, Q={q}")
    if max(b, h) > 65535:
        raise ValueError(f"B={b} or H={h} exceeds the grid's 65535")


def async_refusal(shape, strides, address: int, itemsize: int
                  ) -> Optional[str]:
    """Why the tensor-core kernel's 16-byte asynchronous copies cannot read
    a (B, S, H-or-G, D) input of this shape, element strides and base byte
    address, or None when they can: the base on 16 bytes, a row (D
    elements) of whole 16 bytes, and the stride of every other dimension
    longer than 1 a multiple of 16 bytes (a dimension of length 1 is never
    stepped along). An input they cannot read sends the launch to the
    kernel's synchronous route, which computes the same bits."""
    if address % 16:
        return f"base address {address:#x} is not a multiple of 16 bytes"
    if shape[-1] * itemsize % 16:
        return (f"a row of {shape[-1]} elements ({shape[-1] * itemsize} "
                "bytes) is not a multiple of 16 bytes")
    for n, st in zip(shape[:-1], strides[:-1]):
        if n > 1 and st * itemsize % 16:
            return (f"stride {st} ({st * itemsize} bytes) is not a multiple "
                    "of 16 bytes")
    return None


def head_slabs(h: int, g: int, slab: int = SLAB_HEADS
               ) -> List[Tuple[int, int]]:
    """The tensor-core kernel's slabs of heads, [lo, hi) each: every group
    of h // g heads cut into runs of ``slab`` (the last run shorter), so
    that no slab straddles two groups and the scores of a slab are one
    group's."""
    rep = h // g
    slab = min(slab, rep)
    return [(grp * rep + lo, min(grp * rep + lo + slab, (grp + 1) * rep))
            for grp in range(g) for lo in range(0, rep, slab)]


def _strides(*tensors):
    flat = [x for t in tensors for x in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def ssd_chunk(xh: torch.Tensor, dt: torch.Tensor, a_h: torch.Tensor,
              bm: torch.Tensor, cm: torch.Tensor, *, chunk: int
              ) -> Tuple[torch.Tensor, ...]:
    """Launch K3 on the tensor cores (``csrc/ssd_scan_sm90.cu``): xh (B,
    S, H, P) and bm, cm (B, S, G, N) CUDA tensors of one dtype (float32 or
    bfloat16), dt (B, S, H) (post-softplus) and a_h (H,) (negative)
    float32. The chunk is ``min(chunk, S)``, which must divide S. Returns
    (y_intra (B, S, H, P), states (B, nc, H, N, P), cs (B, nc, H, Q),
    chunk_decay (B, nc, H)). Inputs that `async_refusal` turns away take
    the kernel's synchronous route, with the same results. Raises on
    anything the kernel does not take, CPU tensors and inputs that require
    a gradient included, and when the launch is refused."""
    q = chunk_len(chunk, xh.shape[1])
    _check(xh, dt, a_h, bm, cm, q)
    lib = _bind("ssd_scan_sm90", "ssd_chunk_tc_fwd", _TC_ARGTYPES)
    copies = all(async_refusal(tuple(t.shape), t.stride(), t.data_ptr(),
                               t.element_size()) is None
                 for t in (xh, bm, cm))
    b, s, h, p = xh.shape
    g, n = bm.shape[2], bm.shape[3]
    dev, nc = xh.device, s // q
    f32 = dict(dtype=torch.float32, device=dev)
    outs = (torch.empty((b, s, h, p), dtype=xh.dtype, device=dev),
            torch.empty((b, nc, h, n, p), **f32),
            torch.empty((b, nc, h, q), **f32), torch.empty((b, nc, h), **f32))
    a_h = a_h.contiguous()
    with torch.cuda.device(dev):
        err = lib.ssd_chunk_tc_fwd(
            _DTYPES[xh.dtype], int(copies), SLAB_HEADS, xh.data_ptr(),
            dt.data_ptr(), a_h.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            *(o.data_ptr() for o in outs), _strides(xh, dt, bm, cm),
            b, s, h, g, p, n, q, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed: CUDA error "
                           f"{err}")
    return outs
