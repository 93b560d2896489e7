"""Flash attention on the card (K2): blocked online-softmax attention with
causal and sliding-window masking, a query offset and native GQA (query
head h reads kv head h // (H / Hkv); k and v are never repeated), forward
and backward.

Layout: q (B, H, S, D), k/v (B, Hkv, T, D), out (B, H, S, D) in q's dtype.
Query s sits at position ``q_offset + s``, keys at 0..T-1. Any strides are
taken as long as the head dimension is contiguous, so `kernels.ops.
flash_mha` hands over the model's (B, S, H, D) tensors as transposed views
and the kernels read them in place.

The kernels are CUDA C++ (each source's header says what bounds it and
how it is laid out) and take head_dim 64 or 128; `flash_attention` takes
any head_dim up to 128 by zero-padding to the next of those
(`pad_head_dim`). Two forwards, each also writing the per-row logsumexp
(B, H, S) in float32: ``csrc/flash_attention_sm90.cu`` runs bf16 inputs
on the tensor cores (wgmma, tiles loaded by TMA), and
``csrc/flash_attention.cu`` runs float32 inputs on the CUDA cores (TF32
would change float32 results); `forward_for` picks one by dtype alone.
The backward recomputes the probabilities from that logsumexp, in two
halves, dK/dV per (key tile, kv head) and dQ per (query tile, head): on
the tensor cores for bf16 (``flash_attention_sm90.cu``, both after one
pre-pass that writes D_i = rowsum(dO∘O)) and on the CUDA cores for
float32 (``flash_attention.cu``), picked by `dkdv_for` and `dq_for`.
`flash_attention` joins them in a ``torch.autograd.Function``. Each
launch function keeps a count of its launches. The plain version of
both directions is ``kernels.ref.mha_reference`` under autograd;
``kernels.ops.flash_mha`` picks between the two by the device of the
tensors."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, count_launch

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: B, H, Hkv, S, T, causal, has_window, window, q_offset, scale, stream
_COMMON = [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
_ARGTYPES = {
    # dtype, head_dim, q, k, v, o, lse, strides, problem
    "flash_attention_fwd": [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 6 + _COMMON,
    # dtype, head_dim, q, k, v, o, dout, lse, dk, dv, strides, problem
    "flash_attention_bwd_dkdv": [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 9 + _COMMON,
    # dtype, head_dim, q, k, v, o, dout, lse, dq, strides, problem
    "flash_attention_bwd_dq": [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 8 + _COMMON,
}


_ARGTYPES_TC = {
    # head_dim, q, k, v, o, lse, strides, problem
    "flash_attention_fwd_tc": [ctypes.c_int] + [ctypes.c_void_p] * 6
    + _COMMON,
    # head_dim, q, k, v, dout, lse, delta, dk, dv, strides, problem
    "flash_attention_bwd_dkdv_tc": [ctypes.c_int] + [ctypes.c_void_p] * 9
    + _COMMON,
    # head_dim, q, k, v, dout, lse, delta, dq, strides, problem
    "flash_attention_bwd_dq_tc": [ctypes.c_int] + [ctypes.c_void_p] * 8
    + _COMMON,
    # head_dim, o, dout, delta, strides, B, H, S, stream
    "flash_attention_bwd_delta": [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _bind(name: str, argtypes_by_fn) -> ctypes.CDLL:
    lib = build.load(name)
    for fn_name, argtypes in argtypes_by_fn.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return _bind("flash_attention", _ARGTYPES)


def _lib_tc() -> ctypes.CDLL:
    return _bind("flash_attention_sm90", _ARGTYPES_TC)


def rows_without_keys(s: int, t: int, *, causal: bool,
                      window: Optional[int], q_offset: int) -> bool:
    """Whether some query row has no valid key. The rows that do form an
    interval, so the first and the last row decide."""
    for qpos in (q_offset, q_offset + s - 1):
        lo = max(0, qpos - window + 1) if window is not None else 0
        hi = min(t - 1, qpos) if causal else t - 1
        if lo > hi:
            return True
    return False


def _check(q, k, v, causal, window, q_offset) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA tensors, got {dev}; "
                         "CPU tensors take kernels.ops' plain path")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last "
                             f"(head) dimension, got strides {t.stride()}")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B={b}, Hkv, T, D={d})")
    hkv, t = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if s < 1 or t < 1:
        raise ValueError(f"empty attention: S={s}, T={t}")
    if max(h, b) > 65535:
        raise ValueError(f"B={b} or H={h} exceeds the grid's 65535")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if rows_without_keys(s, t, causal=causal, window=window,
                         q_offset=q_offset):
        raise ValueError(
            f"a query row has no valid key (S={s}, T={t}, causal={causal}, "
            f"window={window}, q_offset={q_offset}); the kernel does not "
            "take fully masked rows")


def _problem(q, k, causal, window, q_offset, scale):
    """The kernels' problem arguments; ``scale`` multiplies q·k, and comes
    from the caller because a padded head dimension must keep the
    unpadded one's D^-1/2."""
    b, h, s, _ = q.shape
    return [b, h, k.shape[1], s, k.shape[2], int(causal),
            int(window is not None), int(window or 0), int(q_offset),
            float(scale)]


def _scale(q, scale: Optional[float]) -> float:
    return float(q.shape[3]) ** -0.5 if scale is None else float(scale)


def _strides(*tensors):
    flat = [x for t in tensors for x in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err < 0:
        raise RuntimeError(f"{what}: a TMA tensor map could not be encoded "
                           f"(CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def tma_refusal(shape, strides, address: int, itemsize: int = 2
                ) -> Optional[str]:
    """Why TMA cannot load a (B, H, S, D) tensor of this shape, element
    strides and base byte address, or None when it can: head_dim 64 or 128
    with a unit stride, the base on 16 bytes, and the stride of every other
    dimension longer than 1 a positive multiple of 16 bytes. TMA never
    steps along a dimension of length 1, so that stride is not checked
    (`_tma_strides` hands the kernel one TMA takes)."""
    if shape[-1] not in HEAD_DIMS:
        return f"head_dim {shape[-1]} is not one of {HEAD_DIMS}"
    if strides[-1] != 1:
        return f"the head dimension has stride {strides[-1]}, not 1"
    if address % 16:
        return f"base address {address:#x} is not a multiple of 16 bytes"
    for n, st in zip(shape[:-1], strides[:-1]):
        if n > 1 and (st <= 0 or st * itemsize % 16):
            return (f"stride {st} ({st * itemsize} bytes) is not a positive "
                    "multiple of 16 bytes")
    return None


def _tma_strides(t):
    """t's (batch, head, position) element strides, the head dimension's
    length standing in for the stride of a dimension of length 1."""
    return [st if n > 1 else t.shape[-1]
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def _require_tma(what: str, tensors) -> None:
    """Raise unless TMA can load each (name, tensor) of ``tensors``."""
    for name, t in tensors:
        why = tma_refusal(tuple(t.shape), t.stride(), t.data_ptr(),
                          t.element_size())
        if why is not None:
            raise ValueError(f"{what}: TMA cannot load {name}: {why}")


def flash_fwd(q, k, v, *, causal: bool, window: Optional[int],
              q_offset: int, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: returns (out laid out like q, lse (B, H,
    S) float32). ``scale`` multiplies q·k (default D^-1/2). Raises on
    arguments it does not take and when the launch is refused."""
    _check(q, k, v, causal, window, q_offset)
    lib = _lib()
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out),
            *_problem(q, k, causal, window, q_offset, _scale(q, scale)),
            _stream(q))
    _raise_on(err, "flash_attention_fwd")
    count_launch(flash_fwd)
    return out, lse


def flash_fwd_tc(q, k, v, *, causal: bool, window: Optional[int],
                 q_offset: int, scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the tensor-core forward kernel (bf16 only): returns (out laid
    out like q, lse (B, H, S) float32), the same function as `flash_fwd`
    with P rounded to bf16 before P·V. Raises on arguments it does not
    take, TMA's alignment rules included, and when the launch is
    refused; it never falls back to another kernel."""
    _check(q, k, v, causal, window, q_offset)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_fwd_tc takes bfloat16, got {q.dtype}")
    _require_tma("flash_fwd_tc", (("q", q), ("k", k), ("v", v)))
    lib = _lib_tc()
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    flat = (_tma_strides(q) + _tma_strides(k) + _tma_strides(v)
            + list(out.stride()[:3]))
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd_tc(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), (ctypes.c_longlong * len(flat))(*flat),
            *_problem(q, k, causal, window, q_offset, _scale(q, scale)),
            _stream(q))
    _raise_on(err, "flash_attention_fwd_tc")
    count_launch(flash_fwd_tc)
    return out, lse


def forward_for(dtype: torch.dtype):
    """The forward kernel's launch function for inputs of this dtype:
    bf16 runs on the tensor cores (`flash_fwd_tc`), float32 on the CUDA
    cores (`flash_fwd`: TF32 would change float32 results). Any other
    dtype raises."""
    if dtype == torch.bfloat16:
        return flash_fwd_tc
    if dtype == torch.float32:
        return flash_fwd
    raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                     f"{dtype}")


def flash_bwd_dkdv(q, k, v, out, lse, dout, *, causal: bool,
                   window: Optional[int], q_offset: int,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA-core dK/dV kernel: returns (dk, dv) laid out like k
    and v."""
    lib = _lib()
    d = q.shape[3]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkdv(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _strides(q, k, v, out, dout, dk, dv),
            *_problem(q, k, causal, window, q_offset, _scale(q, scale)),
            _stream(q))
    _raise_on(err, "flash_attention_bwd_dkdv")
    count_launch(flash_bwd_dkdv)
    return dk, dv


def flash_bwd_delta(out, dout) -> torch.Tensor:
    """Launch the backward's pre-pass (bf16 only): D_i = rowsum(dO∘O) in
    float32 for every query row, a contiguous (B, H, S) array, which
    `flash_bwd_dkdv_tc` and `flash_bwd_dq_tc` read. Raises on arguments it
    does not take: CUDA bf16 tensors of one (B, H, S, D) shape with D 64
    or 128, a unit stride on D and every row on 4 bytes."""
    for name, t in (("out", out), ("dout", dout)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_bwd_delta runs on CUDA tensors, {name} "
                             f"is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_bwd_delta takes bfloat16, {name} is "
                             f"{t.dtype}")
        if t.dim() != 4 or t.shape != out.shape or t.device != out.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does "
                             f"not match out {tuple(out.shape)} on "
                             f"{out.device}")
        if (t.stride(-1) != 1 or t.data_ptr() % 4
                or any(st % 2 for st in t.stride()[:3])):
            raise ValueError(f"flash_bwd_delta: {name} (strides "
                             f"{t.stride()}) does not put every row on 4 "
                             "bytes with a unit stride on the head "
                             "dimension")
    b, h, s, d = out.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    lib = _lib_tc()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=out.device)
    with torch.cuda.device(out.device):
        err = lib.flash_attention_bwd_delta(
            d, out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
            _strides(out, dout), b, h, s, _stream(out))
    _raise_on(err, "flash_attention_bwd_delta")
    count_launch(flash_bwd_delta)
    return delta


def _backward_tc_inputs(what: str, q, k, v, out, lse, dout, causal,
                        window, q_offset, delta):
    """Check a tensor-core backward kernel's inputs (bf16, TMA's rules for
    q, k, v and dout, lse and delta contiguous float32 (B, H, S)) and
    return delta, `flash_bwd_delta`'s (one more launch) when None."""
    _check(q, k, v, causal, window, q_offset)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bfloat16, got {q.dtype}")
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match q {tuple(q.shape)} {q.dtype}")
    _require_tma(what, (("q", q), ("k", k), ("v", v), ("dout", dout)))
    if delta is None:
        delta = flash_bwd_delta(out, dout)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{tuple(q.shape[:3])} tensor on {q.device}")
    return delta


def flash_bwd_dkdv_tc(q, k, v, out, lse, dout, *, causal: bool,
                      window: Optional[int], q_offset: int,
                      scale: Optional[float] = None,
                      delta: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the tensor-core dK/dV kernel (bf16 only): returns (dk, dv)
    laid out like k and v, the function `flash_bwd_dkdv` computes with P
    and dS rounded to bf16 before their products. ``delta`` is
    `flash_bwd_delta`'s output for (out, dout), computed here (one more
    launch) when not given. q, k, v and dout must satisfy TMA's rules
    (`tma_refusal`); it raises on them, as on anything else it does not
    take, and when the launch is refused: it never falls back to another
    kernel. `_FlashAttention.backward` copies an output gradient TMA
    cannot take before it calls this."""
    delta = _backward_tc_inputs("flash_bwd_dkdv_tc", q, k, v, out, lse,
                                dout, causal, window, q_offset, delta)
    lib = _lib_tc()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    flat = (_tma_strides(q) + _tma_strides(k) + _tma_strides(v)
            + _tma_strides(dout) + list(dk.stride()[:3])
            + list(dv.stride()[:3]))
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dkdv_tc(
            q.shape[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            (ctypes.c_longlong * len(flat))(*flat),
            *_problem(q, k, causal, window, q_offset, _scale(q, scale)),
            _stream(q))
    _raise_on(err, "flash_attention_bwd_dkdv_tc")
    count_launch(flash_bwd_dkdv_tc)
    return dk, dv


def dkdv_for(dtype: torch.dtype):
    """The dK/dV launch function for inputs of this dtype: bf16 runs on
    the tensor cores (`flash_bwd_dkdv_tc`), float32 on the CUDA cores
    (`flash_bwd_dkdv`: TF32 would change float32 results). Any other
    dtype raises."""
    if dtype == torch.bfloat16:
        return flash_bwd_dkdv_tc
    if dtype == torch.float32:
        return flash_bwd_dkdv
    raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                     f"{dtype}")


def flash_bwd_dq(q, k, v, out, lse, dout, *, causal: bool,
                 window: Optional[int], q_offset: int,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dQ kernel: returns dq laid out like q."""
    lib = _lib()
    d = q.shape[3]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, out, dout, dq),
            *_problem(q, k, causal, window, q_offset, _scale(q, scale)),
            _stream(q))
    _raise_on(err, "flash_attention_bwd_dq")
    count_launch(flash_bwd_dq)
    return dq


def flash_bwd_dq_tc(q, k, v, out, lse, dout, *, causal: bool,
                    window: Optional[int], q_offset: int,
                    scale: Optional[float] = None,
                    delta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the tensor-core dQ kernel (bf16 only): returns dq laid out
    like q, the function `flash_bwd_dq` computes with dS rounded to bf16
    before dS·K. ``delta`` and what it raises on are as for
    `flash_bwd_dkdv_tc`; it never falls back to another kernel."""
    delta = _backward_tc_inputs("flash_bwd_dq_tc", q, k, v, out, lse, dout,
                                causal, window, q_offset, delta)
    lib = _lib_tc()
    dq = torch.empty_like(q)
    flat = (_tma_strides(q) + _tma_strides(k) + _tma_strides(v)
            + _tma_strides(dout) + list(dq.stride()[:3]))
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_dq_tc(
            q.shape[3], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), (ctypes.c_longlong * len(flat))(*flat),
            *_problem(q, k, causal, window, q_offset, _scale(q, scale)),
            _stream(q))
    _raise_on(err, "flash_attention_bwd_dq_tc")
    count_launch(flash_bwd_dq_tc)
    return dq


def dq_for(dtype: torch.dtype):
    """The dQ launch function for inputs of this dtype: bf16 runs on the
    tensor cores (`flash_bwd_dq_tc`), float32 on the CUDA cores
    (`flash_bwd_dq`: TF32 would change float32 results). Any other dtype
    raises."""
    if dtype == torch.bfloat16:
        return flash_bwd_dq_tc
    if dtype == torch.float32:
        return flash_bwd_dq
    raise ValueError(f"flash_attention takes float32 or bfloat16, got "
                     f"{dtype}")


flash_fwd.launches = 0
flash_fwd_tc.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_delta.launches = 0
flash_bwd_dkdv_tc.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dq_tc.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The forward kernel of q's dtype (`forward_for`), and as its gradient
    the dK/dV and dQ kernels of that dtype (`dkdv_for`, `dq_for`); for
    bf16 both read one D_i pre-pass. The forward saves q, k, v, the output
    and the float32 logsumexp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        mask = dict(causal=causal, window=window, q_offset=q_offset,
                    scale=scale)
        out, lse = forward_for(q.dtype)(q, k, v, **mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = mask
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.shape != out.shape:
            raise ValueError(f"output gradient {tuple(dout.shape)} does not "
                             f"match the output {tuple(out.shape)}")
        if dout.dtype != q.dtype:
            dout = dout.to(q.dtype)
        # autograd's gradient may have any layout: copy it where a kernel
        # cannot read it (a non-unit last stride; for the tensor-core
        # kernels, a layout TMA refuses)
        tc = q.dtype == torch.bfloat16
        if dout.stride(-1) != 1 or (tc and tma_refusal(
                tuple(dout.shape), dout.stride(), dout.data_ptr(),
                dout.element_size()) is not None):
            dout = dout.clone(memory_format=torch.contiguous_format)
        mask = dict(ctx.mask)
        if tc:
            mask["delta"] = flash_bwd_delta(out, dout)
        dk, dv = dkdv_for(q.dtype)(q, k, v, out, lse, dout, **mask)
        dq = dq_for(q.dtype)(q, k, v, out, lse, dout, **mask)
        return dq, dk, dv, None, None, None, None


def pad_head_dim(q, k, v):
    """(q, k, v, d): q, k and v zero-padded on their last axis to the
    narrowest of `HEAD_DIMS` that holds their head dimension d, or the
    same tensors when d is one of `HEAD_DIMS`. Zero columns add exact
    zeros to every q·k and give the output zero columns, so attention of
    the padded tensors with the unpadded scale d^-1/2, sliced back to d,
    is attention of the originals. Raises when k or v has another head
    dimension than q, and for d outside 1..128."""
    d = q.shape[-1]
    for name, t in (("k", k), ("v", v)):
        if t.shape[-1] != d:
            raise ValueError(f"{name} has head_dim {t.shape[-1]}, q has {d}")
    if d in HEAD_DIMS:
        return q, k, v, d
    if not 1 <= d <= HEAD_DIMS[-1]:
        raise ValueError(
            f"head_dim {d} is outside 1..{HEAD_DIMS[-1]}: the reference's "
            "kernel takes any head_dim, the port's K2 at most "
            f"{HEAD_DIMS[-1]}, and no config of this repository has a "
            "wider attention head")
    pad = (0, min(w for w in HEAD_DIMS if w >= d) - d)
    return F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, Hkv, T, D) CUDA tensors with H = G·Hkv,
    float32 or bfloat16, any head_dim D up to 128 (other than 64 or 128
    zero-padded to the next of them, `pad_head_dim`, and the output sliced
    back). The forward, dK/dV and dQ run on the tensor cores for bfloat16
    and on the CUDA cores for float32. Differentiable.
    Raises on anything the kernels do not take, CPU tensors included."""
    qp, kp, vp, d = pad_head_dim(q, k, v)
    out = _FlashAttention.apply(qp, kp, vp, causal, window, q_offset,
                                float(d) ** -0.5)
    return out if qp is q else out[..., :d]
