"""Fused elastic SGD update on the card: Eq. (5)'s masked-renormalized mean
gradient folded into the momentum/parameter apply, over the replica-blocked
flat parameter layout of ``train.megabatch``.

The megabatched trainer computes gradients of the *sum*-form loss
(Σ_tokens w·nll), so per replica the Eq.-(5) renormalization is a scalar:
``ḡ = g_sum / max(Σw, 1e-6)`` when Σw > 0, exactly 0 when every worker is
preempted. One launch updates every parameter of every replica:

    inv  = Σw > 0 ? 1/max(Σw, 1e-6) : 0
    v'   = μ·v + g_sum·inv            # SGD momentum (non-nesterov)
    p'   = p − lr·v'
    p,v  = running ? (p', v') : (p, v)   # idle/finished ticks are no-ops

The kernel is CUDA C++ in ``csrc/elastic_update.cu`` (see its header for
what bounds it and how it is laid out); this module checks the arguments
and launches it on PyTorch's current stream. Its plain version is
``kernels.ref.elastic_update_reference``; ``kernels.ops`` picks between
the two by the device of the tensors."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_float, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = build.load("elastic_update")
    fn = lib.elastic_update_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(params, mom, grads, w_sum, running, lr) -> None:
    dev = params.device
    if dev.type != "cuda":
        raise ValueError(f"elastic_sgd_update runs on CUDA tensors, got "
                         f"{dev}; CPU tensors take kernels.ops' plain path")
    if params.dim() != 2:
        raise ValueError(f"params must be (R, P), got {tuple(params.shape)}")
    r = params.shape[0]
    for name, t, shape, dtype in (
            ("params", params, params.shape, torch.float32),
            ("mom", mom, params.shape, torch.float32),
            ("grads", grads, params.shape, torch.float32),
            ("w_sum", w_sum, (r,), torch.float32),
            ("running", running, (r,), torch.bool),
            ("lr", lr, (r,), torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, params on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def elastic_sgd_update(params: torch.Tensor, mom: torch.Tensor,
                       grads: torch.Tensor, w_sum: torch.Tensor,
                       running: torch.Tensor, lr: torch.Tensor, *,
                       momentum: float = 0.9
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: params/mom/grads (R, P) float32 CUDA tensors,
    w_sum (R,) float32, running (R,) bool, lr (R,) float32. Updates
    ``params`` and ``mom`` IN PLACE and returns them. ``grads`` are
    SUM-form; the Eq.-(5) division by Σw happens inside the kernel.
    Raises on any argument the kernel does not take, and when the launch
    is refused."""
    _check(params, mom, grads, w_sum, running, lr)
    lib = _lib()
    r, p_dim = params.shape
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.elastic_update_launch(
            params.data_ptr(), mom.data_ptr(), grads.data_ptr(),
            w_sum.data_ptr(), running.data_ptr(), lr.data_ptr(), r, p_dim,
            float(momentum), stream)
    if err != 0:
        raise RuntimeError(f"elastic_update kernel launch failed: CUDA "
                           f"error {err}")
    return params, mom
