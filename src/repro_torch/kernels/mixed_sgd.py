"""Mixed-precision SGD with momentum on the card, gated and in place: one
(scenario, seed) cell's whole update in one launch, over the zoo's
``{"params", "master", "opt"}`` carry (`train.zoo_program`). For every
element of every leaf:

    g32 = float(g)                       # g in p's dtype, or float32
    v'  = fl(fl(momentum·v) + g32)       # float32 momentum, two roundings
    m'  = fl(m − fl(lr·v'))              # float32 master
    p'  = m' in p's dtype (bf16 rounded to nearest even, or float32)
    (v, m, p) = running ? (v', m', p') : (v, m, p)

which is bit for bit what the functional update (the gradients cast up,
`optim.sgd`'s momentum step over the masters, the refresh of the working
copy) landed by `sim.engine.gate_model` gives.

The kernel is CUDA C++ in ``csrc/mixed_sgd.cu`` (see its header for what
bounds it and how it is laid out); this module checks the arguments,
builds the leaf table from ``data_ptr()`` on the host and launches it on
PyTorch's current stream. `mixed_sgd_update_reference` is its plain
version; ``kernels.ops`` picks between the two by the device of the
tensors."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_void_p]

#: a leaf's flags in the kernel's table: its gradient, its working copy in
#: bf16 (float32 sets neither)
_GRAD_BF16, _PARAM_BF16 = 1, 2
_WORKING = (torch.bfloat16, torch.float32)
#: the leaves one launch takes (`kMaxLeaves` in the source); the zoo's
#: largest model, Zamba2-7B, has 40
MAX_LEAVES = 64


def mixed_sgd_update_reference(grads: Sequence[torch.Tensor],
                               mom: Sequence[torch.Tensor],
                               master: Sequence[torch.Tensor],
                               params: Sequence[torch.Tensor],
                               running: torch.Tensor, lr: torch.Tensor, *,
                               momentum: float) -> None:
    """The plain version: the same update, leaf by leaf, in the functional
    step's own PyTorch operations and the gate's, landing in ``mom``,
    ``master`` and ``params`` in place."""
    for g, v, m, p in zip(grads, mom, master, params):
        v_new = momentum * v + g.to(torch.float32)
        m_new = m - lr * v_new
        for old, new in ((v, v_new), (m, m_new), (p, m_new.to(p.dtype))):
            old.copy_(torch.where(running, new, old))


def _lib() -> ctypes.CDLL:
    lib = build.load("mixed_sgd")
    fn = lib.mixed_sgd_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(grads, mom, master, params, running, lr) -> None:
    n = len(params)
    if not len(grads) == len(mom) == len(master) == n:
        raise ValueError(f"leaf counts differ: grads {len(grads)}, mom "
                         f"{len(mom)}, master {len(master)}, params {n}")
    if n > MAX_LEAVES:
        raise ValueError(f"{n} leaves: one launch takes at most "
                         f"{MAX_LEAVES}")
    dev = params[0].device if n else running.device
    if dev.type != "cuda":
        raise ValueError(f"mixed_sgd_update runs on CUDA tensors, got {dev}; "
                         f"CPU tensors take kernels.ops' plain path")
    for name, t, dtype in (("running", running, torch.bool),
                           ("lr", lr, torch.float32)):
        if t.device != dev or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"{name} must be one {dtype} on {dev}, got "
                             f"{t.dtype} of shape {tuple(t.shape)} on "
                             f"{t.device}")
    for i, (g, v, m, p) in enumerate(zip(grads, mom, master, params)):
        # a gradient comes in its working copy's dtype, or in float32
        # (accumulated over micro-slices)
        for name, t, dtypes in (("grad", g, (p.dtype, torch.float32)),
                                ("momentum", v, (torch.float32,)),
                                ("master", m, (torch.float32,)),
                                ("param", p, _WORKING)):
            if t.device != dev:
                raise ValueError(f"leaf {i}: {name} is on {t.device}, "
                                 f"running on {dev}")
            if t.dtype not in dtypes:
                raise ValueError(f"leaf {i}: {name} must be one of {dtypes}, "
                                 f"got {t.dtype}")
            if t.shape != p.shape:
                raise ValueError(f"leaf {i}: {name} has shape "
                                 f"{tuple(t.shape)}, param {tuple(p.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"leaf {i}: {name} must be contiguous")


def mixed_sgd_update(grads: Sequence[torch.Tensor],
                     mom: Sequence[torch.Tensor],
                     master: Sequence[torch.Tensor],
                     params: Sequence[torch.Tensor],
                     running: torch.Tensor, lr: torch.Tensor, *,
                     momentum: float) -> int:
    """Launch the kernel over one cell's leaves (at most `MAX_LEAVES`),
    matched by position: working copies (bf16 or float32), grads in their
    working copy's dtype or float32, momentum and masters (float32), each
    the same shape and contiguous; running one bool and lr one float32,
    all on one card. Updates ``mom``, ``master`` and ``params`` IN PLACE
    where ``running`` holds. Returns the number of launches made: 1, or 0
    when every leaf is empty. Raises on any argument the kernel does not
    take, and when a launch is refused."""
    _check(grads, mom, master, params, running, lr)
    n = len(params)
    ptrs = (ctypes.c_longlong * (4 * n))(*(
        t.data_ptr() for leaf in zip(grads, mom, master, params)
        for t in leaf))
    numels = (ctypes.c_longlong * n)(*(p.numel() for p in params))
    flags = (ctypes.c_int * n)(*(
        (_GRAD_BF16 if g.dtype == torch.bfloat16 else 0)
        | (_PARAM_BF16 if p.dtype == torch.bfloat16 else 0)
        for g, p in zip(grads, params)))
    lib = _lib()
    with torch.cuda.device(running.device):
        stream = torch.cuda.current_stream().cuda_stream
        launched = lib.mixed_sgd_launch(n, ptrs, numels, flags,
                                        running.data_ptr(), lr.data_ptr(),
                                        float(momentum), stream)
    if launched < 0:
        raise RuntimeError(f"mixed_sgd kernel launch failed: CUDA error "
                           f"{-launched}")
    return launched
