"""MoE dispatch tables on the card: the (E, C) token, combine-weight and
validity tables of a capacity-routed MoE layer (`models.moe.
_dispatch_tables`) in one launch.

An assignment's slot is its rank among its expert's assignments in token
order; one past the capacity is dropped; an empty slot points at token 0
with weight 0. The kernel is CUDA C++ in ``csrc/moe_dispatch.cu`` (see its
header for what bounds it and how it is laid out); this module checks the
arguments, allocates the tables and launches it on PyTorch's current
stream. The combine weights keep their gradient: the launch also records
each slot's assignment, from which `DispatchTables`' backward scatters the
weights' gradient back to ``topv``, as the plain version's ``index_put``
does. `dispatch_tables_reference` is the plain version; ``kernels.ops``
picks between the two by the device of the tensors."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, count_launch

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
_INDEX_DTYPES = (torch.int64, torch.int32)


def dispatch_tables_reference(topi, topv, e: int, capacity: int):
    """The plain version: ranks by a cumsum over the one-hot of the flat
    expert ids; a dropped assignment lands in a spare column that is cut
    away. Returns (tok_tbl int32, cmb_tbl float32, val_tbl bool), each
    (e, capacity)."""
    t, k = topi.shape
    flat_e = topi.reshape(-1)                                  # (T*k,)
    oh = F.one_hot(flat_e, e).to(torch.int32)
    pos = torch.cumsum(oh, dim=0) - 1
    mypos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    tok_ids = torch.arange(t, dtype=torch.int32,
                           device=topi.device).repeat_interleave(k)
    valid = mypos < capacity
    slot = (flat_e, torch.clamp_max(mypos, capacity).long())

    def table(values, dtype):
        tbl = torch.zeros((e, capacity + 1), dtype=dtype,
                          device=topi.device)
        return tbl.index_put(slot, values.to(dtype))[:, :capacity]

    tok_tbl = table(tok_ids, torch.int32)
    val_tbl = table(valid, torch.bool)
    cmb_tbl = table(torch.where(valid, topv.reshape(-1), 0.0), torch.float32)
    return tok_tbl, cmb_tbl, val_tbl


def _lib() -> ctypes.CDLL:
    lib = build.load("moe_dispatch")
    fn = lib.moe_dispatch_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(topi, topv, e: int, capacity: int) -> None:
    dev = topi.device
    if dev.type != "cuda":
        raise ValueError(f"moe_dispatch_tables runs on CUDA tensors, got "
                         f"{dev}; CPU tensors take kernels.ops' plain path")
    if topv.device != dev:
        raise ValueError(f"topv is on {topv.device}, topi on {dev}")
    if topi.dtype not in _INDEX_DTYPES:
        raise ValueError(f"topi must be one of {_INDEX_DTYPES}, got "
                         f"{topi.dtype}")
    if topv.dtype != torch.float32:
        raise ValueError(f"topv must be torch.float32, got {topv.dtype}")
    if topi.dim() != 2 or topv.shape != topi.shape:
        raise ValueError(f"topi and topv must be one (T, k) shape, got "
                         f"{tuple(topi.shape)} and {tuple(topv.shape)}")
    if not (topi.is_contiguous() and topv.is_contiguous()):
        raise ValueError("topi and topv must be contiguous")
    if topi.numel() >= 2 ** 31:
        raise ValueError(f"{topi.numel()} assignments: the kernel takes "
                         f"fewer than 2^31")
    if e < 0 or capacity < 0:
        raise ValueError(f"experts {e} and capacity {capacity} must be "
                         f"≥ 0")


def dispatch_tables(topi, topv, e: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Launch the kernel over the (T, k) expert ids ``topi`` (int64 or
    int32) and their float32 weights ``topv``, contiguous on one card:
    (tok_tbl, cmb_tbl, val_tbl) as `dispatch_tables_reference` gives them,
    and each slot's flat assignment index t·k + i (int64; T·k where the
    slot is empty). One launch, counted in ``dispatch_tables.launches``
    (none when the tables are empty); no host sync. Raises on any argument
    the kernel does not take, and when the launch is refused. No gradient:
    `DispatchTables` carries it."""
    _check(topi, topv, e, capacity)
    dev = topi.device
    tok = torch.empty((e, capacity), dtype=torch.int32, device=dev)
    cmb = torch.empty((e, capacity), dtype=torch.float32, device=dev)
    val = torch.empty((e, capacity), dtype=torch.bool, device=dev)
    asg = torch.empty((e, capacity), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        launched = lib.moe_dispatch_launch(
            topi.data_ptr(), int(topi.dtype == torch.int64), topv.data_ptr(),
            topi.numel(), topi.shape[1], e, capacity, tok.data_ptr(),
            cmb.data_ptr(), val.data_ptr(), asg.data_ptr(), stream)
    if launched < 0:
        raise RuntimeError(f"moe_dispatch kernel launch failed: CUDA error "
                           f"{-launched}")
    count_launch(dispatch_tables, launched)
    return tok, cmb, val, asg


dispatch_tables.launches = 0


class DispatchTables(torch.autograd.Function):
    """The kernel's tables with the combine weights' gradient: cmb_tbl[s]
    is topv at slot s's assignment, so topv's gradient is cmb_tbl's
    gradient at the slot each assignment filled, 0 where it was dropped,
    the bits the plain version's ``index_put`` backward gives."""

    @staticmethod
    def forward(ctx, topi, topv, e: int, capacity: int):
        tok, cmb, val, asg = dispatch_tables(topi, topv, e, capacity)
        ctx.save_for_backward(asg)
        ctx.shape = topv.shape
        ctx.mark_non_differentiable(tok, val)
        return tok, cmb, val

    @staticmethod
    def backward(ctx, _tok, g_cmb, _val):
        (asg,) = ctx.saved_tensors
        n = ctx.shape.numel()
        # empty slots all scatter into the spare element n, cut away
        g = torch.zeros(n + 1, dtype=g_cmb.dtype, device=g_cmb.device)
        g.scatter_(0, asg.reshape(-1), g_cmb.reshape(-1))
        return None, g[:n].view(ctx.shape), None, None
