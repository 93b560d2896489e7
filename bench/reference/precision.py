"""The matrix product of the references, at a stated precision.

* ``float32``: full float32 products (TF32 off).
* ``tf32``: products whose inputs keep TF32's 10 mantissa bits. On a card
  the tensor cores' own TF32 path; on the CPU the inputs rounded to
  nearest-even at 10 bits, then a float32 product.
* ``fp8``: as an fp8 training recipe has it, the forward's inputs
  quantized to float8 e4m3 and the backward's incoming gradients to e5m2,
  each tensor with one scale (its largest magnitude onto the format's
  largest), products in float32.

The controls of the correctness check use the two lower ones: the step a
program would take below the precision its configuration states."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def _through(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x)`` forward, with the gradient passed straight through."""
    return x + (fn(x.detach()) - x).detach()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with its mantissa rounded to nearest-even at 10 bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def quant(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` through a float8 format with one scale for the tensor."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` (``b`` a matrix, or batched like ``a``) with e4m3 inputs
    forward and an e5m2 incoming gradient backward."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quant(a), quant(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quant(g, torch.float8_e5m2)
        grad_a = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            grad_b = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(
                -1, qg.shape[-1])
        else:
            grad_b = qa.transpose(-1, -2) @ qg
        return grad_a, grad_b


@contextlib.contextmanager
def products(precision: str):
    """Within the block, float32 products on a card run as ``precision``
    says (TF32 only for ``tf32``); the previous setting comes back."""
    if not torch.cuda.is_available():
        yield
        return
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` at ``precision`` (inside `products`)."""
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    if precision == "tf32" and a.device.type == "cpu":
        return _through(a, round_tf32) @ _through(b, round_tf32)
    return a @ b
