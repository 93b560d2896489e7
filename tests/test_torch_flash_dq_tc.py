"""K2's tensor-core dQ backward on the CPU: what of it runs without a card.

The kernel itself (``flash_bwd_dq_tc_kernel`` in
``csrc/flash_attention_sm90.cu``) runs only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version. Here: the dtype route of the dQ half (bf16 to the tensor cores,
float32 to the CUDA cores), the backward's wiring (one D_i pre-pass for
both bf16 halves), the kernel's key-tile range against a brute-force
mask, and the kernel's arithmetic — 64-row query tiles on wgmma's M
dimension over their key tiles, S and dP in float32 of bf16 operands, dS
rounded to bf16 before dS·K, a float32 accumulator scaled at the end, D_i
from the bf16 O and dO — emulated in plain PyTorch against ``jax.grad``
of the reference's jnp oracle."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as flash
from test_torch_flash_bwd_tc import (BWD_SHAPES, _bf16_heads_first, _inputs,
                                     _valid, row_err)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ route


@pytest.mark.parametrize("dtype,launch", [
    (torch.bfloat16, flash.flash_bwd_dq_tc),
    (torch.float32, flash.flash_bwd_dq)])
def test_dq_route_by_dtype(dtype, launch):
    assert flash.dq_for(dtype) is launch


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_dq_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash.dq_for(dtype)


def test_tc_dq_is_counted_and_built():
    """The launch function is in the launch counts, and its C entry point
    is in the tensor-core source, which includes no PyTorch header."""
    assert ops.WRAPPERS["flash_attention_bwd_dq_tc"] is flash.flash_bwd_dq_tc
    src = os.path.join(build.CSRC_DIR, build.SOURCES["flash_attention_sm90"])
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int flash_attention_bwd_dq_tc(' in text
    assert "flash_bwd_dq_tc_kernel" in text
    assert "torch/" not in text


def test_tc_dq_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 64)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_bwd_dq_tc(q, k, k, q, lse, q, causal=True, window=None,
                              q_offset=0, delta=lse)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_forms_delta_once_for_both_halves(monkeypatch, dtype):
    """`_FlashAttention.backward` with the launch functions replaced by
    recorders on CPU tensors: for bf16 one D_i pre-pass, whose output both
    tensor-core halves receive; for float32 none, and the CUDA-core halves
    form D_i themselves."""
    calls = []

    def forward(q, k, v, **mask):
        mask.pop("scale")
        return (ref.mha_reference(q, k, v, **mask),
                ref.mha_lse_reference(q, k, **mask))

    def delta(out, dout):
        calls.append(("delta",))
        return ref.mha_delta_reference(out, dout)

    def half(name, n_out):
        def run(q, k, v, out, lse, dout, **mask):
            calls.append((name, mask.get("delta")))
            zeros = (torch.zeros_like(k), torch.zeros_like(v))
            return zeros if n_out == 2 else torch.zeros_like(q)
        return run

    for name in ("flash_fwd", "flash_fwd_tc"):
        monkeypatch.setattr(flash, name, forward)
    monkeypatch.setattr(flash, "flash_bwd_delta", delta)
    for name, n_out in (("flash_bwd_dkdv", 2), ("flash_bwd_dkdv_tc", 2),
                        ("flash_bwd_dq", 1), ("flash_bwd_dq_tc", 1)):
        monkeypatch.setattr(flash, name, half(name, n_out))
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2).to(dtype)
                   for x in _inputs((1, 70, 70, 4, 2, 64)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash.flash_attention(*leaves, causal=True)
    torch.autograd.grad(out, leaves, do)
    if dtype == torch.bfloat16:
        assert [c[0] for c in calls] == ["delta", "flash_bwd_dkdv_tc",
                                         "flash_bwd_dq_tc"]
        assert calls[1][1] is calls[2][1] is not None
    else:
        assert calls == [("flash_bwd_dkdv", None), ("flash_bwd_dq", None)]


# ---------------------------------------------------- the key-tile range


def key_tiles(s, t, q0, *, causal, window, q_offset, tile=64):
    """A line-by-line transcription of ``key_tiles`` in
    csrc/flash_attention_sm90.cu: the key tiles [begin, end) the forward
    and dQ kernels visit for the query tile at q0."""
    nk = (t + tile - 1) // tile
    last_row = min(q0 + tile, s) - 1
    qpos_lo, qpos_hi = q0 + q_offset, last_row + q_offset
    e = min(nk, qpos_hi // tile + 1) if causal else nk
    b = 0
    if window is not None:
        lo = qpos_lo - window + 1          # the oldest key any row sees
        b = lo // tile if lo > 0 else 0
    return b, e


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_key_tiles_are_the_tiles_with_a_valid_pair(shape):
    """Every key tile that holds a valid (row, key) pair for some row of a
    query tile lies in that query tile's range, and every tile of the range
    holds one: the loop skips exactly the tiles that contribute zeros."""
    s, t = shape[1], shape[2]
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    valid = _valid(s, t, **mask)
    for q0 in range(0, s, 64):
        block = valid[q0:q0 + 64]
        meets = [block[:, k0:k0 + 64].any() for k0 in range(0, t, 64)]
        b, e = key_tiles(s, t, q0, **mask)
        assert [i for i, m in enumerate(meets) if m] == list(range(b, e))


# --------------------------------------------------- the kernel's arithmetic


def tiled_dq(q, k, v, o, lse, do, *, causal, window, q_offset, tile=64,
             round_operands=True):
    """The tensor-core dQ kernel's arithmetic in plain PyTorch. Per 64-row
    query tile (wgmma's M dimension), over the key tiles `key_tiles`
    gives: S = Q Kᵀ and dP = dO Vᵀ in float32 of the bf16 inputs (the
    tensor cores' products of bf16 operands are exact in float32), P =
    exp(S·scale − lse) where valid else 0, dS = P∘(dP − D_i), then dQ +=
    bf16(dS)·K into a float32 accumulator, scaled at the end. D_i =
    rowsum(dO∘O) in float32. ``round_operands`` False keeps dS float32 (the
    CUDA-core kernel's arithmetic). q, o, do (B, H, S, D) and k, v (B, Hkv,
    T, D), any float dtype; lse (B, H, S). Returns float32 dq."""
    b, h, s, d = q.shape
    t, g = k.shape[2], h // k.shape[1]
    scale = d ** -0.5
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    valid = torch.from_numpy(_valid(s, t, **mask))

    def rnd(x):
        return x.to(torch.bfloat16).float() if round_operands else x

    qf, dof = q.float(), do.float()
    kf, vf = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    delta = (o.float() * dof).sum(-1)
    dq = torch.zeros(b, h, s, d)
    for q0 in range(0, s, tile):
        rows = slice(q0, q0 + tile)
        acc = torch.zeros_like(qf[..., rows, :])
        kt0, kt1 = key_tiles(s, t, q0, **mask)
        for k0 in range(kt0 * tile, kt1 * tile, tile):
            keys = slice(k0, k0 + tile)
            kk = kf[..., keys, :]
            st = qf[..., rows, :] @ kk.transpose(-1, -2)
            dp = dof[..., rows, :] @ vf[..., keys, :].transpose(-1, -2)
            p = torch.where(valid[rows, keys],
                            torch.exp(st * scale - lse[..., rows, None]), 0.0)
            acc += rnd(p * (dp - delta[..., rows, None])) @ kk
        dq[..., rows, :] = acc * scale
    return dq


#: per row (row_err), the worst row counting. Against jax.grad of the
#: reference's oracle: dq rounded to bf16 as the kernel writes it, D_i
#: from the bf16 output where the oracle's is float32 (in a row whose
#: softmax sits on few keys dS = P (dP - D) nearly cancels, so D's rounding
#: is large beside the row's dq) and the rounding of dS, within
#: chip_smoke.py's K2_TOL of 0.1 for dq (worst row of these shapes 5.0e-2,
#: the causal GQA shape (2, 256, 256, 8, 2, 64); 5.5e-3 to 1.8e-2 elsewhere).
#: The rounding of dS alone, against the plain float32 gradient from a
#: float32 O: each term dS_ij k_j of a row's sum moves by at most the bf16
#: unit roundoff 2^-8 of itself, with random signs across the keys, so the
#: sum stays under one bf16 ulp of the row's largest entry (2^-7), which is
#: the bound held. Worst row of these shapes 4.5e-3 (3.7e-3 to 4.5e-3 on
#: each). Without that rounding the emulation is the plain gradient summed
#: in another order: 2.4e-6, held at 1e-5.
DQ_TOL = {"vs_reference": 0.1, "rounding": 2.0 ** -7, "unrounded": 1e-5}


def _oracle_dq(q, k, v, do, mask):
    """dq of sum(out * do) by jax.grad of the reference's jnp oracle, in
    float32, as a (B, H, S, D) tensor; inputs (B, H, S, D) tensors."""
    qj, kj, vj, doj = (jnp.asarray(x.numpy()) for x in (q, k, v, do))

    def loss(q_):
        return (jax_ref.mha_reference(q_, kj, vj, **mask) * doj).sum()

    return torch.from_numpy(np.array(jax.grad(loss)(qj)))


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_dq_arithmetic_matches_jax_grad_of_reference(shape):
    """The emulation from bf16 inputs, the forward's bf16 output and its
    float32 lse, rounded to bf16 as the kernel writes dq, against jax.grad
    of the reference's oracle at the same bf16 values."""
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = (_bf16_heads_first(x) for x in _inputs(shape))
    o = ref.mha_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), **mask)
    lse = ref.mha_lse_reference(q, k, **mask)
    dq = tiled_dq(q, k, v, o, lse, do, **mask)
    assert row_err(dq.bfloat16(), _oracle_dq(q, k, v, do, mask)) \
        <= DQ_TOL["vs_reference"]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_dq_rounding_alone(shape):
    """From a float32 O, the emulation with dS rounded to bf16 differs from
    autograd through the plain float32 version by that rounding alone;
    without it, by the order of float32 sums."""
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = (_bf16_heads_first(x) for x in _inputs(shape, seed=1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ref.mha_reference(*leaves, **mask)
    want, = torch.autograd.grad(o, leaves[:1], do)
    lse = ref.mha_lse_reference(q, k, **mask)
    for rounded, tol in ((True, DQ_TOL["rounding"]),
                         (False, DQ_TOL["unrounded"])):
        dq = tiled_dq(q, k, v, o.detach(), lse, do, **mask,
                      round_operands=rounded)
        assert row_err(dq, want) <= tol, rounded
