"""K2's tensor-core forward on the CPU: what of it runs without a card.

The kernel itself (``csrc/flash_attention_sm90.cu``) runs only on the card,
where tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version. Here: the dtype route (bf16 to the tensor-core forward, float32
to the CUDA-core forward, anything else raises), TMA's eligibility rules
as a pure function of shape, strides and address, the CPU path launching
neither forward, and the kernel's arithmetic — 64-key tiles, the online
softmax in float32, P rounded to bf16 before P·V — emulated in plain
PyTorch against the reference's Pallas kernel in interpret mode."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as flash


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ route


@pytest.mark.parametrize("dtype,launch", [
    (torch.bfloat16, flash.flash_fwd_tc), (torch.float32, flash.flash_fwd)])
def test_forward_route_by_dtype(dtype, launch):
    assert flash.forward_for(dtype) is launch


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_forward_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash.forward_for(dtype)


def test_tc_forward_is_counted_and_built():
    """The wrapper is in the launch counts, and its source is a build
    target that defines the C entry point and includes no PyTorch
    header."""
    assert ops.WRAPPERS["flash_attention_fwd_tc"] is flash.flash_fwd_tc
    src = os.path.join(build.CSRC_DIR, build.SOURCES["flash_attention_sm90"])
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int flash_attention_fwd_tc(' in text
    assert "torch/" not in text


# ------------------------------------------------------------------- TMA

D128 = (2, 14, 100, 128)
#: (B, H, S, D) strides of the model's (B, S, H, D) tensor seen transposed
MODEL_VIEW = (100 * 14 * 128, 128, 14 * 128, 1)


@pytest.mark.parametrize("shape,strides,address,why", [
    (D128, (14 * 100 * 128, 100 * 128, 128, 1), 0, None),
    (D128, MODEL_VIEW, 0x7f0000000000, None),
    (D128, MODEL_VIEW, 16, None),                    # 16 bytes suffice
    ((1, 4, 64, 64), (4 * 64 * 64, 64 * 64, 64, 1), 2, "base address"),
    ((1, 4, 64, 64), (4 * 64 * 68, 64 * 68, 68, 1), 0, "multiple of 16"),
    ((2, 4, 64, 64), (0, 64 * 64, 64, 1), 0, "multiple of 16"),
    ((1, 4, 64, 32), (4 * 64 * 32, 64 * 32, 32, 1), 0, "head_dim"),
    ((1, 4, 64, 256), (4 * 64 * 256, 64 * 256, 256, 1), 0, "head_dim"),
    ((1, 4, 64, 64), (4 * 64 * 128, 64 * 128, 128, 2), 0, "stride 2"),
    # a dimension of length 1 is never stepped along: its stride is free
    ((1, 1, 64, 64), (3, 5, 64, 1), 0, None),
])
def test_tma_refusal(shape, strides, address, why):
    got = flash.tma_refusal(shape, strides, address, 2)
    if why is None:
        assert got is None
    else:
        assert got is not None and why in got


def test_tma_refusal_counts_bytes_of_the_element_size():
    """Eight bf16 elements are 16 bytes; four are 8."""
    shape = (1, 2, 2, 64)
    assert flash.tma_refusal(shape, (256, 128, 72, 1), 0, 2) is None
    assert flash.tma_refusal(shape, (256, 128, 68, 1), 0, 2) is not None
    assert flash.tma_refusal(shape, (256, 128, 68, 1), 0, 4) is None


def test_tma_strides_stand_in_for_length_one_dims():
    t = torch.empty(1, 64, 3, 64).transpose(1, 2)     # (1, 3, 64, 64)
    assert flash._tma_strides(t) == [64, 64, 3 * 64]
    u = torch.empty(2, 1, 5, 128)
    assert flash._tma_strides(u) == [5 * 128, 128, 128]


# ------------------------------------------------------------- CPU path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_launches_neither_forward(dtype):
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype) for s in ((1, 64, 4, 64), (1, 64, 2, 64),
                                         (1, 64, 2, 64), (1, 64, 4, 64)))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_mha(*leaves, causal=True)
    torch.autograd.grad(out, leaves, do)
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 0
    assert counts["flash_attention_fwd_tc"] == 0
    assert set(counts.values()) == {0}


def test_tc_forward_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_fwd_tc(q, k, k, causal=True, window=None, q_offset=0)
    assert ops.launch_counts()["flash_attention_fwd_tc"] == 0


# --------------------------------------------------- the kernel's arithmetic


def tiled_forward(q, k, v, *, causal, window, q_offset, tile=64):
    """The tensor-core forward's arithmetic in plain PyTorch: per 64-key
    tile, float32 scores of the bf16 inputs, masked to -1e30; m_cur =
    max(m, tile max), e = exp(s - m_cur), l = l·exp(m - m_cur) + Σe, and
    acc = acc·exp(m - m_cur) + bf16(e)·V (the tensor cores' products of
    bf16 operands are exact in float32). Returns (acc / max(l, 1e-30) in
    float32, lse). Every tile is visited: a tile the kernel skips holds no
    valid key of any row it writes, and visiting it changes nothing (before
    a row's first valid key its sums are reset by exp(-1e30 - m) = 0,
    after it they gain exp(-1e30 - m) = 0)."""
    b, h, s, d = q.shape
    t, g = k.shape[2], h // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(g, dim=1).float()
    vf = v.repeat_interleave(g, dim=1).float()
    m = torch.full((b, h, s), -float("inf"))
    l, acc = torch.zeros(b, h, s), torch.zeros(b, h, s, d)
    qpos = torch.arange(s)[:, None] + q_offset
    for k0 in range(0, t, tile):
        kk, vv = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        sc = torch.einsum("bhsd,bhtd->bhst", qf, kk) * d ** -0.5
        kpos = torch.arange(k0, k0 + kk.shape[2])[None, :]
        valid = torch.ones(s, kk.shape[2], dtype=torch.bool)
        if causal:
            valid &= kpos <= qpos
        if window is not None:
            valid &= qpos - kpos < window
        sc = torch.where(valid, sc, ref.NEG_INF)
        m_cur = torch.maximum(m, sc.amax(-1))
        e = torch.exp(sc - m_cur[..., None])
        corr = torch.exp(m - m_cur)
        l = l * corr + e.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", e.to(torch.bfloat16).float(), vv)
        m = m_cur
    lc = l.clamp_min(1e-30)
    return acc / lc[..., None], m + torch.log(lc)


def row_err(a, b):
    """The worst row's max |a - b| over the larger of that row's max |b|
    and b's RMS (rows along the last axis), as chip_smoke.py measures."""
    a, b = a.float(), b.float()
    num = (a - b).abs().amax(-1)
    den = b.abs().amax(-1).clamp_min(b.pow(2).mean().sqrt().item())
    return (num / den.clamp_min(1e-30)).max().item()


#: (B, S, T, H, Hkv, D, causal, window, q_offset): square MHA, GQA, ragged
#: MQA at D 128 with a query offset, non-causal short q against long k,
#: windows at both head dims
ARITH_SHAPES = [
    (1, 128, 128, 4, 4, 64, True, None, 0),
    (2, 256, 256, 8, 2, 64, True, None, 0),
    (1, 192, 320, 4, 1, 128, True, None, 128),
    (2, 64, 512, 4, 4, 64, False, None, 0),
    (1, 256, 256, 4, 4, 64, True, 32, 0),
    (1, 200, 200, 4, 2, 128, True, 100, 0),
]

#: per row (row_err). Against the reference kernel in bf16: one ulp of the
#: output (2^-7 of the row's largest) plus P's rounding, 1e-2 as the card
#: holds the kernel (chip_smoke.py's K2_TOL). P's rounding alone, in
#: float32 against the plain float32 version: 2^-9 per weight, summed with
#: random signs over the row's keys; 3.3e-3 in the worst row of these
#: shapes, held at 5e-3. lse: the plain logsumexp in another order, 1e-5.
ARITH_TOL = {"out_vs_reference_kernel": 1e-2, "p_rounding": 5e-3,
             "lse": 1e-5}


@pytest.mark.parametrize("shape", ARITH_SHAPES)
def test_kernel_arithmetic_matches_reference_kernel(shape):
    b, s, t, h, hkv, d, causal, window, q_offset = shape
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(dims).astype(np.float32) for dims in
               ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d)))
    want = jax_ops.flash_mha(*(jnp.asarray(x).astype(jnp.bfloat16)
                               for x in (q, k, v)), interpret=True, **mask)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)
                  for x in (q, k, v))
    out, lse = tiled_forward(qt, kt, vt, **mask)
    got = out.to(torch.bfloat16).transpose(1, 2)
    assert row_err(got, want) <= ARITH_TOL["out_vs_reference_kernel"]
    plain = ref.mha_reference(qt.float(), kt.float(), vt.float(), **mask)
    assert row_err(out, plain) <= ARITH_TOL["p_rounding"]
    lse_plain = ref.mha_lse_reference(qt, kt, **mask)
    assert (lse - lse_plain).abs().max().item() <= ARITH_TOL["lse"]
