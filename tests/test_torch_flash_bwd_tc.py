"""K2's tensor-core dK/dV backward and the head_dim repair, on the CPU:
what of them runs without a card.

The kernel itself (``flash_bwd_dkdv_tc_kernel`` in
``csrc/flash_attention_sm90.cu``) runs only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version. Here: the dtype route of the dK/dV half (bf16 to the tensor
cores, float32 to the CUDA cores), the kernel's query-tile range against
a brute-force mask, and the kernel's arithmetic — 64-key × 64-query
tiles with the keys as wgmma's M dimension, the loop over the GQA group,
float32 accumulators, Pᵀ and dSᵀ rounded to bf16 before their products,
D_i from the bf16 O and dO — emulated in plain PyTorch against
``jax.grad`` of the reference's jnp oracle. Then `pad_head_dim`, which
lets `flash_attention` take any head_dim up to 128 as the reference's
kernel does: the plain version on the padded tensors with the unpadded
scale, sliced back, against the plain version at the unpadded width and
the reference's Pallas kernel in interpret mode."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as flash


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed=0):
    """q (B, S, H, D), k/v (B, T, Hkv, D) and an output gradient as
    float32 numpy from a seed, in the model layout."""
    b, s, t, h, hkv, d = shape[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(dims).astype(np.float32) for dims in
            ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, s, h, d))]


def _bf16_heads_first(x):
    """A float32 (B, S, H, D) numpy array rounded to bf16, as a (B, H, S,
    D) float32 tensor."""
    return torch.from_numpy(x).to(torch.bfloat16).float().transpose(1, 2)


def row_err(a, b):
    """The worst row's max |a - b| over the larger of that row's max |b|
    and b's RMS (rows along the last axis), as chip_smoke.py measures."""
    a, b = a.float(), b.float()
    num = (a - b).abs().amax(-1)
    den = b.abs().amax(-1).clamp_min(b.pow(2).mean().sqrt().item())
    return (num / den.clamp_min(1e-30)).max().item()


# ------------------------------------------------------------------ route


@pytest.mark.parametrize("dtype,launch", [
    (torch.bfloat16, flash.flash_bwd_dkdv_tc),
    (torch.float32, flash.flash_bwd_dkdv)])
def test_dkdv_route_by_dtype(dtype, launch):
    assert flash.dkdv_for(dtype) is launch


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_dkdv_route_refuses_other_dtypes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash.dkdv_for(dtype)


def test_tc_backward_is_counted_and_built():
    """Both launch functions are in the launch counts, and their source
    is the tensor-core forward's, which defines the C entry points and
    includes no PyTorch header."""
    assert ops.WRAPPERS["flash_attention_bwd_dkdv_tc"] \
        is flash.flash_bwd_dkdv_tc
    assert ops.WRAPPERS["flash_attention_bwd_delta"] is flash.flash_bwd_delta
    src = os.path.join(build.CSRC_DIR, build.SOURCES["flash_attention_sm90"])
    with open(src) as f:
        text = f.read()
    assert 'extern "C" int flash_attention_bwd_dkdv_tc(' in text
    assert 'extern "C" int flash_attention_bwd_delta(' in text
    assert "torch/" not in text


def test_tc_backward_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 4, 64)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_bwd_dkdv_tc(q, k, k, q, lse, q, causal=True, window=None,
                                q_offset=0)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_bwd_delta(q, q)
    assert set(ops.launch_counts().values()) == {0}


# -------------------------------------------------- the query-tile range


def query_tiles(s, t, k0, *, causal, window, q_offset, tile=64):
    """A line-by-line transcription of ``query_tiles`` in
    csrc/flash_attention_sm90.cu: the query tiles [begin, end) the dK/dV
    kernel visits for the key tile at k0."""
    nq = (s + tile - 1) // tile
    k_hi = min(k0 + tile, t) - 1
    b, e = 0, nq
    if causal:
        lo = k0 - q_offset
        b = min(lo // tile, nq) if lo > 0 else 0
    if window is not None:
        hi = k_hi + window - 1 - q_offset
        e = 0 if hi < 0 else min(nq, hi // tile + 1)
    return b, max(b, e)


def _valid(s, t, *, causal, window, q_offset):
    qpos = np.arange(s)[:, None] + q_offset
    kpos = np.arange(t)[None, :]
    valid = np.ones((s, t), bool)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= qpos - kpos < window
    return valid


@pytest.mark.parametrize("s,t,causal,window,q_offset", [
    (100, 100, True, None, 0),
    (77, 200, True, None, 123),
    (130, 130, True, 32, 0),
    (70, 199, True, 48, 129),      # keys below 82 meet no query row
    (64, 190, False, None, 0),
    (150, 150, False, 50, 0),
    (100, 300, True, 16, 200),     # keys before the window meet no row
    (1023, 1023, True, None, 0),
])
def test_query_tiles_hold_every_valid_pair(s, t, causal, window, q_offset):
    """Every query tile that holds a valid (row, key) pair for some key of
    a key tile lies in that key tile's range; under a causal mask alone
    the range holds no other tile."""
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    valid = _valid(s, t, **mask)
    for k0 in range(0, t, 64):
        block = valid[:, k0:k0 + 64]
        meets = [block[q0:q0 + 64].any() for q0 in range(0, s, 64)]
        b, e = query_tiles(s, t, k0, **mask)
        assert all(b <= i < e for i, m in enumerate(meets) if m)
        if causal and window is None:
            assert all(meets[b:e])


# --------------------------------------------------- the kernel's arithmetic


def tiled_dkdv(q, k, v, o, lse, do, *, causal, window, q_offset, tile=64,
               round_operands=True):
    """The tensor-core dK/dV kernel's arithmetic in plain PyTorch. Per
    64-key tile (wgmma's M dimension), over the query tiles that
    `query_tiles` gives and every query head of the kv head's group:
    Sᵀ = K Qᵀ and dPᵀ = V dOᵀ in float32 of the bf16 inputs (the tensor
    cores' products of bf16 operands are exact in float32), Pᵀ =
    exp(Sᵀ·scale − lse) where valid else 0, dSᵀ = Pᵀ∘(dPᵀ − D_i), then
    dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q into float32 accumulators; dK
    scaled at the end. D_i = rowsum(dO∘O) in float32. ``round_operands``
    False keeps Pᵀ and dSᵀ float32 (the CUDA-core kernel's arithmetic).
    q, o, do (B, H, S, D) and k, v (B, Hkv, T, D), any float dtype; lse
    (B, H, S). Returns float32 (dk, dv)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d ** -0.5
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    valid = torch.from_numpy(_valid(s, t, **mask))

    def rnd(x):
        return x.to(torch.bfloat16).float() if round_operands else x

    def by_group(x):                                  # (B, Hkv, G, ...)
        return x.float().reshape(b, hkv, g, *x.shape[2:])

    qg, dog, lseg = by_group(q), by_group(do), by_group(lse)
    deltag = by_group((o.float() * do.float()).sum(-1))
    kf, vf = k.float(), v.float()
    dk, dv = torch.zeros(b, hkv, t, d), torch.zeros(b, hkv, t, d)
    for k0 in range(0, t, tile):
        kk, vv = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        acc_k, acc_v = torch.zeros_like(kk), torch.zeros_like(vv)
        qt0, qt1 = query_tiles(s, t, k0, **mask)
        for q0 in range(qt0 * tile, qt1 * tile, tile):
            rows = slice(q0, q0 + tile)
            qq, dd = qg[..., rows, :], dog[..., rows, :]
            ok = valid[rows, k0:k0 + tile].T            # (keys, q rows)
            st = torch.einsum("bnkd,bngqd->bngkq", kk, qq)
            dpt = torch.einsum("bnkd,bngqd->bngkq", vv, dd)
            pt = torch.where(ok, torch.exp(st * scale
                                           - lseg[..., None, rows]), 0.0)
            dst = pt * (dpt - deltag[..., None, rows])
            acc_v += torch.einsum("bngkq,bngqd->bnkd", rnd(pt), dd)
            acc_k += torch.einsum("bngkq,bngqd->bnkd", rnd(dst), qq)
        dk[:, :, k0:k0 + tile] = acc_k * scale
        dv[:, :, k0:k0 + tile] = acc_v
    return dk, dv


#: (B, S, T, H, Hkv, D, causal, window, q_offset): square MHA, GQA, ragged
#: MQA at D 128 with a query offset, non-causal short q against long k,
#: causal windows at both head dims, keys no query row sees (a window with
#: an offset), a non-causal window
BWD_SHAPES = [
    (1, 128, 128, 4, 4, 64, True, None, 0),
    (2, 256, 256, 8, 2, 64, True, None, 0),
    (1, 192, 320, 4, 1, 128, True, None, 128),
    (2, 64, 512, 4, 4, 64, False, None, 0),
    (1, 256, 256, 4, 4, 64, True, 32, 0),
    (1, 200, 200, 4, 2, 128, True, 100, 0),
    (1, 70, 199, 7, 1, 128, True, 48, 129),
    (1, 150, 150, 7, 1, 64, False, 50, 0),
]

#: per row (row_err), the worst row counting. Against jax.grad of the
#: reference's oracle: dk and dv rounded to bf16 as the kernel writes them
#: plus the rounding of Pᵀ and dSᵀ, within chip_smoke.py's K2_TOL of 1e-2
#: (worst row of these shapes 8.2e-3, dk). The rounding alone, against the
#: plain float32 gradient from a float32 O: each term of a row's sums
#: moves by at most the bf16 unit roundoff 2^-8; averaged over the
#: queries a key meets it stays under one bf16 ulp of the row's largest
#: entry (2^-7), which is the bound held. Worst row of these shapes 4.9e-3
#: (dv, the causal window of 32 at D 64, where a key meets at most 32
#: queries); 2.7e-3 to 4.5e-3 elsewhere. Without that rounding the
#: emulation is the plain gradient summed in another order: 1.5e-6, held
#: at 1e-5.
BWD_TOL = {"vs_reference": 1e-2, "rounding": 2.0 ** -7, "unrounded": 1e-5}


def _oracle_dkdv(q, k, v, do, mask):
    """dk, dv of sum(out * do) by jax.grad of the reference's jnp oracle,
    in float32, as (B, Hkv, T, D) tensors; inputs (B, H, S, D) tensors."""
    qj, kj, vj, doj = (jnp.asarray(x.numpy()) for x in (q, k, v, do))

    def loss(k_, v_):
        return (jax_ref.mha_reference(qj, k_, v_, **mask) * doj).sum()

    gk, gv = jax.grad(loss, argnums=(0, 1))(kj, vj)
    return torch.from_numpy(np.array(gk)), torch.from_numpy(np.array(gv))


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_dkdv_arithmetic_matches_jax_grad_of_reference(shape):
    """The emulation from bf16 inputs, the forward's bf16 output and its
    float32 lse, rounded to bf16 as the kernel writes dk and dv, against
    jax.grad of the reference's oracle at the same bf16 values."""
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = (_bf16_heads_first(x) for x in _inputs(shape))
    o = ref.mha_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), **mask)
    lse = ref.mha_lse_reference(q, k, **mask)
    dk, dv = tiled_dkdv(q, k, v, o, lse, do, **mask)
    want_k, want_v = _oracle_dkdv(q, k, v, do, mask)
    assert row_err(dk.bfloat16(), want_k) <= BWD_TOL["vs_reference"]
    assert row_err(dv.bfloat16(), want_v) <= BWD_TOL["vs_reference"]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_dkdv_rounding_alone(shape):
    """From a float32 O, the emulation with Pᵀ and dSᵀ rounded to bf16
    differs from autograd through the plain float32 version by that
    rounding alone; without it, by the order of float32 sums."""
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = (_bf16_heads_first(x) for x in _inputs(shape, seed=1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ref.mha_reference(*leaves, **mask)
    _, want_k, want_v = torch.autograd.grad(o, leaves, do)
    lse = ref.mha_lse_reference(q, k, **mask)
    for rounded, tol in ((True, BWD_TOL["rounding"]),
                         (False, BWD_TOL["unrounded"])):
        dk, dv = tiled_dkdv(q, k, v, o.detach(), lse, do, **mask,
                            round_operands=rounded)
        assert row_err(dk, want_k) <= tol, rounded
        assert row_err(dv, want_v) <= tol, rounded


# ------------------------------------------------------ the head_dim repair


@pytest.mark.parametrize("d", [16, 80, 112])
def test_padded_head_dim_computes_the_reference_function(d):
    """The plain version on `pad_head_dim`'s tensors with the unpadded
    scale, sliced back to d: forward and gradients against the plain
    version at width d (float32; zero columns add exact zeros, so only the
    order of sums differs), and the forward against the reference's
    Pallas kernel in interpret mode at width d (its own tolerance)."""
    shape = (1, 96, 130, 4, 2, d, True, 40, 20)
    mask = dict(causal=True, window=40, q_offset=20)
    qn, kn, vn, don = _inputs(shape, seed=2)
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2)
                   for x in (qn, kn, vn, don))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    qp, kp, vp, d_out = flash.pad_head_dim(*leaves)
    assert d_out == d and qp.shape[-1] == (64 if d <= 64 else 128)
    assert kp.shape[-1] == vp.shape[-1] == qp.shape[-1]
    out = ref.mha_reference(qp, kp, vp, scale=d ** -0.5, **mask)[..., :d]
    got = torch.autograd.grad(out, leaves, do)
    plain_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.mha_reference(*plain_leaves, **mask)
    want_g = torch.autograd.grad(want, plain_leaves, do)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    for name, a, b in zip("qkv", got, want_g):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    pallas = jax_ops.flash_mha(*(jnp.asarray(x) for x in (qn, kn, vn)),
                               interpret=True, **mask)
    np.testing.assert_allclose(out.detach().transpose(1, 2).numpy(),
                               np.asarray(pallas), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_head_dims_the_kernels_take_are_not_padded(d):
    q = torch.zeros(1, 4, 8, d)
    k = torch.zeros(1, 2, 8, d)
    qp, kp, vp, d_out = flash.pad_head_dim(q, k, k)
    assert qp is q and kp is k and vp is k and d_out == d


def test_head_dim_above_128_raises():
    q = torch.zeros(1, 4, 8, 160)
    k = torch.zeros(1, 2, 8, 160)
    with pytest.raises(ValueError, match="reference"):
        flash.pad_head_dim(q, k, k)
    with pytest.raises(ValueError, match="reference"):
        flash.flash_attention(q, k, k)


def test_pad_head_dim_refuses_other_widths_of_k_and_v():
    q, k = torch.zeros(1, 4, 8, 80), torch.zeros(1, 2, 8, 96)
    with pytest.raises(ValueError, match="head_dim"):
        flash.pad_head_dim(q, k, k)
    with pytest.raises(ValueError, match="head_dim"):
        flash.pad_head_dim(q, q[:, :2], k)


def test_problem_takes_its_scale_from_the_caller():
    q, k = torch.zeros(2, 4, 10, 128), torch.zeros(2, 2, 12, 128)
    assert flash._problem(q, k, True, 5, 3, 112 ** -0.5) == [
        2, 4, 2, 10, 12, 1, 1, 5, 3, 112 ** -0.5]
    assert flash._scale(q, None) == 128 ** -0.5
    assert flash._scale(q, 0.25) == 0.25


def test_plain_version_scale_defaults_to_head_dim():
    """``scale=None`` is D^-1/2 bit for bit, so every caller that passes
    none computes what it computed before the argument existed."""
    q, k, v, _ = (torch.from_numpy(x).transpose(1, 2)
                  for x in _inputs((1, 40, 40, 4, 2, 80)))
    a = ref.mha_reference(q, k, v, causal=True)
    b = ref.mha_reference(q, k, v, causal=True, scale=80 ** -0.5)
    assert torch.equal(a, b)
    assert torch.equal(ref.mha_lse_reference(q, k),
                       ref.mha_lse_reference(q, k, scale=80 ** -0.5))
