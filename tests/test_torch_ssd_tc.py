"""K3 on the tensor cores, on the CPU: what of it runs without a card.

The kernel itself (``ssd_chunk_tc_kernel`` in ``csrc/ssd_scan_sm90.cu``)
runs only on the card, where tests/test_torch_cuda.py and chip_smoke.py
hold it against the plain version. Here: the TF32 rounding and the 3xTF32
split it uses, the cumsum in its warp-scan order, its slabs of heads, the
rule that sends an input to its synchronous route, its wiring (built from
its own source, counted, never launched on the CPU), and its arithmetic —
scores C·Bᵀ once per slab of one group's heads and 64-row query tile,
every product split into TF32 hi + lo and summed as lo·hi + hi·lo + hi·hi
in float32 — emulated in plain PyTorch (``ref.ssd_chunk_tc_emulation``)
against the reference's ``ssd_chunk_pallas`` in interpret mode and
against the plain version.

Tolerances, and why: against the reference kernel those of
tests/test_torch_ssd.py (float32 5e-5 absolute and relative, cs 1e-4
absolute; bf16 y_intra one bf16 ulp, 1e-2), since 3xTF32 keeps about
2^-21 of each product, below float32's own reordering; against the plain
version per row the card's ``K3_TOL`` (tests/test_torch_cuda.py). One TF32
pass instead (the plain version with every product's operands rounded to
TF32 once) strays from the plain version by up to 5.4e-3 of a row in y
and 9.3e-4 in the states over these shapes (float32), against 2.5e-5 and
1.3e-5 for the 3xTF32 emulation, most of which is the cumsum's order: one
pass lands above the float32 tolerance of 5e-4, which is why the kernel
splits; the test records it and asserts only that the split is the closer.
"""
import functools
import os

import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro_torch.kernels import build, ops, ref, ssd_scan
from test_torch_cuda import K3_TOL, row_err
from test_torch_ssd import CS_TOL, F32_TOL, _both, _f32, _np

#: (B, S, H, P, G, N, chunk): tests/test_torch_ssd.py's shapes and chunks,
#: and two with three heads a group (H 6, G 2), one of them with a ragged
#: 64-row tile (Q 100)
SHAPES = [sh + (c,) for sh in [(1, 256, 2, 32, 1, 32), (2, 512, 4, 64, 1, 64),
                               (1, 384, 4, 64, 2, 32)] for c in (64, 128)] + [
    (1, 300, 6, 32, 2, 32, 100), (1, 256, 6, 64, 2, 64, 128)]
DTYPES = ("float32", "bfloat16")
OUTS = ("y", "states", "cs", "decay")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ TF32


def test_round_tf32_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10
    cases = {1.0 + 2.0 ** -11: 1.0 + one_ulp,              # a tie: away
             -(1.0 + 2.0 ** -11): -(1.0 + one_ulp),
             1.0 + 2.0 ** -11 - 2.0 ** -20: 1.0,           # below the tie
             1.0 + 3 * 2.0 ** -11: 1.0 + 2 * one_ulp,      # a tie, odd
             2.0 - 2.0 ** -12: 2.0,                        # carries over
             3.0: 3.0, 0.0: 0.0}
    got = ref.round_tf32(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())
    assert not (got.view(torch.int32) & 0x1FFF).any()


def test_round_tf32_leaves_bf16_values_unchanged():
    rng = np.random.default_rng(0)
    v = rng.standard_normal(4096) * 2.0 ** rng.integers(-100, 100, 4096)
    bf = torch.from_numpy(v.astype(np.float32)).bfloat16().float()
    assert torch.equal(ref.round_tf32(bf).view(torch.int32),
                       bf.view(torch.int32))


def test_split_recovers_float32_to_2_pow_minus_21():
    rng = np.random.default_rng(1)
    v = (rng.standard_normal(1 << 16)
         * 2.0 ** rng.integers(-60, 60, 1 << 16)).astype(np.float32)
    x = torch.from_numpy(v)
    hi, lo = ref.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21


def test_mm_3xtf32_is_float32_accurate_where_one_pass_is_not():
    """Over 256-term dot products: 3xTF32 within a few float32 roundings
    of the float64 product, one TF32 pass about 2^-11 off."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    err3 = (ref.mm_3xtf32(a, b).double() - exact).abs().max().item() / scale
    err1 = (ref.round_tf32(a) @ ref.round_tf32(b)
            - exact).abs().max().item() / scale
    assert err3 < 1e-6 < 1e-4 < err1


def test_warp_cumsum_is_the_kernels_order():
    """`warp_cumsum` against the kernel's loop written out lane by lane in
    float32 scalars, bit for bit, and against a float64 cumsum."""
    rng = np.random.default_rng(3)
    for q in (1, 16, 48, 100, 256):
        v = rng.standard_normal(q).astype(np.float32)
        per = -(-q // 32)
        spans = [(min(ln * per, q), min(ln * per + per, q))
                 for ln in range(32)]
        runs = []
        for lo, hi in spans:
            run = np.float32(0)
            for i in range(lo, hi):
                run = np.float32(run + v[i])
            runs.append(run)
        incl = list(runs)
        for off in (1, 2, 4, 8, 16):
            incl = [np.float32(incl[ln] + incl[ln - off]) if ln >= off
                    else incl[ln] for ln in range(32)]
        want = np.empty(q, np.float32)
        for ln, (lo, hi) in enumerate(spans):
            acc = np.float32(incl[ln] - runs[ln])
            for i in range(lo, hi):
                acc = np.float32(acc + v[i])
                want[i] = acc
        got = ref.warp_cumsum(torch.from_numpy(v)[None])[0].numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, np.cumsum(v.astype(np.float64)),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ route


@pytest.mark.parametrize("h,g,slab", [(64, 1, 16), (6, 2, 16), (6, 2, 2),
                                      (4, 4, 16), (8, 2, 16), (12, 3, 3),
                                      (40, 1, 16)])
def test_head_slabs_cover_each_group_without_straddling(h, g, slab):
    slabs = ssd_scan.head_slabs(h, g, slab)
    rep = h // g
    assert [k for lo, hi in slabs for k in range(lo, hi)] == list(range(h))
    assert all(lo // rep == (hi - 1) // rep and hi - lo <= slab
               for lo, hi in slabs)
    assert len(slabs) == g * -(-rep // min(slab, rep))


@pytest.mark.parametrize("shape,strides,address,itemsize,why", [
    ((8, 2048, 64, 64), (8388608, 4096, 64, 1), 0, 4, None),
    ((2, 128, 4, 64), (65536, 512, 64, 1), 256, 4, None),     # heads sliced
    ((1, 128, 1, 128), (16384, 128, 128, 1), 0, 2, None),
    ((1, 48, 1, 7), (999, 7, 5, 1), 0, 4, "row"),    # length-1 strides skip
    ((2, 128, 4, 64), (65536, 512, 64, 1), 4, 4, "address"),
    ((2, 128, 4, 60), (30720, 240, 60, 1), 0, 4, None),
    ((2, 128, 4, 60), (30720, 240, 60, 1), 0, 2, "row"),
    ((2, 128, 4, 64), (65536, 513, 64, 1), 0, 4, "stride 513"),
    ((1, 128, 1, 64), (8193, 64, 7, 1), 0, 4, None),
])
def test_async_refusal(shape, strides, address, itemsize, why):
    got = ssd_scan.async_refusal(shape, strides, address, itemsize)
    if why is None:
        assert got is None
    else:
        assert got is not None and why in got


def test_tc_kernel_is_built_and_counted():
    """The tensor-core kernel has its own source, which includes no
    PyTorch header and uses TF32 mma.sync, cp.async and the TF32 rounding
    `ref.round_tf32` emulates (half the dropped ulp added to the bits, the
    low 13 cleared); ops counts it as the path's K3."""
    assert build.SOURCES["ssd_scan_sm90"] == "ssd_scan_sm90.cu"
    with open(os.path.join(build.CSRC_DIR, "ssd_scan_sm90.cu")) as f:
        text = f.read()
    for needle in ('extern "C" int ssd_chunk_tc_fwd',
                   "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                   "(__float_as_uint(v) + 0x1000u) & 0xffffe000u",
                   "cp.async.cg.shared.global"):
        assert needle in text, needle
    assert "torch/" not in text and "atomicAdd" not in text
    assert ops.WRAPPERS["ssd_chunk"] is ops.ssd_chunked


def test_cpu_path_launches_neither_kernel():
    _, targs = _both(SHAPES[0][:6], "float32")
    ops.reset_launch_counts()
    ops.ssd_chunked(*targs, chunk=64)
    assert set(ops.launch_counts().values()) == {0}


# ------------------------------------------------------------------ arithmetic


@functools.lru_cache(maxsize=None)
def _pallas(shape, dtype):
    jargs, _ = _both(shape[:6], dtype)
    return tuple(_f32(w) for w in ssd_chunk_pallas(*jargs, chunk=shape[6],
                                                   interpret=True))


@functools.lru_cache(maxsize=None)
def _emulated(shape, dtype):
    _, targs = _both(shape[:6], dtype)
    return ref.ssd_chunk_tc_emulation(*targs, chunk=shape[6])


def _one_pass_tf32(xh, dt, a_h, bm, cm, *, chunk):
    """`ref.ssd_chunk_reference` with each product's operands rounded to
    TF32 once: what a single-pass TF32 kernel would compute."""
    b, s, h, p = xh.shape
    g, q = bm.shape[2], min(chunk, s)
    nc, rep, t = s // q, h // g, ref.round_tf32

    def heads_first(x, k):
        return x.float().reshape(b, nc, q, k, -1).permute(0, 1, 3, 2, 4)

    x = heads_first(xh, h)
    bc = heads_first(bm, g).repeat_interleave(rep, dim=2)
    cc = heads_first(cm, g).repeat_interleave(rep, dim=2)
    dtc = dt.reshape(b, nc, q, h).permute(0, 1, 3, 2)
    cs = torch.cumsum(dtc * a_h[:, None], dim=-1)
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    seg = cs[..., :, None] - cs[..., None, :]
    w = (t(cc) @ t(bc).transpose(-1, -2)) * torch.where(
        tri, torch.exp(torch.where(tri, seg, 0.0)), 0.0) * dtc[..., None, :]
    y = t(w) @ t(x)
    wstate = torch.exp(cs[..., -1:] - cs) * dtc
    states = t(bc * wstate[..., None]).transpose(-1, -2) @ t(x)
    return y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p).to(xh.dtype), states


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_reference_kernel(shape, dtype):
    for name, w, got in zip(OUTS, _pallas(shape, dtype),
                            _emulated(shape, dtype)):
        assert tuple(got.shape) == w.shape, name
        if name == "y" and dtype == "bfloat16":
            tol = dict(rtol=1e-2, atol=1e-2)
        else:
            tol = CS_TOL if name == "cs" else F32_TOL
        np.testing.assert_allclose(_np(got), w, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_plain_version(shape, dtype):
    _, targs = _both(shape[:6], dtype)
    want = ref.ssd_chunk_reference(*targs, chunk=shape[6])
    tol = K3_TOL[getattr(torch, dtype)]
    for name, got, w in zip(OUTS, _emulated(shape, dtype), want):
        assert got.shape == w.shape and got.dtype == w.dtype, name
        assert row_err(got, w) <= tol[name], name


@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_pass_strays_further_than_the_split(shape):
    """How far one TF32 pass strays from the plain version, float32 (the
    module docstring records the worst over these shapes), beside the
    split's: the split is the closer in y and in the states."""
    _, targs = _both(shape[:6], "float32")
    want = ref.ssd_chunk_reference(*targs, chunk=shape[6])
    one = _one_pass_tf32(*targs, chunk=shape[6])
    three = _emulated(shape, "float32")
    for k in range(2):
        assert row_err(three[k], want[k]) < row_err(one[k], want[k])


def test_slab_width_changes_no_bit():
    """The scores are formed once per slab and shared by its heads: any
    slab width, one head each included, gives the same bits."""
    shape = SHAPES[-2]
    _, targs = _both(shape[:6], "float32")
    one = ref.ssd_chunk_tc_emulation(*targs, chunk=shape[6], slab=1)
    for a, b in zip(one, _emulated(shape, "float32")):
        assert torch.equal(a, b)
