"""The port on the card: the CUDA kernels against their plain versions
(K1 bit for bit; K2 forward and backward and K3 within stated
tolerances; K2's tensor-core forward, dK/dV and dQ kernels for bf16
beside their CUDA-core counterparts; K2 at head_dims other than 64 and 128
through its zero-padding entry point), the engine's random bits and RNG-free market on CUDA against
the CPU, the quadratic oracle on the card against the CPU and its snapshot
resume, a small megabatched run through K1, small zoo runs through K2
(float32 and bf16), the zoo's mixed-precision update bit for bit against
its plain version (at the zoo cell's leaf shapes; ragged, unaligned and
idle leaves) and a small bf16 zoo run through it bit for bit the
functional update's, a small Mamba2 served through K3, the reduced dense,
MLA and MoE transformers served on the card against the CPU (no kernel:
the cached path is the plain attention core) and the MoE block's
deterministic combine, and durable
training: a megabatch snapshot/save/restore/resume and a bf16 durable
``train_zoo`` resume through K2, bit for bit, and checkpoint round trips
of tensors on the card; then the rest of the zoo: K3 at the hybrid's
serving shape, K2 non-causal at Whisper's encoder shape, the SSD's
training route against the CPU, and remat's gradients bit for bit with
the kernels on the path; and expert parallelism: the MoE block's psum and
all-to-all routes with their ranks on one card against the same routes on
the CPU, and their bits from run to run; and dense tensor parallelism: the
ranks' slices on their devices and K2 launched once a rank; and the last
model-axis layouts: K3 on a rank's heads bit for bit the whole launch's,
K2 on a rank's query rows at its offset bit for bit the whole forward's,
the split SSM block and the vocab-parallel loss on the card against the
CPU, and the MoE routing exact under the sequence split; and
DeepSeek-V2-Lite's published block, one bf16 step at its widths and depth
1 + 1, against the benchmark's plain float32 reference.

Every test here needs an NVIDIA GPU and skips itself elsewhere. The file
imports neither ``jax`` nor the reference, so it runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core import bidding, strategies as strat
from repro_torch.core.cost_model import RuntimeModel
from repro_torch.kernels import mixed_sgd, ops, ref, ssd_scan
from repro_torch.kernels.elastic_update import elastic_sgd_update
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.sim import engine
from repro_torch.train import megabatch as mb
from repro_torch.train.trainer import train_batched

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def edge_inputs(r, p, device, seed=0):
    """(R ≥ 6, P) inputs covering Σw = 0, 0 < Σw < 1e-6, fractional Σw, a
    replica that is not running and a learning rate per replica; P
    ragged."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    params = torch.randn(r, p, generator=g)
    mom = torch.randn(r, p, generator=g)
    grads = torch.randn(r, p, generator=g) * 3
    w = torch.rand(r, generator=g) * 40 + 0.5
    w[:4] = torch.tensor([0.0, 1e-8, 0.375, 2.5e-7])
    running = torch.ones(r, dtype=torch.bool)
    running[4] = False
    lr = torch.rand(r, generator=g) * 0.2 + 0.01
    return [x.to(device) for x in (params, mom, grads, w, running, lr)]


@pytest.mark.parametrize("momentum", [0.9, 0.0])
@pytest.mark.parametrize("r,p", [(8, 1037), (6, 3 * 256 * 1024 + 5),
                                 (7, 1)])
def test_kernel_bit_equal_to_plain_version(cuda_device, r, p, momentum):
    args = edge_inputs(r, p, cuda_device)
    want = ref.elastic_update_reference(*args, momentum=momentum)
    ops.reset_launch_counts()
    ops.fused_elastic_update(*args, momentum=momentum)
    torch.cuda.synchronize()
    assert ops.launch_counts()["elastic_sgd_update"] == 1
    assert torch.equal(args[0], want[0]) and torch.equal(args[1], want[1])


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    params, mom, grads, w, running, lr = edge_inputs(6, 64, cuda_device)
    bad = [
        (params.double(), mom, grads, w, running, lr),
        (params, mom, grads[:, :32], w, running, lr),
        (params, mom, grads, w, running.float(), lr),
        (params, mom.t().contiguous().t(), grads, w, running, lr),
        (params, mom, grads.cpu(), w, running, lr),
        (params, mom, grads, w[:3], running, lr),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            elastic_sgd_update(*args, momentum=0.9)


def test_hash_bits_identical_on_cpu_and_cuda(cuda_device):
    seeds = torch.arange(1000, dtype=torch.int64)
    lane = torch.arange(8)
    for k in (0, 17, 123456):
        a = engine._hash(seeds[:, None], k, engine.STREAM_DUR, lane)
        b = engine._hash(seeds.to(cuda_device)[:, None], k,
                         engine.STREAM_DUR, lane.to(cuda_device))
        assert torch.equal(a, b.cpu())


def _job():
    cfg = ARCHS["qwen2-7b"].reduced().with_(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16)
    return JobConfig(model=cfg, shape=InputShape("t", 16, 8, "train"),
                     n_workers=4, learning_rate=0.1)


def _scenarios():
    trace = np.random.default_rng(7).uniform(0.2, 1.0, 50).astype(np.float32)
    plan = strat.FixedBids(bidding.BidPlan(
        n=4, n1=2, b1=0.9, b2=0.5, J=6, expected_cost=0, expected_time=0,
        expected_error=0), name="two-bids")
    return [engine.scenario_from_strategy(
        plan, alpha=0.1, rt=RuntimeModel(kind="det", r_const=1.0), n_max=4,
        idle_step=0.5, price_spec=engine.PriceSpec.from_trace_ticks(trace),
        name="two-bids")]


def test_megabatch_run_on_cuda_goes_through_kernel(cuda_device):
    """A small megabatched run on the card: K1 launched once per tick, the
    RNG-free market bit-equal to the CPU run's, losses and weights within
    float32 reduction-order tolerance of it."""
    job = _job()
    model0 = mb.init_megabatch_state(job.model, job, 0, device="cpu")
    n_ticks = 20
    cpu = train_batched(job, _scenarios(), [0, 3], n_ticks=n_ticks,
                        megabatch=True, use_fused_update=True,
                        model0=model0, device="cpu")
    ops.reset_launch_counts()
    gpu = train_batched(job, _scenarios(), [0, 3], n_ticks=n_ticks,
                        megabatch=True, use_fused_update=True,
                        model0=model0, device=cuda_device)
    assert ops.launch_counts()["elastic_sgd_update"] == n_ticks
    for field in ("iterations", "ys", "total_time", "total_cost"):
        np.testing.assert_array_equal(getattr(gpu, field),
                                      getattr(cpu, field))
    np.testing.assert_allclose(np.nan_to_num(gpu.errors),
                               np.nan_to_num(cpu.errors), rtol=5e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gpu.final_model["p"].cpu().numpy(),
                               cpu.final_model["p"].numpy(), rtol=5e-4,
                               atol=1e-5)


# ------------------------------------------------------------------ K2

#: (B, S, T, H, Hkv, D, causal, window, q_offset): GQA with g = 7, both
#: head dims, ragged S and T (no multiple of the 64-row tiles), a query
#: offset, sliding windows, non-causal
K2_SHAPES = [
    (2, 100, 100, 14, 2, 128, True, None, 0),
    (1, 77, 200, 7, 1, 64, True, None, 123),
    (2, 130, 130, 4, 4, 64, True, 32, 0),
    (1, 70, 199, 7, 1, 128, True, 48, 129),
    (1, 64, 190, 4, 2, 128, False, None, 0),
    (1, 150, 150, 7, 1, 64, False, 50, 0),
    # Qwen2-7B's heads padded for tp 8: 32 query heads over 4 KV heads
    (1, 96, 96, 32, 4, 128, True, None, 0),
]

#: max |kernel - plain| / max |plain|. float32: both sum in float32 in
#: different orders (fused multiply-adds in the kernel). bfloat16: inputs
#: and outputs round to 8 bits of mantissa (0.4 % of the largest value per
#: ulp), the arithmetic stays float32 on both sides.
K2_TOL = {torch.float32: {"fwd": 2e-5, "bwd": 1e-4},
          torch.bfloat16: {"fwd": 1e-2, "bwd": 2e-2}}

#: per row (row_err), chip_smoke.py's K2_TOL, whose comment gives the
#: reasons: float32 sums in other orders; bf16 one ulp of each output, and
#: for dq the cancellation of dS = P (dP - D) where D comes from the bf16
#: output
K2_ROW_TOL = {torch.float32: {"out": 1e-5, "dq": 5e-5, "dk": 2e-5,
                              "dv": 2e-5},
              torch.bfloat16: {"out": 1e-2, "dq": 0.1, "dk": 1e-2,
                               "dv": 1e-2}}


def k2_inputs(shape, dtype, device, seed=0):
    b, s, t, h, hkv, d = shape[:6]
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, do = (torch.randn(*dims, generator=g) for dims in
                   ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, d),
                    (b, s, h, d)))
    return [x.to(device=device, dtype=dtype) for x in (q, k, v, do)]


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_forward_and_backward_match_plain(cuda_device, shape, dtype):
    """Through ``ops.flash_mha`` in the model layout (B, S, H, D), which
    hands the kernels strided views: output and dq/dk/dv against autograd
    through the plain version; the dtype's forward, dK/dV and dQ kernels
    (tensor cores for bf16, both backward halves after one D_i pre-pass;
    CUDA cores for float32) launched once each."""
    causal, window, q_offset = shape[6:]
    q, k, v, do = k2_inputs(shape, dtype, cuda_device)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.mha_reference(*(x.transpose(1, 2) for x in leaves),
                             **mask).transpose(1, 2)
    want_g = torch.autograd.grad(want, leaves, do)
    ops.reset_launch_counts()
    mine = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_mha(*mine, **mask)
    got_g = torch.autograd.grad(out, mine, do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    tc = dtype == torch.bfloat16
    assert counts["flash_attention_fwd_tc"] == int(tc)
    assert counts["flash_attention_fwd"] == int(not tc)
    assert counts["flash_attention_bwd_dkdv_tc"] == int(tc)
    assert counts["flash_attention_bwd_delta"] == int(tc)
    assert counts["flash_attention_bwd_dkdv"] == int(not tc)
    assert counts["flash_attention_bwd_dq_tc"] == int(tc)
    assert counts["flash_attention_bwd_dq"] == int(not tc)
    assert out.dtype == dtype and out.shape == q.shape
    assert out.is_contiguous()
    tol = K2_TOL[dtype]
    assert rel_err(out, want) <= tol["fwd"]
    for name, a, b in zip("qkv", got_g, want_g):
        assert a.dtype == dtype and a.shape == b.shape
        assert rel_err(a, b) <= tol["bwd"], name


def test_k2_reference_layout_and_contiguous_inputs(cuda_device):
    """The (B, H, S, D) entry point on contiguous tensors gives what the
    model-layout wrapper gives on strided views, bit for bit."""
    q, k, v, _ = k2_inputs((2, 90, 90, 14, 2, 128), torch.bfloat16,
                           cuda_device, seed=3)
    a = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=True)
    b = ops.flash_mha(q, k, v, causal=True)
    assert torch.equal(a.transpose(1, 2), b)


def test_k2_refuses_what_it_does_not_take(cuda_device):
    q, k, v, _ = k2_inputs((1, 64, 64, 4, 2, 64), torch.float32,
                           cuda_device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    wide = [torch.cat([x, x, x[..., :32]], dim=-1) for x in (qt, kt, vt)]
    bad = [
        (qt.double(), kt.double(), vt.double(), {}),
        (qt.half(), kt.half(), vt.half(), {}),
        (*wide, {}),                                 # head_dim 160 > 128
        (qt, kt.bfloat16(), vt, {}),
        (qt, kt.cpu(), vt, {}),
        (qt[:, :3], kt, vt, {}),
        (qt, kt, vt[:, :, :10], {}),
        (qt.transpose(2, 3), kt, vt, {}),
        (qt, kt, vt, {"window": 0}),
        # the last query row (position 63 + 64) sees no key of T = 64
        (qt, kt, vt, {"q_offset": 64, "window": 1}),
        (qt.cpu(), kt.cpu(), vt.cpu(), {}),
    ]
    for a, b, c, kw in bad:
        with pytest.raises(ValueError):
            flash_attention(a, b, c, **kw)


#: the tensor-core forward per row (row_err: the worst row's max |a - b|
#: over the larger of its max |b| and the tensor's RMS). Against the plain
#: version: one bf16 ulp of the output (2^-7 of the row's largest) plus P
#: rounded to bf16 before P·V (about 1e-3), under 1e-2 as chip_smoke.py's
#: K2_TOL. Against the CUDA-core forward: each rounds its float32 result to
#: bf16 once, so two ulps. lse: float32 sums of the same scores in other
#: orders, ten ulps of an lse near 8 (measured on an H100: 9.5e-7).
K2_TC_TOL = {"out": 1e-2, "out_vs_cuda_core": 2e-2, "lse": 1e-5}


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_tc_forward_matches_plain_out_and_lse(cuda_device, shape):
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, _ = k2_inputs(shape, torch.bfloat16, cuda_device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ops.reset_launch_counts()
    out, lse = flash.flash_fwd_tc(qt, kt, vt, **mask)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_fwd_tc"] == 1
    assert out.dtype == torch.bfloat16 and out.stride() == qt.stride()
    assert lse.dtype == torch.float32 and lse.shape == qt.shape[:3]
    assert row_err(out, ref.mha_reference(qt, kt, vt, **mask)) \
        <= K2_TC_TOL["out"]
    lse_plain = ref.mha_lse_reference(qt, kt, **mask)
    assert (lse - lse_plain).abs().max().item() <= K2_TC_TOL["lse"]


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_tc_forward_matches_cuda_core_forward(cuda_device, shape):
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, _ = k2_inputs(shape, torch.bfloat16, cuda_device, seed=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out, lse = flash.flash_fwd_tc(qt, kt, vt, **mask)
    old, old_lse = flash.flash_fwd(qt, kt, vt, **mask)
    torch.cuda.synchronize()
    assert row_err(out, old) <= K2_TC_TOL["out_vs_cuda_core"]
    assert (lse - old_lse).abs().max().item() <= K2_TC_TOL["lse"]


def test_k2_tc_forward_reads_model_layout_in_place(cuda_device):
    """The (B, S, H, D) tensors through transposed views give what
    contiguous (B, H, S, D) copies give, bit for bit, and the output keeps
    the model's layout."""
    q, k, v, _ = k2_inputs((2, 130, 130, 14, 2, 128), torch.bfloat16,
                           cuda_device, seed=4)
    views = [x.transpose(1, 2) for x in (q, k, v)]
    out_v, lse_v = flash.flash_fwd_tc(*views, causal=True, window=None,
                                      q_offset=0)
    out_c, lse_c = flash.flash_fwd_tc(*(x.contiguous() for x in views),
                                      causal=True, window=None, q_offset=0)
    assert out_v.stride() == views[0].stride()
    assert out_v.transpose(1, 2).is_contiguous()
    assert torch.equal(out_v, out_c) and torch.equal(lse_v, lse_c)


def test_k2_tc_forward_refuses_what_tma_cannot_take(cuda_device):
    """A base not on 16 bytes, a stride not a multiple of 16 bytes, another
    dtype or head_dim: raises, never falls back."""
    b, s, h, d = 1, 64, 4, 64
    q, k, v, _ = k2_inputs((b, s, s, h, 2, d), torch.bfloat16, cuda_device)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:1 + q.numel()].view(b, s, h, d).transpose(1, 2)
    wide = torch.zeros(b, s, h, d + 4, dtype=torch.bfloat16,
                       device=cuda_device)[..., :d].transpose(1, 2)
    ops.reset_launch_counts()
    for args, match in [((shifted, kt, vt), "16 bytes"),
                        ((wide, kt, vt), "multiple of 16 bytes"),
                        ((qt, kt[..., :32], vt), "k"),
                        ((qt.float(), kt.float(), vt.float()), "bfloat16"),
                        ((qt.cpu(), kt.cpu(), vt.cpu()), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            flash.flash_fwd_tc(*args, causal=True, window=None, q_offset=0)
    assert set(ops.launch_counts().values()) == {0}


#: the tensor-core dK/dV kernel per row (row_err). Against the plain
#: version: one bf16 ulp of dk and dv (2^-7 of the row's largest) plus Pᵀ
#: and dSᵀ rounded to bf16 before their products (up to 4.9e-3 on the CPU,
#: tests/test_torch_flash_bwd_tc.py), under 1e-2 as chip_smoke.py's
#: K2_TOL. Against the CUDA-core dK/dV kernel: each rounds its float32
#: result to bf16 once, so two ulps. D_i against its plain version: both
#: sum exact float32 products of bf16 values in other orders, each within
#: (D - 1) 2^-24 of the row's sum of |products|, so 2e-5 of that sum.
K2_DKDV_TC_TOL = {"dkdv": 1e-2, "dkdv_vs_cuda_core": 2e-2, "delta": 2e-5}


def k2_tc_backward_inputs(shape, device, seed=0):
    """(q, k, v, dout) as (B, H, S, D) views of the model layout, and the
    tensor-core forward's (out, lse) of them."""
    causal, window, q_offset = shape[6:]
    q, k, v, do = k2_inputs(shape, torch.bfloat16, device, seed=seed)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = flash.flash_fwd_tc(qt, kt, vt, causal=causal, window=window,
                                  q_offset=q_offset)
    return qt, kt, vt, dot, out, lse


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_tc_dkdv_matches_plain(cuda_device, shape):
    """dk and dv of the tensor-core kernel from the tensor-core forward's
    output and lse, against autograd through the plain version; D_i
    against its plain version; one launch each."""
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    qt, kt, vt, dot, out, lse = k2_tc_backward_inputs(shape, cuda_device)
    ops.reset_launch_counts()
    delta = flash.flash_bwd_delta(out, dot)
    dk, dv = flash.flash_bwd_dkdv_tc(qt, kt, vt, out, lse, dot, **mask,
                                     delta=delta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd_delta"] == 1
    assert ops.launch_counts()["flash_attention_bwd_dkdv_tc"] == 1
    assert dk.dtype == dv.dtype == torch.bfloat16
    assert dk.stride() == kt.stride() and dv.stride() == vt.stride()
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    want = ref.mha_reference(*leaves, **mask)
    _, want_k, want_v = torch.autograd.grad(want, leaves, dot)
    assert row_err(dk, want_k) <= K2_DKDV_TC_TOL["dkdv"]
    assert row_err(dv, want_v) <= K2_DKDV_TC_TOL["dkdv"]
    terms = (out.float() * dot.float()).abs().sum(-1)
    rel = (delta - ref.mha_delta_reference(out, dot)).abs() / terms
    assert rel.max().item() <= K2_DKDV_TC_TOL["delta"]


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_tc_dkdv_matches_cuda_core_dkdv(cuda_device, shape):
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    qt, kt, vt, dot, out, lse = k2_tc_backward_inputs(shape, cuda_device,
                                                      seed=2)
    dk, dv = flash.flash_bwd_dkdv_tc(qt, kt, vt, out, lse, dot, **mask)
    dk0, dv0 = flash.flash_bwd_dkdv(qt, kt, vt, out, lse, dot, **mask)
    torch.cuda.synchronize()
    assert row_err(dk, dk0) <= K2_DKDV_TC_TOL["dkdv_vs_cuda_core"]
    assert row_err(dv, dv0) <= K2_DKDV_TC_TOL["dkdv_vs_cuda_core"]


def test_k2_tc_dkdv_reads_model_layout_in_place(cuda_device):
    """The (B, S, H, D) tensors through transposed views give what
    contiguous (B, H, S, D) copies give, bit for bit, and dk and dv keep
    the model's layout."""
    shape = (2, 130, 130, 14, 2, 128, True, None, 0)
    mask = dict(causal=True, window=None, q_offset=0)
    qt, kt, vt, dot, out, lse = k2_tc_backward_inputs(shape, cuda_device,
                                                      seed=4)
    dk_v, dv_v = flash.flash_bwd_dkdv_tc(qt, kt, vt, out, lse, dot, **mask)
    dk_c, dv_c = flash.flash_bwd_dkdv_tc(
        *(x.contiguous() for x in (qt, kt, vt, out)), lse, dot.contiguous(),
        **mask)
    assert dk_v.stride() == kt.stride()
    assert dk_v.transpose(1, 2).is_contiguous()
    assert torch.equal(dk_v, dk_c) and torch.equal(dv_v, dv_c)


def test_k2_tc_dkdv_refuses_what_tma_cannot_take(cuda_device):
    """An output gradient whose base is not on 16 bytes or whose stride is
    not a multiple of 16 bytes, another dtype, CPU tensors: the kernel's
    launch function raises and never falls back."""
    shape = (1, 64, 64, 4, 2, 64, True, None, 0)
    mask = dict(causal=True, window=None, q_offset=0)
    qt, kt, vt, dot, out, lse = k2_tc_backward_inputs(shape, cuda_device)
    b, h, s, d = qt.shape
    flat = torch.zeros(dot.numel() + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:1 + dot.numel()].view(b, s, h, d).transpose(1, 2)
    wide = torch.zeros(b, s, h, d + 4, dtype=torch.bfloat16,
                       device=cuda_device)[..., :d].transpose(1, 2)
    ops.reset_launch_counts()
    for args, match in [((qt, kt, vt, out, lse, shifted), "16 bytes"),
                        ((qt, kt, vt, out, lse, wide),
                         "multiple of 16 bytes"),
                        ((qt.float(), kt.float(), vt.float(), out.float(),
                          lse, dot.float()), "bfloat16"),
                        ((qt.cpu(), kt.cpu(), vt.cpu(), out.cpu(),
                          lse.cpu(), dot.cpu()), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            flash.flash_bwd_dkdv_tc(*args, **mask)
    assert set(ops.launch_counts().values()) == {0}


#: the tensor-core dQ kernel per row (row_err). Against the plain version:
#: chip_smoke.py's K2_TOL for dq, 0.1, whose comment gives the reason (D_i
#: from the bf16 output, where dS = P (dP - D) nearly cancels); dS rounded
#: to bf16 before dS K adds up to 4.5e-3 (tests/test_torch_flash_dq_tc.py).
#: Against the CUDA-core dQ kernel, which forms D_i from the same bf16
#: output: the rounding of dS plus one bf16 rounding of each result, two
#: ulps (7.8e-3 in the worst row of the CPU emulation of both).
K2_DQ_TC_TOL = {"dq": 0.1, "dq_vs_cuda_core": 2e-2}


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_tc_dq_matches_plain(cuda_device, shape):
    """dq of the tensor-core kernel from the tensor-core forward's output
    and lse and the D_i pre-pass, against autograd through the plain
    version; one launch each, none of the CUDA-core dQ kernel."""
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    qt, kt, vt, dot, out, lse = k2_tc_backward_inputs(shape, cuda_device)
    ops.reset_launch_counts()
    delta = flash.flash_bwd_delta(out, dot)
    dq = flash.flash_bwd_dq_tc(qt, kt, vt, out, lse, dot, **mask,
                               delta=delta)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd_dq_tc"] == 1
    assert counts["flash_attention_bwd_dq"] == 0
    assert dq.dtype == torch.bfloat16 and dq.stride() == qt.stride()
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    want = ref.mha_reference(*leaves, **mask)
    want_q, = torch.autograd.grad(want, leaves[:1], dot)
    assert row_err(dq, want_q) <= K2_DQ_TC_TOL["dq"]


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_tc_dq_matches_cuda_core_dq(cuda_device, shape):
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    qt, kt, vt, dot, out, lse = k2_tc_backward_inputs(shape, cuda_device,
                                                      seed=2)
    dq = flash.flash_bwd_dq_tc(qt, kt, vt, out, lse, dot, **mask)
    dq0 = flash.flash_bwd_dq(qt, kt, vt, out, lse, dot, **mask)
    torch.cuda.synchronize()
    assert row_err(dq, dq0) <= K2_DQ_TC_TOL["dq_vs_cuda_core"]


def test_k2_tc_dq_reads_model_layout_in_place(cuda_device):
    """The (B, S, H, D) tensors through transposed views give what
    contiguous (B, H, S, D) copies give, bit for bit, and dq keeps the
    model's layout."""
    shape = (2, 130, 130, 14, 2, 128, True, None, 0)
    mask = dict(causal=True, window=None, q_offset=0)
    qt, kt, vt, dot, out, lse = k2_tc_backward_inputs(shape, cuda_device,
                                                      seed=4)
    dq_v = flash.flash_bwd_dq_tc(qt, kt, vt, out, lse, dot, **mask)
    dq_c = flash.flash_bwd_dq_tc(
        *(x.contiguous() for x in (qt, kt, vt, out)), lse, dot.contiguous(),
        **mask)
    assert dq_v.stride() == qt.stride()
    assert dq_v.transpose(1, 2).is_contiguous()
    assert torch.equal(dq_v, dq_c)


def test_k2_tc_dq_refuses_what_tma_cannot_take(cuda_device):
    """An output gradient whose base is not on 16 bytes or whose stride is
    not a multiple of 16 bytes, another dtype, CPU tensors: the kernel's
    launch function raises and never falls back."""
    shape = (1, 64, 64, 4, 2, 64, True, None, 0)
    mask = dict(causal=True, window=None, q_offset=0)
    qt, kt, vt, dot, out, lse = k2_tc_backward_inputs(shape, cuda_device)
    b, h, s, d = qt.shape
    flat = torch.zeros(dot.numel() + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:1 + dot.numel()].view(b, s, h, d).transpose(1, 2)
    wide = torch.zeros(b, s, h, d + 4, dtype=torch.bfloat16,
                       device=cuda_device)[..., :d].transpose(1, 2)
    ops.reset_launch_counts()
    for args, match in [((qt, kt, vt, out, lse, shifted), "16 bytes"),
                        ((qt, kt, vt, out, lse, wide),
                         "multiple of 16 bytes"),
                        ((qt.float(), kt.float(), vt.float(), out.float(),
                          lse, dot.float()), "bfloat16"),
                        ((qt.cpu(), kt.cpu(), vt.cpu(), out.cpu(),
                          lse.cpu(), dot.cpu()), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            flash.flash_bwd_dq_tc(*args, **mask)
    assert set(ops.launch_counts().values()) == {0}


def test_k2_backward_copies_an_output_gradient_tma_refuses(cuda_device):
    """Through ``flash_attention`` with an output gradient whose base is
    not on 16 bytes: the backward copies it and gives what an aligned
    gradient gives, bit for bit, on the tensor-core kernels, each launched
    once, after one D_i pre-pass for both halves."""
    q, k, v, do = k2_inputs((1, 96, 96, 4, 2, 64), torch.bfloat16,
                            cuda_device, seed=6)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    flat = torch.zeros(dot.numel() + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    shifted = flat[1:1 + dot.numel()].view(dot.shape)
    shifted.copy_(dot)
    grads = []
    for g_out in (dot, shifted):
        leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
        ops.reset_launch_counts()
        out = flash_attention(*leaves, causal=True)
        grads.append(torch.autograd.grad(out, leaves, g_out))
        assert ops.launch_counts() == {
            n: int(n in ("flash_attention_fwd_tc",
                         "flash_attention_bwd_delta",
                         "flash_attention_bwd_dkdv_tc",
                         "flash_attention_bwd_dq_tc"))
            for n in ops.WRAPPERS}
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 100, 100, 14, 2, 112, True, None, 0),      # Zamba2-7B's head_dim
    (1, 77, 200, 7, 1, 80, True, 48, 123),         # not a multiple of 16
])
def test_k2_any_head_dim_through_flash_attention(cuda_device, shape, dtype):
    """A head_dim the kernels do not take, zero-padded by the entry point:
    output and dq/dk/dv in the model layout against autograd through the
    plain version at that head_dim, within the per-row tolerances the
    kernels are held to at 64 and 128; the dtype's kernels launched once
    each."""
    causal, window, q_offset = shape[6:]
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = k2_inputs(shape, dtype, cuda_device, seed=7)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.mha_reference(*(x.transpose(1, 2) for x in leaves),
                             **mask).transpose(1, 2)
    want_g = torch.autograd.grad(want, leaves, do)
    ops.reset_launch_counts()
    mine = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_mha(*mine, **mask)
    got_g = torch.autograd.grad(out, mine, do)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd_tc"] == counts[
        "flash_attention_bwd_dkdv_tc"] == int(tc)
    assert counts["flash_attention_fwd"] == counts[
        "flash_attention_bwd_dkdv"] == counts["flash_attention_bwd_dq"] \
        == int(not tc)
    assert counts["flash_attention_bwd_dq_tc"] == int(tc)
    assert out.shape == q.shape and out.dtype == dtype
    tol = K2_ROW_TOL[dtype]
    assert row_err(out, want) <= tol["out"]
    for name, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
        assert a.shape == b.shape and a.dtype == dtype, name
        assert row_err(a, b) <= tol[name], name


def test_zoo_run_on_cuda_goes_through_k2(cuda_device):
    """A small float32 zoo run with flash attention on the card: K2's
    three kernels launched once per layer, cell and tick, the RNG-free
    market bit-equal to the CPU run's (which takes the plain attention),
    losses and weights within float32 reduction-order tolerance of it."""
    from repro_torch.train.trainer import train_zoo
    from repro_torch.train.zoo_program import init_zoo_state
    from repro_torch.tree import tree_leaves

    job = _job()
    job = JobConfig(model=job.model.with_(head_dim=64,
                                          use_flash_attention=True),
                    shape=job.shape, n_workers=job.n_workers,
                    learning_rate=job.learning_rate)
    model0 = init_zoo_state(job.model, job, 0, device="cpu")
    n_ticks, seeds = 12, [0, 3]
    cpu = train_zoo(job, _scenarios(), seeds, n_ticks=n_ticks,
                    model0=model0, device="cpu")
    ops.reset_launch_counts()
    gpu = train_zoo(job, _scenarios(), seeds, n_ticks=n_ticks,
                    model0=model0, device=cuda_device)
    counts = ops.launch_counts()
    per = job.model.num_layers * len(seeds) * n_ticks
    assert counts["flash_attention_fwd"] == per
    assert counts["flash_attention_bwd_dkdv"] == per
    assert counts["flash_attention_bwd_dq"] == per
    assert counts["flash_attention_fwd_tc"] == 0
    assert counts["flash_attention_bwd_dkdv_tc"] == 0
    assert counts["flash_attention_bwd_dq_tc"] == 0
    for field in ("iterations", "ys", "total_time", "total_cost"):
        np.testing.assert_array_equal(getattr(gpu, field),
                                      getattr(cpu, field))
    np.testing.assert_allclose(np.nan_to_num(gpu.errors),
                               np.nan_to_num(cpu.errors), rtol=5e-4,
                               atol=1e-5)
    for a, b in zip(tree_leaves(gpu.final_model),
                    tree_leaves(cpu.final_model)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=5e-4,
                                   atol=1e-5)


def test_zoo_bf16_run_on_cuda_goes_through_tc_forward(cuda_device):
    """A small bf16 zoo run with flash attention on the card: the
    tensor-core forward, the D_i pre-pass and the tensor-core dK/dV and dQ
    kernels launched once per layer, cell and tick, the CUDA-core
    forward, dK/dV and dQ kernels never; the RNG-free market
    bit-equal to the CPU run's; finite losses, the first (on the initial
    weights, before any update) within the bf16 train_zoo pin's 2e-2 of the
    CPU run's."""
    from repro_torch.train.trainer import train_zoo
    from repro_torch.train.zoo_program import init_zoo_state

    base = _job()
    job = JobConfig(model=base.model.with_(
        head_dim=64, use_flash_attention=True, dtype="bfloat16",
        param_dtype="bfloat16"), shape=base.shape,
        n_workers=base.n_workers, learning_rate=base.learning_rate)
    model0 = init_zoo_state(job.model, job, 0, device="cpu")
    n_ticks, seeds = 12, [0, 3]
    cpu = train_zoo(job, _scenarios(), seeds, n_ticks=n_ticks,
                    model0=model0, device="cpu")
    ops.reset_launch_counts()
    gpu = train_zoo(job, _scenarios(), seeds, n_ticks=n_ticks,
                    model0=model0, device=cuda_device)
    counts = ops.launch_counts()
    per = job.model.num_layers * len(seeds) * n_ticks
    assert counts["flash_attention_fwd_tc"] == per
    assert counts["flash_attention_fwd"] == 0
    assert counts["flash_attention_bwd_delta"] == per
    assert counts["flash_attention_bwd_dkdv_tc"] == per
    assert counts["flash_attention_bwd_dkdv"] == 0
    assert counts["flash_attention_bwd_dq_tc"] == per
    assert counts["flash_attention_bwd_dq"] == 0
    for field in ("iterations", "ys", "total_time", "total_cost"):
        np.testing.assert_array_equal(getattr(gpu, field),
                                      getattr(cpu, field))
    ran = gpu.iterations > 0
    assert np.isfinite(gpu.errors[..., 0][ran]).all()
    np.testing.assert_allclose(gpu.errors[..., 0][ran],
                               cpu.errors[..., 0][ran], atol=2e-2)


# ------------------------------------------- the zoo's mixed-precision SGD


def _mixed_leaves(shapes, device, grad_dtype=torch.bfloat16,
                  work=torch.bfloat16, seed=0):
    """(grads, momentum, masters, working copies) at ``shapes``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale
    master = [randn(sh) for sh in shapes]
    return ([randn(sh, 3.0).to(grad_dtype) for sh in shapes],
            [randn(sh) for sh in shapes], master,
            [m.to(work) for m in master])


def _bit_view(t):
    return t.view({torch.bfloat16: torch.int16,
                   torch.float32: torch.int32}[t.dtype])


def _kernel_and_plain(grads, carry, running, lr):
    """The kernel's update of ``carry`` (in place) and the plain version's
    of a copy of it, from the same start."""
    want = [[x.clone() for x in part] for part in carry]
    mixed_sgd.mixed_sgd_update_reference(grads, *want, running, lr,
                                         momentum=0.9)
    ops.mixed_sgd_update(grads, *carry, running, lr, momentum=0.9)
    torch.cuda.synchronize()
    return want


def test_mixed_sgd_bit_equal_to_plain_at_the_zoo_cells_shapes(cuda_device):
    """One grid cell of the zoo cell (full-width Qwen2-7B at depth 2: its
    15 leaves, 1.56 B parameters, bf16 over float32 masters and momentum)
    in one launch, every bit of the plain version's."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import abstract_params
    from repro_torch.tree import tree_leaves

    cfg = ARCHS["qwen2-7b"].with_(num_layers=2)
    shapes = [t.shape for t in tree_leaves(abstract_params(
        model_zoo.param_defs(cfg), torch.bfloat16))]
    assert len(shapes) == 15
    grads, *carry = _mixed_leaves(shapes, cuda_device)
    ops.reset_launch_counts()
    want = _kernel_and_plain(grads, carry,
                             torch.tensor(True, device=cuda_device),
                             torch.full((), 0.1, device=cuda_device))
    assert ops.launch_counts()["mixed_sgd_update"] == 1
    for part, wpart in zip(carry, want):
        for a, b in zip(part, wpart):
            assert torch.equal(_bit_view(a), _bit_view(b)), tuple(a.shape)


@pytest.mark.parametrize("grad_dtype,work", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_mixed_sgd_ragged_and_unaligned_leaves(cuda_device, grad_dtype,
                                               work):
    """Leaf sizes no multiple of 8 (one of 1), whole and ragged chunks, one
    leaf starting an element off its 16-byte boundary in every part (the
    scalar path), NaN and infinite gradients: every bit of the plain
    version's."""
    shapes = [(1,), (7,), (4096,), (3, 4099), (2, 8192 + 13), (5, 8)]
    grads, mom, master, params = _mixed_leaves(shapes, cuda_device,
                                               grad_dtype, work, seed=1)
    grads[2].view(-1)[::5] = float("nan")
    grads[4].view(-1)[::7] = float("inf")

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out
    for part in (grads, mom, master, params):
        part[3] = shifted(part[3])
    assert grads[3].data_ptr() % 16 and mom[3].data_ptr() % 16
    carry = [mom, master, params]
    want = _kernel_and_plain(grads, carry,
                             torch.tensor(True, device=cuda_device),
                             torch.full((), 0.05, device=cuda_device))
    for part, wpart in zip(carry, want):
        for a, b in zip(part, wpart):
            assert torch.equal(_bit_view(a), _bit_view(b)), tuple(a.shape)


def test_mixed_sgd_idle_cell_leaves_a_canary_untouched(cuda_device):
    """``running`` false: not a bit of any leaf moves (a canary pattern
    under NaN gradients), nor of the guard elements around each leaf;
    running, the leaves move and the guards still do not. The counter adds
    one per cell-update, idle or not."""
    shapes = [(3 * 4096,), (1000, 7)]
    grads, mom, master, params = _mixed_leaves(shapes, cuda_device, seed=2)
    canary = {torch.float32: 0x7FA5A5A5, torch.bfloat16: 0x7F81}
    bufs = []

    def guarded(x):
        buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
        _bit_view(buf).fill_(canary[x.dtype])
        bufs.append(buf)
        return buf[8:8 + x.numel()].view(x.shape)
    carry = [[guarded(x) for x in part] for part in (mom, master, params)]
    nan_grads = [torch.full_like(g, float("nan")) for g in grads]
    before = [_bit_view(b).clone() for b in bufs]
    lr = torch.full((), 0.1, device=cuda_device)
    ops.reset_launch_counts()
    for _ in range(2):
        ops.mixed_sgd_update(nan_grads, *carry,
                             torch.tensor(False, device=cuda_device), lr,
                             momentum=0.9)
    torch.cuda.synchronize()
    for b, c in zip(bufs, before):
        assert torch.equal(_bit_view(b), c)
    for part in carry:                # finite values for the running call
        for x in part:
            x.copy_(torch.randn(x.shape, device=cuda_device))
    ops.mixed_sgd_update(grads, *carry, torch.tensor(True, device=cuda_device),
                         lr, momentum=0.9)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mixed_sgd_update"] == 3
    for b, c in zip(bufs, before):
        assert torch.equal(_bit_view(b)[:8], c[:8])
        assert torch.equal(_bit_view(b)[-8:], c[-8:])
        assert not torch.equal(_bit_view(b), c)


def test_mixed_sgd_refuses_what_it_does_not_take(cuda_device):
    grads, mom, master, params = _mixed_leaves([(64,), (8, 8)], cuda_device,
                                               seed=3)
    on = torch.tensor(True, device=cuda_device)
    lr = torch.full((), 0.1, device=cuda_device)
    bad = [
        (grads, mom, master, params, on.cpu(), lr),
        (grads, mom, master, params, on, lr.double()),
        (grads, mom, master[:1], params, on, lr),
        ([g.double() for g in grads], mom, master, params, on, lr),
        (grads, [v.to(torch.bfloat16) for v in mom], master, params, on, lr),
        (grads, mom, master, [p.half() for p in params], on, lr),
        (grads, mom, master, [params[0], params[1].t()], on, lr),
        (grads, mom, master, [params[0], params[1][:4]], on, lr),
        ([grads[0].cpu(), grads[1]], mom, master, params, on, lr),
        # a bf16 gradient under a float32 working copy: no caller makes it
        (grads, mom, master, [p.float() for p in params], on, lr),
        ([grads[0]] * 65, [mom[0]] * 65, [master[0]] * 65, [params[0]] * 65,
         on, lr),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            mixed_sgd.mixed_sgd_update(*args, momentum=0.9)
    # through the dispatching wrapper: CUDA leaves with a CPU ``running``
    # or rate raise, rather than taking the plain path
    for args in ((grads, mom, master, params, on.cpu(), lr),
                 (grads, mom, master, params, on.cpu(), lr.cpu())):
        with pytest.raises(ValueError):
            ops.mixed_sgd_update(*args, momentum=0.9)


def test_mixed_sgd_counts_the_launches_it_makes(cuda_device):
    """The counter adds what the launcher made: one for a cell's leaves,
    none when every leaf is empty."""
    on = torch.tensor(True, device=cuda_device)
    lr = torch.full((), 0.1, device=cuda_device)
    ops.reset_launch_counts()
    ops.mixed_sgd_update(*_mixed_leaves([(0,), (0, 8)], cuda_device), on, lr,
                         momentum=0.9)
    assert ops.launch_counts()["mixed_sgd_update"] == 0
    ops.mixed_sgd_update(*_mixed_leaves([(0,), (40,)], cuda_device), on, lr,
                         momentum=0.9)
    assert ops.launch_counts()["mixed_sgd_update"] == 1


def test_zoo_bf16_run_lands_in_place_as_the_functional_step(cuda_device,
                                                            monkeypatch):
    """A small bf16 zoo run on the card, its update through the
    mixed-precision kernel once a cell and tick, against the same run
    through the functional update and the engine's gate: the same losses
    and trajectories and every carry bit."""
    from repro_torch.train import zoo_program
    from repro_torch.train.trainer import train_zoo
    from repro_torch.tree import tree_leaves

    base = _job()
    job = JobConfig(model=base.model.with_(
        head_dim=64, use_flash_attention=True, dtype="bfloat16",
        param_dtype="bfloat16"), shape=base.shape,
        n_workers=base.n_workers, learning_rate=base.learning_rate)
    model0 = zoo_program.init_zoo_state(job.model, job, 0, device="cpu")
    n_ticks, seeds = 12, [0, 3]

    def run():
        return train_zoo(job, _scenarios(), seeds, n_ticks=n_ticks,
                         model0=model0, device=cuda_device)
    ops.reset_launch_counts()
    mine = run()
    assert ops.launch_counts()["mixed_sgd_update"] == len(seeds) * n_ticks
    monkeypatch.setattr(zoo_program, "lands_in_place", lambda cfg, job: False)
    ops.reset_launch_counts()
    theirs = run()
    assert ops.launch_counts()["mixed_sgd_update"] == 0
    assert (mine.iterations > 0).all()
    for field in ("errors", "iterations", "ys", "total_time", "total_cost"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(theirs, field))
    for a, b in zip(tree_leaves(mine.final_model),
                    tree_leaves(theirs.final_model)):
        assert a.dtype == b.dtype and torch.equal(_bit_view(a), _bit_view(b))


# ----------------------------------------------- the MoE dispatch tables


def _routing(t, e, e_real, k, device, unpicked=None, idx=torch.int64):
    """(topi, topv) of ``t`` tokens over ``e`` experts, top-``k``: real
    `moe._route` output on random activations at DeepSeek-V2-Lite's width
    (``e_real`` < ``e`` masks the padded experts), or, with ``unpicked``,
    random picks that never take that expert."""
    import dataclasses

    from repro_torch.models import moe

    gen = torch.Generator(device=device).manual_seed(t * 131 + e + k)
    if unpicked is not None:
        score = torch.rand(t, e, generator=gen, device=device)
        score[:, unpicked] = -1.0
        topi = torch.topk(score, k, dim=-1).indices
        topv = torch.softmax(torch.randn(t, k, generator=gen, device=device),
                             dim=-1)
        return topi.to(idx).contiguous(), topv
    cfg = ARCHS["deepseek-v2-lite-16b"]
    m = dataclasses.replace(cfg.moe, num_experts=e,
                            num_experts_unpadded=e_real, top_k=k)
    x = torch.randn(t, cfg.d_model, generator=gen, device=device)
    router = torch.randn(cfg.d_model, e, generator=gen,
                         device=device) * cfg.d_model ** -0.5
    topi, topv, _ = moe._route(x, router, m)
    return topi.to(idx).contiguous(), topv


#: (tokens, experts, real experts, top-k, capacity, an unpicked expert,
#: id dtype): DeepSeek-V2-Lite's cell (8 × 1023 tokens, capacity 1.25 →
#: 960), the same at capacity 1, capacity past T·k (no drops), Qwen2-MoE's
#: 60 experts padded to 64 at top-4, decode's 1–3 tokens (capacity 1), and
#: an expert that no assignment picks, with int32 ids
DISPATCH_CASES = {
    "cell": (8184, 64, 64, 6, 960, None, torch.int64),
    "cell-capacity-1": (8184, 64, 64, 6, 1, None, torch.int64),
    "no-drops": (1024, 64, 64, 6, 6144, None, torch.int64),
    "qwen2-moe-padded": (4096, 64, 60, 4, 320, None, torch.int64),
    "decode-1": (1, 64, 64, 6, 1, None, torch.int64),
    "decode-2": (2, 64, 64, 6, 1, None, torch.int64),
    "decode-3": (3, 64, 64, 6, 1, None, torch.int64),
    "unpicked-expert-int32": (2048, 64, 64, 6, 240, 7, torch.int32),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_moe_dispatch_tables_bit_equal_to_plain(cuda_device, case):
    """One launch a call, with and without autograd recording: the three
    tables every bit of the plain one-hot/cumsum version's on the same
    card tensors, and topv's gradient through the combine weights every bit
    of the plain version's."""
    from repro_torch.kernels import moe_dispatch
    from repro_torch.models import moe

    t, e, e_real, k, cap, unpicked, idx = DISPATCH_CASES[case]
    topi, topv = _routing(t, e, e_real, k, cuda_device, unpicked, idx)
    want = moe_dispatch.dispatch_tables_reference(topi.long(), topv, e, cap)
    if unpicked is not None:
        assert not bool(want[2][unpicked].any())
    if e_real < e:
        assert not bool(want[2][e_real:].any())
    if case == "no-drops":
        assert int(want[2].sum()) == t * k

    def one_launch(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        assert ops.launch_counts() == {
            n: int(n == "moe_dispatch_tables") for n in ops.WRAPPERS}
        return out

    with torch.no_grad():
        got = one_launch(lambda: moe._dispatch_tables(topi, topv, e, cap))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) if a.dtype != torch.float32 else \
            torch.equal(a.view(torch.int32), b.view(torch.int32))

    g = torch.randn(e, cap, device=cuda_device,
                    generator=torch.Generator(device=cuda_device
                                              ).manual_seed(9))
    mine, plain = topv.clone().requires_grad_(), topv.clone().requires_grad_()
    tables = one_launch(lambda: moe._dispatch_tables(topi, mine, e, cap))
    for a, b in zip(tables, want):
        assert torch.equal(a.detach(), b)
    (gm,) = torch.autograd.grad((tables[1] * g).sum(), mine)
    (gp,) = torch.autograd.grad((moe_dispatch.dispatch_tables_reference(
        topi.long(), plain, e, cap)[1] * g).sum(), plain)
    assert torch.equal(gm.view(torch.int32), gp.view(torch.int32))


def test_moe_dispatch_tables_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import moe_dispatch

    topi, topv = _routing(64, 64, 64, 6, cuda_device)
    bad = [
        (topi.float(), topv), (topi.to(torch.int16), topv),
        (topi, topv.double()), (topi, topv.to(torch.bfloat16)),
        (topi[:, :4].contiguous(), topv), (topi.reshape(-1), topv.reshape(-1)),
        (topi.t(), topv.t()), (topi.cpu(), topv), (topi, topv.cpu()),
        (topi.cpu(), topv.cpu()),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            moe_dispatch.dispatch_tables(*args, 64, 8)
    with pytest.raises(ValueError):
        moe_dispatch.dispatch_tables(topi, topv, 64, -1)
    # through the dispatching wrapper: a CUDA tensor beside a CPU one
    # raises, rather than taking the plain path
    with pytest.raises(ValueError):
        ops.moe_dispatch_tables(topi, topv.cpu(), 64, 8)


# ------------------------------------------------------------------ K3

#: (B, S, H, P, G, N, chunk): Q = 16, 64, 100 (a ragged 64-row tile), 256
#: and S < chunk (Q = S = 48); one and two B/C groups, and three heads a
#: group (H 6, G 2: a slab of the tensor-core kernel straddles no group);
#: P 32, 64 and 128 (with Q 100 too); N 32, 64 and 128; two or more chunks
#: wherever Q < S
K3_SHAPES = [
    (2, 32, 4, 32, 1, 32, 16),
    (1, 128, 4, 64, 2, 128, 64),
    (1, 300, 2, 64, 1, 64, 100),
    (1, 512, 2, 64, 1, 128, 256),
    (2, 768, 4, 32, 2, 32, 256),
    (1, 48, 2, 128, 1, 128, 256),
    (1, 512, 6, 64, 2, 128, 256),
    (1, 300, 2, 128, 1, 64, 100),
]
#: the shape the serving path gives K3 (Mamba2-1.3B, batch 8, 2048 tokens)
K3_PATH_SHAPE = (8, 2048, 64, 64, 1, 128, 256)

#: K3 against its plain version per row (the last axis): the worst row's
#: max |kernel - plain| over the larger of that row's max |plain| and the
#: tensor's RMS. float32 sums in other orders (3xTF32 mma against cuBLAS,
#: a warp scan against torch.cumsum). cs runs to about -180 over 256
#: positions, where a float32 ulp is 1.5e-5: the two cumsums differ there
#: by a random walk of 256 roundings of up to 7.6e-6, 1.2e-4 at one sigma,
#: and exp(cs_i - cs_j) carries that into y, the states and the decay as a
#: relative error. The worst of many rows sits in the tail: 5e-4 (measured
#: on an H100 up to 1.2e-4 for y at the serving path's shape, a million
#: rows); cs itself within 1e-5 of its row. bf16 inputs are widened exactly on both sides; y_intra is
#: rounded to bf16 from float32 values that differ in their last bits: one
#: ulp, at most 2^-7 of its row's largest entry, under 1e-2.
K3_TOL = {torch.float32: {"y": 5e-4, "states": 5e-4, "cs": 1e-5,
                          "decay": 5e-4},
          torch.bfloat16: {"y": 1e-2, "states": 5e-4, "cs": 1e-5,
                           "decay": 5e-4}}
K3_OUTS = ("y", "states", "cs", "decay")


def ssd_inputs(shape, dtype, device, seed=0):
    """xh, dt (post-softplus), a_h < 0, bm, cm in the model's layouts."""
    b, s, h, p, g, n = shape[:6]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    xh = torch.randn(b, s, h, p, generator=gen) * 0.5
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
    a_h = -torch.exp(torch.randn(h, generator=gen) * 0.2)
    bm = torch.randn(b, s, g, n, generator=gen) * 0.3
    cm = torch.randn(b, s, g, n, generator=gen) * 0.3
    return (xh.to(device, dtype), dt.to(device), a_h.to(device),
            bm.to(device, dtype), cm.to(device, dtype))


def row_err(a, b):
    a, b = a.float(), b.float()
    num = (a - b).abs().amax(-1)
    den = b.abs().amax(-1).clamp_min(b.pow(2).mean().sqrt().item())
    return (num / den.clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_matches_plain(cuda_device, shape, dtype):
    args = ssd_inputs(shape, dtype, cuda_device)
    chunk = shape[6]
    got = ssd_scan.ssd_chunk(*args, chunk=chunk)
    want = ref.ssd_chunk_reference(*args, chunk=chunk)
    torch.cuda.synchronize()
    for name, a, b in zip(K3_OUTS, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert a.is_contiguous(), name
        assert row_err(a, b) <= K3_TOL[dtype][name], name


def test_k3_matches_plain_at_path_shape(cuda_device):
    """The tensor-core kernel at the serving path's shape, float32: a
    million rows, where the cumsum's order shows most."""
    args = ssd_inputs(K3_PATH_SHAPE, torch.float32, cuda_device)
    got = ssd_scan.ssd_chunk(*args, chunk=K3_PATH_SHAPE[6])
    want = ref.ssd_chunk_reference(*args, chunk=K3_PATH_SHAPE[6])
    torch.cuda.synchronize()
    for name, a, b in zip(K3_OUTS, got, want):
        assert row_err(a, b) <= K3_TOL[torch.float32][name], name


@pytest.mark.parametrize("shape", K3_SHAPES[1:4])
def test_k3_glue_from_a_state_matches_naive_recurrence(cuda_device, shape):
    """ops.ssd_chunked with a nonzero initial state against the per-token
    recurrence from it, at the reference's own tolerance, one K3 launch
    per call."""
    b, _, h, p, _, n, chunk = shape
    args = ssd_inputs(shape, torch.float32, cuda_device, seed=1)
    gen = torch.Generator(device="cpu").manual_seed(2)
    h0 = (torch.randn(b, h, p, n, generator=gen) * 0.5).to(cuda_device)
    ops.reset_launch_counts()
    y, hfin = ops.ssd_chunked(*args, chunk=chunk, h0=h0)
    assert ops.launch_counts()["ssd_chunk"] == 1
    ops.ssd_chunked(*args, chunk=chunk, h0=h0)
    assert ops.launch_counts()["ssd_chunk"] == 2
    yr, hr = ref.ssd_reference(*args, h0=h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yr, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(hfin, hr, rtol=5e-4, atol=5e-4)


def test_k3_reads_strided_inputs_in_place(cuda_device):
    """Views with other strides (heads sliced out of a wider tensor, B and
    C sliced out of one concatenated projection, as the model hands them
    over) give what contiguous copies give, bit for bit."""
    shape = (2, 128, 4, 64, 1, 64, 64)
    xh, dt, a_h, bm, cm = ssd_inputs(shape, torch.float32, cuda_device)
    wide = torch.cat([xh, xh], dim=2)[:, :, :4]
    bc = torch.cat([bm, cm], dim=-1)
    dtw = torch.cat([dt, dt], dim=-1)[..., :4]
    strided = ssd_scan.ssd_chunk(wide, dtw, a_h, bc[..., :64],
                                 bc[..., 64:], chunk=64)
    plain = ssd_scan.ssd_chunk(xh, dt, a_h, bm, cm, chunk=64)
    for a, b in zip(strided, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_synchronous_route_gives_the_async_routes_bits(cuda_device,
                                                          dtype):
    """Views that 16-byte copies cannot read (rows that start two elements
    past 16 bytes, so `async_refusal` sends them to the synchronous route)
    give what aligned contiguous copies give through cp.async, bit for
    bit."""
    shape = (2, 256, 6, 64, 2, 64, 128)
    xh, dt, a_h, bm, cm = ssd_inputs(shape, dtype, cuda_device)
    xw = torch.cat([xh, xh], dim=-1)[..., 2:66]
    bw = torch.cat([bm, cm, bm], dim=-1)[..., 2:130]
    for t in (xw, bw[..., :64], bw[..., 64:]):
        assert ssd_scan.async_refusal(tuple(t.shape), t.stride(),
                                      t.data_ptr(), t.element_size())
    xw.copy_(xh)
    bw[..., :64].copy_(bm)
    bw[..., 64:].copy_(cm)
    for t in (xh, bm, cm):
        assert ssd_scan.async_refusal(tuple(t.shape), t.stride(),
                                      t.data_ptr(), t.element_size()) is None
    sync = ssd_scan.ssd_chunk(xw, dt, a_h, bw[..., :64], bw[..., 64:],
                              chunk=128)
    copies = ssd_scan.ssd_chunk(xh, dt, a_h, bm, cm, chunk=128)
    for a, b in zip(sync, copies):
        assert torch.equal(a, b)


def test_k3_refuses_what_it_does_not_take(cuda_device):
    xh, dt, a_h, bm, cm = ssd_inputs((1, 512, 4, 64, 2, 64), torch.float32,
                                     cuda_device)
    with pytest.raises(NotImplementedError, match="models.ssm.ssd_chunked"):
        ssd_scan.ssd_chunk(xh.clone().requires_grad_(), dt, a_h, bm, cm,
                           chunk=64)
    bad = [
        ((xh.double(), dt, a_h, bm, cm), 64),
        ((xh, dt, a_h, bm.bfloat16(), cm), 64),
        ((xh, dt.cpu(), a_h, bm, cm), 64),
        ((xh, dt, a_h, bm[:, :, :1], cm), 64),
        ((xh[:, :, :3], dt[:, :, :3], a_h[:3], bm, cm), 64),
        ((xh.transpose(2, 3), dt, a_h, bm, cm), 64),
        ((xh, dt, a_h, bm, cm), 512),                    # Q > 256
        ((xh, dt, a_h, bm, cm), 100),                    # S % Q != 0
        ((torch.cat([xh, xh, xh], -1), dt, a_h, bm, cm), 64),   # P > 128
        ((xh.cpu(), dt.cpu(), a_h.cpu(), bm.cpu(), cm.cpu()), 64),
    ]
    for args, chunk in bad:
        with pytest.raises(ValueError):
            ssd_scan.ssd_chunk(*args, chunk=chunk)


def test_serving_on_cuda_goes_through_k3(cuda_device):
    """The reduced Mamba2 served on the card: K3 launched once per layer in
    the prefill and never in decode, logits and caches within float32
    reduction-order tolerance of the CPU run (which takes the plain
    version), the same greedy tokens."""
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map

    cfg = ARCHS["mamba2-1.3b"].reduced()
    params = init_params(model_zoo.param_defs(cfg), 0, device="cpu")
    caches = init_params(model_zoo.cache_defs(cfg, 2, 160), 0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), params)
        c = tree_map(lambda t: t.to(dev), caches)
        ops.reset_launch_counts()
        nxt, c = serve.prefill_prompt(cfg, p, c, prompt.to(dev))
        n_prefill = ops.launch_counts()["ssd_chunk"]
        toks, c = serve.greedy_decode(cfg, p, c, nxt, 128, 8)
        n_decode = ops.launch_counts()["ssd_chunk"] - n_prefill
        runs[str(dev)] = (toks.cpu(), {k: v.cpu() for k, v in c.items()},
                          n_prefill, n_decode)
    cpu, gpu = runs["cpu"], runs[str(cuda_device)]
    assert cpu[2:] == (0, 0)
    assert gpu[2:] == (cfg.num_layers, 0)
    assert torch.equal(gpu[0], cpu[0])
    for k in ("h", "conv"):
        torch.testing.assert_close(gpu[1][k], cpu[1][k], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-lite-16b",
                                  "qwen2-moe-a2.7b"])
def test_transformer_serving_on_cuda_matches_the_cpu(cuda_device, arch,
                                                    monkeypatch):
    """A reduced dense (QKV bias), MLA + MoE and MoE transformer served on
    the card: ``prefill_prompt`` over 16 tokens then 6 greedy serve steps.
    float32, TF32 off: the prefill's logits and every cache leaf within
    1e-4 of the CPU run (the same products summed in other orders), the
    positions and greedy tokens equal, and no kernel launched but the MoE
    dispatch tables, once a routing on the card."""
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo, moe
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map

    calls = []
    tables = moe._dispatch_tables
    monkeypatch.setattr(moe, "_dispatch_tables",
                        lambda *a: calls.append(a) or tables(*a))
    cfg = ARCHS[arch].reduced()
    params = init_params(model_zoo.param_defs(cfg), 0, device="cpu")
    caches = init_params(model_zoo.cache_defs(cfg, 2, 24), 0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), params)
        c = tree_map(lambda t: t.to(dev), caches)
        calls.clear()
        ops.reset_launch_counts()
        logits, c1 = model_zoo.prefill(p, cfg, {"tokens": prompt.to(dev)}, c)
        nxt, c = serve.prefill_prompt(cfg, p, c, prompt.to(dev))
        toks, c = serve.greedy_decode(cfg, p, c, nxt, 16, 6)
        assert bool(calls) == (cfg.moe is not None)
        tables_launches = len(calls) if dev != "cpu" else 0
        assert ops.launch_counts() == {
            n: tables_launches if n == "moe_dispatch_tables" else 0
            for n in ops.WRAPPERS}
        runs[str(dev)] = (logits.cpu(), tree_map(lambda t: t.cpu(), c1),
                          toks.cpu(), tree_map(lambda t: t.cpu(), c))
    cpu, gpu = runs["cpu"], runs[str(cuda_device)]
    torch.testing.assert_close(gpu[0], cpu[0], rtol=1e-4, atol=1e-4)
    assert torch.equal(gpu[2], cpu[2])
    for i in (1, 3):
        for k in cpu[i]:
            if k == "pos":
                assert torch.equal(gpu[i][k], cpu[i][k])
            else:
                torch.testing.assert_close(gpu[i][k], cpu[i][k], rtol=1e-4,
                                           atol=1e-4)
    assert cpu[3]["pos"][0, 0].tolist() == list(range(22)) + [-1, -1]


def test_moe_block_on_cuda_is_bit_reproducible(cuda_device):
    """The MoE block twice on the same inputs, bf16 and float32: output and
    aux bit for bit (the combine's scatter-add sorts its indices rather
    than adding by atomics), at 4096 tokens over 8 experts, top-2, capacity
    1.25 (drops) — many tokens add into each row of the combine."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    for dtype in (torch.float32, torch.bfloat16):
        cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, num_experts=8,
                                                num_experts_unpadded=6))
        p = init_params(moe.moe_defs(cfg), 0, dtype, device=cuda_device)
        x = torch.randn(16, 256, cfg.d_model, device=cuda_device,
                        generator=torch.Generator(device=cuda_device
                                                  ).manual_seed(1)).to(dtype)
        y0, a0 = moe.moe_block(p, cfg, x)
        y1, a1 = moe.moe_block(p, cfg, x)
        assert y0.dtype == dtype and torch.isfinite(y0).all()
        assert torch.equal(y0, y1) and torch.equal(a0, a1)


def _quad_grid():
    """An RNG-free grid for the quadratic oracle (tick-indexed trace
    prices, a deterministic runtime) and a stochastic one (uniform and
    Gaussian prices, exp runtimes, preemptions)."""
    from repro_torch.data.synthetic import QuadraticProblem

    quad = QuadraticProblem(dim=10, n_samples=256, cond=8.0, noise=0.3,
                            label_noise=1.0, seed=0)
    alpha = 0.5 / quad.L
    trace = np.random.default_rng(7).uniform(0.2, 1.0, 313).astype(
        np.float32)
    free = [engine.Scenario(price=engine.PriceSpec.from_trace_ticks(trace),
                            alpha=alpha, bid_schedule=np.tile(b, (60, 1)),
                            rt_kind="det", rt_const=1.0, idle_step=0.5,
                            name=f"free{i}")
            for i, b in enumerate([[0.6] * 4, [0.9, 0.9, 0.4, 0.4]])]
    drawn = [engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0),
                             alpha=alpha, bid_schedule=np.tile([0.7] * 8,
                                                               (60, 1)),
                             rt_kind="exp", rt_lam=2.0, idle_step=0.5),
             engine.Scenario(price=engine.PriceSpec.trunc_gaussian(
                 0.6, 0.175, 0.2, 1.0), alpha=alpha,
                 bid_schedule=np.tile([0.9] * 4 + [0.5] * 4, (60, 1)),
                 rt_kind="exp", rt_lam=2.0, idle_step=0.5),
             engine.Scenario(price=engine.PriceSpec.uniform(0.0, 1.0),
                             alpha=alpha, worker_schedule=np.full(60, 6),
                             preempt_q=0.3, rt_kind="exp", rt_lam=2.0)]
    return quad, quad.w_star + 1.0, free, drawn


def test_evaluate_batch_on_cuda_equals_the_cpu_on_rng_free_grid(
        cuda_device):
    from repro_torch.sim import evaluate

    quad, w0, free, _ = _quad_grid()
    kw = dict(quad=quad, w0=w0, alpha=free[0].alpha, grad="full",
              n_ticks=200)
    card = evaluate.evaluate_batch({}, free, 4, device="cuda", **kw)
    cpu = evaluate.evaluate_batch({}, free, 4, device="cpu", **kw)
    assert card.result.completed.all()
    for f in ("iterations", "ys", "costs", "times", "total_cost",
              "total_time", "total_idle"):
        np.testing.assert_array_equal(getattr(card.result, f),
                                      getattr(cpu.result, f), err_msg=f)
    np.testing.assert_allclose(card.result.errors, cpu.result.errors,
                               rtol=1e-5)
    assert card.result.final_model.device.type == "cuda"


def test_minibatch_indices_on_cuda_equal_the_cpu(cuda_device):
    key = torch.arange(4096, dtype=torch.int64) * 2654435761 % (1 << 32)
    card = engine.minibatch_indices(key.cuda(), 8, 16, 256)
    np.testing.assert_array_equal(
        card.cpu().numpy(), engine.minibatch_indices(key, 8, 16, 256).numpy())


@pytest.mark.parametrize("every,index", [(7, 2), (25, 0)])
def test_snapshot_resume_on_cuda_is_bitexact(cuda_device, every, index):
    """Minibatch gradients, random prices, exp runtimes and preemptions on
    the card: a run resumed from a snapshot at its tick repeats the
    uninterrupted run bit for bit."""
    quad, w0, free, drawn = _quad_grid()
    scenarios = engine.stack_scenarios(free + drawn, device="cuda")
    data = engine.torch_quadratic(quad, "cuda")
    program = engine.quadratic_program("minibatch", 16)
    model0 = torch.as_tensor(w0, dtype=torch.float32, device="cuda")
    seeds = [0, 1, 2, 9]

    def run(cfg, **kw):
        return engine.simulate_program(scenarios, program, model0, data,
                                       seeds, cfg, device="cuda", **kw)

    straight = run(engine.SimConfig(n_ticks=120))
    snap = run(engine.SimConfig(n_ticks=120, snapshot_every=every))
    state, tick = engine.snapshot_state(snap, index)
    assert state.t.device.type == "cuda" and tick == every * (index + 1)
    resumed = run(engine.SimConfig(n_ticks=120), init_state=state,
                  tick0=tick)
    for res in (snap, resumed):
        for f in ("errors", "costs", "times", "ys", "iterations",
                  "total_time", "total_cost", "total_idle"):
            np.testing.assert_array_equal(getattr(res, f),
                                          getattr(straight, f), err_msg=f)
        assert torch.equal(res.final_model, straight.final_model)


# ------------------------------------------------------- durable training


def _stochastic_scenarios(n_workers=4):
    """Random prices and exp runtimes: the market draws every tick."""
    bids = [0.9] * (n_workers // 2) + [0.5] * (n_workers - n_workers // 2)
    return [engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0),
                            alpha=0.1, bid_schedule=np.tile(bids, (8, 1)),
                            rt_kind="exp", rt_lam=2.0, rt_delta=0.05,
                            idle_step=0.5, name="s0")]


def _bits(x):
    x = x.detach().contiguous().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes()


def _assert_same_bits(a, b):
    from repro_torch.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _bits(x) == _bits(y)


def test_megabatch_snapshot_save_restore_resume_is_bitexact(cuda_device,
                                                            tmp_path):
    """The megabatch program through K1 on a market that draws: a second
    run repeats the first bit for bit, and a run snapshotted mid-way,
    saved, restored into fresh buffers and resumed at its tick lands on
    the same bits, K1 launched once a tick in each."""
    from repro_torch.train.trainer import restore_batched, save_batched

    job = _job()
    kw = dict(megabatch=True, use_fused_update=True, device=cuda_device)
    ops.reset_launch_counts()
    straight = train_batched(job, _stochastic_scenarios(), [0, 5],
                             n_ticks=24, snapshot_every=4, **kw)
    assert ops.launch_counts()["elastic_sgd_update"] == 24
    again = train_batched(job, _stochastic_scenarios(), [0, 5], n_ticks=24,
                          **kw)
    _assert_same_bits(again.final_model, straight.final_model)
    path = str(tmp_path / "mega.npz")
    assert save_batched(path, straight, index=0) == 4
    state, tick = restore_batched(path, job, _stochastic_scenarios(),
                                  [0, 5], megabatch=True,
                                  device=cuda_device)
    assert state.model["p"].is_cuda and tick == 4
    ops.reset_launch_counts()
    resumed = train_batched(job, _stochastic_scenarios(), [0, 5],
                            n_ticks=24, init_state=state, tick0=tick, **kw)
    assert ops.launch_counts()["elastic_sgd_update"] == 20
    for f in ("errors", "costs", "times", "ys", "iterations", "total_time",
              "total_cost", "total_idle"):
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(straight, f), err_msg=f)
    _assert_same_bits(resumed.final_model, straight.final_model)


def test_bf16_durable_train_zoo_resume_through_k2(cuda_device, tmp_path):
    """A bf16 zoo run with K2 at full width and two layers (InternVL2-1B's
    heads: 14 q, 2 kv, head_dim 64), killed after its first chunk (a
    shorter first call) and resumed from its step directory in fresh
    buffers: bit for bit the uninterrupted run, the tensor-core kernels
    launched once a layer, cell and tick, a NaN chunk rolled back."""
    from repro_torch.chaos import Fault, FaultInjector, FaultLedger, FaultPlan
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import train_zoo

    cfg = ARCHS["internvl2-1b"].with_(
        num_layers=2, vocab_size=4096, dtype="bfloat16",
        param_dtype="bfloat16", use_flash_attention=True)
    job = JobConfig(model=cfg, shape=InputShape("t", 384, 8, "train"),
                    n_workers=8, learning_rate=0.01)
    scenarios = _stochastic_scenarios(8)
    ops.reset_launch_counts()
    full = train_zoo(job, scenarios, [0], n_ticks=12, device=cuda_device)
    counts = ops.launch_counts()
    for name in ("flash_attention_fwd_tc", "flash_attention_bwd_delta",
                 "flash_attention_bwd_dkdv_tc", "flash_attention_bwd_dq_tc"):
        assert counts[name] == 2 * 12, name
    assert counts["flash_attention_fwd"] == counts[
        "flash_attention_bwd_dq"] == 0
    root = str(tmp_path / "ckpt")
    kw = dict(checkpoint_path=root, save_every=4, keep_last=2,
              nan_guard=True, device=cuda_device)
    train_zoo(job, scenarios, [0], n_ticks=4, **kw)
    inj = FaultInjector(FaultPlan((Fault("nan", at_tick=8),)),
                        FaultLedger(str(tmp_path / "fired.json")))
    resumed = train_zoo(job, scenarios, [0], n_ticks=12, hooks=inj, **kw)
    assert [e["fault"] for e in inj.events] == ["nan", "rollback"]
    assert ckpt.list_steps(root) == [8, 12]
    for f in ("errors", "costs", "times", "ys", "iterations", "total_cost"):
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(full, f), err_msg=f)
    _assert_same_bits(resumed.final_state, full.final_state)


def test_checkpoint_roundtrip_of_cuda_tensors(cuda_device, tmp_path):
    """bf16, float32 and int64 tensors on the card: saved as the
    reference's format (bf16 as uint16 bits under ``__bf16__``) and
    restored onto the card, bit for bit, in fresh contiguous buffers."""
    from repro_torch.train import checkpoint as ckpt

    g = torch.Generator(device="cuda").manual_seed(3)
    tree = {"p": torch.randn(5, 7, generator=g, device="cuda").to(
        torch.bfloat16), "m": (torch.randn(4, generator=g, device="cuda"),
                               torch.arange(6, device="cuda")),
            "strided": torch.randn(8, 6, generator=g,
                                   device="cuda").t()[::2]}
    tree["p"][0, 0] = float("nan")
    path = str(tmp_path / "c.npz")
    ckpt.save(path, tree, 9)
    with np.load(path) as f:
        assert f["__bf16__"].tolist() == ["['p']"]
        assert f["['p']"].dtype == np.uint16
        assert f["['p']"].tobytes() == _bits(tree["p"])
    like = {"p": torch.zeros(5, 7, dtype=torch.bfloat16, device="cuda"),
            "m": (torch.zeros(4, device="cuda"),
                  torch.zeros(6, dtype=torch.int64, device="cuda")),
            "strided": torch.zeros(3, 8, device="cuda")}
    got, step = ckpt.restore(path, like)
    assert step == 9
    assert got["p"].is_cuda and got["strided"].is_contiguous()
    _assert_same_bits(got, tree)
    want = tree["m"][0].clone()
    with ckpt.AsyncCheckpointWriter() as w:
        w.submit(str(tmp_path / "a.npz"), tree, 10)
        tree["m"][0].add_(1.0)      # the writer holds its own host copy
    got, _ = ckpt.restore(str(tmp_path / "a.npz"), like)
    assert _bits(got["m"][0]) == _bits(want)


# ---------------------------------------------------- the rest of the zoo

#: the shape the hybrid's prefill gives K3 (Zamba2-7B: 112 heads of 64 in
#: one group, N 64, batch 8, 2048 tokens), in its bf16
K3_HYBRID_SHAPE = (8, 2048, 112, 64, 1, 64, 256)
#: the shape Whisper-base's encoder gives K2: non-causal over 1500 frames
K2_WHISPER_SHAPE = (8, 1500, 1500, 8, 8, 64, False, None, 0)


def test_k3_matches_plain_at_hybrid_shape(cuda_device):
    """The tensor-core kernel at the hybrid's serving shape in bf16 (seven
    slabs of 16 heads a group, N 64): every output within its per-row
    tolerance of the plain version."""
    args = ssd_inputs(K3_HYBRID_SHAPE, torch.bfloat16, cuda_device)
    got = ssd_scan.ssd_chunk(*args, chunk=K3_HYBRID_SHAPE[6])
    want = ref.ssd_chunk_reference(*args, chunk=K3_HYBRID_SHAPE[6])
    torch.cuda.synchronize()
    for name, a, b in zip(K3_OUTS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert row_err(a, b) <= K3_TOL[torch.bfloat16][name], name


def test_k2_non_causal_at_whisper_encoder_shape(cuda_device):
    """K2 forward and backward, non-causal, at the encoder's shape (S = T
    = 1500, ragged against the 64-row tiles) in bf16 through
    ``ops.flash_mha``, against autograd through the plain version, per
    row: the tensor-core forward, D_i, dK/dV and dQ kernels once each."""
    q, k, v, do = k2_inputs(K2_WHISPER_SHAPE, torch.bfloat16, cuda_device)
    mask = dict(causal=False, window=None, q_offset=0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = ref.mha_reference(*(x.transpose(1, 2) for x in leaves),
                             **mask).transpose(1, 2)
    want_g = torch.autograd.grad(want, leaves, do)
    ops.reset_launch_counts()
    mine = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_mha(*mine, **mask)
    got_g = torch.autograd.grad(out, mine, do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in ("flash_attention_fwd_tc", "flash_attention_bwd_delta",
                 "flash_attention_bwd_dkdv_tc", "flash_attention_bwd_dq_tc"):
        assert counts[name] == 1, name
    tol = K2_ROW_TOL[torch.bfloat16]
    assert row_err(out, want) <= tol["out"]
    for name, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
        assert row_err(a, b) <= tol[name], name


def test_ssd_training_route_on_cuda_matches_the_cpu(cuda_device):
    """``models.ssm.ssd_chunked`` (the training route) on the card against
    the CPU in float32 with a nonzero initial state: y, the final state and
    the gradients of every input within 1e-4 (the same products summed in
    other orders; TF32 off), one call counted on each, K3 never."""
    from repro_torch.models import ssm

    shape = (2, 256, 4, 32, 2, 32, 64)
    args = ssd_inputs(shape, torch.float32, "cpu", seed=4)
    h0 = torch.randn(2, 4, 32, 32, generator=torch.Generator().manual_seed(5))
    w_y = torch.randn(2, 256, 4, 32,
                      generator=torch.Generator().manual_seed(6))
    runs = {}
    for dev in ("cpu", cuda_device):
        leaves = [x.to(dev).requires_grad_() for x in args]
        ssm.ssd_chunked.calls = 0
        ops.reset_launch_counts()
        y, hfin = ssm.ssd_chunked(*leaves, shape[6], h0=h0.to(dev))
        grads = torch.autograd.grad(
            (y * w_y.to(dev)).sum() + hfin.sum(), leaves)
        assert ssm.ssd_chunked.calls == 1
        assert set(ops.launch_counts().values()) == {0}
        runs[str(dev)] = [t.detach().cpu() for t in (y, hfin) + grads]
    for a, b in zip(runs[str(cuda_device)], runs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _zoo_job(arch, dtype, **over):
    cfg = ARCHS[arch].reduced().with_(dtype=dtype, param_dtype=dtype,
                                      use_flash_attention=True, **over)
    return JobConfig(model=cfg, shape=InputShape("t", 64, 4, "train"),
                     n_workers=4)


def _zoo_batch(job, device):
    from repro_torch.train.trainer import stack_batches

    return {k: x[0] for k, x in stack_batches(job, 1, device=device).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,over", [("zamba2-7b", {"num_layers": 5}),
                                       ("whisper-base", {}),
                                       ("mamba2-1.3b", {})])
def test_remat_gradients_bit_equal_with_kernels_on_the_path(
        cuda_device, arch, over, dtype):
    """One loss-and-gradient step of a reduced hybrid, enc-dec and SSM LM on
    the card with K2 on, under "none", "dots" and "full": the loss and every
    gradient leaf bit for bit; K2's forward launched again in the backward
    by both recomputing modes (once per attention site), its backward once;
    the SSD's training route run again likewise; K3 never."""
    from repro_torch.models import model_zoo, ssm
    from repro_torch.models.common import init_params
    from repro_torch.train.train_step import make_loss_grad
    from repro_torch.tree import tree_leaves

    job = _zoo_job(arch, dtype, **over)
    cfg = job.model
    params = init_params(model_zoo.param_defs(cfg), 0,
                         cfg.resolved_param_dtype(), device=cuda_device)
    batch = _zoo_batch(job, cuda_device)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda_device)
    fwd = "flash_attention_fwd_tc" if dtype == "bfloat16" \
        else "flash_attention_fwd"
    runs = {}
    for remat in ("none", "dots", "full"):
        ops.reset_launch_counts()
        ssm.ssd_chunked.calls = 0
        grads, loss, _ = make_loss_grad(cfg, job, remat)(params, batch, mask)
        torch.cuda.synchronize()
        runs[remat] = (grads, loss, ops.launch_counts()[fwd],
                       ssm.ssd_chunked.calls, ops.launch_counts()["ssd_chunk"])
    base = runs["none"]
    assert base[2] > 0 or arch == "mamba2-1.3b"
    assert base[4] == 0
    for remat in ("dots", "full"):
        grads, loss, n_fwd, n_ssd, n_k3 = runs[remat]
        assert torch.equal(loss, base[1]), remat
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(grads), tree_leaves(base[0]))), remat
        assert n_k3 == 0
    if arch == "whisper-base":
        # every layer of the encoder and decoder is checkpointed
        assert runs["full"][2] == runs["dots"][2] == 2 * base[2]
    elif arch == "zamba2-7b":
        # each super-group is checkpointed, the tail is not
        g, tail = divmod(cfg.num_layers, cfg.attn_every)
        assert runs["full"][2] == runs["dots"][2] == 2 * base[2] == 2 * g
        assert base[3] == cfg.num_layers
        assert runs["full"][3] == runs["dots"][3] == cfg.num_layers + g * \
            cfg.attn_every
    else:
        assert runs["full"][3] == runs["dots"][3] == 2 * base[3] == \
            2 * cfg.num_layers


# ------------------------------------------------------------------ mesh


def _card_mesh(layout):
    """Shards on the one card: ``layout`` is the mesh's (axes, shape)."""
    from repro_torch.launch.mesh import Mesh

    axes, shape = layout
    return Mesh(np.full(shape, "cuda:0", dtype=object), axes)


@pytest.mark.parametrize("layout", [(("data",), (2,)), (("data",), (3,)),
                                    (("data", "replica"), (2, 2))])
def test_quadratic_grid_in_shards_on_one_card_is_bitexact(cuda_device,
                                                          layout):
    """The quadratic grid (minibatch gradients, drawn prices, exp runtimes,
    preemptions; 5 scenarios × 4 seeds, never an even split) in two or
    three shards on the card, or 2 × 2: every trajectory, the final
    iterates and the snapshots bit for bit the unsharded run."""
    quad, w0, free, drawn = _quad_grid()
    scenarios = engine.stack_scenarios(free + drawn, device="cuda")
    data = engine.torch_quadratic(quad, "cuda")
    program = engine.quadratic_program("minibatch", 16)
    model0 = torch.as_tensor(w0, dtype=torch.float32, device="cuda")
    cfg = engine.SimConfig(n_ticks=120, snapshot_every=40)
    seeds = [0, 1, 2, 9]
    straight = engine.simulate_program(scenarios, program, model0, data,
                                       seeds, cfg, device="cuda")
    sharded = engine.simulate_sharded(scenarios, program, model0, data,
                                      seeds, cfg, mesh=_card_mesh(layout))
    for f in ("errors", "costs", "times", "ys", "iterations", "total_time",
              "total_cost", "total_idle"):
        np.testing.assert_array_equal(getattr(sharded, f),
                                      getattr(straight, f), err_msg=f)
    assert sharded.final_model.is_cuda
    _assert_same_bits(tuple(sharded.final_state), tuple(straight.final_state))
    _assert_same_bits(tuple(sharded.snapshots), tuple(straight.snapshots))


@pytest.mark.parametrize("layout", [(("replica",), (2,)),
                                    (("replica",), (3,))])
def test_megabatch_grid_in_shards_on_one_card(cuda_device, layout):
    """The megabatch grid through K1, its 3 seeds in two or three shards
    on the card: K1 runs once per shard and tick, the market trajectories
    are bit for bit the unsharded run's, and a second sharded run repeats
    the first bit for bit. The losses and the final carry are held at
    tests/test_torch_megabatch.py's tolerance, not bit for bit: cuBLAS
    forms a shard's products over one or two replicas with other kernels
    than over three, and the last bits move (ROADMAP queue 3)."""
    job = _job()
    kw = dict(megabatch=True, use_fused_update=True, device=cuda_device,
              n_ticks=24)
    ops.reset_launch_counts()
    straight = train_batched(job, _stochastic_scenarios(), [0, 5, 7], **kw)
    assert ops.launch_counts()["elastic_sgd_update"] == 24
    ops.reset_launch_counts()
    sharded = train_batched(job, _stochastic_scenarios(), [0, 5, 7],
                            mesh=_card_mesh(layout), **kw)
    assert ops.launch_counts()["elastic_sgd_update"] == 24 * layout[1][0]
    again = train_batched(job, _stochastic_scenarios(), [0, 5, 7],
                          mesh=_card_mesh(layout), **kw)
    _assert_same_bits(again.final_model, sharded.final_model)
    np.testing.assert_array_equal(again.errors, sharded.errors)
    for f in ("costs", "times", "ys", "iterations", "total_time",
              "total_cost", "total_idle"):
        np.testing.assert_array_equal(getattr(sharded, f),
                                      getattr(straight, f), err_msg=f)
    rtol, atol = 5e-4, 1e-5          # tests/test_torch_megabatch.py's
    np.testing.assert_allclose(sharded.errors, straight.errors, rtol=rtol,
                               atol=atol)
    for k in ("p", "v"):
        torch.testing.assert_close(sharded.final_model[k],
                                   straight.final_model[k], rtol=rtol,
                                   atol=atol)


def test_scenario_mesh_takes_the_visible_cards(cuda_device):
    """``make_scenario_mesh`` spans the visible cards, each once, and
    refuses more than ``torch.cuda.device_count()``."""
    from repro_torch.launch.mesh import make_scenario_mesh

    n = torch.cuda.device_count()
    mesh = make_scenario_mesh()
    assert [str(d) for d in mesh.devices.flat] == \
        [f"cuda:{i}" for i in range(n)]
    with pytest.raises(ValueError, match=f"needs {n + 1} devices but only"):
        make_scenario_mesh(n + 1)


def _ep_case(route, device, cf=1.25):
    """The reduced Qwen2-MoE block (8 experts, 6 real, one shared) on
    ``device``: (cfg, params, x, dx) in float32."""
    import dataclasses

    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
    cfg = cfg.with_(moe=dataclasses.replace(
        cfg.moe, num_experts=8, num_experts_unpadded=6, parallelism=route,
        capacity_factor=cf))
    p = init_params(moe.moe_defs(cfg), 0, device="cpu")
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(4, 64, cfg.d_model, generator=g)
    dy = torch.randn(4, 64, cfg.d_model, generator=g)
    return cfg, {k: v.to(device) for k, v in p.items()}, x.to(device), \
        dy.to(device)


def _ep_run(cfg, p, x, dy, mesh):
    """The block under ``mesh`` with the gradient of <y, dy> + aux with
    respect to x and every weight."""
    from repro_torch.models import moe
    from repro_torch.models.common import mesh_context

    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xl = x.clone().requires_grad_()
    with mesh_context(mesh):
        y, aux = moe.moe_block(leaves, cfg, xl)
    names = sorted(leaves)
    grads = torch.autograd.grad((y * dy).sum() + aux,
                                [xl] + [leaves[k] for k in names])
    return y.detach(), aux.detach(), dict(zip(["x"] + names, grads))


@pytest.mark.parametrize("route", ["psum", "alltoall"])
@pytest.mark.parametrize("tp", [2, 4])
def test_expert_parallel_routes_on_one_card_match_the_cpu(cuda_device, tp,
                                                          route):
    """The ranks of a (1, tp) mesh that lists cuda:0 tp times run in turn
    on the card: output, aux and every gradient against the same route on
    a CPU mesh, float32 at 1e-4 of each tensor's largest entry (cuBLAS and
    the CPU's BLAS sum in other orders), and bit for bit run to run."""
    from repro_torch.launch.mesh import Mesh

    cfg, p, x, dy = _ep_case(route, cuda_device)
    card = Mesh([[cuda_device] * tp], ("data", "model"))
    host = Mesh([[torch.device("cpu")] * tp], ("data", "model"))
    y, aux, g = _ep_run(cfg, p, x, dy, card)
    y2, aux2, g2 = _ep_run(cfg, p, x, dy, card)
    cfg_c, p_c, x_c, dy_c = _ep_case(route, "cpu")
    yc, auxc, gc = _ep_run(cfg_c, p_c, x_c, dy_c, host)
    assert y.device.type == "cuda" and torch.isfinite(y).all()
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert all(torch.equal(g[k], g2[k]) for k in g)
    torch.testing.assert_close(aux.cpu(), auxc, rtol=1e-5, atol=0)
    for name, a, b in [("y", y, yc)] + [(k, g[k], gc[k]) for k in g]:
        assert rel_err(a.cpu(), b) <= 1e-4, name


def _tp_case(device):
    """Reduced Qwen2-7B (4 query heads over 2 KV heads, d_ff 512) in
    float32 through K2, its weights and a batch on ``device``."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params

    cfg = ARCHS["qwen2-7b"].reduced().with_(use_flash_attention=True)
    params = init_params(model_zoo.param_defs(cfg), 3, torch.float32,
                         device=device)
    g = torch.Generator(device="cpu").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (4, 65), generator=g)
    batch = {"tokens": tokens[:, :-1].to(device),
             "labels": tokens[:, 1:].to(device)}
    job = JobConfig(model=cfg, shape=InputShape("tp", 64, 4, "train"),
                    n_workers=4)
    return cfg, job, params, batch


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_launches_k2_per_rank_on_rank_devices(cuda_device,
                                                              tp):
    """A (1, tp) mesh over the visible cards (cuda:0 repeated where there
    are fewer): every rank multiplies by its slice of wq and w_gate on its
    own device, K2 runs once per rank where the unmeshed step runs it once
    (each of its kernels tp times as often), and the loss, its gradients
    and the logits agree with the unmeshed step on the card to 1e-4 of each
    tensor's largest entry."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model_zoo
    from repro_torch.models.common import mesh_context
    from repro_torch.train.train_step import make_loss_grad

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.seen.append((tuple(args[1].shape), args[1].device))
            return func(*args, **(kwargs or {}))

    n = torch.cuda.device_count()
    devs = [torch.device("cuda", r % n) for r in range(tp)]
    mesh = Mesh([devs], ("data", "model"))
    cfg, job, params, batch = _tp_case(cuda_device)
    step = make_loss_grad(cfg, job, "none")
    mask = torch.ones(4, device=cuda_device)
    runs, counts = {}, {}
    for name, on in (("none", None), ("mesh", mesh)):
        ops.reset_launch_counts()
        with mesh_context(on):
            runs[name] = step(params, batch, mask)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
    flash = {k for k, v in counts["none"].items() if v}
    assert flash and all(k.startswith("flash_attention") for k in flash)
    assert {k: counts["mesh"][k] for k in counts["mesh"]} == \
        {k: tp * v for k, v in counts["none"].items()}
    rec = Products()
    with mesh_context(mesh), torch.no_grad(), rec:
        y, _ = model_zoo.forward(params, cfg, {"tokens": batch["tokens"]},
                                 remat="none")
    y0, _ = model_zoo.forward(params, cfg, {"tokens": batch["tokens"]},
                              remat="none")
    d, dh = cfg.d_model, cfg.resolved_head_dim
    for shape in ((d, cfg.num_heads // tp * dh), (d, cfg.d_ff // tp)):
        on = [dev for s, dev in rec.seen if s == shape]
        assert len(on) >= tp * cfg.num_layers, shape
        assert set(on) == set(devs), (shape, set(on))
    assert y.device.type == "cuda"
    assert rel_err(y, y0) <= 1e-4
    (g1, l1, _), (g0, l0, _) = runs["mesh"], runs["none"]
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=0)
    for k in ("wq", "wk", "wo", "bq"):
        assert rel_err(g1["layers"]["attn"][k], g0["layers"]["attn"][k]) \
            <= 1e-4, k
    for k in ("w_gate", "w_down"):
        assert rel_err(g1["layers"]["mlp"][k], g0["layers"]["mlp"][k]) \
            <= 1e-4, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tp", [((2, 512, 64, 64, 1, 128, 256), 4),
                                      ((1, 512, 56, 64, 1, 64, 256), 2)])
def test_k3_per_rank_is_the_whole_launch_heads(cuda_device, shape, tp,
                                               dtype):
    """K3 on each rank's heads (contiguous, one group, so B and C whole)
    gives the whole launch's outputs on those heads bit for bit: a rank's
    16 heads are one of the whole launch's slabs, and a rank's 28 are the
    whole launch's slabs [16r', ...) cut 16 + 12 in its own slabs, each
    head's arithmetic the same."""
    xh, dt, a_h, bm, cm = ssd_inputs(shape, dtype, cuda_device)
    q, h = shape[6], shape[2]
    whole = ssd_scan.ssd_chunk(xh, dt, a_h, bm, cm, chunk=q)
    per = h // tp
    for r in range(tp):
        heads = slice(r * per, (r + 1) * per)
        got = ssd_scan.ssd_chunk(xh[:, :, heads].contiguous(),
                                 dt[:, :, heads].contiguous(),
                                 a_h[heads].contiguous(), bm, cm, chunk=q)
        for name, a, w in zip(K3_OUTS, got, whole):
            assert torch.equal(a, w[:, :, heads]), (r, name)


def test_seq_split_k2_is_the_whole_forward_by_rows(cuda_device):
    """K2 on each rank's 128 query rows at q_offset r·128 (a multiple of
    the 64-row tile) against all 512 keys gives the whole forward's rows
    bit for bit; the keys' and values' gradients summed over the ranks
    agree with the whole backward's to bf16 rounding (7.8e-3 of the
    largest entry, K2_TOL's rows)."""
    shape = (2, 512, 512, 8, 2, 128, True, None, 0)
    q, k, v, do = k2_inputs(shape, torch.bfloat16, cuda_device)
    whole = ops.flash_mha(q, k, v, causal=True)
    kl, vl = (x.clone().requires_grad_() for x in (k, v))
    outs = []
    for r in range(4):
        rows = slice(128 * r, 128 * (r + 1))
        outs.append(ops.flash_mha(q[:, rows], kl, vl, causal=True,
                                  q_offset=128 * r))
        assert torch.equal(outs[-1], whole[:, rows]), r
    dk, dv = torch.autograd.grad(torch.cat(outs, dim=1), (kl, vl), do)
    k0, v0 = (x.clone().requires_grad_() for x in (k, v))
    dk0, dv0 = torch.autograd.grad(ops.flash_mha(q, k0, v0, causal=True),
                                   (k0, v0), do)
    assert rel_err(dk, dk0) <= 7.8e-3 and rel_err(dv, dv0) <= 7.8e-3


def _split_case(device):
    """Reduced Mamba2 in float32, its weights and a batch of 4 × 64 tokens
    drawn on the CPU, then moved to ``device``."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map

    cfg = ARCHS["mamba2-1.3b"].reduced()
    params = init_params(model_zoo.param_defs(cfg), 4, torch.float32,
                         device="cpu")
    g = torch.Generator(device="cpu").manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (4, 65), generator=g)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    job = JobConfig(model=cfg, shape=InputShape("tp", 64, 4, "train"),
                    n_workers=4)
    return cfg, job, *tree_map(lambda t: t.to(device), (params, batch))


def _split_runs(cfg, job, params, batch, mesh, device):
    """forward, a prefill and make_loss_grad under ``mesh``, with the
    launch counts of the prefill."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import init_params, mesh_context
    from repro_torch.train.train_step import make_loss_grad

    caches = init_params(model_zoo.cache_defs(cfg, 4, 64), 0, torch.float32,
                         device=device)
    with mesh_context(mesh):
        with torch.no_grad():
            y, _ = model_zoo.forward(params, cfg, batch, remat="none")
            ops.reset_launch_counts()
            yp, c = model_zoo.prefill(params, cfg,
                                      {"tokens": batch["tokens"]}, caches)
            counts = ops.launch_counts()
        g, loss, _ = make_loss_grad(cfg, job, "full")(
            params, batch, torch.tensor([1.0, 0.0, 1.0, 1.0], device=device))
    return {"logits": y, "prefill": yp, "h": c["h"], "loss": loss,
            "wx": g["layers"]["ssm"]["wx"], "wo": g["layers"]["ssm"]["wo"],
            "lm_head": g["lm_head"]}, counts


def test_split_ssm_block_and_vocab_loss_on_the_card_match_the_cpu(
        cuda_device):
    """Reduced Mamba2 on a (1, 4) mesh of cuda:0 against a (1, 4) mesh of
    host devices: the forward's logits, the prefill's logits and state
    (K3 once a rank and layer) and ``make_loss_grad``'s vocab-parallel
    loss and gradients (the SSD's training route once a rank), float32 at
    1e-4 of each tensor's largest entry (the loss at 1e-5 relative)."""
    from repro_torch.launch.mesh import Mesh

    card = Mesh([[cuda_device] * 4], ("data", "model"))
    host = Mesh([[torch.device("cpu")] * 4], ("data", "model"))
    cfg, job, params, batch = _split_case(cuda_device)
    got, counts = _split_runs(cfg, job, params, batch, card, cuda_device)
    torch.cuda.synchronize()
    cfg, job, params, batch = _split_case("cpu")
    want, _ = _split_runs(cfg, job, params, batch, host, "cpu")
    assert counts["ssd_chunk"] == 4 * cfg.num_layers
    torch.testing.assert_close(got["loss"].cpu(), want["loss"], rtol=1e-5,
                               atol=0)
    for k in ("logits", "prefill", "h", "wx", "wo", "lm_head"):
        assert rel_err(got[k].cpu(), want[k]) <= 1e-4, k


def test_expert_parallel_routing_is_exact_with_the_sequence_split(
        cuda_device):
    """Reduced Qwen2-MoE in float32 with ``attn_seq_shard`` on a (1, 4)
    mesh of cuda:0, 2048 positions as in the expert-parallel phase: its
    attention splits over the query sequence (each rank's rows of q, k
    and v are the whole run's, its 512 rows one of the whole core's
    blocks, ``wo`` on the joined rows), and every MoE block routes as no
    mesh's, exactly (that phase's check)."""
    import contextlib

    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model_zoo, moe
    from repro_torch.models.common import init_params, mesh_context

    cfg = ARCHS["qwen2-moe-a2.7b"].reduced().with_(attn_seq_shard=True)
    params = init_params(model_zoo.param_defs(cfg), 5, torch.float32,
                         device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=g)
    tokens = tokens.to(cuda_device)
    mesh = Mesh([[cuda_device] * 4], ("data", "model"))
    routes = {}

    @contextlib.contextmanager
    def recorded(out):
        route = moe._route

        def recording(x2d, router, moe_cfg):
            res = route(x2d, router, moe_cfg)
            out.append(res[0])
            return res

        moe._route = recording
        try:
            yield
        finally:
            moe._route = route

    for name, on in (("none", None), ("mesh", mesh)):
        routes[name] = []
        with recorded(routes[name]), torch.no_grad(), mesh_context(on):
            model_zoo.forward(params, cfg, {"tokens": tokens}, remat="none")
    none, meshed = routes["none"], routes["mesh"]
    assert len(meshed) == 4 * len(none)
    for i, r in enumerate(none):
        for rank in range(4):
            assert torch.equal(meshed[4 * i + rank], r), (i, rank)


def test_deepseek_v2_published_block_bf16_step_against_the_reference(
        cuda_device):
    """DeepSeek-V2-Lite's published block at its published widths and
    depth 1 + 1 (MLA with YaRN's rope, the dense layer 0, one MoE layer
    holding 8 of 64 experts, the 12,800-row vocabulary slice), as the
    benchmark's cell ``deepseek-v2-lite.zoo-bf16`` configures it: one bf16
    loss/grad step of the zoo's (bf16 parameters, 8 rows of 1023 tokens, a
    preempted worker) against the benchmark's plain float32 reference on
    the same weights, TF32 off. The loss's relative gap and the gradient
    norms' (`bench.harness.check`'s measures) lie within the cell's own
    limits, which its 14 layers and 3 iterations set."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench.harness import check, spec, weights as wmod
    from bench.reference.elastic_sgd import row_weights
    from bench.reference.precision import products
    from repro_torch.train.train_step import make_loss_grad

    cell = spec.cell("deepseek-v2-lite.zoo-bf16")
    conf = {**cell.config, "num_hidden_layers": 2}
    cfg = cell.port.model_config(conf, cell.traffic)
    assert (cfg.first_dense_layers, cfg.moe.held, cfg.dtype) == (
        1, 8, "bfloat16")
    b, s = 8, 1023
    job = JobConfig(model=cfg, shape=InputShape("t", s, b, "train"),
                    n_workers=8)
    leaves = cell.reference.leaves(conf)
    seed = 3200000077
    params = cell.port.to_program(
        {k: v.to(torch.bfloat16) for k, v in
         wmod.make_all(leaves, seed, cuda_device).items()})
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    toks = torch.randint(0, conf["vocab_size"], (b, s + 1), generator=gen,
                         device=cuda_device)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    mask = np.asarray([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    grads, loss, aux = make_loss_grad(cfg, job, remat="none")(
        params, {"tokens": tokens, "labels": labels},
        torch.from_numpy(mask).to(cuda_device))
    prog = {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in cell.port.from_program(grads, 0).items()}
    assert float(aux) > 0 and torch.isfinite(loss)
    del grads, params

    w = wmod.make_all(leaves, seed, cuda_device)
    for x in w.values():
        x.requires_grad_(True)
    rows = torch.from_numpy(row_weights(mask, b)).to(cuda_device)
    with products("float32"):
        ref_loss = cell.reference.loss(w, conf, tokens, labels,
                                       rows[:, None].expand(b, s))
        ref = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(
            w, torch.autograd.grad(ref_loss, list(w.values())))}
    assert set(prog) == set(ref)
    gap = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    assert gap <= cell.limits["loss"], gap
    assert check._rel_norm_gap(prog, ref) <= cell.limits["grad"]
