"""The port on the card: the CUDA kernels against their plain versions
(K1 bit for bit; K2 forward and backward within stated tolerances), the
engine's random bits and RNG-free market on CUDA against the CPU, a small
megabatched run through K1 and a small zoo run through K2.

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
from repro_torch.kernels import ops, ref
from repro_torch.kernels.elastic_update import elastic_sgd_update
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
]

#: max |kernel - plain| / max |plain|. float32: both sum in float32 in
#: different orders (fused multiply-adds in the kernel). bfloat16: inputs
#: and outputs round to 8 bits of mantissa (0.4 % of the largest value per
#: ulp), the arithmetic stays float32 on both sides.
K2_TOL = {torch.float32: {"fwd": 2e-5, "bwd": 1e-4},
          torch.bfloat16: {"fwd": 1e-2, "bwd": 2e-2}}


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
    through the plain version; each kernel launched once."""
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
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dkdv"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
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
    bad = [
        (qt.double(), kt.double(), vt.double(), {}),
        (qt.half(), kt.half(), vt.half(), {}),
        (qt[..., :32], kt[..., :32], vt[..., :32], {}),
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
