"""The port on the card: the CUDA kernel against its plain version, the
engine's random bits and RNG-free market on CUDA against the CPU, and a
small megabatched run through the kernel.

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
    assert ops.launch_counts() == {"elastic_sgd_update": 1}
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
    assert ops.launch_counts() == {"elastic_sgd_update": n_ticks}
    for field in ("iterations", "ys", "total_time", "total_cost"):
        np.testing.assert_array_equal(getattr(gpu, field),
                                      getattr(cpu, field))
    np.testing.assert_allclose(np.nan_to_num(gpu.errors),
                               np.nan_to_num(cpu.errors), rtol=5e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gpu.final_model["p"].cpu().numpy(),
                               cpu.final_model["p"].numpy(), rtol=5e-4,
                               atol=1e-5)
