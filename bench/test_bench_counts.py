"""The operation and byte counts behind ``mfu``, ``k1_roofline`` and
``k2_roofline``, pinned to hand-worked values."""
import math

import pytest

from bench import peaks
from bench.harness import spec

H100 = peaks.card_peaks("NVIDIA H100 80GB HBM3")


def reader(name):
    return spec.metric_reader(name)


def test_peaks_by_card_name():
    assert H100.label == "H100 SXM"
    assert (H100.hbm_bytes_per_s, H100.float32, H100.bfloat16) == (
        3.35e12, 67e12, 989e12)
    assert peaks.card_peaks("NVIDIA H100 PCIe") is None
    assert peaks.card_peaks("cpu") is None


def test_k1_bound_at_the_main_paths_shape():
    # 2 replicas × 1,556,113,920 float32 parameters: 20 bytes each
    # (read p, v, g; write p, v) at 3.35 TB/s
    k1 = reader("k1_roofline")
    assert k1.bound_s(2, 1556113920, H100) * 1e3 == pytest.approx(
        18.58, abs=5e-3)
    conf = spec.cell("qwen2-7b.megabatch-f32").config
    ref = spec.cell("qwen2-7b.megabatch-f32").reference
    assert k1.param_count(ref.leaves(conf)) == 1556113920


@pytest.mark.parametrize("kernel,bound_ms,by", [
    ("flash_fwd_tc_kernel", 0.070, "bytes"),
    ("flash_bwd_delta_kernel", 0.035, "bytes"),
    ("flash_bwd_dkdv_tc_kernel", 0.121, "operations"),
    ("flash_bwd_dq_tc_kernel", 0.091, "operations")])
def test_k2_bounds_at_head_dim_112(kernel, bound_ms, by):
    # B 8, S = T = 1023, H = Hkv = 32, D 112, causal
    k2 = reader("k2_roofline")
    shape = (8, 1023, 32, 32, 112)
    assert k2.bound_s(kernel, *shape, H100) * 1e3 == pytest.approx(
        bound_ms, abs=5e-4)
    flops, nbytes = k2.work(kernel, *shape)
    t_ops, t_bytes = flops / H100.bfloat16, nbytes / H100.hbm_bytes_per_s
    assert (t_ops >= t_bytes) == (by == "operations")


def test_mfu_flops_of_a_qwen2_cell_step():
    cell = spec.cell("qwen2-7b.megabatch-f32")
    conf, ref = cell.config, cell.reference
    # per layer: q, k, v 3584·4608; o 3584·3584; gated MLP 3·3584·18944
    assert ref.matmul_params(conf) == 2 * (3584 * 4608 + 3584 * 3584
                                           + 3 * 3584 * 18944) \
        + 3584 * 152064 == 1011089408
    # 32 rows of 63 positions: 6·N·D plus the causal attention
    want = 6 * 1011089408 * 32 * 63 + 12 * 2 * 28 * 128 * 32 * (63 * 64 / 2)
    assert ref.step_flops(conf, 32, 63) == pytest.approx(want, rel=1e-12)
    facts = {"peaks": H100, "traffic": {"batch": 32, "seq_len": 64,
                                        "dtype": "float32"},
             "conf": conf, "reference": ref, "trace_window_s": 2.0,
             "cell_steps": 6, "running_steps": 1}
    # every computed cell-step counts, whether the market ran it or not
    assert reader("mfu").read(facts) == pytest.approx(
        100 * 6 * want / 2.0 / 67e12, rel=1e-12)


def test_end_to_end_readers():
    facts = {"setup_s": 21.5, "window_s": 10.5, "cell_steps": 48,
             "tokens_per_cell_step": 32 * 63}
    assert reader("setup_s").read(facts) == 21.5
    assert reader("grid_tokens_per_s").read(facts) == pytest.approx(
        48 * 32 * 63 / 10.5, rel=1e-12)


def test_readers_return_nothing_without_a_trace():
    ref = spec.cell("qwen2-7b.megabatch-f32").reference
    facts = {"kernels": None, "busy_s": None, "window_s": 3.0, "ticks": 5,
             "peaks": None, "peak_window_bytes": 0, "running_steps": 0,
             "cell_steps": 10, "conf": {}, "traffic": {}, "grid": (1, 2),
             "leaves": [], "reference": ref}
    for name in ("launches_per_tick", "device_idle_pct", "peak_mem_gb",
                 "mfu", "k1_roofline", "k2_roofline"):
        assert reader(name).read(facts) is None, name


def test_a_reference_without_flop_counts_reads_no_mfu():
    import types
    facts = {"peaks": H100, "traffic": {"batch": 8, "seq_len": 9,
                                        "dtype": "bfloat16"},
             "conf": {}, "reference": types.ModuleType("no_counts"),
             "trace_window_s": 1.0, "cell_steps": 4, "kernels": {}}
    assert reader("mfu").read(facts) is None
    assert reader("k2_roofline").read(facts) is None


def test_k1_and_k2_readers_over_a_trace():
    k1, k2 = reader("k1_roofline"), reader("k2_roofline")
    conf = spec.cell("qwen2-7b.zoo-bf16").config
    leaves = spec.cell("qwen2-7b.zoo-bf16").reference.leaves(conf)
    bound = k1.bound_s(2, k1.param_count(leaves), H100)
    ctx = {"peaks": H100, "grid": (1, 2), "leaves": leaves, "conf": conf,
           "running_steps": 1,
           "reference": spec.cell("qwen2-7b.zoo-bf16").reference,
           "traffic": {"batch": 8, "seq_len": 1024},
           "kernels": {"elastic_update_kernel(float*, ...)": [4, 4 * 0.025],
                       "void flash_fwd_tc_kernel<128>(...)": [8, 8 * 3e-4],
                       "ampere_sgemm_128x64_nn": [100, 1.0]}}
    # one running row of two: half the bytes of the whole grid
    assert k1.read(ctx) == pytest.approx(100 * bound / 2 / 0.1, rel=1e-9)
    fwd = k2.bound_s("flash_fwd_tc_kernel", 8, 1023, 28, 4, 128, H100)
    assert k2.read(ctx) == pytest.approx(100 * fwd / 3e-4, rel=1e-9)
    assert math.isfinite(reader("launches_per_tick").read(
        {**ctx, "ticks": 4}))
