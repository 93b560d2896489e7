"""The cell ``deepseek-v2-lite.zoo-bf16`` at a tiny float32 size on the
CPU, the look for a card skipped: its result is correct, the faults a
training cell can have turn it false, its control fails, and its import
graph holds no JAX. Also its configuration's FLOP count, pinned to a
hand-worked value, and the readers of its spans; and, on the card only,
the program, control and faults at the cell's own size."""
import json
import os
import subprocess
import sys

import pytest
import torch

from bench import calibrate, peaks, run as bench_run
from bench.harness import check, spec
from bench.test_bench_harness import _answer, _half_batch, _token

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "deepseek-v2-lite.zoo-bf16"
SEED = 2**31 + 91
#: MLA and MoE cut to a CPU test's size on top of `conftest.TINY_CONFIG`:
#: 3 layers (1 dense, 2 MoE), 4 of 16 experts held
TINY_KEYS = {"num_hidden_layers": 3, "num_key_value_heads": 4,
             "kv_lora_rank": 32, "qk_rope_head_dim": 8,
             "qk_nope_head_dim": 16, "v_head_dim": 16,
             "moe_intermediate_size": 24, "n_routed_experts": 4,
             "router_experts": 16}
SPANS = ("moe_route_ms", "moe_experts_ms", "mla_core_ms")


@pytest.fixture
def cell(tiny_cell):
    c = tiny_cell(NAME)
    c.config = {**c.config, **TINY_KEYS}
    return c


def one_run(cell, trace=False):
    return bench_run.run(cell, SEED, 0.2, trace, torch.device("cpu"))


def test_the_cell_is_correct_at_a_tiny_size(cell):
    result, _ = one_run(cell)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"grid_tokens_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", [_half_batch, _token, _answer],
                         ids=["half_batch", "token", "answer"])
def test_a_fault_underneath_turns_correct_false(cell, monkeypatch, fault):
    fault(monkeypatch, NAME)
    result, _ = one_run(cell)
    assert result["correct"] is False, result["check"]


def test_the_fp8_control_fails(cell):
    assert cell.control == "fp8"
    recs = calibrate.readings(cell, SEED, torch.device("cpu"), True)
    prog = next(r for r in recs if r["kind"] == "program")
    ctrl = next(r for r in recs if r["kind"] == "control")
    assert check.judge(prog, cell.limits)
    assert not check.judge(ctrl, cell.limits)


def test_the_new_metrics_are_the_cells_alone():
    names = {m["name"] for m in spec.cell(NAME).per_layer}
    assert set(SPANS) <= names
    for other in ("qwen2-7b.megabatch-f32", "qwen2-7b.zoo-bf16"):
        assert not set(SPANS) & {m["name"] for m in
                                 spec.cell(other).per_layer}
    for name in SPANS:
        assert spec.metric_reader(name).read({"ticks": 4}) is None


def test_mfu_flops_of_a_cell_step():
    c = spec.cell(NAME)
    conf, ref = c.config, c.reference
    mla = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    moe = 3 * 2048 * 2816 + 2048 * 64 + 6 * 8 / 64 * 3 * 2048 * 1408
    n = 14 * mla + 3 * 2048 * 10944 + 13 * moe + 2048 * 12800
    assert ref.matmul_params(conf) == pytest.approx(n, rel=1e-12)
    assert ref.matmul_params(conf) == pytest.approx(597.08e6, rel=1e-4)
    want = 6 * n * 8 * 1023 + 6 * 14 * 16 * 320 * 8 * (1023 * 1024 / 2)
    assert ref.step_flops(conf, 8, 1023) == pytest.approx(want, rel=1e-12)
    facts = {"peaks": peaks.card_peaks("NVIDIA H100 80GB HBM3"),
             "traffic": c.traffic, "conf": conf, "reference": ref,
             "trace_window_s": 2.0, "cell_steps": 6}
    assert spec.metric_reader("mfu").read(facts) == pytest.approx(
        100 * 6 * want / 2.0 / 989e12, rel=1e-12)


def test_import_graph_holds_no_jax():
    script = f"""
import json, sys
sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]
import torch
torch.set_num_threads(1)
from bench import run
from bench.harness import spec
TINY = {{"hidden_size": 64, "num_attention_heads": 4,
        "intermediate_size": 96, "vocab_size": 256, **{TINY_KEYS!r}}}
c = spec.cell({NAME!r})
c.config = {{**c.config, **TINY}}
c.traffic = {{**c.traffic, "batch": 8, "seq_len": 9, "chunk_ticks": 2,
             "setup_ticks": 4, "dtype": "float32"}}
for m in c.per_layer:
    spec.metric_reader(m["name"])
run.run(c, 3, 0.1, False, torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env={**os.environ,
                                                      "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.cuda
def test_program_passes_and_control_fails_at_the_cells_size(card):
    """On the card at the cell's own size: set-up's iterations pass the
    cell's limits, the fp8 control and the half-batch, token and answer
    faults fail them. ``python -m pytest -q -m cuda
    bench/test_bench_deepseek.py``; elsewhere this skips."""
    c = spec.cell(NAME)
    recs = calibrate.readings(c, 2024, card, controls=True)
    by_kind = {r["kind"]: r for r in recs if r["kind"] != "fault"}
    assert check.judge(by_kind["program"], c.limits)
    assert not check.judge(by_kind["control"], c.limits)
    for r in recs:
        if r["kind"] == "fault" and r["fault"] != "state_unchanged":
            assert not check.judge(r, c.limits), r["fault"]
