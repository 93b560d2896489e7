"""A run of the harness at a tiny size on the CPU, the look for a card
skipped: its result line, its import graph, and ``correct`` under the
faults a training cell can have, planted in the program underneath."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench import calibrate, run as bench_run
from bench.harness import check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ["qwen2-7b.megabatch-f32", "qwen2-7b.zoo-bf16"]
SEED = 2**31 + 77


def one_run(cell, trace=False):
    return bench_run.run(cell, SEED, 0.2, trace, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_result_line_holds_exactly_the_result_keys(tiny_cell, name):
    cell = tiny_cell(name)
    result, lines = one_run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert set(result["metrics"]) == {"grid_tokens_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert list(result["check"]) == list(check.NAMES)
    assert result["attempted"] > 0 and result["failed"] == 0
    json.loads(json.dumps(result))
    assert lines[-4:] == [f"{k}: {v['value']!r} (limit {v['limit']!r})"
                          for k, v in result["check"].items()]


def test_traced_line_names_per_layer_metrics(tiny_cell):
    cell = tiny_cell(CELLS[0])
    result, _ = one_run(cell, trace=True)
    # on the CPU only the metrics that need no device trace can read
    assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "mfu" not in result["metrics"]


def test_megabatch_program_is_correct_at_a_tiny_size(tiny_cell):
    result, _ = one_run(tiny_cell(CELLS[0]))
    assert result["correct"], result["check"]


def test_zoo_program_is_correct_at_a_tiny_size(tiny_cell):
    """So that the faults below turn a correct run false."""
    result, _ = one_run(tiny_cell(CELLS[1]))
    assert result["correct"], result["check"]


def _unchanged(monkeypatch, name):
    if name == CELLS[0]:
        from repro_torch.kernels import ops
        monkeypatch.setattr(ops, "fused_elastic_update",
                            lambda p, v, *a, **k: (p, v))
    else:
        from repro_torch.optim import sgd
        from repro_torch.train import zoo_program
        real = sgd.get_optimizer

        def frozen(*a, **k):
            opt = real(*a, **k)
            return sgd.Optimizer(opt.init, lambda g, s, p, lr: (p, s))
        monkeypatch.setattr(zoo_program, "get_optimizer", frozen)


def _half_batch(monkeypatch, name):
    def halve(w):
        w = w.clone()
        flat = w.reshape(-1, w.shape[-1])
        live = torch.nonzero(flat.sum(-1) > 0).flatten()
        flat[live[1::2]] = 0
        return w

    if name == CELLS[0]:
        from repro_torch.train import megabatch
        real = megabatch._weights

        def weights(masks, b, s, label_mask=None):
            w = real(masks, b, s, label_mask).view(masks.shape[0], b, s)
            return halve(w).reshape(masks.shape[0], b * s)
        monkeypatch.setattr(megabatch, "_weights", weights)
    else:
        from repro_torch.train import train_step
        real = train_step.elastic_token_weights
        monkeypatch.setattr(train_step, "elastic_token_weights",
                            lambda *a, **k: halve(real(*a, **k)))


def _token(monkeypatch, name):
    from repro_torch.train import trainer
    real = trainer.stack_batches

    def altered(*a, **k):
        data = real(*a, **k)
        data["tokens"][0, 0, 0] = (data["tokens"][0, 0, 0] + 1) % 256
        return data
    monkeypatch.setattr(trainer, "stack_batches", altered)


def _answer(monkeypatch, name):
    """The loss a step reports off by one part in a hundred."""
    from repro_torch.train import megabatch, zoo_program

    mod, attr = ((megabatch, "make_megabatch_step") if name == CELLS[0]
                 else (zoo_program, "make_zoo_step"))
    real = getattr(mod, attr)

    def make(*a, **k):
        step = real(*a, **k)

        def altered(*sa, **sk):
            out, loss = step(*sa, **sk)
            return out, loss * 1.01
        return altered
    monkeypatch.setattr(mod, attr, make)


def _swap(monkeypatch, name):
    """The grid's two replicas trade carries at the end of every call."""
    from repro_torch.train import trainer
    real = trainer.train_batched

    def swap(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                swap(v)
        elif isinstance(tree, (tuple, list)):
            for v in tree:
                swap(v)
        else:
            tree.copy_(tree.flip(1))

    def swapped(*a, **k):
        res = real(*a, **k)
        swap(res.final_state.model)
        return res
    monkeypatch.setattr(trainer, "train_batched", swapped)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "token": _token, "answer": _answer, "replicas_swapped": _swap}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_underneath_turns_correct_false(tiny_cell, monkeypatch,
                                                name, fault):
    FAULTS[fault](monkeypatch, name)
    result, _ = one_run(tiny_cell(name))
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_reads_below_it(tiny_cell, name):
    cell = tiny_cell(name)
    recs = calibrate.readings(cell, SEED, torch.device("cpu"), True)
    prog = next(r for r in recs if r["kind"] == "program")
    ctrl = next(r for r in recs if r["kind"] == "control")
    assert not check.judge(ctrl, cell.limits)
    for k in ("grad", "change"):
        assert ctrl[k] >= 3 * prog[k], (k, prog[k], ctrl[k])
    for r in recs:
        if r["kind"] == "fault":
            assert not check.judge(r, cell.limits), r["fault"]


def test_import_graph_holds_no_jax(tmp_path):
    script = f"""
import json, sys
sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'src')!r}]
import torch
torch.set_num_threads(1)
from bench import run, calibrate, peaks
from bench.harness import spec
TINY = {{"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 96,
        "vocab_size": 256, "num_hidden_layers": 2}}
for name in {CELLS!r}:
    c = spec.cell(name)
    c.config = {{**c.config, **TINY}}
    c.traffic = {{**c.traffic, "batch": 8, "seq_len": 9, "chunk_ticks": 2}}
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
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top & {
        "jax", "jaxlib", "flax", "repro"}


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("the look for a card passes here")
    assert bench_run.main(["--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_the_run_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "repro_torch" in out.stderr


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    before = set(bench_run.banned_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    monkeypatch.setitem(sys.modules, "repro.fake",
                        types.ModuleType("repro.fake"))
    found = set(bench_run.banned_modules()) - before
    assert found == {"repro.fake"}
