"""On the card, at each cell's own size: the program's set-up iterations
pass the cell's limits and the control (the reference one precision below)
fails them. ``python -m pytest -q -m cuda bench/test_bench_card.py`` on a
machine with the card; elsewhere these skip."""
import pytest

from bench import calibrate
from bench.harness import check, spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-7b.megabatch-f32",
                                  "qwen2-7b.zoo-bf16"])
def test_program_passes_and_control_fails_at_the_cells_size(card, name):
    cell = spec.cell(name)
    recs = calibrate.readings(cell, 2024, card, controls=True)
    by_kind = {r["kind"]: r for r in recs if r["kind"] != "fault"}
    assert check.judge(by_kind["program"], cell.limits)
    assert not check.judge(by_kind["control"], cell.limits)
    # an input token altered is within bf16 rounding at the zoo cell's
    # size on some seeds (PERF.md), so only these faults are held here
    for r in recs:
        if r["kind"] == "fault" and r["fault"] in ("half_batch", "answer"):
            assert not check.judge(r, cell.limits), r["fault"]
