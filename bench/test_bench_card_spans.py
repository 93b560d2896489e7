"""On the card, at each cell's own size: a short traced window split by
the program's spans (`harness.spans`). ``python -m pytest -q -m cuda
bench/test_bench_card_spans.py`` on a machine with the card; elsewhere
these skip."""
import gc
import time

import pytest

from bench import run as bench_run
from bench.harness import spans as sp
from bench.harness import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-7b.megabatch-f32",
                                  "qwen2-7b.zoo-bf16"])
def test_a_traced_window_splits_its_device_time_by_the_spans(card, name):
    """The program's spans have no device twin, one ``engine.tick`` opens
    a tick, every device operation's launch is found, and the device time
    launched under no span stays under 5 % of the window's busy time."""
    import torch
    from repro_torch.spans import NAMES

    cell = spec.cell(name)
    window = bench_run.Window(trace=True, on_card=True)
    out = cell.entry.measure(cell, 2**31 + 2024, 2.0, window, card,
                             time.perf_counter())
    facts = {**out.facts, **window.facts()}
    assert not {n for n, _, _ in facts["trace"]["device"]} & set(NAMES)
    split = sp.split(facts["trace"], NAMES)
    assert split["by_name"]["engine.tick"]["count"] == facts["ticks"]
    assert split["unpaired"] == 0
    assert split["unattributed_s"] < 0.05 * facts["busy_s"], split
    del out, facts
    gc.collect()
    torch.cuda.empty_cache()
