"""Fixtures of the benchmark's own tests: a cell cut to a size a CPU test
holds, and the decision whether a card is there (taken in a fixture, never
at import)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: published widths cut to a CPU test's size (the traffic's shapes too), in
#: float32: bf16 at these widths is off the cells' limits by rounding alone
TINY_CONFIG = {"hidden_size": 64, "num_attention_heads": 4,
               "num_key_value_heads": 2, "intermediate_size": 96,
               "vocab_size": 256, "num_hidden_layers": 2}
TINY_TRAFFIC = {"batch": 8, "seq_len": 9, "chunk_ticks": 2, "setup_ticks": 4,
                "dtype": "float32", "flash_attention": False}


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell of BENCHMARK.json at a tiny size."""
    import torch

    from bench.harness import spec

    torch.set_num_threads(1)

    def make(name, **traffic):
        c = spec.cell(name)
        c.config = {**c.config, **TINY_CONFIG}
        c.traffic = {**c.traffic, **TINY_TRAFFIC, **traffic}
        return c

    return make


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's sizes and kernels run "
                    "only on the card")
    return torch.device("cuda", 0)
