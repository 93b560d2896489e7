"""The port's host spans (`repro_torch.spans`): a tiny float32 megabatch
call and tiny bf16 and float32 zoo calls (one with DeepSeek-V2's MLA and
MoE block) under ``torch.profiler`` on the CPU record each span as often
as the run implies, as a plain function range nested where its layer is,
and a traced run is bit for bit an untraced one."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.sim import engine
from repro_torch.train.trainer import train_batched, train_zoo
from repro_torch.tree import tree_leaves

N_TICKS = 5
SEEDS = [0, 1]
#: the spans each step opens under ``engine.tick``
UNDER_TICK = ("engine.market", "engine.gate", "step.forward",
              "step.backward", "step.optimizer")
#: the model's spans, each under ``step.forward``
UNDER_FORWARD = ("moe.route", "moe.experts", "mla.core")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenarios(n=2):
    bids = np.tile([0.9, 0.9, 0.5, 0.5], (8, 1))
    return [engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0),
                            alpha=0.1, bid_schedule=bids, rt_kind="exp",
                            rt_lam=2.0, rt_delta=0.05, idle_step=0.5,
                            name=f"s{i}") for i in range(n)]


def _megabatch(**kw):
    cfg = ARCHS["qwen2-7b"].reduced().with_(
        d_model=64, num_heads=2, num_kv_heads=1, d_ff=128, vocab_size=256,
        head_dim=32)
    job = JobConfig(model=cfg, shape=InputShape("t", 16, 8, "train"),
                    n_workers=4, learning_rate=0.1)
    return train_batched(job, _scenarios(), SEEDS, n_ticks=N_TICKS,
                         megabatch=True, use_fused_update=True,
                         device="cpu", **kw)


def _zoo(dtype="bfloat16", **kw):
    cfg = ARCHS["qwen2-7b"].reduced().with_(
        d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64,
        vocab_size=128, dtype=dtype, param_dtype=dtype,
        use_flash_attention=True)
    job = JobConfig(model=cfg, shape=InputShape("t", 24, 8, "train"),
                    n_workers=4, learning_rate=0.1)
    return train_zoo(job, _scenarios(), SEEDS, n_ticks=N_TICKS,
                     device="cpu", **kw)


def _zoo_mla_moe(**kw):
    """DeepSeek-V2's block, bf16, tiny: one dense layer, then two MoE
    layers holding 4 of 8 experts, with a shared expert."""
    base = ARCHS["deepseek-v2-lite-16b"].reduced()
    cfg = base.with_(
        d_model=32, num_heads=2, num_kv_heads=2, d_ff=24, d_ff_dense=48,
        num_layers=3, first_dense_layers=1, vocab_size=128,
        dtype="bfloat16", param_dtype="bfloat16",
        moe=dataclasses.replace(base.moe, num_experts=8,
                                num_experts_unpadded=8, d_ff_expert=24,
                                d_ff_shared=24, experts_held=4,
                                norm_topk_prob=False))
    job = JobConfig(model=cfg, shape=InputShape("t", 24, 8, "train"),
                    n_workers=4, learning_rate=0.1)
    return train_zoo(job, _scenarios(), SEEDS, n_ticks=N_TICKS,
                     device="cpu", **kw)


RUNS = {"megabatch": _megabatch, "zoo": _zoo,
        "zoo-f32": lambda **kw: _zoo("float32", **kw),
        "zoo-mla-moe": _zoo_mla_moe}
CELLS = 2 * len(SEEDS)
_ZOO = {"engine.tick": N_TICKS, "engine.market": N_TICKS,
        "step.forward": CELLS * N_TICKS, "step.backward": CELLS * N_TICKS,
        "step.optimizer": CELLS * N_TICKS, "train.prepare": 2,
        "engine.readback": 1}
#: the model's spans in a run without MLA or MoE
_NO_MODEL_SPANS = {"moe.route": 0, "moe.experts": 0, "mla.core": 0}
#: per span: how often a call of N_TICKS ticks over CELLS cells opens it.
#: The bf16 zoo step lands its update in place and gates itself, so the
#: engine's gate opens only for the float32 one.
COUNTS = {
    "megabatch": {"engine.tick": N_TICKS, "engine.market": N_TICKS,
                  "engine.gate": 0, "step.forward": N_TICKS,
                  "step.backward": N_TICKS, "step.optimizer": N_TICKS,
                  "train.prepare": 2, "engine.readback": 1,
                  **_NO_MODEL_SPANS},
    "zoo": {**_ZOO, "engine.gate": 0, **_NO_MODEL_SPANS},
    "zoo-f32": {**_ZOO, "engine.gate": CELLS * N_TICKS, **_NO_MODEL_SPANS},
    # a step: MLA's core once a layer; the route (tables, then combine)
    # and the experts (routed, then shared) twice an MoE layer
    "zoo-mla-moe": {**_ZOO, "engine.gate": 0,
                    "mla.core": 3 * CELLS * N_TICKS,
                    "moe.route": 4 * CELLS * N_TICKS,
                    "moe.experts": 4 * CELLS * N_TICKS},
}


def _traced(run, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = run(**kw)
    return res, prof.events()


def _bits(x):
    x = x.detach().contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy().tobytes()


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_each_span_opens_as_often_as_the_run_implies(kind):
    _, evs = _traced(RUNS[kind])
    got = {n: 0 for n in spans.NAMES}
    for e in evs:
        if e.name in got:
            got[e.name] += 1
    assert got == COUNTS[kind]


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_spans_are_plain_host_ranges_nested_by_layer(kind):
    _, evs = _traced(RUNS[kind])
    mine = [e for e in evs if e.name in spans.NAMES]
    assert mine
    for e in mine:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation, e.name
        parent = e.cpu_parent
        while parent is not None and parent.name not in spans.NAMES:
            parent = parent.cpu_parent
        if e.name in UNDER_TICK:
            assert parent is not None and parent.name == "engine.tick", \
                (e.name, parent)
        elif e.name in UNDER_FORWARD:
            assert parent is not None and parent.name == "step.forward", \
                (e.name, parent)
        else:
            # the tick, the call's preparation and its read back open
            # under the entry call itself
            assert parent is None, (e.name, parent.name)
    # aten work of the backward nests under step.backward
    back = [e for e in evs if e.name == "step.backward"]
    assert all(any(c.name.startswith(("aten::", "autograd::"))
                   for c in _descendants(b)) for b in back)


def _descendants(e):
    for c in e.cpu_children:
        yield c
        yield from _descendants(c)


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_a_traced_run_is_bit_for_bit_an_untraced_one(kind):
    plain = RUNS[kind]()
    traced, _ = _traced(RUNS[kind])
    for f in ("losses", "costs", "times", "ys", "iterations", "total_time",
              "total_cost", "total_idle"):
        np.testing.assert_array_equal(getattr(plain, f), getattr(traced, f))
    la, lb = tree_leaves(plain.final_model), tree_leaves(traced.final_model)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and _bits(x) == _bits(y)


def test_the_sharded_path_ticks_once_a_shard():
    mesh = Mesh(["cpu"] * 2, ("data",))
    res, evs = _traced(_megabatch, mesh=mesh)
    names = [e.name for e in evs]
    # two shards of one scenario each, each through the engine's loop
    assert names.count("engine.tick") == 2 * N_TICKS
    assert names.count("engine.market") == 2 * N_TICKS
    assert names.count("engine.readback") == 3      # two shards, the join
    np.testing.assert_array_equal(res.iterations,
                                  _megabatch(mesh=mesh).iterations)
