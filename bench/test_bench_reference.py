"""The plain references against the port at tiny sizes: the frozen market
against the engine's tick, Eq. (5) against the port's update, and the
Qwen2 reference's loss and gradients against both training programs."""
import numpy as np
import pytest
import torch

from bench.harness import program as prog_mod
from bench.harness import spec, weights as wmod
from bench.reference import elastic_sgd, market

TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 96,
        "vocab_size": 256, "num_hidden_layers": 2}


def tiny_conf():
    return {**spec.cell("qwen2-7b.megabatch-f32").config, **TINY}


def qwen_ref():
    return spec.cell("qwen2-7b.megabatch-f32").reference


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_frozen_market_matches_the_engines_tick(seed):
    from repro_torch.sim import engine

    rng = np.random.default_rng(seed)
    bids = rng.uniform(0.1, 1.0, (40, 8)).astype(np.float32)
    sc = engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0),
                         alpha=0.1, bid_schedule=bids)
    batch = engine.stack_scenarios([sc], device="cpu")
    seeds = np.array([seed, seed + 1, seed + 2], np.int64)
    j = np.array([0, 3, 39], np.int64)
    for k in (0, 1, 17, 1000):
        m = engine._market_tick(
            batch, torch.as_tensor(seeds), torch.zeros(1, 3),
            torch.as_tensor(j)[None], torch.full((1, 3), -1), k)
        mask, y, running = market.tick(seeds, k, j, bids, 0.2, 1.0, 40)
        assert np.array_equal(m.mask[0].numpy(), mask)
        assert np.array_equal(m.y[0].numpy(), y)
        assert np.array_equal(m.running[0].numpy(), running)


def test_eq5_step_matches_the_ports_update():
    from repro_torch.kernels import ref
    from repro_torch.optim.sgd import sgd

    g = torch.Generator().manual_seed(3)
    p, v, grad = (torch.randn(2, 50, generator=g) for _ in range(3))
    w = torch.tensor([4.0, 0.0])
    p_new, v_new = ref.elastic_update_reference(
        p, v, grad, w, torch.tensor([True, True]), torch.tensor([0.1, 0.1]),
        momentum=0.9)
    for r in range(2):
        inv = 1 / w[r] if w[r] > 0 else 0.0
        params, mom = {"x": p[r].clone()}, {"x": v[r].clone()}
        elastic_sgd.step(params, mom, {"x": grad[r] * inv}, 0.1, 0.9)
        assert torch.allclose(params["x"], p_new[r], rtol=0, atol=1e-6)
        assert torch.allclose(mom["x"], v_new[r], rtol=0, atol=1e-6)
    new_p, new_v = sgd(0.9).update({"x": grad[0]}, {"x": v[0]},
                                   {"x": p[0]}, torch.tensor(0.1))
    params, mom = {"x": p[0].clone()}, {"x": v[0].clone()}
    elastic_sgd.step(params, mom, {"x": grad[0]}, 0.1, 0.9)
    assert torch.equal(params["x"], new_p["x"])
    assert torch.equal(mom["x"], new_v["x"])


def _inputs(conf, seed=11, b=8, s=9):
    ref = qwen_ref()
    flat = wmod.make_all(ref.leaves(conf), seed, "cpu")
    batch = prog_mod.batch_maker(seed, b, s, conf["vocab_size"])(0)
    mask = np.array([1, 1, 0, 1, 0, 0, 1, 0], np.float32)
    return flat, batch, mask


def _ref_loss_grads(conf, flat, batch, mask, precision="float32"):
    ref = qwen_ref()
    w = {k: v.clone().requires_grad_() for k, v in flat.items()}
    tokens = torch.as_tensor(batch["tokens"])
    rows = torch.as_tensor(elastic_sgd.row_weights(mask, tokens.shape[0]))
    loss = ref.loss(w, conf, tokens, torch.as_tensor(batch["labels"]),
                    rows[:, None].expand(tokens.shape), precision)
    grads = torch.autograd.grad(loss, list(w.values()))
    return loss.detach(), dict(zip(w, grads))


def test_reference_matches_the_megabatch_program():
    from repro_torch.train import megabatch

    conf = tiny_conf()
    cell = spec.cell("qwen2-7b.megabatch-f32")
    cfg = cell.port.model_config(conf, cell.traffic)
    flat, batch, mask = _inputs(conf)
    loss, grads = _ref_loss_grads(conf, flat, batch, mask)
    packed = megabatch.pack_state(wmod.nest(flat), (), cfg, 0.0)["p"][None]
    tok = torch.as_tensor(batch["tokens"])[None]
    lab = torch.as_tensor(batch["labels"])[None]
    g, nll, w = megabatch.sum_form_grads(packed, cfg, tok, lab,
                                         torch.as_tensor(mask)[None])
    assert float(nll[0] / w[0]) == pytest.approx(float(loss), rel=1e-6)
    views = wmod.flat_views(
        megabatch.unpack_state({"p": g / w[0], "v": g}, cfg, 0.0)[0], 1)
    _close(views, grads)


def _close(views, grads):
    """Each leaf within 1e-5 of the reference's norm (float32 sums taken
    in another order)."""
    for k, gr in grads.items():
        gap = torch.linalg.vector_norm(views[k][0] - gr)
        assert gap <= 1e-5 * torch.linalg.vector_norm(gr) + 1e-12, k


def test_reference_matches_the_zoo_program_in_float32():
    from repro_torch.train.train_step import make_loss_grad

    conf = tiny_conf()
    cell = spec.cell("qwen2-7b.zoo-bf16")
    cell.config = conf
    cell.traffic = {**cell.traffic, "dtype": "float32",
                    "flash_attention": False, "batch": 8, "seq_len": 9}
    cfg = cell.port.model_config(conf, cell.traffic)
    flat, batch, mask = _inputs(conf, seed=2**31 + 1)
    loss, grads = _ref_loss_grads(conf, flat, batch, mask)
    p = prog_mod.Program(cell, 1, "cpu")
    grad_step = make_loss_grad(cfg, p.job, "none")
    g, zloss, _ = grad_step(wmod.nest(flat),
                            {k: torch.as_tensor(v) for k, v in batch.items()},
                            torch.as_tensor(mask))
    assert float(zloss) == pytest.approx(float(loss), rel=1e-6)
    views = wmod.flat_views(_lead(g), 1)
    _close(views, grads)


def _lead(tree):
    """Every leaf with a leading axis of 1."""
    if isinstance(tree, dict):
        return {k: _lead(v) for k, v in tree.items()}
    return tree[None]


@pytest.mark.parametrize("precision", ["tf32", "fp8"])
def test_lower_precision_reference_departs(precision):
    conf = tiny_conf()
    flat, batch, mask = _inputs(conf)
    loss, grads = _ref_loss_grads(conf, flat, batch, mask)
    lo_loss, lo_grads = _ref_loss_grads(conf, flat, batch, mask, precision)
    assert lo_loss != loss
    assert any(not torch.equal(grads[k], lo_grads[k]) for k in grads)


@pytest.mark.parametrize("name", ["qwen2-7b.megabatch-f32",
                                  "qwen2-7b.zoo-bf16"])
def test_traffic_states_the_bids_the_strategy_makes(name):
    """The frozen market takes the traffic's bids, not the program's; the
    launcher's strategy bids the same at every iteration."""
    cell = spec.cell(name)
    cell.config = tiny_conf()
    p = prog_mod.Program(cell, 5, "cpu")
    (table,) = p.scenarios[0].bid_table
    want = np.asarray(cell.traffic["bids"], np.float32)
    assert np.array_equal(table, np.broadcast_to(want, table.shape))


@pytest.mark.parametrize("name", ["qwen2-7b.megabatch-f32",
                                  "qwen2-7b.zoo-bf16"])
def test_every_replica_starts_from_its_own_weights(name):
    cell = spec.cell(name)
    cell.config = tiny_conf()
    cell.traffic = {**cell.traffic, "batch": 8, "seq_len": 9}
    p = prog_mod.Program(cell, 2**31 + 9, "cpu")
    leaves = cell.reference.leaves(cell.config)
    views = p.leaves(p.initial_state(leaves, 2**31 + 9), "params")
    for cell_i in range(2):
        want = wmod.make_all(leaves, 2**31 + 9, "cpu", cell_i)
        for k, x in want.items():
            assert torch.equal(views[k][0, cell_i].float(), x), k
    assert not torch.equal(views["embed"][0, 0], views["embed"][0, 1])


def test_set_up_plan_ends_calls_where_the_check_reads():
    from bench.harness.training import plan

    # two cells; j after each of 12 ticks
    js = np.array([[0, 0], [1, 0], [1, 1], [1, 1], [2, 1], [2, 1],
                   [2, 2], [3, 2], [3, 2], [3, 2], [4, 3], [4, 3]])
    ends = plan(js, 3, 4, 4)
    # chunk ends at 4, 8 and 12 (the second cell reaches 3 at tick 11);
    # each cell's counts of 1 and 3 hold over a chunk end: no other call
    assert ends == [4, 8, 12]
    js2 = np.array([[1, 0], [2, 1], [3, 1], [4, 2], [4, 3], [5, 4]])
    # cell 0 holds 1 only after tick 1 and 3 only after tick 3; cell 1
    # holds 1 after ticks 2-3 and 3 after tick 5: none over a chunk end
    assert plan(js2, 3, 4, 4) == [1, 2, 3, 4, 5, 8]
