"""Dense tensor parallelism over the model axis: ``attention_block``,
``mla_block`` and ``mlp_block`` split their heads and d_ff over the tp
ranks of a CPU mesh of 8 host devices, and the port's ``model_zoo.forward``,
``make_loss_grad``, ``make_train_step``, ``prefill`` and ``decode_step``
under (data 2, model 4), (data 1, model 4) and (pod 2, data 2, model 2)
meshes are held against the reference under Auto-typed meshes of the same
shapes (tests/torch_mesh_ref.py, one child process for the module) and
against the port's own run with no mesh.

Cases (reduced configs, float32, widths chosen so that no two products
share a shape): query heads and KV heads that both divide tp (8 over 4); Qwen2-7B's 4 query heads over 2 KV heads, whose KV
heads stay whole at tp 4 and split at tp 2; 12 query heads over 6 KV heads,
whose ranks' 3 query heads straddle KV groups at tp 4, with a d_ff of 510
that does not divide 4 (the MLP computes whole there); 6 query heads,
which do not divide 4 (the attention computes whole; the MLP splits);
Whisper's self- and cross-attention; DeepSeek-V2-Lite's MLA and MoE
layer. The split is shown on the products' shapes, recorded below the
dispatcher: each rank's slice of ``wq``, ``wo``, ``w_gate`` and
``w_down``, and none of the whole matrices. A (1, 1) mesh gives the
unmeshed run bit for bit, and under the (2, 4) mesh remat "full" and
"dots" give "none"'s gradients bit for bit.

Tolerances: tests/torch_mesh_ref.py's against the reference; the same
against the port's unmeshed run (the ranks' partial sums are added in
rank order, the whole products in one)."""
import numpy as np
import pytest
import torch

import torch_mesh_ref as mr
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.models import attention, model_zoo
from repro_torch.models.common import mesh_context
from repro_torch.train.train_step import make_loss_grad

ALL = ["forward", "loss_grad", "train_step", "serve"]
MESHES = ["2x4", "1x4", "2x2x2"]
CASES = [
    {"name": "kv_split", "arch": "qwen2-7b",
     "over": {"num_heads": 8, "num_kv_heads": 4, "head_dim": 32,
              "d_ff": 384}},
    {"name": "kv_repl", "arch": "qwen2-7b"},
    {"name": "straddle", "arch": "qwen2-7b",
     "over": {"num_heads": 12, "num_kv_heads": 6, "head_dim": 16,
              "d_ff": 510}},
    {"name": "heads_whole", "arch": "qwen2-7b",
     "over": {"num_heads": 6, "num_kv_heads": 2, "d_ff": 448}},
    {"name": "whisper", "arch": "whisper-base"},
    {"name": "dsv2", "arch": "deepseek-v2-lite-16b"},
]
for c in CASES:
    c.update(meshes=MESHES, batches=[4], fns=ALL)
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return mr.run_reference(CASES, tmp_path_factory.mktemp("tp") / "ref.npz")


@pytest.fixture(scope="module")
def unmeshed(reference):
    """The port's runs with no mesh, once per case."""
    return {c["name"]: mr.port_run(reference, c, None, 4, ALL)
            for c in CASES if c["name"] != "dsv2"}


@pytest.mark.parametrize("tag", MESHES)
@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_split_matches_reference_and_no_mesh(reference, unmeshed, case, tag):
    out = mr.port_run(reference, case, tag, 4, ALL)
    mr.check_against_reference(reference, case, tag, 4, out)
    if case["name"] == "dsv2":
        # MoE capacity counts a data rank's tokens: not the unmeshed run
        return
    mr.check_against_no_mesh(out, unmeshed[case["name"]])


def _products(reference, case, tag):
    cfg = mr.port_cfg(case)
    params = mr.port_params(reference, case, cfg)
    batch, _, _ = mr.port_inputs(reference, case, 4)
    rec = mr.Products()
    with mesh_context(mr.port_mesh(tag)), torch.no_grad(), rec:
        model_zoo.forward(params, cfg, batch, remat="none")
    return cfg, rec.shapes


@pytest.mark.parametrize("tag,tp,groups", [("2x4", 4, 2), ("1x4", 4, 1),
                                           ("2x2x2", 2, 2)])
def test_ranks_compute_their_slices(reference, tag, tp, groups):
    """kv_split: every layer, data group and rank multiplies by its slices
    (d, 8/tp heads) of wq, (8/tp heads, d) of wo, (d, 384/tp) of w_gate
    and w_up and (384/tp, d) of w_down, and every data group and rank by
    its (d, V/tp) columns of the LM head; the whole matrices never."""
    cfg, shapes = _products(reference, BY_NAME["kv_split"], tag)
    d, dh, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    n = cfg.num_layers * groups * tp
    hq, hkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
    assert shapes.count((d, hq * dh)) == n                # wq
    assert shapes.count((d, hkv * dh)) == 2 * n           # wk, wv
    assert shapes.count((hq * dh, d)) == n                # wo
    assert shapes.count((d, f // tp)) == 2 * n            # w_gate, w_up
    assert shapes.count((f // tp, d)) == n                # w_down
    # the LM head's vocab slices, once a group and rank; at tp 2 their
    # (d, V / 2) is the whole wo's shape, which must not appear beside them
    head = (d, cfg.vocab_size // tp)
    assert shapes.count(head) == groups * tp
    for whole in ((cfg.num_heads * dh, d), (f, d), (d, f)):
        assert shapes.count(whole) == (groups * tp if whole == head
                                       else 0), whole


def test_straddling_ranks_read_the_kv_heads_of_their_query_heads(reference):
    """12 query heads over 6 KV heads at tp 4: rank r's query heads
    3r..3r+2 read KV heads (3r..3r+2) // 2, two of them, the middle one
    shared by two heads or by one; the MLP (d_ff 510) computes whole."""
    plan = [attention.rank_heads(12, 6, 4, r) for r in range(4)]
    assert [p[:2] for p in plan] == [((0, 3), (0, 2)), ((3, 6), (1, 3)),
                                     ((6, 9), (3, 5)), ((9, 12), (4, 6))]
    assert [p[2] for p in plan] == [[0, 0, 1], [0, 1, 1], [0, 0, 1],
                                    [0, 1, 1]]
    cfg, shapes = _products(reference, BY_NAME["straddle"], "1x4")
    d, dh = cfg.d_model, cfg.resolved_head_dim
    assert shapes.count((d, 3 * dh)) == 4 * cfg.num_layers      # wq
    assert shapes.count((d, 2 * dh)) == 8 * cfg.num_layers      # wk, wv
    assert shapes.count((d, 510)) == 2 * cfg.num_layers         # whole MLP
    # Qwen2-7B's 32 padded heads over 4 KV heads at tp 8: 4 query heads a
    # rank, all in one group of 8
    assert attention.rank_heads(32, 4, 8, 3) == ((12, 16), (1, 2), None)


def test_heads_that_do_not_divide_compute_whole(reference):
    cfg, shapes = _products(reference, BY_NAME["heads_whole"], "1x4")
    d, dh, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    assert shapes.count((d, 6 * dh)) == cfg.num_layers         # whole wq
    assert shapes.count((d, f // 4)) == 8 * cfg.num_layers     # split MLP


def test_whisper_splits_self_and_cross_attention(reference):
    cfg, shapes = _products(reference, BY_NAME["whisper"], "1x4")
    d, dh = cfg.d_model, cfg.resolved_head_dim
    n_attn = cfg.encoder.num_layers + 2 * cfg.num_layers
    assert shapes.count((cfg.num_heads // 4 * dh, d)) == 4 * n_attn   # wo
    assert (cfg.num_heads * dh, d) not in shapes


def test_mla_splits_heads_and_keeps_the_latent_whole(reference):
    cfg, shapes = _products(reference, BY_NAME["dsv2"], "1x4")
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert shapes.count((d, h // 4 * dq)) == 4 * cfg.num_layers      # wq
    # wo's rows, and the shared expert's w_sh_down rows (d_ff 128 / 4)
    assert shapes.count((h // 4 * m.v_head_dim, d)) == 8 * cfg.num_layers
    # the latent projection once a layer: whole, read by every rank
    assert shapes.count((d, m.kv_lora_rank + m.qk_rope_head_dim)) == \
        cfg.num_layers


@pytest.mark.parametrize("name", ["kv_split", "straddle", "whisper", "dsv2"])
def test_one_rank_mesh_is_bit_for_bit_no_mesh(reference, name):
    case = BY_NAME[name]
    one = mr.port_run(reference, case, "1x1", 4, ALL)
    alone = mr.port_run(reference, case, None, 4, ALL)
    for what in one:
        mr.bits_equal(one[what], alone[what], what)


@pytest.mark.parametrize("name", ["kv_split", "straddle", "dsv2"])
def test_remat_is_bit_equal_under_the_mesh(reference, name):
    case = BY_NAME[name]
    cfg = mr.port_cfg(case)
    params = mr.port_params(reference, case, cfg)
    batch, labels, _ = mr.port_inputs(reference, case, 4)
    job = JobConfig(model=cfg, shape=InputShape("t", mr.PROMPT, 4, "train"),
                    n_workers=mr.N_W)
    mask = torch.from_numpy(mr.MASK.copy())
    runs = {}
    with mesh_context(mr.port_mesh("2x4")):
        for mode in ("none", "dots", "full"):
            runs[mode] = make_loss_grad(cfg, job, mode)(
                params, dict(batch, labels=labels), mask)
    for mode in ("dots", "full"):
        mr.bits_equal(runs[mode][0], runs["none"][0], mode)
        assert torch.equal(runs[mode][1], runs["none"][1])


def test_replicated_batch_splits_over_the_model_axis_alone(reference):
    """A batch of 3 does not split over data 2: one group, replicated,
    still split over the four tp ranks; its logits are the first three
    rows of the batch of 4's to the unmeshed run's tolerance."""
    case = BY_NAME["kv_split"]
    cfg = mr.port_cfg(case)
    params = mr.port_params(reference, case, cfg)
    batch, _, _ = mr.port_inputs(reference, case, 4)
    rec = mr.Products()
    with mesh_context(mr.port_mesh("2x4")), torch.no_grad():
        with rec:
            y3, _ = model_zoo.forward(params, cfg,
                                      {"tokens": batch["tokens"][:3]},
                                      remat="none")
        y4, _ = model_zoo.forward(params, cfg, batch, remat="none")
    d, dh = cfg.d_model, cfg.resolved_head_dim
    assert rec.shapes.count((2 * dh, d)) == 4 * cfg.num_layers     # wo
    np.testing.assert_allclose(y3.numpy(), y4[:3].numpy(), rtol=0,
                               atol=1e-4 * float(y4.abs().max()))
