"""The query sequence split over the model axis (``cfg.attn_seq_shard``,
the reference's ``shard(q, "batch", "tp", None, None)``): under a mesh
whose model axis divides the sequence and without a cache, rank r of
``attention_block`` takes query rows [r·S/tp, (r+1)·S/tp) with their
positions and every key and value and attends on its device (K2 at
``q_offset`` r·S/tp on the flash path); the rows join in rank order with
no psum, and ``wo`` multiplies them once; the keys' and values' gradient
sums over the ranks. With a cache (prefill, decode) or where tp
does not divide S, attention computes whole.

Held against the reference's ``attn_seq_shard`` runs under Auto-typed
(data 2, model 4), (data 1, model 4) and (pod 2, data 2, model 2) meshes
(tests/torch_mesh_ref.py, one child process for the module) and against
the port's run with no mesh: forward, ``make_loss_grad`` and the prefill
with two decode steps of reduced Qwen2-7B at S = 16 (4 rows a rank at tp
4, 8 at tp 2) and S = 18 (whole at tp 4, 9 rows a rank at tp 2), and
reduced Whisper's forward and loss (its encoder's 64 frames, its decoder's
self- and cross-attention split). The flash path (the plain version of K2
on the CPU) against the reference's plain core, its ranks' query offsets
recorded. A (1, 1) mesh gives no mesh's bits, remat's gradients are
bit-equal, and ``attn_defs`` keeps the unpadded heads under the flag.

Tolerances: tests/torch_mesh_ref.py's (logits within 1e-4 of the largest,
the loss at 1e-5 relative, leaves at rtol 1e-4 plus 1e-4 of the leaf's
largest)."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_mesh_ref as mr
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import attention, model_zoo
from repro_torch.models.common import mesh_context
from repro_torch.train.train_step import make_loss_grad

SEQ = {"attn_seq_shard": True}
#: head_dim 48: no other product shares wo's (192, d) shape
QWEN = dict(SEQ, head_dim=48)
MESHES = ["2x4", "1x4", "2x2x2"]
CASES = [
    {"name": "s16", "arch": "qwen2-7b", "over": QWEN, "meshes": MESHES,
     "fns": ["forward", "loss_grad", "serve"]},
    {"name": "s18", "arch": "qwen2-7b", "over": QWEN, "prompt": 18,
     "meshes": ["1x4", "2x2x2"], "fns": ["forward", "loss_grad", "serve"]},
    {"name": "whisper", "arch": "whisper-base", "over": SEQ,
     "meshes": ["1x4"], "fns": ["forward", "loss_grad"]},
]
for c in CASES:
    c.update(batches=[4])
BY_NAME = {c["name"]: c for c in CASES}
RUNS = [(c, tag) for c in CASES for tag in c["meshes"]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return mr.run_reference(CASES, tmp_path_factory.mktemp("seq_tp")
                            / "ref.npz")


@pytest.fixture(scope="module")
def unmeshed(reference):
    return {c["name"]: mr.port_run(reference, c, None, 4, c["fns"])
            for c in CASES}


@pytest.mark.parametrize("case,tag", RUNS,
                         ids=[f"{c['name']}-{t}" for c, t in RUNS])
def test_split_matches_reference_and_no_mesh(reference, unmeshed, case, tag):
    out = mr.port_run(reference, case, tag, 4, case["fns"])
    mr.check_against_reference(reference, case, tag, 4, out)
    mr.check_against_no_mesh(out, unmeshed[case["name"]])


class _Rows(TorchDispatchMode):
    """Records (rows of the left operand, shape of the right) of every
    ``aten.mm``."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.seen.append((args[0].shape[0], tuple(args[1].shape)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,tag,split", [
    ("s16", "2x4", 4), ("s16", "1x4", 4), ("s16", "2x2x2", 2),
    ("s18", "1x4", 1), ("s18", "2x2x2", 2)])
def test_ranks_attend_their_rows(reference, monkeypatch, name, tag, split):
    """Each rank of each batch group attends its S/tp query rows against
    all S keys; where tp does not divide S, the core takes all S rows of
    the batch once a layer. ``wo`` multiplies the joined B·S rows once a
    layer either way."""
    case = BY_NAME[name]
    cfg = mr.port_cfg(case)
    params = mr.port_params(reference, case, cfg)
    batch, _, _ = mr.port_inputs(reference, case, 4)
    cores = []
    attend = attention._attend

    def recording(q, k, v, qpos, kpos, **kw):
        cores.append((q.shape[0], q.shape[1], k.shape[1]))
        return attend(q, k, v, qpos, kpos, **kw)

    monkeypatch.setattr(attention, "_attend", recording)
    rec = _Rows()
    with mesh_context(mr.port_mesh(tag)), torch.no_grad(), rec:
        model_zoo.forward(params, cfg, batch, remat="none")
    groups = mr.port_mesh(tag).shape["data"] if split > 1 else 1
    s = mr.prompt_of(case)
    assert cores == [(4 // groups, s // split, s)] * split * groups \
        * cfg.num_layers
    wo = (cfg.num_heads * cfg.resolved_head_dim, cfg.d_model)
    assert [r for r, shape in rec.seen if shape == wo] == \
        [4 * s] * cfg.num_layers


@pytest.mark.parametrize("tag,tp", [("2x4", 4), ("2x2x2", 2)])
def test_flash_path_launches_each_rank_at_its_offset(reference, monkeypatch,
                                                     tag, tp):
    """With ``use_flash_attention`` the ranks attend through
    ``ops.flash_mha`` (K2 on the card, its plain version here) at
    ``q_offset`` r·S/tp, S/tp query rows against all S keys, and the
    forward and ``make_loss_grad`` match the reference's run of the plain
    core under the same mesh."""
    case = BY_NAME["s16"]
    cfg = mr.port_cfg(case).with_(use_flash_attention=True)
    params = mr.port_params(reference, case, cfg)
    batch, labels, _ = mr.port_inputs(reference, case, 4)
    job = JobConfig(model=cfg, shape=InputShape("t", mr.PROMPT, 4, "train"),
                    n_workers=mr.N_W)
    seen = []
    flash = ops.flash_mha

    def recording(q, k, v, **kw):
        seen.append((kw["q_offset"], q.shape[1], k.shape[1]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_mha", recording)
    with mesh_context(mr.port_mesh(tag)):
        y, _ = model_zoo.forward(params, cfg, batch, remat="none")
        grads, loss, _ = make_loss_grad(cfg, job, "none")(
            params, dict(batch, labels=labels),
            torch.from_numpy(mr.MASK.copy()))
    part = mr.PROMPT // tp
    layer = [(r * part, part, mr.PROMPT) for r in range(tp)] * 2  # groups
    assert seen == layer * cfg.num_layers * 2        # forward, loss_grad
    key = f"s16/{tag}/b4"
    mr.logits_close(y, reference[key + "/logits"])
    mr.scalar_close(loss, reference[key + "/loss"])
    mr.tree_close(grads, reference, key + "/grad")


def test_one_rank_mesh_is_bit_for_bit_no_mesh(reference):
    case = BY_NAME["s16"]
    one = mr.port_run(reference, case, "1x1", 4, case["fns"])
    alone = mr.port_run(reference, case, None, 4, case["fns"])
    for what in one:
        mr.bits_equal(one[what], alone[what], what)


def test_remat_is_bit_equal_under_the_mesh(reference):
    case = BY_NAME["s16"]
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


def test_attn_defs_keep_unpadded_heads_under_the_flag():
    """At tp 8, Qwen2-7B's 28 query heads are padded to 32 for the head
    split, and stay 28 when the sequence splits instead."""
    cfg = ARCHS["qwen2-7b"]
    dh = cfg.resolved_head_dim
    with mesh_context(AbstractMesh((1, 8), ("data", "model"))):
        heads = attention.attn_defs(cfg)["wq"].shape[1] // dh
        seq = attention.attn_defs(cfg.with_(**SEQ))["wq"].shape[1] // dh
    assert (heads, seq) == (32, 28)
