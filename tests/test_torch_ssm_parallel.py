"""The SSM's heads split over the model axis: ``ssm_block`` runs each tp
rank's SSD heads (their columns of ``wz``, ``wx`` and ``conv_x``, their
entries of ``wdt``, ``A_log``, ``D``, ``dt_bias`` and ``norm_w``, their
rows of ``wo``, the B/C groups they read) on the rank's device, the gated
RMSNorm over the whole d_inner by a psum of the ranks' sums of squares,
and a psum after ``wo``; the caches are cut by heads and joined back.
The port's ``model_zoo.forward``, ``make_loss_grad`` (the SSD's training
route once a rank), ``prefill`` (the kernel route once a rank) and two
``decode_step``s with every cache leaf, under (data 2, model 4), (data 1,
model 4) and (pod 2, data 2, model 2) meshes of 8 host devices, are held
against the reference under Auto-typed meshes of the same shapes
(tests/torch_mesh_ref.py, one child process for the module) and against
the port's own run with no mesh.

Cases (reduced configs, float32): Mamba2 (16 heads of one group: 4 a rank
at tp 4, 8 at tp 2) and Zamba2 (the same SSM layers beside the shared
attention and MLP, which split as slice 14's dense layers do); 6 heads,
which do not divide 4 (the block computes whole); two groups of 8 heads,
each rank's heads inside one group; three groups of 4 heads at tp 4,
whose ranks' 3 heads straddle groups (each head reads its group through
an index). A (1, 1) mesh gives the unmeshed run bit for bit, and remat
"full" and "dots" give "none"'s gradients bit for bit under the (2, 4)
mesh.

Tolerances: tests/torch_mesh_ref.py's against the reference (logits
within 1e-4 of the largest, the loss at 1e-5 relative, leaves at rtol
1e-4 plus 1e-4 of the leaf's largest); the same against the port's
unmeshed run. The ranks' norm sums and their outputs after ``wo`` add in
rank order, where the whole block reduces d_inner in one: measured here,
logits and cache leaves within 1.5e-6 of their largest entry and gradient
leaves within 5.4e-6 against the reference (9.4e-7 and 2.7e-6 against
the port's unmeshed run)."""
import pytest
import torch

import torch_mesh_ref as mr
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, model_zoo, ssm
from repro_torch.models.common import mesh_context
from repro_torch.train.train_step import make_loss_grad

FNS = ["forward", "loss_grad", "serve"]
MESHES = ["2x4", "1x4", "2x2x2"]
CASES = [
    {"name": "mamba2", "arch": "mamba2-1.3b", "over": {"vocab_size": 480},
     "meshes": MESHES},
    {"name": "zamba2", "arch": "zamba2-7b", "meshes": MESHES},
    {"name": "heads_whole", "arch": "mamba2-1.3b", "over": {"d_model": 96},
     "meshes": ["1x4"]},
    {"name": "groups2", "arch": "mamba2-1.3b", "ssm": {"ngroups": 2},
     "meshes": ["1x4", "2x2x2"]},
    {"name": "straddle", "arch": "mamba2-1.3b", "over": {"d_model": 192},
     "ssm": {"ngroups": 3}, "meshes": ["1x4"]},
]
for c in CASES:
    c.update(batches=[4], fns=FNS)
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
    return mr.run_reference(CASES, tmp_path_factory.mktemp("ssm_tp")
                            / "ref.npz")


@pytest.fixture(scope="module")
def unmeshed(reference):
    """The port's runs with no mesh, once per case."""
    return {c["name"]: mr.port_run(reference, c, None, 4, FNS)
            for c in CASES}


@pytest.mark.parametrize("case,tag", RUNS,
                         ids=[f"{c['name']}-{t}" for c, t in RUNS])
def test_split_matches_reference_and_no_mesh(reference, unmeshed, case, tag):
    out = mr.port_run(reference, case, tag, 4, FNS)
    mr.check_against_reference(reference, case, tag, 4, out)
    mr.check_against_no_mesh(out, unmeshed[case["name"]])


def _ssd_calls(reference, case, tag, monkeypatch):
    """The xh shapes of every kernel-route SSD call of one prefill and one
    forward (no gradient: the kernel route), and the products' right
    operands of the forward."""
    cfg = mr.port_cfg(case)
    params = mr.port_params(reference, case, cfg)
    batch, _, _ = mr.port_inputs(reference, case, 4)
    seen = []
    chunked = ops.ssd_chunked

    def recording(xh, *args, **kw):
        seen.append(tuple(xh.shape))
        return chunked(xh, *args, **kw)

    monkeypatch.setattr(ops, "ssd_chunked", recording)
    rec = mr.Products()
    with mesh_context(mr.port_mesh(tag)), torch.no_grad():
        model_zoo.prefill(params, cfg, batch, mr.fresh_caches(cfg, 4))
        with rec:
            model_zoo.forward(params, cfg, batch, remat="none")
    return cfg, seen, rec.shapes


@pytest.mark.parametrize("tag,tp,groups", [("2x4", 4, 2), ("1x4", 4, 1),
                                           ("2x2x2", 2, 2)])
def test_ranks_run_their_heads(reference, monkeypatch, tag, tp, groups):
    """Mamba2: each layer, batch group and rank runs the SSD on its heads
    (the kernel route, K3 on the card, once a rank) and multiplies by its
    (d, d_inner / tp) slices of wz and wx, its (d, heads / tp) slice of
    wdt, the whole (d, N) wB and wC (one group) and its (d_inner / tp, d)
    rows of wo; the whole matrices never. The LM head is split too: each
    rank forms its (d, V / tp) columns."""
    cfg, seen, shapes = _ssd_calls(reference, BY_NAME["mamba2"], tag,
                                   monkeypatch)
    s = cfg.ssm
    d, d_inner = cfg.d_model, s.expand * cfg.d_model
    h = d_inner // s.head_dim
    n = cfg.num_layers * groups * tp
    assert seen == [(4 // groups, mr.PROMPT, h // tp, s.head_dim)] * 2 * n
    wide, tall = (d, d_inner // tp), (d_inner // tp, d)  # wz, wx; wo
    if wide == tall:                                      # d_inner = 2d
        assert shapes.count(wide) == 3 * n
    else:
        assert shapes.count(wide) == 2 * n and shapes.count(tall) == n
    assert shapes.count((d, h // tp)) == n                # wdt
    assert shapes.count((d, s.d_state)) == 2 * n          # wB, wC
    assert shapes.count((d, cfg.vocab_size // tp)) == groups * tp
    for whole in ((d, d_inner), (d_inner, d), (d, cfg.vocab_size)):
        assert whole not in shapes, whole


def test_heads_that_do_not_divide_compute_whole(reference, monkeypatch):
    cfg, seen, shapes = _ssd_calls(reference, BY_NAME["heads_whole"], "1x4",
                                   monkeypatch)
    d = cfg.d_model
    h = cfg.ssm.expand * d // cfg.ssm.head_dim
    assert h == 6
    assert seen == [(4, mr.PROMPT, 6, cfg.ssm.head_dim)] * 2 \
        * cfg.num_layers
    assert shapes.count((d, 2 * d)) == 2 * cfg.num_layers       # wz, wx


def test_rank_groups_and_straddling_heads(reference, monkeypatch):
    """Two groups of 8 heads at tp 4: ranks 0, 1 read group 0 and ranks 2,
    3 group 1, one group's B/C columns each; three groups of 4 heads at tp
    4: a rank's 3 heads read the run of groups they fall in, through an
    index where they straddle two."""
    assert [attention.rank_heads(16, 2, 4, r)[1:] for r in range(4)] == \
        [((0, 1), None), ((0, 1), None), ((1, 2), None), ((1, 2), None)]
    assert [attention.rank_heads(12, 3, 4, r) for r in range(4)] == [
        ((0, 3), (0, 1), None), ((3, 6), (0, 2), [0, 1, 1]),
        ((6, 9), (1, 3), [0, 0, 1]), ((9, 12), (2, 3), None)]
    cfg, seen, shapes = _ssd_calls(reference, BY_NAME["groups2"], "1x4",
                                   monkeypatch)
    assert shapes.count((cfg.d_model, cfg.ssm.d_state)) == \
        2 * 4 * cfg.num_layers                            # wB, wC: 1 group
    cfg, seen, shapes = _ssd_calls(reference, BY_NAME["straddle"], "1x4",
                                   monkeypatch)
    n = cfg.ssm.d_state
    assert sorted({s for s in shapes if s[1] in (n, 2 * n)}) == \
        [(cfg.d_model, n), (cfg.d_model, 2 * n)]
    assert seen == [(4, mr.PROMPT, 3, cfg.ssm.head_dim)] * 2 * 4 \
        * cfg.num_layers


def test_training_route_runs_once_a_rank(reference):
    """``make_loss_grad`` under remat "full" takes the SSD's training
    route once a rank and layer in the forward and again in the
    recompute."""
    case = BY_NAME["mamba2"]
    cfg = mr.port_cfg(case)
    params = mr.port_params(reference, case, cfg)
    batch, labels, _ = mr.port_inputs(reference, case, 4)
    job = JobConfig(model=cfg, shape=InputShape("t", mr.PROMPT, 4, "train"),
                    n_workers=mr.N_W)
    calls = ssm.ssd_chunked.calls
    with mesh_context(mr.port_mesh("1x4")):
        make_loss_grad(cfg, job, "full")(params, dict(batch, labels=labels),
                                         torch.from_numpy(mr.MASK.copy()))
    assert ssm.ssd_chunked.calls - calls == 2 * 4 * cfg.num_layers


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_one_rank_mesh_is_bit_for_bit_no_mesh(reference, name):
    case = BY_NAME[name]
    one = mr.port_run(reference, case, "1x1", 4, FNS)
    alone = mr.port_run(reference, case, None, 4, FNS)
    for what in one:
        mr.bits_equal(one[what], alone[what], what)


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
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
