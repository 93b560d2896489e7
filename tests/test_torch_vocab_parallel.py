"""The vocab split over the model axis: under a mesh whose model axis
divides the vocab, ``transformer.unembed`` forms each tp rank's logit
slice on its device from the rank's columns of ``lm_head`` (its rows of
``embed`` where the embeddings are tied) and joins them in rank order;
``loss.token_nll`` and ``next_token_loss`` run the vocab-parallel cross
entropy (a pmax of the ranks' maxima, a psum of their Σ exp(l − max), the
gold logit read on the rank that holds the label and a psum); and
``make_loss_grad`` stops its forward before the head, which
``loss.head_token_nll`` applies rank by rank, so the (B, S, V) logits are
never formed whole in the step, forward or backward.

Held against the reference under Auto-typed (data 2, model 4), (data 1,
model 4) and (pod 2, data 2, model 2) meshes (tests/torch_mesh_ref.py, one
child process for the module): the logits, ``next_token_loss`` of them
with the elastic weights and with every weight 0 (exactly 0), and
``make_loss_grad`` with a mask and with every worker preempted (loss and
gradients exactly 0), for an untied and a tied head and for a vocab of
510, which tp 4 does not divide (the head computes whole) and tp 2 does;
and against the port's own run with no mesh.

Tolerances: tests/torch_mesh_ref.py's against the reference. The split
loss against the whole logsumexp in float32: 1e-6 relative (the ranks'
sums add in rank order, the whole sum in one; measured within 2.1e-7
over five seeds of these logits), its gradient at rtol 1e-4 plus 1e-4 of
the largest entry."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_mesh_ref as mr
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.models import transformer
from repro_torch.models.common import mesh_context
from repro_torch.train.loss import next_token_loss, token_nll
from repro_torch.train.train_step import make_loss_grad

FNS = ["forward", "loss_grad", "nll"]
MESHES = ["2x4", "1x4", "2x2x2"]
CASES = [
    {"name": "untied", "arch": "qwen2-7b", "meshes": MESHES},
    {"name": "tied", "arch": "qwen2-7b", "over": {"tie_embeddings": True},
     "meshes": MESHES},
    {"name": "odd_vocab", "arch": "qwen2-7b", "over": {"vocab_size": 510},
     "meshes": ["1x4", "2x2x2"]},
]
for c in CASES:
    c.update(batches=[4], fns=FNS, zero_mask=True)
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
    return mr.run_reference(CASES, tmp_path_factory.mktemp("vocab_tp")
                            / "ref.npz")


@pytest.fixture(scope="module")
def unmeshed(reference):
    return {c["name"]: mr.port_run(reference, c, None, 4, FNS)
            for c in CASES}


@pytest.mark.parametrize("case,tag", RUNS,
                         ids=[f"{c['name']}-{t}" for c, t in RUNS])
def test_split_matches_reference_and_no_mesh(reference, unmeshed, case, tag):
    out = mr.port_run(reference, case, tag, 4, FNS)
    mr.check_against_reference(reference, case, tag, 4, out)
    mr.check_against_no_mesh(out, unmeshed[case["name"]])
    assert float(out["nll0"]) == 0.0 and float(out["loss0"]) == 0.0
    for g in _leaves(out["grad0"]):
        assert not g.any()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _logits(seed, b=4, s=16, v=512):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        (3 * rng.standard_normal((b, s, v))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, v, (b, s)))
    return logits, labels


@pytest.mark.parametrize("tag", MESHES)
def test_vocab_parallel_loss_against_the_whole_logsumexp(tag):
    """``token_nll`` split over the vocab against the whole logsumexp at
    1e-6 relative; ``next_token_loss`` and its gradient in the logits with
    elastic weights, and exactly 0 with Σw = 0."""
    logits, labels = _logits(0)
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])[:, None].expand(4, 16)
    whole = token_nll(logits, labels)
    runs = {}
    for name, mesh in (("none", None), ("mesh", mr.port_mesh(tag))):
        lg = logits.clone().requires_grad_()
        with mesh_context(mesh):
            nll = token_nll(lg, labels)
            loss = next_token_loss(lg, labels, w)
            (grad,) = torch.autograd.grad(loss, lg)
            zero = next_token_loss(logits, labels, 0 * w)
        runs[name] = (nll.detach(), loss.detach(), grad)
        assert float(zero) == 0.0
    (nll, loss, grad), (_, loss0, grad0) = runs["mesh"], runs["none"]
    np.testing.assert_allclose(nll.numpy(), whole.numpy(), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), grad0.numpy(), rtol=1e-4,
                               atol=1e-4 * float(grad0.abs().max()))


def test_a_vocab_tp_does_not_divide_computes_whole():
    logits, labels = _logits(1, v=510)
    with mesh_context(mr.port_mesh("1x4")):
        split = token_nll(logits, labels)
    assert torch.equal(split, token_nll(logits, labels))


@pytest.mark.parametrize("name", ["untied", "tied"])
def test_joined_logits_are_the_ranks_slices_in_rank_order(reference, name):
    """Under (2, 4) each batch group's four slices are the whole head's
    vocab columns r·V/4 .. (r+1)·V/4 of those rows, and `unembed` returns
    them joined in that order."""
    case = BY_NAME[name]
    cfg = mr.port_cfg(case)
    params = mr.port_params(reference, case, cfg)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    whole = transformer.unembed(params, cfg, x)
    with mesh_context(mr.port_mesh("2x4")):
        parts = transformer.unembed_ranks(params, cfg, x)
        joined = transformer.unembed(params, cfg, x)
    v = cfg.vocab_size // 4
    assert [rows for rows, _ in parts] == [slice(0, 2), slice(2, 4)]
    for rows, ranks in parts:
        assert len(ranks) == 4
        for r, t in enumerate(ranks):
            assert t.shape == (2, 16, v)
            np.testing.assert_allclose(
                t.numpy(), whole[rows, :, r * v:(r + 1) * v].numpy(),
                rtol=0, atol=1e-5 * float(whole.abs().max()))
            assert torch.equal(joined[rows, :, r * v:(r + 1) * v], t)


class _Outputs(TorchDispatchMode):
    """Records the shape of every op's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("name", ["untied", "tied"])
@pytest.mark.parametrize("tag", MESHES)
def test_loss_grad_never_forms_the_whole_logits(reference, name, tag):
    """No op of ``make_loss_grad`` under tp > 1, forward or backward,
    outputs logits over the whole vocab for a batch group's positions
    ((B, S, V), (rows, S, V) or their flattened (B·S, V), (rows·S, V)),
    while the ranks' (rows, S, V / tp) slices are there; with no mesh the
    whole (B, S, V) logits are."""
    case = BY_NAME[name]
    cfg = mr.port_cfg(case)
    params = mr.port_params(reference, case, cfg)
    batch, labels, _ = mr.port_inputs(reference, case, 4)
    job = JobConfig(model=cfg, shape=InputShape("t", mr.PROMPT, 4, "train"),
                    n_workers=mr.N_W)
    step = make_loss_grad(cfg, job, "full")
    mask = torch.from_numpy(mr.MASK.copy())
    mesh = mr.port_mesh(tag)
    tp, groups = mesh.shape["model"], mesh.shape["data"]
    b, s, v = 4, mr.PROMPT, cfg.vocab_size
    rows = b // groups
    whole = {(b, s, v), (rows, s, v), (b * s, v), (rows * s, v)}
    seen = {}
    for key, on in (("none", None), ("mesh", mesh)):
        rec = _Outputs()
        with mesh_context(on), rec:
            step(params, dict(batch, labels=labels), mask)
        seen[key] = set(rec.shapes)
    assert (b, s, v) in seen["none"]
    assert not whole & seen["mesh"]
    assert (rows, s, v // tp) in seen["mesh"]
