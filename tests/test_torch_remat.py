"""Activation rematerialisation in the port: ``remat="dots"`` (selective
checkpointing that keeps the outputs of products without batch dimensions,
the reference's ``dots_with_no_batch_dims_saveable``) and ``"full"``
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) for the
dense, SSM, hybrid and enc-dec families. Remat never changes a value: the
loss and every gradient leaf bit-equal to ``"none"``'s in the port, on the
CPU here (tests/test_torch_cuda.py holds the same on the card with K2 on
the path), and against the reference's checkpointed gradients at the
float32 tolerances of tests/torch_parity.py. Each checkpointed region runs
its forward again in the backward: the SSD's training route is called
twice a Mamba2 layer under both modes."""
import pytest
import torch

from repro_torch.models import model_zoo, ssm, transformer
from repro_torch.train.train_step import make_loss_grad
from repro_torch.tree import tree_leaves
from torch_parity import (assert_loss_grad_match, jobs, loss_grad_both,
                          ref_batch, ref_params, to_port, torch_batch)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

#: a family each: dense (Qwen2: QKV bias, GQA), SSM (Mamba2), hybrid
#: (Zamba2, two super-groups and a tail layer), enc-dec (Whisper)
FAMILIES = {"dense": ("qwen2-7b", {}), "ssm": ("mamba2-1.3b", {}),
            "hybrid": ("zamba2-7b", {"num_layers": 5}),
            "encdec": ("whisper-base", {})}


def _step(family, remat, act="float32"):
    """One loss-and-gradient step of the port with a preempted worker:
    (grads, loss, the SSD training route's calls)."""
    arch, over = FAMILIES[family]
    job, jjob = jobs(arch, act=act, **over)
    ssm.ssd_chunked.calls = 0
    grads, loss, _ = make_loss_grad(job.model, job, remat)(
        to_port(ref_params(jjob.model)), torch_batch(ref_batch(jjob)),
        torch.tensor([1.0, 0.0, 1.0, 1.0]))
    return grads, loss, ssm.ssd_chunked.calls


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_gradients_bit_equal_to_none(family, remat, act):
    grads, loss, calls = _step(family, remat, act)
    base, base_loss, base_calls = _step(family, "none", act)
    assert torch.equal(loss, base_loss)
    a, b = tree_leaves(grads), tree_leaves(base)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    if family in ("ssm", "hybrid"):
        arch, over = FAMILIES[family]
        cfg = jobs(arch, **over)[0].model
        assert base_calls == cfg.num_layers
        # every layer's region is checkpointed, but the hybrid's tail
        tail = cfg.num_layers % cfg.attn_every if cfg.attn_every else 0
        assert calls == 2 * cfg.num_layers - tail


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_gradients_match_reference_checkpointed(family, remat):
    """The port's checkpointed step against ``jax.grad`` of the
    reference's, both under ``remat``."""
    arch, over = FAMILIES[family]
    job, jjob = jobs(arch, **over)
    grads, loss, jg, jl = loss_grad_both(job, jjob, "preempted", remat=remat,
                                         jax_remat=remat)
    assert_loss_grad_match(grads, loss, jg, jl)


def test_dots_policy_keeps_only_products_without_batch_dims():
    """Plain and bias-added matrix products are kept; batched products,
    elementwise work and reductions are recomputed."""
    keep = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    redo = torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default):
        assert transformer._dots_policy(None, op) == keep
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default,
               aten.sum.dim_IntList):
        assert transformer._dots_policy(None, op) == redo


def test_dots_recomputes_less_than_full():
    """In the backward of one dense layer, "full" runs the forward's plain
    products again and "dots" does not."""
    job, jjob = jobs("qwen2-7b")
    params = to_port(ref_params(jjob.model))
    batch = torch_batch(ref_batch(jjob))
    counts = {}
    for remat in ("none", "dots", "full"):
        n = {"mm": 0}

        class Count(torch.utils._python_dispatch.TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func in (torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default):
                    n["mm"] += 1
                return func(*args, **(kwargs or {}))

        leaves = [x.requires_grad_() for x in tree_leaves(params)]
        logits, _ = model_zoo.forward(params, job.model, batch, remat=remat)
        with Count():
            torch.autograd.grad(logits.float().sum(), leaves)
        counts[remat] = n["mm"]
    assert counts["dots"] == counts["none"] < counts["full"]


def test_remat_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="remat"):
        transformer._remat(lambda x: x, "some")
