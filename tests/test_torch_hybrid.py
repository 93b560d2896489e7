"""The hybrid family (Zamba2) of the port against the reference, at
``zamba2-7b.reduced()`` with 5 layers and ``attn_every`` 2: two
super-groups of two Mamba2 layers and the one shared attention/MLP block,
then a tail of one Mamba2 layer. The parameter and cache layouts, the
training forward (attention through ``flash_mha``'s plain path and through
the plain core), the loss and gradients against ``jax.grad`` of the
reference's ``make_loss_grad`` (the shared block's gradient summed over
its two sites), ``model_zoo.prefill`` and ``decode_step`` in float32 and
all-bf16, the port's own prefill and prefill-then-decode against its
forward (tests/test_prefill.py), ``train_zoo`` against the reference's,
and the serve launcher. Weights come from the reference's ``init_params``
and are carried across with ``convert``. Tolerances as in
tests/torch_parity.py; the port against its own forward at the reference
tests' 2e-3."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as jax_zoo
from repro.sim import engine as jax_engine
from repro.train import trainer as jax_trainer
from repro.train.zoo_program import init_zoo_state as jax_init_zoo
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import hybrid, model_zoo, ssm
from repro_torch.sim import engine
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves
from torch_parity import (assert_loss_grad_match, close, close_trees, f32,
                          jobs, loss_grad_both, ref_caches, ref_params,
                          to_port)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCH = "zamba2-7b"
OVER = {"num_layers": 5}
B = 2
SELF_TOL = 2e-3


def _cfgs(act="float32", **over):
    job, jjob = jobs(ARCH, act=act, **OVER, **over)
    return job.model, jjob.model


def _tokens(cfg, s, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_hybrid_layout_matches_reference():
    """Groups stacked (G, k, ...), one shared block, a tail; the caches'
    ssm_groups (G, k, ...), attn (G, ...) and ssm_tail: the reference's
    keys, leaf order and shapes (``convert`` raises on any other)."""
    cfg, jcfg = _cfgs()
    assert hybrid._groups(cfg) == (2, 1)
    params, caches = ref_params(jcfg), ref_caches(jcfg, B, 16)
    tp, tc = convert.serve_state_from_reference(params, caches, cfg, B, 16,
                                                device="cpu")
    assert sorted(tp) == sorted(model_zoo.param_defs(cfg)) == [
        "embed", "groups", "lm_head", "ln_f", "shared", "tail"]
    assert sorted(tc) == ["attn", "ssm_groups", "ssm_tail"]
    assert tuple(tp["groups"]["ssm"]["wx"].shape[:2]) == (2, 2)


@pytest.mark.parametrize("flash", [False, True])
def test_hybrid_forward_matches_reference(flash):
    cfg, jcfg = _cfgs(use_flash_attention=flash)
    params = ref_params(jcfg)
    toks = _tokens(cfg, 24)
    want, _ = jax_zoo.forward(params, jcfg.with_(use_flash_attention=False),
                              {"tokens": toks}, remat="none")
    got, aux = model_zoo.forward(to_port(params), cfg, {"tokens": _t(toks)},
                                 remat="none")
    assert float(aux) == 0.0 and tuple(got.shape) == (B, 24, cfg.vocab_size)
    close(got, want)


@pytest.mark.parametrize("mask", ["full", "preempted"])
def test_hybrid_loss_grad_matches_reference(mask):
    """One loss-and-gradient step against ``jax.grad`` of the reference,
    every leaf; the shared block, applied at both sites, carries the sum
    of its sites' gradients, as the reference's does."""
    job, jjob = jobs(ARCH, **OVER)
    grads, loss, jg, jl = loss_grad_both(job, jjob, mask)
    assert_loss_grad_match(grads, loss, jg, jl)
    shared = grads["shared"]["attn"]["wq"]
    assert float(shared.abs().max()) > 0
    close(shared, jg["shared"]["attn"]["wq"])


def _serve_ref(params, jcfg, toks, s, seq):
    """The reference's prefill of ``s`` tokens and three decode steps:
    (logits of each call, final caches)."""
    jc = ref_caches(jcfg, B, seq)
    out, jc = jax_zoo.prefill(params, jcfg, {"tokens": toks[:, :s]}, jc)
    logits = [out]
    for i in range(s, s + 3):
        out, jc = jax_zoo.decode_step(params, jcfg, toks[:, i:i + 1], jc,
                                      jnp.int32(i))
        logits.append(out)
    return logits, jc


def _as_close_to_float32(got, want, want32):
    """``got`` lies as close to the reference's float32 result ``want32``
    as the reference's bf16 result ``want`` does: within twice its
    distance, relative to the largest |want32|."""
    want32 = f32(want32)
    scale = np.abs(want32).max()
    theirs = np.abs(f32(want) - want32).max() / scale
    ours = np.abs(f32(got) - want32).max() / scale
    assert ours <= 2 * theirs, (ours, theirs)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_hybrid_prefill_and_decode_match_reference(act):
    """A chunked prefill of 12 tokens from fresh caches, then three decode
    steps: the logits of each call and every cache leaf (SSM states, conv
    context, the sites' K/V and positions) against the reference's. In
    all-bf16 the hybrid is held to the reference's float32 computation on
    the same weights: each output as close to it as the reference's own
    bf16 one, within twice its distance. (Five layers of bf16 residuals,
    two of them the shared block's, take the reference's bf16 logits up to
    2.6e-2 of their largest from float32 and its tail's SSM state 2.6e-2;
    the port's lie 1.3e-2 to 3.8e-2 from it, so the two differ by up to
    3.6e-2, beyond tests/test_torch_decode.py's direct 3e-2; measured on
    the CPU.)"""
    cfg, jcfg = _cfgs(act)
    params = ref_params(jcfg)
    seq, s = 16, 12
    toks = _tokens(cfg, s + 3)
    want, jc = _serve_ref(params, jcfg, toks, s, seq)
    tp = to_port(params)
    got = []
    with torch.no_grad():
        out, tc = model_zoo.prefill(tp, cfg, {"tokens": _t(toks[:, :s])},
                                    to_port(ref_caches(jcfg, B, seq)))
        got.append(out)
        for i in range(s, s + 3):
            out, tc = model_zoo.decode_step(tp, cfg, _t(toks[:, i:i + 1]),
                                            tc, i)
            got.append(out)
    if act == "float32":
        for a, b in zip(got, want):
            close(a, b)
        close_trees(tc, jc)
        return
    want32, jc32 = _serve_ref(
        jax.tree.map(lambda a: a.astype(np.float32), params),
        jcfg.with_(dtype="float32", param_dtype="float32"), toks, s, seq)
    for a, b, c in zip(got, want, want32):
        assert a.dtype == torch.bfloat16
        _as_close_to_float32(a, b, c)
    for x, y, y32 in zip(tree_leaves(tc), jax.tree.leaves(jc),
                         jax.tree.leaves(jc32)):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
        if x.is_floating_point():
            _as_close_to_float32(x, y, y32)
        else:
            np.testing.assert_array_equal(x.numpy(), y)


def _self_setup(s):
    """The port's own weights (float32) with the SSD chunk set to ``s``, so
    a prompt of ``s`` tokens is one whole chunk (tests/test_prefill.py)."""
    cfg, jcfg = _cfgs()
    cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, chunk_size=s))
    params = to_port(ref_params(jcfg))
    toks = _t(_tokens(cfg, s, seed=7))
    with torch.no_grad():
        ref_logits, _ = model_zoo.forward(params, cfg, {"tokens": toks},
                                          remat="none")
    return cfg, params, toks, ref_logits


def _fresh(cfg, seq):
    from repro_torch.models.common import init_params

    return init_params(model_zoo.cache_defs(cfg, B, seq), 0, device="cpu")


def test_hybrid_prefill_matches_forward():
    cfg, params, toks, ref_logits = _self_setup(16)
    with torch.no_grad():
        logits, _ = model_zoo.prefill(params, cfg, {"tokens": toks},
                                      _fresh(cfg, 32))
    assert float((logits - ref_logits).abs().max()) < SELF_TOL


def test_hybrid_prefill_then_decode_matches_forward():
    """Prefill the first half in one pass, decode the second half token by
    token: every logit against the teacher-forced forward."""
    cfg, params, toks, ref_logits = _self_setup(16)
    half = 8
    with torch.no_grad():
        logits, caches = model_zoo.prefill(params, cfg,
                                           {"tokens": toks[:, :half]},
                                           _fresh(cfg, 16))
        np.testing.assert_allclose(f32(logits), f32(ref_logits[:, :half]),
                                   atol=SELF_TOL)
        for t in range(half, 16):
            lg, caches = model_zoo.decode_step(params, cfg,
                                               toks[:, t:t + 1], caches, t)
            err = float((lg[:, 0] - ref_logits[:, t]).abs().max())
            assert err < SELF_TOL, (t, err)


def test_hybrid_serving_never_runs_the_training_route():
    """Prefill and decode run under no_grad: the SSD takes
    ``ops.ssd_chunked`` (K3 on the card), never the training route; the
    training forward takes the training route once per Mamba2 layer."""
    cfg, jcfg = _cfgs()
    params = to_port(ref_params(jcfg))
    toks = _t(_tokens(cfg, 12))
    ssm.ssd_chunked.calls = 0
    nxt, caches = serve.prefill_prompt(cfg, params, _fresh(cfg, 16), toks)
    serve.greedy_decode(cfg, params, caches, nxt, 12, 2)
    assert ssm.ssd_chunked.calls == 0
    for x in tree_leaves(params):
        x.requires_grad_()
    model_zoo.forward(params, cfg, {"tokens": toks},
                                  remat="none")
    assert ssm.ssd_chunked.calls == cfg.num_layers


def _trace_scenario(mod_engine):
    trace = np.asarray([0.3, 0.7, 0.95, 0.45, 0.3, 0.7], np.float32)
    bids = np.asarray([0.9, 0.9, 0.5, 0.5], np.float32)
    return mod_engine.Scenario(
        price=mod_engine.PriceSpec.from_trace_ticks(trace), alpha=0.1,
        bid_schedule=np.tile(bids, (4, 1)), rt_kind="det", rt_const=1.0,
        idle_step=0.5, name="trace"), len(trace)


def test_hybrid_train_zoo_matches_reference():
    """``train_zoo`` of the reduced hybrid (float32) against the
    reference's on an RNG-free market, from the same weights: the market's
    accounting exactly, the losses and every final leaf at 1e-4."""
    job, jjob = jobs(ARCH, b=4, s=16, **OVER)
    jsc, n_ticks = _trace_scenario(jax_engine)
    jres = jax_trainer.train_zoo(jjob, [jsc], seeds=[0], n_ticks=n_ticks,
                                 donate=False)
    model0 = jax.tree.map(np.asarray, jax_init_zoo(
        jjob.model, jjob, jax.random.PRNGKey(jjob.seed)))
    res = trainer.train_zoo(
        job, [_trace_scenario(engine)[0]], seeds=[0], n_ticks=n_ticks,
        model0=convert.zoo_state_from_reference(model0, job.model,
                                                device="cpu"),
        device="cpu")
    for field in ("iterations", "ys", "total_time", "total_cost"):
        np.testing.assert_array_equal(getattr(res, field),
                                      np.asarray(getattr(jres, field)))
    assert int(res.iterations.sum()) > 0
    np.testing.assert_allclose(res.losses, np.asarray(jres.losses),
                               rtol=1e-4, atol=1e-4)
    a, b = tree_leaves(res.final_model), jax.tree.leaves(jres.final_model)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-4)


def test_serve_launcher_serves_the_hybrid(capsys):
    """``python -m repro_torch.launch.serve --arch zamba2-7b`` on the CPU:
    the reduced hybrid's prefill and greedy tokens."""
    serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "16",
                "--gen", "4", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == ARCH and len(out["sample"]) == 4
    assert all(0 <= t < 512 for t in out["sample"])


def test_supervised_worker_trains_the_hybrid(tmp_path):
    """The training launcher's zoo route (``launch.train --supervise --zoo
    --arch zamba2-7b`` pins this spec and runs this worker, which runs
    ``train_zoo``), in process on the CPU at the reduced width: checkpoints
    every 3 ticks and a final one at the tick budget."""
    from repro_torch.launch import supervisor
    from repro_torch.launch.workload import WorkerSpec

    WorkerSpec(arch=ARCH, zoo=True, n_workers=4, global_batch=4, seq_len=16,
               bids=((0.9, 0.9, 0.5, 0.5),), iterations=3, seeds=1,
               n_ticks=6, save_every=3).save(
        str(tmp_path / supervisor.SPEC_NAME))
    assert supervisor.worker_main(str(tmp_path), "cpu") == 0
    with open(tmp_path / supervisor.RESULT_NAME) as f:
        result = json.load(f)
    assert result["final_tick"] == 6 and result["device"] == "cpu"
