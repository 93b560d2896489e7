"""The enc-dec family (Whisper) of the port against the reference, at
``whisper-base.reduced()``: one encoder layer over 64 stub frames, two
decoder layers (self-attention, cross-attention, MLP), 4 query heads over
2 key/value heads of 64, absolute sinusoidal positions. The sinusoidal
embeddings, the parameter and cache layouts, ``build_cross_cache``, the
cross-attention block (full sequence and against the cross cache), the
training forward (the encoder's non-causal and the decoder's causal
self-attention through ``flash_mha``'s plain path and through the plain
core), the loss and gradients against ``jax.grad`` of the reference's
``make_loss_grad``, ``model_zoo.prefill`` (building the cross cache from
the frames) and ``decode_step`` in float32 and all-bf16, the port's own
prefill and prefill-then-decode against its forward
(tests/test_prefill.py), ``train_zoo`` against the reference's, and the
serve launcher's enc-dec limit, mirrored. Weights come from the
reference's ``init_params`` and are carried across with ``convert``.
Tolerances as in tests/torch_parity.py; the port against its own forward
at the reference tests' 2e-3."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jax_serve
from repro.models import attention as jax_attn
from repro.models import encdec as jax_encdec
from repro.models import model_zoo as jax_zoo
from repro.models.common import sinusoidal_at as jax_sinusoidal_at
from repro.sim import engine as jax_engine
from repro.train import trainer as jax_trainer
from repro.train.zoo_program import init_zoo_state as jax_init_zoo
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import attention, encdec, model_zoo
from repro_torch.models.common import init_params, sinusoidal_at
from repro_torch.sim import engine
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves
from torch_parity import (assert_loss_grad_match, close, close_trees, f32,
                          jobs, loss_grad_both, ref_batch, ref_caches,
                          ref_params, to_port, torch_batch)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCH = "whisper-base"
B = 2
SELF_TOL = 2e-3
#: sinusoidal embeddings in float32: the angle p·f is one float32 product
#: on both sides, but the frequencies f come from each framework's exp and
#: may differ by an ulp, which moves the angle by up to an ulp of it: below
#: position 2048 that is 1.2e-4, and sin and cos move by as much. Two such
#: ulps: 2.5e-4 (measured on the CPU: 1.22e-4 over 1500 positions, d 256
#: and 512)
SIN_TOL = 2.5e-4


def _cfgs(act="float32", **over):
    job, jjob = jobs(ARCH, act=act, **over)
    return job.model, jjob.model


def _frames(cfg, seed=5):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder.src_len, cfg.d_model)) * 0.5).astype(np.float32)


def _tokens(cfg, s, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("d", [256, 512])
def test_sinusoidal_positions_match_reference(d):
    pos = np.arange(1500, dtype=np.int32).reshape(3, 500)
    want = np.asarray(jax_sinusoidal_at(jnp.asarray(pos), d))
    got = sinusoidal_at(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SIN_TOL)


def test_encdec_layout_matches_reference():
    """Encoder and decoder layers stacked, the decoder's cross-attention
    beside its self-attention; caches {"self", "cross"}, the cross cache
    (L, B, src_len, Hkv, D) with int32 positions: the reference's keys,
    leaf order and shapes (``convert`` raises on any other)."""
    cfg, jcfg = _cfgs()
    params, caches = ref_params(jcfg), ref_caches(jcfg, B, 16)
    tp, tc = convert.serve_state_from_reference(params, caches, cfg, B, 16,
                                                device="cpu")
    assert sorted(tp["dec_layers"]) == sorted(
        model_zoo.param_defs(cfg)["dec_layers"])
    assert sorted(tc) == ["cross", "self"]
    one = attention.cross_cache_defs(cfg, B, cfg.encoder.src_len)
    assert one["k"].shape == (B, 64, 2, 64)
    assert one["pos"].dtype == torch.int32 and one["pos"].init == "zeros"
    assert tuple(tc["cross"]["k"].shape) == (cfg.num_layers, B, 64, 2, 64)


def test_build_cross_cache_matches_reference():
    """The encoder's states times each decoder layer's wk and wv (no
    biases, as the reference), and the source positions."""
    cfg, jcfg = _cfgs()
    params = ref_params(jcfg)
    frames = _frames(cfg)
    want = jax_encdec.build_cross_cache(params, jcfg, frames)
    with torch.no_grad():
        got = encdec.build_cross_cache(to_port(params), cfg,
                                       torch.from_numpy(frames))
    assert got["pos"].dtype == torch.int32
    close_trees(got, want)


def test_cross_attention_block_matches_reference():
    """The decoder's cross-attention over the encoder's states (no rope,
    neither causal nor windowed), then against a cross cache, which comes
    back as it came."""
    cfg, jcfg = _cfgs()
    params = ref_params(jcfg)
    p = jax.tree.map(lambda a: a[0], params["dec_layers"]["cross_attn"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 64, cfg.d_model)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(7, 12, dtype=np.int32), (B, 5))
    kpos = np.broadcast_to(np.arange(64, dtype=np.int32), (B, 64))
    want, _ = jax_attn.attention_block(p, jcfg, x, qpos, kv_src=src,
                                       kv_pos=kpos, causal=False)
    tp = to_port(p)
    got, none = attention.attention_block(
        tp, cfg, torch.from_numpy(x), torch.from_numpy(qpos.copy()),
        kv_src=torch.from_numpy(src), kv_pos=torch.from_numpy(kpos.copy()),
        causal=False)
    assert none is None
    close(got, want)
    cache = jax.tree.map(lambda a: np.asarray(a)[0],
                         jax_encdec.build_cross_cache(params, jcfg,
                                                      _frames(cfg)))
    want, _ = jax_attn.attention_block(p, jcfg, x, qpos, cache=cache,
                                       causal=False, cross_cached=True)
    tcache = to_port(cache)
    got, back = attention.attention_block(
        tp, cfg, torch.from_numpy(x), torch.from_numpy(qpos.copy()),
        cache=tcache, causal=False, cross_cached=True)
    assert back is tcache
    close(got, want)


@pytest.mark.parametrize("flash", [False, True])
def test_encdec_forward_matches_reference(flash):
    cfg, jcfg = _cfgs(use_flash_attention=flash)
    params = ref_params(jcfg)
    toks, frames = _tokens(cfg, 24), _frames(cfg)
    want, _ = jax_zoo.forward(params, jcfg.with_(use_flash_attention=False),
                              {"tokens": toks, "frames": frames},
                              remat="none")
    got, aux = model_zoo.forward(
        to_port(params), cfg,
        {"tokens": _t(toks), "frames": torch.from_numpy(frames)},
        remat="none")
    assert float(aux) == 0.0 and tuple(got.shape) == (B, 24, cfg.vocab_size)
    close(got, want)


@pytest.mark.parametrize("mask", ["full", "preempted"])
def test_encdec_loss_grad_matches_reference(mask):
    """One loss-and-gradient step on the reference's batch (tokens and
    frames) against ``jax.grad`` of the reference, every leaf of the
    encoder and the decoder."""
    job, jjob = jobs(ARCH)
    assert "frames" in ref_batch(jjob)
    grads, loss, jg, jl = loss_grad_both(job, jjob, mask)
    assert_loss_grad_match(grads, loss, jg, jl)
    assert float(grads["enc_layers"]["attn"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_encdec_prefill_and_decode_match_reference(act):
    """``prefill`` of 12 tokens with the frames (the encoder and the cross
    cache), then three decode steps: the logits of each call and every
    cache leaf against the reference's."""
    cfg, jcfg = _cfgs(act)
    params = ref_params(jcfg)
    seq, s = 16, 12
    toks, frames = _tokens(cfg, s + 3), _frames(cfg)
    jc = ref_caches(jcfg, B, seq)
    tp, tc = to_port(params), to_port(jc)
    want, jc = jax_zoo.prefill(params, jcfg,
                               {"tokens": toks[:, :s], "frames": frames}, jc)
    with torch.no_grad():
        got, tc = model_zoo.prefill(
            tp, cfg, {"tokens": _t(toks[:, :s]),
                      "frames": torch.from_numpy(frames)}, tc)
    close(got, want, act)
    close_trees(tc, jc, act)
    for i in range(s, s + 3):
        want, jc = jax_zoo.decode_step(params, jcfg, toks[:, i:i + 1], jc,
                                       jnp.int32(i))
        with torch.no_grad():
            got, tc = model_zoo.decode_step(tp, cfg, _t(toks[:, i:i + 1]),
                                            tc, i)
        close(got, want, act)
    close_trees(tc, jc, act)


def _self_setup(s=16):
    cfg, jcfg = _cfgs()
    params = to_port(ref_params(jcfg))
    batch = {"tokens": _t(_tokens(cfg, s, seed=7)),
             "frames": torch.from_numpy(_frames(cfg, seed=8))}
    with torch.no_grad():
        ref_logits, _ = model_zoo.forward(params, cfg, batch, remat="none")
    return cfg, params, batch, ref_logits


def _fresh(cfg, seq):
    return init_params(model_zoo.cache_defs(cfg, B, seq), 0, device="cpu")


def test_encdec_prefill_matches_forward():
    cfg, params, batch, ref_logits = _self_setup()
    with torch.no_grad():
        logits, caches = model_zoo.prefill(params, cfg, batch,
                                           _fresh(cfg, 32))
    assert float((logits - ref_logits).abs().max()) < SELF_TOL
    assert bool((caches["cross"]["pos"] == torch.arange(64)).all())


def test_encdec_prefill_then_decode_matches_forward():
    """Prefill the first half (with the frames) in one pass, decode the
    second half token by token against the cross cache: every logit
    against the teacher-forced forward."""
    cfg, params, batch, ref_logits = _self_setup()
    half = 8
    with torch.no_grad():
        logits, caches = model_zoo.prefill(
            params, cfg, {"tokens": batch["tokens"][:, :half],
                          "frames": batch["frames"]}, _fresh(cfg, 16))
        np.testing.assert_allclose(f32(logits), f32(ref_logits[:, :half]),
                                   atol=SELF_TOL)
        cross = caches["cross"]
        for t in range(half, 16):
            lg, caches = model_zoo.decode_step(
                params, cfg, batch["tokens"][:, t:t + 1], caches, t)
            assert caches["cross"] is cross
            err = float((lg[:, 0] - ref_logits[:, t]).abs().max())
            assert err < SELF_TOL, (t, err)


def test_encode_runs_each_layer_under_remat():
    """``encode`` with remat "full" gives ``remat="none"``'s states bit for
    bit, layer 0's self-attention non-causal: a later frame changes an
    earlier frame's state."""
    cfg, jcfg = _cfgs()
    params = to_port(ref_params(jcfg))
    frames = torch.from_numpy(_frames(cfg))
    a = encdec.encode(params, cfg, frames, remat="none")
    b = encdec.encode(params, cfg, frames, remat="full")
    assert torch.equal(a, b)
    moved = frames.clone()
    moved[:, -1] += 1.0
    c = encdec.encode(params, cfg, moved, remat="none")
    assert float((c[:, 0] - a[:, 0]).abs().max()) > 0


def _trace_scenario(mod_engine):
    trace = np.asarray([0.3, 0.7, 0.95, 0.45, 0.3, 0.7], np.float32)
    bids = np.asarray([0.9, 0.9, 0.5, 0.5], np.float32)
    return mod_engine.Scenario(
        price=mod_engine.PriceSpec.from_trace_ticks(trace), alpha=0.1,
        bid_schedule=np.tile(bids, (4, 1)), rt_kind="det", rt_const=1.0,
        idle_step=0.5, name="trace"), len(trace)


def test_encdec_train_zoo_matches_reference():
    """``train_zoo`` of the reduced enc-dec (float32; its batches carry the
    frames) against the reference's on an RNG-free market, from the same
    weights: the market's accounting exactly, the losses and every final
    leaf at 1e-4."""
    job, jjob = jobs(ARCH, b=4, s=16)
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


def test_serve_launcher_cannot_serve_encdec_as_the_reference():
    """The reference's ``prefill_prompt`` hands ``prefill`` only tokens, so
    an enc-dec model lacks its frames there; the port mirrors it (the
    frames go to ``model_zoo.prefill`` directly, as above)."""
    cfg, jcfg = _cfgs()
    params = ref_params(jcfg)
    toks = _tokens(cfg, 8)
    with pytest.raises(KeyError, match="frames"):
        jax_serve.prefill_prompt(jcfg, params, ref_caches(jcfg, B, 16),
                                 jnp.asarray(toks))
    with pytest.raises(KeyError, match="frames"):
        serve.prefill_prompt(cfg, to_port(params), _fresh(cfg, 16), _t(toks))


def test_batches_carry_frames_to_the_model():
    """The zoo's batches for enc-dec carry the frames (B, src_len, d) the
    forward needs, as the reference's do."""
    job, jjob = jobs(ARCH)
    batch = torch_batch(ref_batch(jjob))
    assert tuple(batch["frames"].shape) == (4, 64, job.model.d_model)
    logits, _ = model_zoo.forward(to_port(ref_params(jjob.model)), job.model,
                                  batch)
    assert tuple(logits.shape) == (4, 32, job.model.vocab_size)


def test_supervised_worker_trains_the_encdec(tmp_path):
    """The training launcher's zoo route for ``--arch whisper-base``, in
    process on the CPU at the reduced width (its batches carry the
    frames)."""
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
