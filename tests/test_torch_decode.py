"""Serving the decoder-only transformer with the port against the
reference: ``model_zoo.cache_defs``, ``prefill`` and ``decode_step`` for
the dense (DeepSeek-7B; Qwen2-7B with its QKV bias), VLM (InternVL2-1B,
text tokens only, as the reference decodes) and MoE families (MLA's latent
cache in DeepSeek-V2-Lite; Qwen2-MoE), at the reduced width, in float32
and all-bf16 (parameters, activations and caches; positions int32).
Weights come from the reference's ``init_params`` and are carried across
with ``convert``; zero-initialised QKV biases are perturbed so the bias
path carries weight. Then the port's own prefill and prefill-then-decode
against its forward (tests/test_prefill.py), the sliding-window ring cache
(tests/test_decode_consistency.py), and the cache write's clamp: JAX's
``dynamic_update_slice`` moves a start that would overrun the cache back
to ``W − S``, held against the reference's ``attention_block``.

Tolerances: float32 at 1e-4 absolute and relative (the same products
summed in other orders, tests/test_torch_serve.py's ``TOL``). All-bf16
logits and caches are bf16 themselves, one rounding step 2^-8 = 3.9e-3 of
their size, so test_torch_serve's bf16 entry (2e-3, for float32 logits)
cannot hold; and the two frameworks round bf16 intermediates at other
places (XLA keeps float32 across fused elementwise chains, torch rounds
after each op). The reference's own bf16 logits lie up to 1.5e-2 of the
largest logit from its float32 computation on the same weights, and the
port's up to 1.4e-2 (over these five configs, prefill and decode;
``test_bf16_port_as_close_to_float32_as_the_reference`` holds the port
within twice the reference's); two computations each that close to it
may differ by twice that: bf16 at 3e-2 of the largest magnitude of each
leaf (measured 1.1e-2). Port against its own forward at the reference
tests' 2e-3 (float32)."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import attention as jax_attn
from repro.models import mla as jax_mla
from repro.models import model_zoo as jax_zoo
from repro.models.common import init_params as jax_init_params
from repro.models.common import is_spec_leaf
from repro.train.train_step import make_serve_step as jax_serve_step
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention, mla, model_zoo
from repro_torch.models.common import init_params
from repro_torch.tree import tree_leaves

ARCHS_SERVED = ["deepseek-7b", "qwen2-7b", "internvl2-1b",
                "deepseek-v2-lite-16b", "qwen2-moe-a2.7b"]
B, S, SEQ = 2, 12, 16
TOL = {"float32": dict(rtol=1e-4, atol=1e-4)}
BF16_REL = 3e-2
SELF_TOL = 2e-3
GAP = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, act="float32", **over):
    """The reduced ``arch`` in both packages, parameters and activations
    in ``act``."""
    return tuple(archs[arch].reduced().with_(dtype=act, param_dtype=act,
                                             **over)
                 for archs in (ARCHS, JAX_ARCHS))


def _params(jcfg, seed=1):
    """Reference params (numpy) in the config's dtype, the QKV biases
    perturbed."""
    params = jax.tree.map(np.asarray, jax_init_params(
        jax_zoo.param_defs(jcfg), jax.random.PRNGKey(seed),
        jnp.dtype(jcfg.param_dtype)))
    rng = np.random.default_rng(seed)
    blk = params["layers"].get("attn", {})
    for name in ("bq", "bk", "bv"):
        if name in blk:
            leaf = blk[name]
            blk[name] = (leaf.astype(np.float32) + 0.1 * rng.standard_normal(
                leaf.shape)).astype(leaf.dtype)
    return params


def _caches(jcfg, seq=SEQ, batch=B):
    """A fresh reference cache (numpy): zeros, positions −1."""
    return jax.tree.map(np.asarray, jax_init_params(
        jax_zoo.cache_defs(jcfg, batch, seq), jax.random.PRNGKey(0),
        jnp.dtype(jcfg.param_dtype)))


def _tokens(cfg, s, batch=B, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, s)).astype(np.int32)


def _t(a):
    """numpy → CPU tensor; token ids as int64, torch's index type."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, act, what=""):
    want = _f32(want)
    if act == "float32":
        np.testing.assert_allclose(_f32(got), want, **TOL[act],
                                   err_msg=what)
    else:
        np.testing.assert_allclose(_f32(got), want, rtol=0,
                                   atol=BF16_REL * np.abs(want).max(),
                                   err_msg=what)


def _close_caches(got, want, act):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        if k == "pos":
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
            _close(got[k], want[k], act, k)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, act):
    """The reference's prefill of S tokens into a fresh cache, then one
    decode step: (logits, caches) of each, as numpy."""
    _, jcfg = _cfgs(arch, act)
    params, caches = _params(jcfg), _caches(jcfg)
    toks = _tokens(jcfg, S + 1)
    lg0, c0 = jax_zoo.prefill(params, jcfg,
                              {"tokens": jnp.asarray(toks[:, :S])}, caches)
    lg1, c1 = jax_zoo.decode_step(params, jcfg, jnp.asarray(toks[:, S:]), c0,
                                  jnp.int32(S))
    npy = functools.partial(jax.tree.map, np.asarray)
    return npy((lg0, c0)), npy((lg1, c1))


@pytest.mark.parametrize("full_width", [False, True])
@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_cache_defs_match_reference(arch, full_width):
    """``model_zoo.cache_defs`` (``lm_cache_defs`` of ``self_cache_defs``
    or ``mla_cache_defs``): shapes, initialisers and dtypes, the
    positions int32."""
    cfg, jcfg = _cfgs(arch)
    if full_width:
        cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    want = jax.tree.leaves(jax_zoo.cache_defs(jcfg, 8, 2080),
                           is_leaf=is_spec_leaf)
    got = tree_leaves(model_zoo.cache_defs(cfg, 8, 2080))
    assert [s.shape for s in got] == [s.shape for s in want]
    assert [s.init for s in got] == [s.init for s in want]
    assert [s.dtype for s in got] == [
        None if s.dtype is None else getattr(torch, jnp.dtype(s.dtype).name)
        for s in want]
    keys = sorted(model_zoo.cache_defs(cfg, 8, 2080))
    assert keys == (["ckv", "krope", "pos"] if cfg.mla else ["k", "pos", "v"])
    if full_width and arch == "qwen2-7b":
        assert got[0].shape == (28, 8, 2080, 4, 128)
    if full_width and arch == "deepseek-v2-lite-16b":
        assert [s.shape for s in got] == [(27, 8, 2080, 512),
                                          (27, 8, 2080, 64), (27, 8, 2080)]


@pytest.mark.parametrize("window", [None, 8])
def test_layer_cache_defs_match_reference(window):
    """``self_cache_defs`` and ``mla_cache_defs`` for one layer, with and
    without a sliding window (a ring of ``min(seq, window)`` slots)."""
    for arch, port_fn, jax_fn in (
            ("qwen2-7b", attention.self_cache_defs, jax_attn.self_cache_defs),
            ("deepseek-v2-lite-16b", mla.mla_cache_defs,
             jax_mla.mla_cache_defs)):
        cfg, jcfg = _cfgs(arch, sliding_window=window)
        got, want = port_fn(cfg, 3, 20), jax_fn(jcfg, 3, 20)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, (arch, k)
            assert got[k].shape[1] == (8 if window else 20)
            assert got[k].init == want[k].init
        assert got["pos"].dtype == torch.int32


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_prefill_matches_reference(arch, act):
    """A 12-token prompt into a fresh 16-slot cache: logits and every cache
    leaf; the caches handed in are left as they were."""
    cfg, jcfg = _cfgs(arch, act)
    params, caches = _params(jcfg), _caches(jcfg)
    tp, tc = convert.serve_state_from_reference(params, caches, cfg, B, SEQ,
                                                device="cpu")
    # the router's float32 override and the int32 positions keep their
    # dtypes across
    assert [str(x.dtype).split(".")[-1] for x in tree_leaves((tp, tc))] == [
        str(a.dtype) for a in jax.tree.leaves((params, caches))]
    (want, wc), _ = _reference_run(arch, act)
    toks = _tokens(cfg, S + 1)
    got, gc = model_zoo.prefill(tp, cfg, {"tokens": _t(toks[:, :S])}, tc)
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    assert got.dtype == cfg.activation_dtype()
    _close(got, want, act)
    _close_caches(gc, wc, act)
    assert gc["pos"][:, :, :S].tolist() == [[list(range(S))] * B] * 2
    assert (gc["pos"][:, :, S:] == -1).all()
    assert (tc["pos"] == -1).all() and not any(
        bool(x.any()) for k, x in tc.items() if k != "pos")


@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_bf16_port_as_close_to_float32_as_the_reference(arch):
    """The bf16 tolerance's ground: the reference's float32 prefill and
    decode step on the same (bf16) weights as the truth, the port's bf16
    logits lie no farther from it than twice the reference's own bf16
    logits (relative to the largest |logit|; measured up to 1.4e-2 and
    1.5e-2, their ratio at most 1.25)."""
    cfg, jcfg = _cfgs(arch, "bfloat16")
    _, jcfg32 = _cfgs(arch, "float32")
    params, caches = _params(jcfg), _caches(jcfg)
    up = functools.partial(jax.tree.map, lambda a: a if a.dtype == np.int32
                           else np.asarray(a, np.float32))
    toks = _tokens(cfg, S + 1)
    t0, c32 = jax_zoo.prefill(up(params), jcfg32,
                              {"tokens": jnp.asarray(toks[:, :S])},
                              up(caches))
    t1, _ = jax_zoo.decode_step(up(params), jcfg32, jnp.asarray(toks[:, S:]),
                                c32, jnp.int32(S))
    (r0, _), (r1, _) = _reference_run(arch, "bfloat16")
    tp, tc = convert.serve_state_from_reference(params, caches, cfg, B, SEQ,
                                                device="cpu")
    g0, gc = model_zoo.prefill(tp, cfg, {"tokens": _t(toks[:, :S])}, tc)
    g1, _ = model_zoo.decode_step(tp, cfg, _t(toks[:, S:]), gc, S)
    for got, ref, truth in ((g0, r0, t0), (g1, r1, t1)):
        truth = _f32(truth)
        scale = np.abs(truth).max()
        port_err = np.abs(_f32(got) - truth).max() / scale
        ref_err = np.abs(_f32(ref) - truth).max() / scale
        assert 0 < ref_err < BF16_REL and port_err <= 2 * ref_err, (
            port_err, ref_err)


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_decode_step_matches_reference(arch, act):
    """One decode step at position 12 from the reference's prefilled
    cache: logits and every cache leaf."""
    cfg, jcfg = _cfgs(arch, act)
    (_, c0), (want, wc) = _reference_run(arch, act)
    tp, tc = convert.serve_state_from_reference(_params(jcfg), c0, cfg, B,
                                                SEQ, device="cpu")
    toks = _tokens(cfg, S + 1)
    got, gc = model_zoo.decode_step(tp, cfg, _t(toks[:, S:]), tc, S)
    assert tuple(got.shape) == (B, 1, cfg.vocab_size)
    _close(got, want, act)
    _close_caches(gc, wc, act)


def _port_setup(arch, s, seed=3):
    """A reduced ``arch`` in the port alone (float32), MoE capacity 8 so no
    assignment is dropped (as the reference's own tests set it)."""
    cfg = ARCHS[arch].reduced()
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                capacity_factor=8.0))
    params = init_params(model_zoo.param_defs(cfg), seed, device="cpu")
    toks = _t(_tokens(cfg, s, seed=seed))
    return cfg, params, toks


@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_prefill_matches_forward(arch):
    """tests/test_prefill.py::test_prefill_matches_forward for the port."""
    s = 16
    cfg, params, toks = _port_setup(arch, s)
    ref_logits, _ = model_zoo.forward(params, cfg, {"tokens": toks})
    caches = init_params(model_zoo.cache_defs(cfg, B, 2 * s), 0,
                         device="cpu")
    logits, _ = model_zoo.prefill(params, cfg, {"tokens": toks}, caches)
    assert (logits - ref_logits).abs().max() < SELF_TOL


@pytest.mark.parametrize("arch", ARCHS_SERVED)
def test_prefill_then_decode_matches_forward(arch):
    """tests/test_prefill.py::test_prefill_then_decode_matches_forward for
    the port: the first half in one cached pass, the rest token by
    token."""
    s = 16
    cfg, params, toks = _port_setup(arch, s)
    ref_logits, _ = model_zoo.forward(params, cfg, {"tokens": toks})
    caches = init_params(model_zoo.cache_defs(cfg, B, s), 0, device="cpu")
    half = s // 2
    logits, caches = model_zoo.prefill(params, cfg,
                                       {"tokens": toks[:, :half]}, caches)
    assert (logits - ref_logits[:, :half]).abs().max() < SELF_TOL
    for t in range(half, s):
        lg, caches = model_zoo.decode_step(params, cfg, toks[:, t:t + 1],
                                           caches, t)
        assert (lg[:, 0] - ref_logits[:, t]).abs().max() < SELF_TOL, t
    assert caches["pos"][0, 0].tolist() == list(range(s))


def test_sliding_window_decode_matches_windowed_forward():
    """tests/test_decode_consistency.py's ring-buffer test for the port: a
    window of 8, 24 tokens decoded one by one into an 8-slot cache, against
    the port's windowed forward (2e-3) and the reference's decode (1e-4)."""
    s = 24
    cfg, jcfg = _cfgs("deepseek-7b", sliding_window=8)
    params = _params(jcfg)
    toks = _tokens(cfg, s)
    tp, tc = convert.serve_state_from_reference(
        params, _caches(jcfg, seq=s), cfg, B, s, device="cpu")
    assert tuple(tc["k"].shape[1:3]) == (B, 8)
    ref_logits, _ = model_zoo.forward(tp, cfg, {"tokens": _t(toks)})
    jc = _caches(jcfg, seq=s)
    for t in range(s):
        lg, tc = model_zoo.decode_step(tp, cfg, _t(toks[:, t:t + 1]), tc, t)
        jl, jc = jax_zoo.decode_step(params, jcfg, jnp.asarray(
            toks[:, t:t + 1]), jc, jnp.int32(t))
        assert (lg[:, 0] - ref_logits[:, t]).abs().max() < SELF_TOL, t
        np.testing.assert_allclose(_f32(lg), _f32(jl), **TOL["float32"])
    # the ring holds the last 8 positions, each at its slot t % 8
    assert tc["pos"][0, 0].tolist() == [16, 17, 18, 19, 20, 21, 22, 23]


@pytest.mark.parametrize("window", [8, None])
def test_clamped_cache_write_matches_reference(window):
    """A 4-token chunk at position 6 of an 8-slot cache (window 8: slot
    6 % 8 = 6; no window: slot 6). 6 + 4 overruns the cache, so JAX clamps
    the start to 8 − 4 = 4 and the chunk overwrites slots 4 and 5; the
    port's write does the same. Output and new cache against the
    reference's ``attention_block``."""
    cfg, jcfg = _cfgs("qwen2-7b", sliding_window=window)
    params = _params(jcfg)
    p = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    rng = np.random.default_rng(7)
    w, hkv, dh = 8, cfg.num_kv_heads, cfg.resolved_head_dim
    cache = {"k": rng.standard_normal((B, w, hkv, dh)).astype(np.float32),
             "v": rng.standard_normal((B, w, hkv, dh)).astype(np.float32),
             "pos": np.tile(np.asarray([0, 1, 2, 3, 4, 5, -1, -1], np.int32),
                            (B, 1))}
    x = rng.standard_normal((B, 4, cfg.d_model)).astype(np.float32)
    qpos = np.tile(np.arange(6, 10, dtype=np.int32), (B, 1))
    want, wc = jax_attn.attention_block(p, jcfg, jnp.asarray(x),
                                        jnp.asarray(qpos), cache=cache,
                                        cache_pos=jnp.int32(6))
    tp = convert.tree_from_reference(p, device="cpu")
    tcache = convert.tree_from_reference(cache, device="cpu")
    got, gc = attention.attention_block(tp, cfg, torch.from_numpy(x),
                                        _t(qpos), cache=tcache, cache_pos=6)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])
    _close_caches(gc, wc, "float32")
    assert gc["pos"][0].tolist() == [0, 1, 2, 3, 6, 7, 8, 9]
    with pytest.raises(ValueError, match="do not fit"):
        attention.cache_write(tcache["k"], torch.zeros(B, 9, hkv, dh), 0)


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-v2-lite-16b"])
def test_launcher_path_matches_reference_greedy_tokens(arch):
    """The launcher's ``prefill_prompt`` over a 12-token prompt, then
    ``greedy_decode``'s serve steps, against the reference's prefill and
    serve step (float32). Each token equals the reference's wherever its
    top-two gap exceeds ``GAP`` (ten times the logit tolerance); a row is
    compared up to its first closer call. No kernel is launched: the
    cached path is the plain attention core, as in the reference."""
    cfg, jcfg = _cfgs(arch)
    params, caches = _params(jcfg), _caches(jcfg)
    tp, tc = convert.serve_state_from_reference(params, caches, cfg, B, SEQ,
                                                device="cpu")
    prompt, n_gen = _tokens(cfg, S), 4
    lg, jc = jax_zoo.prefill(params, jcfg, {"tokens": jnp.asarray(prompt)},
                             caches)
    gaps = [np.asarray(lg[:, -1], np.float32)]
    toks = [np.asarray(jnp.argmax(lg[:, -1:], axis=-1))]
    step = jax.jit(jax_serve_step(jcfg))
    for g in range(n_gen - 1):
        lg, _ = jax_zoo.decode_step(params, jcfg, jnp.asarray(toks[-1]), jc,
                                    jnp.int32(S + g))
        nxt, jc = step(params, jc, jnp.asarray(toks[-1]), jnp.int32(S + g))
        gaps.append(np.asarray(lg[:, -1], np.float32))
        toks.append(np.asarray(nxt))
    ops.reset_launch_counts()
    nxt, tc = serve.prefill_prompt(cfg, tp, tc, _t(prompt))
    got, tc = serve.greedy_decode(cfg, tp, tc, nxt, S, n_gen - 1)
    assert set(ops.launch_counts().values()) == {0}
    assert tuple(got.shape) == (B, n_gen)
    assert tc["pos"][0, 0].tolist() == list(range(S + n_gen - 1)) + [-1]
    live, compared = np.ones(B, bool), 0
    for g, lgs in enumerate(gaps):
        top2 = np.sort(lgs, axis=-1)[:, -2:]
        live &= (top2[:, 1] - top2[:, 0]) > GAP
        for r in np.flatnonzero(live):
            assert got[r, g].item() == toks[g][r, 0], (r, g)
            compared += 1
    assert compared >= B * n_gen // 2


@pytest.mark.parametrize("arch", ["internvl2-1b", "qwen2-moe-a2.7b"])
def test_serve_launcher_main_on_the_cpu(arch, capsys):
    """``launch.serve.main`` for the VLM (text decode) and the reduced
    Qwen2-MoE: its summary names the arch and the CPU, with four tokens in
    the reduced vocabulary."""
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "16", "--gen", "4"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["arch"] == arch and summary["device"] == "cpu"
    assert len(summary["sample"]) == 4
    assert all(0 <= t < 512 for t in summary["sample"])
