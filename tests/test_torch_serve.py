"""Serving the SSM family with the port against the reference: the Mamba2
block in its three branches (full sequence, chunked prefill from a cached
state, one-token decode), the SSM language model's ``forward``,
``prefill``, ``decode_step`` and ``cache_defs``, ``make_serve_step``, and
the launcher's ``prefill_prompt`` plus greedy decoding, at the reduced
Mamba2-1.3B (2 layers, d_model 256, 16 heads of P = 32, N = 32, chunk 64,
vocab 512). Weights and caches are drawn in the reference and carried
across with ``convert``; A_log, dt_bias and D are perturbed from their
constant initial values, and caches are random, so every term carries
weight. On the CPU the chunked SSD runs K3's plain version.

Activations run in float32 and, with float32 parameters, in bf16 (the
full-width config's activation dtype): jnp's ``@`` promotes bf16 × f32 to
float32, the port's `ssm._mm` mirrors it. The reference's own
``model_zoo`` cannot run that mix: its ``lax.scan`` over layers refuses a
carry that enters bf16 and leaves float32 (pinned below), so the model
is held against the reference's layers looped in Python, which is what
its scan would compute.

Tolerances: float32 throughout, summed in other orders (XLA's cumsum and
products against torch's), agree to ~1e-5 on logits of magnitude ~5:
1e-4 absolute and relative. With bf16 activations the embedding, the first
layer's norm and its decode output are rounded to bf16 on both sides from
float32 values that agree to an ulp or two; where two straddle a rounding
boundary an element moves by 2^-8 relative, so 2e-3. Prefill against
forward and decode against forward mirror tests/test_prefill.py and keep
its 2e-3, with one exception: with bf16 activations the decode branch
rounds layer 0's SSD output to the residual's bf16 (``y.astype(x.dtype)``
in the reference's ``ssm_block``) where the chunked branches keep it
float32, so there decode and forward differ by design by about one bf16
rounding, 2^-8 ≈ 4e-3 of an O(1) value, carried to the logits: 2e-2
(8.4e-3 measured). Greedy tokens must be equal wherever the reference's top-two
logit gap exceeds 1e-3, ten times the logit tolerance."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import serve as jax_serve
from repro.models import hybrid as jax_hybrid
from repro.models import model_zoo as jax_zoo
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro.models.common import init_params as jax_init_params
from repro.models.common import is_spec_leaf
from repro.train.train_step import make_serve_step as jax_serve_step
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import model_zoo, ssm
from repro_torch.train.train_step import make_serve_step
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "mamba2-1.3b"
B = 2
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-3, atol=2e-3)}
PREFILL_TOL = 2e-3
DECODE_TOL = {"float32": 2e-3, "bfloat16": 2e-2}
GAP = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(act="float32", chunk=None):
    """The reduced Mamba2 in both packages, activations in ``act``, the
    SSD chunk ``chunk`` if given."""
    out = []
    for archs in (ARCHS, JAX_ARCHS):
        cfg = archs[ARCH].reduced().with_(dtype=act)
        if chunk is not None:
            cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm,
                                                    chunk_size=chunk))
        out.append(cfg)
    return tuple(out)


def _params(jcfg, seed=1):
    """Reference float32 params (numpy), A_log, dt_bias and D perturbed."""
    params = jax.tree.map(np.asarray, jax_init_params(
        jax_zoo.param_defs(jcfg), jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    lay = params["layers"]["ssm"]
    lay["A_log"] = (rng.standard_normal(lay["A_log"].shape) * 0.5
                    ).astype(np.float32)
    lay["dt_bias"] = (rng.standard_normal(lay["dt_bias"].shape) * 0.5
                      ).astype(np.float32)
    lay["D"] = (1 + 0.3 * rng.standard_normal(lay["D"].shape)
                ).astype(np.float32)
    return params


def _caches(jcfg, batch=B, seq=256, seed=2, random=True):
    """Reference caches (numpy): random states and conv contexts, or the
    zeros ``init_params`` gives a fresh cache."""
    caches = jax.tree.map(np.asarray, jax_init_params(
        jax_zoo.cache_defs(jcfg, batch, seq), jax.random.PRNGKey(0),
        jnp.float32))
    if not random:
        return caches
    rng = np.random.default_rng(seed)
    return {k: (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
            for k, v in caches.items()}


def _tokens(cfg, s, batch=B, seed=4):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, s)).astype(np.int32)


def _t(a):
    """numpy → CPU tensor; token ids as int64, torch's index type."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.copy())


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _jax_lm(params, jcfg, tokens, caches=None):
    """The reference's SSM LM: its ``model_zoo`` (``forward``, or
    ``decode_step`` against ``caches``) in float32; with bf16 activations
    its layers looped in Python, so a bf16 residual may enter layer 0 and
    leave it float32, as its scan would not let it."""
    tokens = jnp.asarray(tokens)
    if jcfg.dtype == "float32":
        if caches is None:
            return jax_zoo.forward(params, jcfg, {"tokens": tokens},
                                   remat="none")[0], None
        return jax_zoo.decode_step(params, jcfg, tokens, caches,
                                   jnp.int32(0))
    x = jax_tf.embed_tokens(params, jcfg, tokens)
    new = []
    for i in range(jcfg.num_layers):
        c = None if caches is None else _layer(caches, i)
        x, nc = jax_hybrid._ssm_layer(_layer(params["layers"], i), jcfg, x,
                                      cache=c)
        new.append(nc)
    logits = jax_tf.unembed(params, jcfg, x)
    if caches is None:
        return logits, None
    return logits, jax.tree.map(lambda *a: jnp.stack(a), *new)


# ------------------------------------------------------------ the block


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch", ["full", "prefill", "decode"])
def test_ssm_block_matches_reference(branch, act):
    cfg, jcfg = _cfgs(act)
    params = _layer(_params(jcfg)["layers"], 1)["ssm"]
    caches = _layer(_caches(jcfg), 0)
    s = {"full": 128, "prefill": 128, "decode": 1}[branch]
    x = (np.random.default_rng(6).standard_normal((B, s, cfg.d_model))
         ).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(act))
    cache = None if branch == "full" else caches
    want, wcache = jax_ssm.ssm_block(params, jcfg, jx, cache=cache)
    tp = convert.tree_from_reference(params, device="cpu")
    tcache = None if cache is None else convert.tree_from_reference(
        cache, device="cpu")
    got, gcache = ssm.ssm_block(tp, cfg, _t(np.asarray(jx, np.float32)).to(
        cfg.activation_dtype()), cache=tcache)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_np(got), _f32(want), **TOL[act])
    if branch == "full":
        assert gcache is None
        return
    for k in ("h", "conv"):
        assert tuple(gcache[k].shape) == wcache[k].shape
        np.testing.assert_allclose(_np(gcache[k]), _f32(wcache[k]),
                                   **TOL[act], err_msg=k)


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_reference(act):
    cfg, jcfg = _cfgs(act)
    params = _params(jcfg)
    caches = _caches(jcfg)
    toks = _tokens(cfg, 128)
    tp, tc = convert.serve_state_from_reference(params, caches, cfg, B, 256,
                                                device="cpu")
    want, _ = _jax_lm(params, jcfg, toks)
    got, aux = model_zoo.forward(tp, cfg, {"tokens": _t(toks)})
    assert float(aux) == 0.0 and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _f32(want), **TOL[act])

    want, wc = _jax_lm(params, jcfg, toks, caches)
    got, gc = model_zoo.prefill(tp, cfg, {"tokens": _t(toks)}, tc)
    np.testing.assert_allclose(_np(got), _f32(want), **TOL[act])
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(gc[k]), _f32(wc[k]), **TOL[act])
    # the caches handed in are left as they were
    for k in ("h", "conv"):
        np.testing.assert_array_equal(_np(tc[k]), caches[k])

    nxt = toks[:, :1]
    want, wc = _jax_lm(params, jcfg, nxt, wc)
    got, gc = model_zoo.decode_step(tp, cfg, _t(nxt), gc, 128)
    assert tuple(got.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _f32(want), **TOL[act])
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(gc[k]), _f32(wc[k]), **TOL[act])


def test_reference_model_zoo_refuses_bf16_activations_with_f32_params():
    """Pins the reference fault the module docstring names: the day its
    scan takes the promotion, this fails and the bf16 tests above can hold
    the port against ``model_zoo`` itself."""
    _, jcfg = _cfgs("bfloat16")
    params = _params(jcfg)
    with pytest.raises(TypeError, match="carry"):
        jax_zoo.forward(params, jcfg,
                        {"tokens": jnp.asarray(_tokens(jcfg, 64))},
                        remat="none")


@pytest.mark.parametrize("full_width", [False, True])
def test_cache_defs_match_reference(full_width):
    cfg, jcfg = _cfgs()
    if full_width:
        cfg, jcfg = ARCHS[ARCH], JAX_ARCHS[ARCH]
    want = jax_zoo.cache_defs(jcfg, 8, 2080)
    got = model_zoo.cache_defs(cfg, 8, 2080)
    jleaves = jax.tree.leaves(want, is_leaf=is_spec_leaf)
    tleaves = tree_leaves(got)
    assert [s.shape for s in tleaves] == [s.shape for s in jleaves]
    assert [s.init for s in tleaves] == [s.init for s in jleaves]
    assert got["h"].dtype == torch.float32 and got["conv"].dtype is None
    if full_width:
        assert got["h"].shape == (48, 8, 64, 64, 128)
        assert got["conv"].shape == (48, 8, 3, 4352)


def test_full_width_param_count():
    """Mamba2-1.3B as published: 1,446,505,472 parameters."""
    defs = model_zoo.param_defs(ARCHS[ARCH])
    assert sum(int(np.prod(s.shape)) for s in tree_leaves(defs)) \
        == 1_446_505_472


def test_convert_checks_shapes():
    cfg, jcfg = _cfgs()
    params, caches = _params(jcfg), _caches(jcfg)
    with pytest.raises(ValueError, match="caches"):
        convert.serve_state_from_reference(params, caches, cfg, B + 1, 256,
                                           device="cpu")
    params["lm_head"] = params["lm_head"][:, :-1]
    with pytest.raises(ValueError, match="params"):
        convert.serve_state_from_reference(params, caches, cfg, B, 256,
                                           device="cpu")


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_prefill_matches_forward(act):
    """tests/test_prefill.py::test_prefill_matches_forward for the port."""
    s = 16
    cfg, jcfg = _cfgs(act, chunk=s)     # the prompt divides the chunk
    tp = convert.tree_from_reference(_params(jcfg), device="cpu")
    tc = convert.tree_from_reference(_caches(jcfg, seq=2 * s, random=False),
                                     device="cpu")
    toks = _t(_tokens(cfg, s))
    ref_logits, _ = model_zoo.forward(tp, cfg, {"tokens": toks})
    logits, _ = model_zoo.prefill(tp, cfg, {"tokens": toks}, tc)
    assert (logits - ref_logits).abs().max() < PREFILL_TOL


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_forward(act):
    """tests/test_prefill.py::test_prefill_then_decode_matches_forward for
    the port: prefill the first half in one shot (chunked SSD), decode the
    second token by token (the plain recurrence)."""
    s = 16
    cfg, jcfg = _cfgs(act, chunk=s)     # the prompt divides the chunk
    tp = convert.tree_from_reference(_params(jcfg), device="cpu")
    caches = convert.tree_from_reference(_caches(jcfg, seq=s, random=False),
                                         device="cpu")
    toks = _t(_tokens(cfg, s))
    ref_logits, _ = model_zoo.forward(tp, cfg, {"tokens": toks})
    half = s // 2
    logits, caches = model_zoo.prefill(tp, cfg, {"tokens": toks[:, :half]},
                                       caches)
    assert (logits - ref_logits[:, :half]).abs().max() < PREFILL_TOL
    for t in range(half, s):
        lg, caches = model_zoo.decode_step(tp, cfg, toks[:, t:t + 1], caches,
                                           t)
        assert (lg[:, 0] - ref_logits[:, t]).abs().max() < DECODE_TOL[act], t


# ------------------------------------------------------------ serving


def test_serve_step_matches_reference():
    cfg, jcfg = _cfgs()
    params, caches = _params(jcfg), _caches(jcfg)
    tp, tc = convert.serve_state_from_reference(params, caches, cfg, B, 256,
                                                device="cpu")
    toks = _tokens(cfg, 1)
    want_tok, want_c = jax.jit(jax_serve_step(jcfg))(
        params, caches, jnp.asarray(toks), jnp.int32(5))
    got_tok, got_c = make_serve_step(cfg)(tp, tc, _t(toks), 5)
    assert tuple(got_tok.shape) == (B, 1)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(got_c[k]), _f32(want_c[k]),
                                   **TOL["float32"])


def test_prefill_prompt_and_greedy_tokens_match_reference():
    """The launcher's path: ``prefill_prompt`` over a 128-token prompt (two
    chunks), then greedy serve steps. Each generated token equals the
    reference's wherever the reference's top-two gap exceeds ``GAP``; a
    row stops being compared after its first closer call (from there the
    two may feed different tokens)."""
    cfg, jcfg = _cfgs()
    params, caches = _params(jcfg), _caches(jcfg, random=False)
    tp, tc = convert.serve_state_from_reference(params, caches, cfg, B, 256,
                                                device="cpu")
    prompt = _tokens(cfg, 128)
    n_gen = 6
    # the reference: its prefill_prompt, then its serve step, with the
    # logits of every step kept for the gaps
    logits, jc = jax_zoo.prefill(params, jcfg,
                                 {"tokens": jnp.asarray(prompt)}, caches)
    want_first, _ = jax_serve.prefill_prompt(jcfg, params, caches,
                                             jnp.asarray(prompt))
    steps = [np.asarray(logits[:, -1], np.float32)]
    toks = [np.asarray(want_first)]
    for g in range(n_gen - 1):
        lg, jc = jax_zoo.decode_step(params, jcfg, jnp.asarray(toks[-1]), jc,
                                     jnp.int32(128 + g))
        steps.append(np.asarray(lg[:, -1], np.float32))
        toks.append(np.asarray(jnp.argmax(lg[:, -1:], axis=-1)))
    np.testing.assert_array_equal(toks[0][:, 0], steps[0].argmax(-1))

    ops.reset_launch_counts()
    nxt, tc = serve.prefill_prompt(cfg, tp, tc, _t(prompt))
    got, _ = serve.greedy_decode(cfg, tp, tc, nxt, 128, n_gen - 1)
    assert tuple(got.shape) == (B, n_gen)
    assert ops.launch_counts()["ssd_chunk"] == 0       # CPU: plain version
    live = np.ones(B, bool)
    compared = 0
    for g, lg in enumerate(steps):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        live &= (top2[:, 1] - top2[:, 0]) > GAP
        for r in np.flatnonzero(live):
            assert got[r, g].item() == toks[g][r, 0], (r, g)
            compared += 1
    assert compared >= B * n_gen // 2


@pytest.mark.parametrize("arch", [ARCH, "qwen2-7b", "deepseek-v2-lite-16b"])
def test_launcher_module_runs_on_the_cpu_without_jax(arch):
    """``python -m repro_torch.launch.serve --arch ARCH --device cpu``,
    through its ``__main__`` entry, in a process that never imports jax:
    the reduced Mamba2, dense Qwen2-7B (KV caches) and DeepSeek-V2-Lite
    (MLA's latent cache, MoE)."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['serve', '--arch', {arch!r}, '--device', 'cpu', "
        "'--batch', '2', '--prompt-len', '64', '--gen', '4']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "print('JAX_LOADED', 'jax' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    body, last = out.stdout.rsplit("\n", 2)[0], out.stdout.splitlines()[-1]
    assert last == "JAX_LOADED False"
    summary = json.loads(body)
    assert summary["arch"] == arch and summary["device"] == "cpu"
    assert len(summary["sample"]) == 4
    assert all(0 <= t < 512 for t in summary["sample"])
