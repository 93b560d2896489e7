"""DeepSeek-V2-Lite's published block in the port, at a tiny float32 size
on the CPU: d 64, 4 heads, latent rank 32, rope 8, 16 experts of width 24
(top 6, not renormalised), a shared expert pair, one dense layer then two
MoE layers, YaRN's rope.

* The port's loss and every gradient leaf against the benchmark's plain
  reference (``bench/configs/deepseek-v2-lite.py``) on seeded weights,
  whole and holding the first 4 of the 16 experts.
* The expert share: four shares of four held experts each; each share's
  routed part matches the reference's on its experts, the parts plus the
  shared experts counted once add up to the uncut reference's MoE output,
  and the tables keep on each expert what the uncut layer keeps.
* YaRN's correction range and mscale² at the published sizes.
* Each new config field at its default leaves the registry's
  DeepSeek-V2-Lite and Qwen2-MoE forwards bit for bit what they compute
  without it, and at the parity tolerance of the JAX reference's.

Tolerances: the loss at rtol 1e-5; a gradient leaf at rtol 1e-4 and, for
entries near zero, within 1e-5 of the leaf's largest (the same float32
products summed in other orders: tests/test_torch_moe.py's rule); a
share's routed part and the MoE share sum at 1e-5 of the output's largest
entry."""
import dataclasses
import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as jax_zoo
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.models import mla, moe, model_zoo
from repro_torch.models.common import yarn_inv_freq, yarn_range
from repro_torch.train.train_step import make_loss_grad
from torch_parity import TOL, jobs, ref_batch, ref_params, to_port, torch_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench.harness import spec, weights as wmod  # noqa: E402
from bench.reference.elastic_sgd import row_weights  # noqa: E402

REF = spec.load_module(os.path.join(ROOT, "bench", "configs",
                                    "deepseek-v2-lite.py"), "ds_v2_ref")
PORT = spec.load_module(os.path.join(ROOT, "bench", "ports",
                                     "deepseek-v2-lite.py"), "ds_v2_port")
PUBLISHED = spec.load_json(os.path.join(ROOT, "bench", "configs",
                                        "deepseek-v2-lite.json"))
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "kv_lora_rank": 32, "qk_rope_head_dim": 8,
        "qk_nope_head_dim": 16, "v_head_dim": 16, "moe_intermediate_size": 24,
        "intermediate_size": 96, "router_experts": 16, "n_routed_experts": 16,
        "num_hidden_layers": 3, "vocab_size": 256}
N_W, B, S = 4, 8, 12
SEED = 2**31 + 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(**over):
    return {**PUBLISHED, **TINY, **over}


def _tokens(conf, seed=3):
    g = np.random.default_rng(seed)
    toks = torch.from_numpy(g.integers(0, conf["vocab_size"], (B, S + 1)))
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("mask", [(1, 1, 1, 1), (1, 0, 1, 1)])
@pytest.mark.parametrize("held", [16, 4])
def test_loss_and_every_gradient_match_the_plain_reference(held, mask):
    conf = _conf(n_routed_experts=held)
    cfg = PORT.model_config(conf, {"dtype": "float32"})
    assert cfg.moe.held == held and cfg.first_dense_layers == 1
    job = JobConfig(model=cfg, shape=InputShape("t", S, B, "train"),
                    n_workers=N_W)
    flat = wmod.make_all(REF.leaves(conf), SEED, "cpu")
    tokens, labels = _tokens(conf)
    m = torch.tensor(mask, dtype=torch.float32)
    grads, loss, aux = make_loss_grad(cfg, job, remat="none")(
        PORT.to_program({k: v.clone() for k, v in flat.items()}),
        {"tokens": tokens, "labels": labels}, m)

    w = {k: v.clone().requires_grad_() for k, v in flat.items()}
    rows = torch.from_numpy(row_weights(np.asarray(mask, np.float32), B))
    ref_loss = REF.loss(w, conf, tokens, labels,
                        rows[:, None].expand(B, S).contiguous())
    ref_grads = dict(zip(w, torch.autograd.grad(ref_loss, list(w.values()))))

    assert float(aux) > 0
    np.testing.assert_allclose(float(loss), float(ref_loss.detach()),
                               rtol=1e-5)
    got = PORT.from_program(grads, 0)
    assert set(got) == set(ref_grads)
    for k, want in ref_grads.items():
        want = want.numpy()
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Four shares of four experts, each one rank's `moe._moe_device`:
    Σ (share's output − the shared experts) + the shared experts once =
    the uncut reference's layer; each share's dispatch tables keep, on its
    experts, what the uncut reference keeps there (the assignments less
    its drops)."""
    conf = _conf(capacity_factor=1.0)
    cfg = PORT.model_config(conf, {"dtype": "float32"})
    flat = wmod.make_all(REF.leaves(conf), SEED, "cpu")
    p = {k.split(".")[2]: v for k, v in flat.items()
         if k.startswith("layers.moe.") and k.endswith(".0")}
    x = torch.randn(2, 16, conf["hidden_size"],
                    generator=torch.Generator().manual_seed(9))
    x2d = x.reshape(-1, x.shape[-1])

    topv, topi, _ = REF.route(conf, x2d, p["router"])
    uncut, drops = REF.moe_routed(conf, x2d, topv, topi, p["w_in"],
                                  p["w_out"])
    shared = moe._shared(x2d, p)
    assert sum(drops) > 0
    (_, _, val_tbl), _ = moe._tables(x2d, p["router"], cfg.moe)
    total = shared.clone()
    for i in range(4):
        held = slice(4 * i, 4 * i + 4)
        mine = dict(p, w_in=p["w_in"][held], w_out=p["w_out"][held])
        y, _ = moe._moe_device(x, mine, cfg, 4 * i, 4)
        routed = y.reshape(x2d.shape) - shared
        total += routed
        experts = range(4 * i, 4 * i + 4)
        want, want_drops = REF.moe_routed(conf, x2d, topv, topi, p["w_in"],
                                          p["w_out"], experts=experts)
        assert want_drops == [drops[e] for e in experts]
        want = want.detach().numpy()
        np.testing.assert_allclose(routed.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        for e in experts:
            assert int(val_tbl[e].sum()) == int((topi == e).sum()) - drops[e]
    want = (uncut + shared).detach().numpy()
    np.testing.assert_allclose(total.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_yarn_range_and_mscale_at_the_published_sizes():
    cfg = PORT.model_config(PUBLISHED, {"dtype": "float32"})
    yarn = cfg.mla.yarn
    assert yarn_range(yarn, 64, cfg.rope_theta) == (10, 23)
    assert REF.yarn_range(PUBLISHED) == (10, 23)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert abs(mscale - 1.26080) < 5e-6
    assert abs(REF.mscale_squared(PUBLISHED) - 1.58963) < 5e-6
    assert mla.softmax_scale(cfg) == pytest.approx(
        192 ** -0.5 * 1.58963, rel=5e-6)
    assert mla.softmax_scale(cfg) == pytest.approx(
        REF.softmax_scale(PUBLISHED), rel=1e-12)
    port, ref = yarn_inv_freq(yarn, 64, cfg.rope_theta), \
        REF.inv_freq(PUBLISHED)
    np.testing.assert_allclose(port.numpy(), ref.numpy(), rtol=1e-6)
    # below ``low`` the plain frequencies, above ``high`` those over 40
    plain = 10000.0 ** (-torch.arange(32, dtype=torch.float64) / 32)
    np.testing.assert_allclose(port[:11].numpy(), plain[:11].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(port[23:].numpy(), plain[23:].numpy() / 40,
                               rtol=1e-6)


def _explicit_default(cfg, field):
    """``cfg`` with ``field`` stated at the value it takes by default."""
    if field == "norm_topk_prob":
        return cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                 norm_topk_prob=True))
    if field == "experts_held":
        return cfg.with_(moe=dataclasses.replace(
            cfg.moe, experts_held=cfg.moe.num_experts))
    if field == "first_dense_layers":
        return cfg.with_(first_dense_layers=0, d_ff_dense=0)
    return cfg.with_(mla=dataclasses.replace(cfg.mla, yarn=None))


@pytest.mark.parametrize("arch,field", [
    ("deepseek-v2-lite-16b", f) for f in ("norm_topk_prob", "experts_held",
                                         "first_dense_layers", "yarn")] + [
    ("qwen2-moe-a2.7b", f) for f in ("norm_topk_prob", "experts_held",
                                    "first_dense_layers")])
def test_new_fields_at_their_defaults_leave_the_forward_as_it_was(arch,
                                                                  field):
    job, jjob = jobs(arch, b=2, s=16)
    params = ref_params(jjob.model)
    batch = ref_batch(jjob)
    today = model_zoo.forward(to_port(params), job.model,
                              torch_batch(batch), remat="none")
    stated = model_zoo.forward(to_port(params),
                               _explicit_default(job.model, field),
                               torch_batch(batch), remat="none")
    for a, b in zip(today, stated):
        assert torch.equal(a, b)
    logits, aux = jax_zoo.forward(params, jjob.model,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()}, remat="none")
    np.testing.assert_allclose(today[0].numpy(), np.asarray(logits), **TOL)
    np.testing.assert_allclose(float(today[1]), float(aux), **TOL)


def test_the_configuration_file_keeps_the_published_widths():
    conf = PUBLISHED
    reduced = conf["reduced"]
    assert reduced == {"num_hidden_layers": [27, 14],
                       "n_routed_experts": [64, 8],
                       "vocab_size": [102400, 12800]}
    for key, (published, here) in reduced.items():
        assert conf[key] == here
    assert conf["router_experts"] == 64 and conf["num_experts_per_tok"] == 6
    assert 8 * conf["vocab_size"] == 102400
    cfg = PORT.model_config(conf, {"dtype": "bfloat16"})
    assert (cfg.d_model, cfg.num_heads, cfg.d_ff_dense) == (2048, 16, 10944)
    assert (cfg.mla.kv_lora_rank, cfg.mla.qk_nope_head_dim,
            cfg.mla.qk_rope_head_dim, cfg.mla.v_head_dim) == (512, 128, 64,
                                                             128)
    assert (cfg.moe.num_experts, cfg.moe.held, cfg.moe.top_k,
            cfg.moe.d_ff_expert, cfg.moe.d_ff_shared) == (64, 8, 6, 1408,
                                                         2816)
    assert not cfg.moe.norm_topk_prob
    json.dumps(conf)


def test_prefill_then_decode_match_the_forward():
    """The published block served: a prefill of the first S − 2 tokens
    through the latent cache (the absorbed path, YaRN's frequencies and
    mscale², the dense layer's cache first), then two decode steps, give
    the training forward's logits at those positions (float32 at 1e-4).
    Capacity counts the tokens of each call, so it is set past every
    expert's load here: no call drops an assignment."""
    from repro_torch.models.common import init_params

    conf = _conf(n_routed_experts=4, capacity_factor=16.0)
    cfg = PORT.model_config(conf, {"dtype": "float32"})
    params = PORT.to_program(wmod.make_all(REF.leaves(conf), SEED, "cpu"))
    tokens, _ = _tokens(conf)
    with torch.no_grad():
        want, _ = model_zoo.forward(params, cfg, {"tokens": tokens},
                                    remat="none")
        caches = init_params(model_zoo.cache_defs(cfg, B, S), 0,
                             torch.float32, device="cpu")
        got, caches = model_zoo.prefill(params, cfg,
                                        {"tokens": tokens[:, :S - 2]}, caches)
        steps = [got]
        for pos in (S - 2, S - 1):
            lg, caches = model_zoo.decode_step(
                params, cfg, tokens[:, pos:pos + 1], caches, pos)
            steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(),
                               want.numpy(), **TOL)
