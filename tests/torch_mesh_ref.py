"""The reference's runs under Auto-typed meshes, and the port's runs of the
same cases, for tests/test_torch_serve_mesh.py,
tests/test_torch_tensor_parallel.py, tests/test_torch_ssm_parallel.py,
tests/test_torch_vocab_parallel.py and tests/test_torch_seq_parallel.py
(not a test file).

The reference runs in a child process with 8 forced XLA host devices
(the flag set only there), as tests/test_torch_expert_parallel.py's
``REF_CHILD`` does; JAX 0.9's ``jax.make_mesh`` gives Explicit axes,
which ``with_sharding_constraint`` refuses, so the child builds its meshes
with ``axis_types=(AxisType.Auto,) * n``. A case names a reduced arch, the
overrides applied to its config in both packages, the meshes and batch
sizes to run, and the functions: ``forward`` (remat "none"),
``loss_grad`` (``make_loss_grad``, remat "full"), ``train_step``
(``make_train_step``, remat "none", SGD with momentum from zero state),
``serve`` (``prefill`` of the prompt into fresh caches, then two
``decode_step``s of given tokens), ``nll`` (``next_token_loss`` of the
forward's logits, with the elastic weights and with every weight 0) and, for ``mesh`` None, the same with no mesh. A case may set its own
``prompt`` length, ``ssm`` overrides and ``zero_mask`` (``loss_grad`` once
more with every worker preempted). Weights come from the reference's ``init_params`` outside any mesh
(so no head is padded), float32, with the zero-initialised QKV biases
perturbed so the bias path carries weight; tokens, labels, decode tokens
and enc-dec frames from numpy seeds. The child saves every value in one
``.npz`` under ``<case>/<mesh>/b<B>/<what>`` keys and the shared inputs
under ``<case>/...``; the port's side reads the weights and inputs back
from it.

Tolerances (tests/test_torch_expert_parallel.py's): logits within 1e-4 of
the largest logit, the loss and the MoE aux at 1e-5 relative, each
gradient, parameter or cache leaf at rtol 1e-4 plus 1e-4 of the leaf's
largest entry; integer leaves (cache positions) exactly."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model_zoo
from repro_torch.models.common import map_specs, mesh_context
from repro_torch.train.loss import elastic_token_weights, next_token_loss
from repro_torch.train.train_step import make_loss_grad, make_train_step
from repro_torch.tree import tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

#: mesh tag -> (shape, axis names)
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
PROMPT, GEN, N_W = 16, 2, 4
MASK = np.array([1, 0, 1, 1], np.float32)

CHILD = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ARCHS
from repro.configs.base import InputShape, JobConfig
from repro.models import model_zoo
from repro.models.common import init_params, mesh_context
from repro.train.loss import elastic_token_weights, next_token_loss
from repro.train.train_step import make_loss_grad, make_train_step

cases, meshes, prompt0, gen, n_w, mask, out_path = json.loads(sys.argv[1])
mask = np.asarray(mask, np.float32)

def cfg_of(case):
    cfg = ARCHS[case["arch"]].reduced().with_(**case.get("over", {}))
    if case.get("moe"):
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **case["moe"]))
    if case.get("ssm"):
        cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, **case["ssm"]))
    return cfg

def flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

def mesh_of(tag):
    if tag is None:
        return None
    shape, names = meshes[tag]
    return jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(AxisType.Auto,) * len(shape))

out = {}
for case in cases:
    name, cfg = case["name"], cfg_of(case)
    prompt = case.get("prompt", prompt0)
    params = init_params(model_zoo.param_defs(cfg), jax.random.PRNGKey(1),
                         jnp.float32)
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * rng.standard_normal(v.shape).astype(v.dtype)
        if jax.tree_util.keystr(p).endswith(("['bq']", "['bk']", "['bv']"))
        else v,
        params)
    flat(name + "/param", params, out)
    bmax = max(case["batches"])
    tokens = rng.integers(0, cfg.vocab_size, (bmax, prompt)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (bmax, prompt)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (gen, bmax, 1)).astype(np.int32)
    out.update({name + "/tokens": tokens, name + "/labels": labels,
                name + "/steps": steps})
    extra = {}
    if cfg.family == "encdec":
        frames = (0.1 * rng.standard_normal(
            (bmax, cfg.encoder.src_len, cfg.d_model))).astype(np.float32)
        out[name + "/frames"] = frames
        extra["frames"] = frames
    for tag in case["meshes"]:
        m = mesh_of(tag)
        for b in case["batches"]:
            key = f"{name}/{tag}/b{b}"
            batch = {"tokens": tokens[:b], **{k: v[:b]
                                             for k, v in extra.items()}}
            job = JobConfig(model=cfg, shape=InputShape("t", prompt, b,
                                                        "train"),
                            n_workers=n_w)
            with mesh_context(m):
                fns = case["fns"]
                if "forward" in fns:
                    y, aux = jax.jit(lambda p, bt: model_zoo.forward(
                        p, cfg, bt, remat="none"))(params, batch)
                    out[key + "/logits"], out[key + "/aux"] = y, aux
                if "nll" in fns:
                    # the loss over the forward's (vocab-sharded) logits,
                    # with the elastic weights and with all weights 0
                    w = elastic_token_weights(mask, b, prompt)
                    nll = jax.jit(next_token_loss)
                    out[key + "/nll"] = nll(y, labels[:b], w)
                    out[key + "/nll0"] = nll(y, labels[:b], 0 * w)
                lbatch = dict(batch, labels=labels[:b])
                if "loss_grad" in fns:
                    lg = jax.jit(make_loss_grad(cfg, job, remat="full"))
                    g, loss, gaux = lg(params, lbatch, mask)
                    out[key + "/loss"], out[key + "/gaux"] = loss, gaux
                    flat(key + "/grad", g, out)
                    if case.get("zero_mask"):
                        g, loss, _ = lg(params, lbatch, 0 * mask)
                        out[key + "/loss0"] = loss
                        flat(key + "/grad0", g, out)
                if "train_step" in fns:
                    opt = jax.tree.map(jnp.zeros_like, params)
                    new, _, _ = jax.jit(make_train_step(
                        cfg, job, remat="none"))(params, opt, lbatch, mask, 0)
                    flat(key + "/step", new, out)
                if "serve" in fns:
                    caches = init_params(model_zoo.cache_defs(
                        cfg, b, prompt + gen), jax.random.PRNGKey(0),
                        jnp.float32)
                    y, caches = jax.jit(lambda p, bt, c: model_zoo.prefill(
                        p, cfg, bt, c))(params, batch, caches)
                    out[key + "/prefill"] = y
                    flat(key + "/prefill_cache", caches, out)
                    dec = jax.jit(lambda p, t, c, pos: model_zoo.decode_step(
                        p, cfg, t, c, pos))
                    for i in range(gen):
                        y, caches = dec(params, steps[i, :b], caches,
                                        jnp.int32(prompt + i))
                        out[key + f"/decode{i}"] = y
                    flat(key + "/decode_cache", caches, out)
np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
"""


def run_reference(cases, path, timeout=600):
    """Run ``cases`` through the reference in a child process and return
    its values as a dict of numpy arrays."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    spec = json.dumps([cases, MESHES, PROMPT, GEN, N_W, MASK.tolist(),
                       str(path)])
    out = subprocess.run([sys.executable, "-c", CHILD, spec], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def port_cfg(case):
    cfg = ARCHS[case["arch"]].reduced().with_(**case.get("over", {}))
    if case.get("moe"):
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **case["moe"]))
    if case.get("ssm"):
        cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, **case["ssm"]))
    return cfg


def prompt_of(case) -> int:
    return case.get("prompt", PROMPT)


def port_mesh(tag):
    if tag is None:
        return None
    shape, names = MESHES[tag]
    return make_mesh(shape, names, device="cpu", host_devices=8)


def _tensor(a):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.from_numpy(a.copy())


def port_params(ref, case, cfg):
    return map_specs(lambda path, _: torch.from_numpy(
        ref[case["name"] + "/param" + path].copy()),
        model_zoo.param_defs(cfg))


def port_inputs(ref, case, b):
    name = case["name"]
    batch = {"tokens": _tensor(ref[name + "/tokens"][:b])}
    if name + "/frames" in ref:
        batch["frames"] = _tensor(ref[name + "/frames"][:b])
    labels = _tensor(ref[name + "/labels"][:b])
    steps = _tensor(ref[name + "/steps"][:, :b])
    return batch, labels, steps


def fresh_caches(cfg, b, prompt=PROMPT):
    """Zeros, positions −1, as the reference's ``init_params`` of the
    cache definitions gives them."""
    def make(_, spec):
        if spec.init == "neg_ones":
            return torch.full(spec.shape, -1, dtype=torch.int32)
        return torch.zeros(spec.shape, dtype=spec.dtype or torch.float32)

    return map_specs(make, model_zoo.cache_defs(cfg, b, prompt + GEN))


def port_run(ref, case, tag, b, fns):
    """The port's values for one (case, mesh, batch): a dict keyed as the
    child keys them (without the ``<case>/<mesh>/b<B>`` prefix), trees
    kept as trees."""
    cfg = port_cfg(case)
    prompt = prompt_of(case)
    params = port_params(ref, case, cfg)
    batch, labels, steps = port_inputs(ref, case, b)
    job = JobConfig(model=cfg, shape=InputShape("t", prompt, b, "train"),
                    n_workers=N_W)
    mask = torch.from_numpy(MASK.copy())
    out = {}
    with mesh_context(port_mesh(tag)):
        if "forward" in fns:
            out["logits"], out["aux"] = model_zoo.forward(
                params, cfg, batch, remat="none")
        if "nll" in fns:
            w = elastic_token_weights(mask, b, prompt)
            out["nll"] = next_token_loss(out["logits"], labels, w)
            out["nll0"] = next_token_loss(out["logits"], labels, 0 * w)
        lbatch = dict(batch, labels=labels)
        if "loss_grad" in fns:
            lg = make_loss_grad(cfg, job, "full")
            out["grad"], out["loss"], out["gaux"] = lg(params, lbatch, mask)
            if case.get("zero_mask"):
                out["grad0"], out["loss0"], _ = lg(params, lbatch, 0 * mask)
        if "train_step" in fns:
            opt = tree_map(torch.zeros_like, params)
            out["step"], _, _ = make_train_step(cfg, job, remat="none")(
                params, opt, lbatch, mask, 0)
        if "serve" in fns:
            with torch.no_grad():
                y, caches = model_zoo.prefill(params, cfg, batch,
                                              fresh_caches(cfg, b, prompt))
                out["prefill"], out["prefill_cache"] = y, caches
                for i in range(GEN):
                    y, caches = model_zoo.decode_step(
                        params, cfg, steps[i], caches, prompt + i)
                    out[f"decode{i}"] = y
                out["decode_cache"] = caches
    return out


def logits_close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max(), err_msg=what)


def scalar_close(got, want, what=""):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               err_msg=what)


def tree_close(tree, ref, prefix):
    """Every leaf of the reference's flattened tree under ``prefix``
    against the port's tree; returns the number of leaves held."""
    keys = [k for k in ref if k.startswith(prefix + "[")]
    assert keys, prefix
    for k in keys:
        got = tree
        for part in k[len(prefix) + 2:-2].split("']['"):
            got = got[part]
        want = ref[k]
        got = got.detach()
        assert tuple(got.shape) == want.shape, k
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)
    return len(keys)


def check_against_reference(ref, case, tag, b, out):
    """Hold every value of ``port_run`` against the child's."""
    key = f"{case['name']}/{tag}/b{b}"
    for what, got in out.items():
        if what in ("logits", "prefill") or (
                what.startswith("decode") and not what.endswith("cache")):
            logits_close(got, ref[f"{key}/{what}"], f"{key}/{what}")
        elif what in ("aux", "loss", "gaux", "loss0", "nll", "nll0"):
            scalar_close(got, ref[f"{key}/{what}"], f"{key}/{what}")
        else:
            tree_close(got, ref, f"{key}/{what}")


def trees_close(a, b, what=""):
    """Two of the port's trees (or tensors) leaf by leaf: floating leaves
    at the reference's leaf tolerance, integer leaves exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            trees_close(a[k], b[k], f"{what}/{k}")
        return
    a, b = a.detach(), b.detach()
    if not a.is_floating_point():
        assert torch.equal(a, b), what
        return
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                               atol=1e-4 * float(b.abs().max()),
                               err_msg=what)


def check_against_no_mesh(out, alone):
    """Every value of a meshed ``port_run`` against the unmeshed one:
    tensors within 1e-4 of the largest entry, trees by `trees_close`."""
    for what, got in out.items():
        if isinstance(got, dict):
            trees_close(got, alone[what], what)
        else:
            np.testing.assert_allclose(
                got.detach().numpy(), alone[what].detach().numpy(), rtol=0,
                atol=1e-4 * float(alone[what].abs().max()) + 1e-7,
                err_msg=what)


def bits_equal(a, b, what=""):
    if isinstance(a, dict):
        for k in a:
            bits_equal(a[k], b[k], f"{what}/{k}")
    else:
        assert torch.equal(a, b), what


class Products(TorchDispatchMode):
    """Records the shape of every ``aten.mm``'s right operand."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.shapes.append(tuple(args[1].shape))
        return func(*args, **(kwargs or {}))
