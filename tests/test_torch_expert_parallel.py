"""The port's expert parallelism against the reference's sharded runs.

* `models.spmd`'s collectives against ``jax.lax`` under ``jax.vmap(...,
  axis_name=...)``: psum, pmean and the tiled all-to-all.
* ``moe_block`` under a (1, tp) mesh of host devices against the
  reference's per-rank functions (``moe._moe_device`` with the psum,
  ``moe._moe_device_a2a``) under ``jax.vmap(axis_name="model")`` on the
  same weights, each rank given its own slice as the reference's
  ``shard_map`` gives it: tp 2 and 4, capacity factors 1.25 (drops) and
  16 (none), with and without a shared expert; and the reference's quirk
  that a shared expert whose d_ff does not split over tp counts tp times.
* On a (1, 1) mesh both routes are bit for bit the no-mesh block.
* ``model_zoo.forward`` and ``make_loss_grad`` (and one ``make_train_step``)
  of the reduced Qwen2-MoE (8 experts, 6 real) on a CPU (2, 4) mesh of 8
  host devices against the reference under an Auto-typed (2, 4) mesh, run
  once per module in a child process with 8 forced XLA host devices, both
  routes; and forwards where the batch does not split over data (3 over
  2) and where an axis is neither batch nor model (a (2, 2, 2) pod mesh
  under the default rules).

Tolerances: the block and the collectives at 1e-5 absolute and relative
in float32 (the ranks' partial sums are added in rank order, XLA's in its
own); the model's logits within 1e-4 of the largest logit, the loss and
aux at 1e-5 relative, and each gradient leaf at rtol 1e-4 plus 1e-4 of
the leaf's largest entry (tests/torch_parity.py's bound)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import moe as jax_moe
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.launch.mesh import AbstractMesh, Mesh, make_mesh
from repro_torch.models import model_zoo, moe, spmd
from repro_torch.models.common import (DEFAULT_RULES, map_specs,
                                       mesh_context)
from repro_torch.train.train_step import make_loss_grad, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
TOL = dict(rtol=1e-5, atol=1e-5)


def _host_mesh(tp, dp=1):
    return Mesh(np.full((dp, tp), torch.device("cpu"), dtype=object),
                ("data", "model"))


@pytest.mark.parametrize("split,concat", [(0, 1), (1, 0), (1, 1), (2, 0)])
def test_collectives_match_jax_under_vmap(split, concat):
    x = np.random.default_rng(0).standard_normal((4, 8, 12, 4)).astype(
        np.float32)
    parts = [torch.from_numpy(x[i].copy()) for i in range(4)]
    want = jax.vmap(lambda v: jax.lax.all_to_all(
        v, "i", split, concat, tiled=True), axis_name="i")(x)
    got = spmd.all_to_all(parts, split, concat)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for ours, theirs in ((spmd.psum, jax.lax.psum),
                         (spmd.pmean, jax.lax.pmean)):
        want = jax.vmap(lambda v: theirs(v, "i"), axis_name="i")(x)
        for i, g in enumerate(ours(parts)):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[i]),
                                       **TOL)
    with pytest.raises(ValueError, match="split 4 ways"):
        spmd.all_to_all([torch.zeros(3, 2)] * 4, 0, 1)


def _cfgs(**moe_over):
    """The reduced Qwen2-MoE in both packages, float32, 8 experts of which
    6 are real."""
    out = []
    for archs in (ARCHS, JAX_ARCHS):
        cfg = archs["qwen2-moe-a2.7b"].reduced()
        over = {"num_experts": 8, "num_experts_unpadded": 6, **moe_over}
        out.append(cfg.with_(moe=dataclasses.replace(cfg.moe, **over)))
    return tuple(out)


def _ref_per_rank(jcfg, p, x, tp):
    """The reference's per-rank MoE under ``jax.vmap(axis_name="model")``,
    each rank holding the slices its ``shard_map`` in_specs give it."""
    m = jcfg.moe
    el = m.num_experts // tp
    a2a = m.parallelism == "alltoall" and x.shape[1] % tp == 0
    split = m.num_shared_experts and m.d_ff_shared % tp == 0 and not a2a

    def rank_slices(k, v):
        if k in ("w_in", "w_out"):
            return v.reshape((tp, el) + v.shape[1:])
        if split and k in ("w_sh_gate", "w_sh_up"):
            return np.stack(np.split(v, tp, axis=1))
        if split and k == "w_sh_down":
            return np.stack(np.split(v, tp, axis=0))
        return np.stack([v] * tp)

    ps = {k: rank_slices(k, v) for k, v in p.items()}
    if a2a:
        def fn(xl, pl):
            y, aux = jax_moe._moe_device_a2a(xl, pl, jcfg, el, "model")
            return y, jax.lax.pmean(aux, "model")

        y, aux = jax.vmap(fn, axis_name="model")(
            np.stack(np.split(x, tp, axis=1)), ps)
        return np.concatenate(list(np.asarray(y)), axis=1), float(aux[0])

    def fn(pl):
        start = jax.lax.axis_index("model") * el
        y, aux = jax_moe._moe_device(jnp.asarray(x), pl, jcfg, start, el,
                                     "model")
        return y, jax.lax.pmean(aux, "model")

    y, aux = jax.vmap(fn, axis_name="model")(ps)
    return np.asarray(y[0]), float(aux[0])


def _block_case(route, cf, shared, d_ff_shared=None, seed=1):
    over = dict(parallelism=route, capacity_factor=cf,
                num_shared_experts=int(shared))
    if d_ff_shared is not None:
        over["d_ff_shared"] = d_ff_shared
    cfg, jcfg = _cfgs(**over)
    p = jax.tree.map(np.asarray, jax_init_params(
        jax_moe.moe_defs(jcfg), jax.random.PRNGKey(seed), jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    tp_ = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    return cfg, jcfg, p, x, tp_


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("route", ["psum", "alltoall"])
@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("tp", [2, 4])
def test_moe_routes_match_reference_per_rank(tp, cf, route, shared):
    cfg, jcfg, p, x, tparams = _block_case(route, cf, shared)
    want_y, want_aux = _ref_per_rank(jcfg, p, x, tp)
    with mesh_context(_host_mesh(tp)):
        y, aux = moe.moe_block(tparams, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_unsplit_shared_expert_counts_tp_times_as_the_reference(tp):
    """The reference's quirk, mirrored: under the psum route a shared
    expert whose d_ff (here 131) does not split over tp runs whole on
    every rank and the psum adds it tp times. No config of the repo
    triggers it at a power-of-two tp."""
    cfg, jcfg, p, x, tparams = _block_case("psum", 16.0, True,
                                           d_ff_shared=131)
    want_y, _ = _ref_per_rank(jcfg, p, x, tp)
    with mesh_context(_host_mesh(tp)):
        y, _ = moe.moe_block(tparams, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    alone, _ = moe.moe_block(tparams, cfg, torch.from_numpy(x))
    x2d = torch.from_numpy(x).reshape(-1, x.shape[-1])
    shared = (torch.nn.functional.silu(x2d @ tparams["w_sh_gate"])
              * (x2d @ tparams["w_sh_up"])) @ tparams["w_sh_down"]
    # no drops at capacity factor 16: the routed part is the same
    np.testing.assert_allclose(
        y.numpy(), (alone + (tp - 1) * shared.reshape(x.shape)).numpy(),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("route", ["psum", "alltoall"])
def test_one_rank_mesh_is_bit_for_bit_the_block(route):
    cfg, _, _, x, tparams = _block_case(route, 1.25, True)
    xt = torch.from_numpy(x).requires_grad_()
    y0, a0 = moe.moe_block(tparams, cfg, xt)
    with mesh_context(_host_mesh(1)):
        y1, a1 = moe.moe_block(tparams, cfg, xt)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    g0, = torch.autograd.grad((y0 ** 2).sum() + a0, xt)
    g1, = torch.autograd.grad((y1 ** 2).sum() + a1, xt)
    assert torch.equal(g0, g1)


def test_mesh_routes_refuse_what_they_cannot_run():
    cfg, _, _, x, tparams = _block_case("psum", 1.25, True)
    x = torch.from_numpy(x)
    with mesh_context(AbstractMesh((2, 4), ("data", "model"))):
        with pytest.raises(ValueError, match="no devices"):
            moe.moe_block(tparams, cfg, x)
    with mesh_context(Mesh([torch.device("cpu")], ("data",))):
        with pytest.raises(ValueError, match="one model axis"):
            moe.moe_block(tparams, cfg, x)
    with mesh_context(_host_mesh(3)):
        with pytest.raises(ValueError, match="do not split"):
            moe.moe_block(tparams, cfg, x)
    if not torch.cuda.is_available():
        with mesh_context(Mesh([["cuda:0", "cuda:0"]], ("data", "model"))):
            with pytest.raises(ValueError, match="not visible"):
                moe.moe_block(tparams, cfg, x)


REF_CHILD = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ARCHS
from repro.configs.base import InputShape, JobConfig
from repro.models import model_zoo
from repro.models.common import init_params, mesh_context
from repro.train.train_step import make_loss_grad, make_train_step

def mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

def cfg_of(route):
    cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
    return cfg.with_(moe=dataclasses.replace(
        cfg.moe, num_experts=8, num_experts_unpadded=6, parallelism=route))

def flat(prefix, tree, out):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

out = {}
params = init_params(model_zoo.param_defs(cfg_of("psum")),
                     jax.random.PRNGKey(1), jnp.float32)
flat("param", params, out)
rng = np.random.default_rng(0)
tokens = rng.integers(0, 512, (4, 16)).astype(np.int32)
labels = rng.integers(0, 512, (4, 16)).astype(np.int32)
mask = np.array([1, 0, 1, 1], np.float32)
out.update(tokens=tokens, labels=labels, mask=mask)
m24 = mesh((2, 4), ("data", "model"))
for route in ("psum", "alltoall"):
    cfg = cfg_of(route)
    job = JobConfig(model=cfg, shape=InputShape("t", 16, 4, "train"),
                    n_workers=4)
    with mesh_context(m24):
        logits, aux = jax.jit(lambda p, t: model_zoo.forward(
            p, cfg, {"tokens": t}, remat="none"))(params, tokens)
        g, loss, gaux = jax.jit(make_loss_grad(cfg, job, remat="full"))(
            params, {"tokens": tokens, "labels": labels}, mask)
        if route == "psum":
            opt = jax.tree.map(jnp.zeros_like, params)
            new, _, _ = jax.jit(make_train_step(cfg, job, remat="none"))(
                params, opt, {"tokens": tokens, "labels": labels}, mask, 0)
            flat("psum/step", new, out)
        # a batch of 3 does not split over data: replicated there
        y3, a3 = jax.jit(lambda p, t: model_zoo.forward(
            p, cfg, {"tokens": t}, remat="none"))(params, tokens[:3])
    with mesh_context(mesh((2, 2, 2), ("pod", "data", "model"))):
        # "pod" is neither batch nor model under the default rules
        yp, ap = jax.jit(lambda p, t: model_zoo.forward(
            p, cfg, {"tokens": t}, remat="none"))(params, tokens)
    out.update({route + "/logits": logits, route + "/aux": aux,
                route + "/loss": loss, route + "/gaux": gaux,
                route + "/logits_b3": y3, route + "/aux_b3": a3,
                route + "/logits_pod": yp, route + "/aux_pod": ap})
    flat(route + "/grad", g, out)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's sharded runs on Auto-typed meshes of 8 forced host
    devices, computed once in a child process (the flag set only there)."""
    path = tmp_path_factory.mktemp("ep") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", REF_CHILD, str(path)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _port_inputs(ref, route):
    cfg = ARCHS["qwen2-moe-a2.7b"].reduced()
    cfg = cfg.with_(moe=dataclasses.replace(
        cfg.moe, num_experts=8, num_experts_unpadded=6, parallelism=route))
    params = map_specs(lambda path, _: torch.from_numpy(
        ref["param" + path].copy()), model_zoo.param_defs(cfg))
    batch = {"tokens": torch.from_numpy(ref["tokens"].astype(np.int64)),
             "labels": torch.from_numpy(ref["labels"].astype(np.int64))}
    job = JobConfig(model=cfg, shape=InputShape("t", 16, 4, "train"),
                    n_workers=4)
    return cfg, job, params, batch, torch.from_numpy(ref["mask"])


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _leaves_close(tree, ref, prefix):
    n = [0]

    def check(path, _):
        want = ref[prefix + path]
        got = tree
        for key in path[2:-2].split("']['"):
            got = got[key]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=prefix + path)
        n[0] += 1

    return check, n


@pytest.mark.parametrize("route", ["psum", "alltoall"])
def test_forward_and_loss_grad_match_reference_on_2x4_mesh(reference_runs,
                                                           route):
    ref = reference_runs
    cfg, job, params, batch, mask = _port_inputs(ref, route)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu",
                     host_devices=8)
    with mesh_context(mesh, DEFAULT_RULES):
        logits, aux = model_zoo.forward(params, cfg,
                                        {"tokens": batch["tokens"]},
                                        remat="none")
        grads, loss, gaux = make_loss_grad(cfg, job, "full")(params, batch,
                                                             mask)
    _logits_close(logits, ref[route + "/logits"])
    for got, key in ((aux, "/aux"), (loss, "/loss"), (gaux, "/gaux")):
        np.testing.assert_allclose(float(got), float(ref[route + key]),
                                   rtol=1e-5)
    check, n = _leaves_close(grads, ref, route + "/grad")
    map_specs(check, model_zoo.param_defs(cfg))
    assert n[0] == len([k for k in ref if k.startswith(route + "/grad")])
    if route == "psum":
        opt = map_specs(lambda _, s: torch.zeros(s.shape),
                        model_zoo.param_defs(cfg))
        with mesh_context(mesh):
            new, _, _ = make_train_step(cfg, job, remat="none")(
                params, opt, batch, mask, 0)
        check, n = _leaves_close(new, ref, "psum/step")
        map_specs(check, model_zoo.param_defs(cfg))


@pytest.mark.parametrize("route", ["psum", "alltoall"])
def test_replicated_batch_and_other_axes_match_reference(reference_runs,
                                                         route):
    ref = reference_runs
    cfg, _, params, batch, _ = _port_inputs(ref, route)
    with mesh_context(make_mesh((2, 4), ("data", "model"), device="cpu",
                                host_devices=8)):
        y3, a3 = model_zoo.forward(params, cfg,
                                   {"tokens": batch["tokens"][:3]},
                                   remat="none")
    with mesh_context(make_mesh((2, 2, 2), ("pod", "data", "model"),
                                device="cpu", host_devices=8)):
        yp, ap = model_zoo.forward(params, cfg, {"tokens": batch["tokens"]},
                                   remat="none")
    for got, aux, tag in ((y3, a3, "_b3"), (yp, ap, "_pod")):
        _logits_close(got, ref[route + "/logits" + tag])
        np.testing.assert_allclose(float(aux), float(ref[route + "/aux"
                                                         + tag]), rtol=1e-5)
