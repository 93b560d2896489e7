"""The port's logical sharding, padded heads, roofline accounting and dry
run against the reference.

* ``resolve_spec`` / ``param_pspecs`` of every arch's parameters and
  caches equal the reference's, on the production meshes (16, 16) and (2,
  16, 16), on (2, 4) and (1, 1), under both rule sets, FSDP on and off
  and every ``kv_cache_shard`` mode, with the definitions built under each
  mesh context (padded query heads). The reference's ``resolve_spec``
  reads ``mesh.axis_names`` and ``mesh.devices.shape`` only, so it is
  handed an object with those; the port's an `AbstractMesh`.
* Padded heads: ``attn_defs`` at tp 1 to 16 as the reference's, and a
  reduced model with padded heads (plain attention core and K2's plain
  version) against the reference's forward on the same weights.
* ``model_flops`` / ``active_param_count`` for every arch × shape equal
  the reference's; ``arg_bytes_per_device`` equals the reference's XLA
  record (``lower_one`` on an Auto-typed (2, 4) mesh, in a child process
  with forced host devices) exactly, for train, prefill and decode
  pairs.
* ``python -m repro_torch.launch.dryrun --all`` (and ``--multi-pod``)
  and the training launcher's dry run in a subprocess that loads no jax.

Tolerances: the forward at 1e-4 absolute and relative (float32 sums in
other orders); everything else exact."""
import contextlib
import io
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import config_for_shape as jax_config_for_shape
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import model_zoo as jax_zoo
from repro.roofline import analysis as jax_analysis
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES, config_for_shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_mesh, \
    make_production_mesh
from repro_torch.models import attention, common, mla, model_zoo
from repro_torch.roofline import analysis
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
H100 = "NVIDIA H100 80GB HBM3"

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


class _RefMesh:
    """What the reference's layout functions read of a mesh."""

    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(sizes, dtype=object)


def _ref_flat(tree):
    """keystr path -> the reference's PartitionSpec as a tuple."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(v) for p, v in leaves}


def _port_flat(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
        else:
            assert isinstance(t, common.PartitionSpec)
            out[path] = tuple(t)

    walk(tree, "")
    return out


def test_resolve_spec_picks_divisible_candidates_once():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    rules = common.MULTI_POD_RULES
    rs = common.resolve_spec
    assert rs((128, 4096), ("batch", None), rules, mesh) == \
        common.P(("pod", "data"))
    # 14 heads do not split 16 ways: the candidate falls to None
    assert rs((14, 64), (("tp", None), ("tp", None)), rules, mesh) == \
        common.P(None, "model")
    # an axis is used once: the second "tp" is dropped
    assert rs((32, 32), ("tp", "tp"), rules, mesh) == common.P("model")
    assert rs((5, 7), ("fsdp", "tp"), rules, mesh) == common.P()
    assert rs((4,), (None,), rules, mesh) == ()
    spec = rs((64, 32, 8), ("batch", None, "tp"), common.DEFAULT_RULES,
              AbstractMesh((2, 4), ("data", "model")))
    assert isinstance(spec, tuple) and spec == ("data", None, "model")
    sh = common.NamedSharding(AbstractMesh((2, 4), ("data", "model")), spec)
    assert sh.shard_shape((64, 32, 8)) == (32, 32, 2)
    assert common.shard_bytes((64, 32, 8), torch.bfloat16, sh) == \
        32 * 32 * 2 * 2


@pytest.mark.parametrize("rules_name", ["default", "multi_pod"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_pspecs_match_reference(mesh_name, rules_name):
    sizes, names = MESHES[mesh_name]
    mesh, ref_mesh = AbstractMesh(sizes, names), _RefMesh(sizes, names)
    rules = {"default": common.DEFAULT_RULES,
             "multi_pod": common.MULTI_POD_RULES}[rules_name]
    assert rules == {"default": jax_common.DEFAULT_RULES,
                     "multi_pod": jax_common.MULTI_POD_RULES}[rules_name]
    n = 0
    for arch in sorted(ARCHS):
        for mode in ("heads", "seq", "none"):
            cfg = ARCHS[arch].with_(kv_cache_shard=mode)
            jcfg = JAX_ARCHS[arch].with_(kv_cache_shard=mode)
            with common.mesh_context(mesh, rules):
                defs = {"params": model_zoo.param_defs(cfg),
                        "caches": model_zoo.cache_defs(cfg, 128, 4096)}
            with jax_common.mesh_context(ref_mesh, rules):
                jdefs = {"params": jax_zoo.param_defs(jcfg),
                         "caches": jax_zoo.cache_defs(jcfg, 128, 4096)}
            for fsdp in (True, False):
                want = _ref_flat(jax_common.param_pspecs(
                    jdefs, ref_mesh, rules, fsdp))
                got = _port_flat(common.param_pspecs(defs, mesh, rules,
                                                     fsdp))
                assert got == want, (arch, mode, fsdp)
                n += 1
    assert n == 60


def test_cache_defs_shard_as_the_reference_for_each_mode():
    """The repaired logical tokens: InternVL2-1B's two KV heads do not
    split 16 ways, so "heads" shards the head_dim; "seq" the positions;
    "none" neither; MLA's latent and Whisper's cross cache likewise."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    specs = {}
    for mode in ("heads", "seq", "none"):
        cfg = ARCHS["internvl2-1b"].with_(kv_cache_shard=mode)
        c = common.param_pspecs(attention.self_cache_defs(cfg, 128, 4096),
                                mesh)
        specs[mode] = (tuple(c["k"]), tuple(c["pos"]))
    assert specs == {"heads": (("data", None, None, "model"), ("data",)),
                     "seq": (("data", "model"), ("data", "model")),
                     "none": (("data",), ("data",))}
    cfg = ARCHS["whisper-base"]
    c = common.param_pspecs(attention.cross_cache_defs(cfg, 128, 1500), mesh)
    assert tuple(c["k"]) == ("data", None, None, "model")
    for mode, want in (("heads", ("data", None, "model")),
                       ("seq", ("data", "model"))):
        cfg = ARCHS["deepseek-v2-lite-16b"].with_(kv_cache_shard=mode)
        c = common.param_pspecs(mla.mla_cache_defs(cfg, 128, 4096), mesh)
        assert tuple(c["ckv"]) == want


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_attn_defs_pad_heads_as_the_reference(tp):
    for arch in ("qwen2-7b", "internvl2-1b", "yi-34b", "whisper-base",
                 "zamba2-7b"):
        for seq_shard in (False, True):
            cfg = ARCHS[arch].with_(attn_seq_shard=seq_shard)
            jcfg = JAX_ARCHS[arch].with_(attn_seq_shard=seq_shard)
            with common.mesh_context(AbstractMesh((1, tp),
                                                  ("data", "model"))):
                got = {k: s.shape for k, s in
                       attention.attn_defs(cfg).items()}
                assert common.padded_heads(cfg.num_heads) == \
                    common.ceil_to(cfg.num_heads, tp)
            with jax_common.mesh_context(_RefMesh((1, tp),
                                                  ("data", "model"))):
                want = {k: s.shape for k, s in
                        jax_attn.attn_defs(jcfg).items()}
            assert got == want, (arch, tp, seq_shard)
    cfg = ARCHS["qwen2-7b"]
    with common.mesh_context(AbstractMesh((1, 8), ("data", "model"))):
        wq = attention.attn_defs(cfg)["wq"].shape
    assert wq == (3584, 32 * 128)        # 28 query heads padded to 32


@pytest.mark.parametrize("flash", [False, True])
def test_padded_heads_forward_matches_reference(flash):
    """A reduced Qwen2 with 6 query heads over 2 KV heads, its weights
    laid out at tp 4 (8 heads: a GQA group of 4) in both packages: the
    port's forward (the plain core, or K2's plain version on the CPU)
    against the reference's on the same weights."""
    over = dict(num_heads=6, num_kv_heads=2, use_flash_attention=flash)
    cfg = ARCHS["qwen2-7b"].reduced().with_(**over)
    jcfg = JAX_ARCHS["qwen2-7b"].reduced().with_(num_heads=6, num_kv_heads=2)
    with jax_common.mesh_context(_RefMesh((1, 4), ("data", "model"))):
        jdefs = jax_zoo.param_defs(jcfg)
    with common.mesh_context(AbstractMesh((1, 4), ("data", "model"))):
        defs = model_zoo.param_defs(cfg)
    assert defs["layers"]["attn"]["wq"].shape[-1] == 8 * 64
    params = jax.tree.map(np.asarray, jax_common.init_params(
        jdefs, jax.random.PRNGKey(3), jnp.float32))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
    want, _ = jax_zoo.forward(params, jcfg, {"tokens": jnp.asarray(tokens)},
                              remat="none")
    got, _ = model_zoo.forward(convert.tree_from_reference(params,
                                                           device="cpu"),
                               cfg, {"tokens": torch.from_numpy(tokens)},
                               remat="none")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_mesh_context_is_per_thread_and_restored():
    mesh = AbstractMesh((2, 4), ("data", "model"))
    seen = []
    assert common.current_ctx().mesh is None
    with common.mesh_context(mesh, common.MULTI_POD_RULES) as ctx:
        assert common.current_ctx() is ctx and ctx.rules["batch"] == \
            ("pod", "data")
        assert common.axis_size("tp") == 4 and common.axis_size("fsdp") == 2
        assert common.data_axis_names() == ("pod", "data")
        with common.mesh_context(None):
            assert common.axis_size("tp") == 1
        assert common.current_ctx() is ctx
        t = threading.Thread(target=lambda: seen.append(
            common.current_ctx().mesh))
        t.start()
        t.join()
    assert seen == [None] and common.current_ctx().mesh is None
    assert common.data_axis_names() == ("data",)


def test_shard_checks_rank_and_returns_its_input():
    x = torch.randn(4, 6)
    assert common.shard(x, "batch") is x            # no mesh: no check
    with common.mesh_context(make_mesh((2, 4), ("data", "model"),
                                       device="cpu", host_devices=8)):
        assert common.shard(x, "batch", "tp") is x
        with pytest.raises(AssertionError):
            common.shard(x, "batch")


def test_abstract_params_and_param_count_match_reference():
    for arch in sorted(ARCHS):
        cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
        defs = model_zoo.param_defs(cfg)
        metas = common.abstract_params(defs, "bfloat16")
        structs = jax_common.abstract_params(jax_zoo.param_defs(jcfg),
                                             "bfloat16")
        got = [(tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type)
               for t in tree_leaves(metas)]
        want = [(tuple(s.shape), str(s.dtype), "meta")
                for s in jax.tree.leaves(structs)]
        assert got == want, arch
        assert common.param_count(defs) == jax_common.param_count(
            jax_zoo.param_defs(jcfg))
    sh = common.param_shardings(model_zoo.param_defs(ARCHS["qwen2-7b"]),
                                AbstractMesh((16, 16), ("data", "model")))
    assert sh["layers"]["attn"]["wo"].spec == (None, "model", "data")


def test_model_flops_and_active_params_match_reference():
    for arch in sorted(ARCHS):
        assert analysis.active_param_count(ARCHS[arch]) == \
            jax_analysis.active_param_count(JAX_ARCHS[arch])
        for name in SHAPES:
            cfg = config_for_shape(arch, SHAPES[name])
            jcfg = jax_config_for_shape(arch, JAX_SHAPES[name])
            assert analysis.model_flops(cfg, SHAPES[name]) == \
                jax_analysis.model_flops(jcfg, JAX_SHAPES[name]), (arch, name)


#: (arch, shape) pairs whose argument bytes are held against XLA's: a
#: train, prefill and decode shape each, and the steps whose unread
#: arguments jit drops (the train step's counter, the SSM decode's
#: position, the enc-dec decode's encoder)
ARG_PAIRS = [("deepseek-v2-lite-16b", "decode_32k"),
             ("qwen2-7b", "train_4k"), ("whisper-base", "train_4k"),
             ("internvl2-1b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
             ("mamba2-1.3b", "decode_32k"), ("whisper-base", "decode_32k"),
             ("zamba2-7b", "long_500k")]

#: the same on a (2, 2, 2) pod mesh under the multi-pod rules
MULTI_POD_PAIRS = [("internvl2-1b", "train_4k"),
                   ("deepseek-v2-lite-16b", "decode_32k")]

REF_LOWER = r"""
import json, sys
from jax.sharding import AxisType
from repro.launch import dryrun   # forces 512 host devices before jax starts
import jax
out = {}
for tag, sizes, names, pairs in json.loads(sys.argv[1]):
    mesh = jax.make_mesh(tuple(sizes), tuple(names),
                         axis_types=(AxisType.Auto,) * len(sizes))
    for arch, shape in pairs:
        rec = dryrun.lower_one(arch, shape, mesh=mesh,
                               multi_pod=tag == "multi_pod")
        out[tag + ":" + arch + ":" + shape] = [
            rec["arg_bytes_per_device"], rec["model_flops_global"],
            rec["chips"]]
print("RESULT " + json.dumps(out))
"""


def test_arg_bytes_equal_the_reference_lowering():
    runs = [("single", (2, 4), ("data", "model"), ARG_PAIRS),
            ("multi_pod", (2, 2, 2), ("pod", "data", "model"),
             MULTI_POD_PAIRS)]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_LOWER, json.dumps(runs)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    want = json.loads(line[len("RESULT "):])
    assert want["single:deepseek-v2-lite-16b:decode_32k"][0] == \
        26_126_310_660
    for tag, sizes, names, pairs in runs:
        mesh = AbstractMesh(sizes, names)
        for arch, shape in pairs:
            with contextlib.redirect_stdout(io.StringIO()):
                rec = dryrun.dry_run_one(arch, shape, mesh=mesh, card=H100,
                                         multi_pod=tag == "multi_pod")
            assert [rec["arg_bytes_per_device"], rec["model_flops_global"],
                    rec["chips"]] == want[f"{tag}:{arch}:{shape}"], \
                (tag, arch, shape)


def test_roofline_record_and_bound():
    peaks = analysis.card_peaks(H100)
    assert peaks == (3.35e12, 67e12, 989e12, 495e12, "H100 SXM")
    assert analysis.card_peaks("NVIDIA H100 PCIe").label == "H100 PCIe"
    assert "not recognised" in analysis.card_peaks("Some GPU").label
    mesh = make_production_mesh(abstract=True)
    assert mesh.shape == {"data": 16, "model": 16}
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(device="cpu")
    cfg = config_for_shape("qwen2-7b", SHAPES["train_4k"]).with_(
        dtype="bfloat16", param_dtype="bfloat16")
    rec = analysis.analyze_abstract(cfg, SHAPES["train_4k"], mesh,
                                    peaks=peaks)
    assert rec["chips"] == 256
    assert rec["t_compute_s"] == rec["model_flops_global"] / 256 / 989e12
    assert rec["t_memory_s"] == rec["arg_bytes_per_device"] / 3.35e12
    assert rec["dominant"] == "compute"
    for key in analysis.HLO_KEYS:
        assert rec[key] is None
    assert analysis.step_time_bound(rec) == rec["t_compute_s"]
    assert analysis.step_time_bound(dict(rec, t_collective_s=1e3)) == 1e3
    with pytest.raises(ValueError, match="peaks"):
        analysis.analyze_abstract(cfg, SHAPES["train_4k"], mesh)


def test_dry_run_needs_a_card_name_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--card"):
        dryrun.dry_run_one("qwen2-7b", "train_4k")
    with pytest.raises(RuntimeError, match="--card"):
        dryrun.main(["--arch", "qwen2-7b", "--shape", "train_4k"])


DRYRUN_CHILD = r"""
import contextlib, io, json, sys
from repro_torch.launch import dryrun
from repro_torch.launch.train import main as train_main
rcs, outs = [], []
for extra in ([], ["--multi-pod"]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rcs.append(dryrun.main(["--all", "--card", sys.argv[1]] + extra))
    outs.append(buf.getvalue())
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rcs.append(train_main(["--arch", "deepseek-v2-lite-16b", "--shape",
                           "decode_32k", "--card", sys.argv[1]]))
print("RESULT " + json.dumps({"rcs": rcs, "outs": outs,
                              "launcher": buf.getvalue(),
                              "jax": "jax" in sys.modules}))
"""


def test_dryrun_all_and_the_launcher_run_without_jax():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", DRYRUN_CHILD, H100],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads([ln for ln in out.stdout.splitlines()
                      if ln.startswith("RESULT ")][-1][len("RESULT "):])
    assert rec["rcs"] == [0, 0, 0] and rec["jax"] is False
    for text, mesh in zip(rec["outs"], ("16x16", "2x16x16")):
        assert "DRY-RUN SUMMARY: 40 ok, 0 failed" in text
        records = [json.loads(ln) for ln in text.splitlines()
                   if ln.startswith("{")]
        assert len(records) == 40
        assert {(r["arch"], r["shape"]) for r in records} == {
            (a, s) for a in ARCHS for s in dryrun.ALL_SHAPES}
        assert all(r["mesh"] == mesh and r["card"] == "H100 SXM"
                   for r in records)
    body = rec["launcher"][rec["launcher"].index("\n{\n"):]
    launched = json.loads(body)
    assert launched["arch"] == "deepseek-v2-lite-16b"
    assert launched["shape"] == "decode_32k" and launched["chips"] == 256
