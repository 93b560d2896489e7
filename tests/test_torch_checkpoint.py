"""The port's checkpointing (`repro_torch.train.checkpoint`) against the
reference's: the mirrors of tests/test_checkpoint.py,
tests/test_checkpoint_steps.py (SIGKILL mid-write included) and the
non-mesh half of tests/test_checkpoint_sharded.py, and the two packages'
files restoring in each other bit for bit — a nested dict/tuple/NamedTuple
tree of float32, int32 and bf16 leaves, and the whole ``SimState`` carry
of a small RNG-free megabatch grid (the port's int64 counters and the
reference's int32 ones interchange by the template's cast)."""
import json
import os
import signal
import subprocess
import sys
import tempfile
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import JobConfig as JaxJob
from repro.sim import engine as jax_engine
from repro.train import checkpoint as jax_ck
from repro.train import trainer as jax_trainer
from repro_torch.chaos import corrupt_checkpoint
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core.cost_model import RuntimeModel
from repro_torch.core.strategies import DynamicWorkers
from repro_torch.sim import engine
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.train import checkpoint as ck
from repro_torch.train import megabatch as mb
from repro_torch.train import trainer
from repro_torch.train.train_step import init_train_state
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_tree_equal(a, b):
    """Leaf for leaf, the same dtype and the same bits (NaN included)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert _bits(x).tobytes() == _bits(y).tobytes(), (x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _train_state():
    cfg = ARCHS["internvl2-1b"].reduced()
    job = JobConfig(model=cfg, shape=InputShape("t", 16, 4, "train"),
                    n_workers=2)
    return init_train_state(cfg, job, 0, device="cpu")


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    params, opt = _train_state()
    path = str(tmp_path / "ck.npz")
    ck.save(path, {"params": params, "opt": opt}, step=7)
    restored, step = ck.restore(path, {"params": params, "opt": opt})
    assert step == 7
    _assert_tree_equal(restored, {"params": params, "opt": opt})


def test_atomic_overwrite(tmp_path):
    params, opt = _train_state()
    path = str(tmp_path / "ck.npz")
    ck.save(path, {"params": params, "opt": opt}, step=1)
    p2 = {k: v for k, v in params.items()}
    p2["embed"] = params["embed"] + 1
    ck.save(path, {"params": p2, "opt": opt}, step=2)
    restored, step = ck.restore(path, {"params": params, "opt": opt})
    assert step == 2
    assert torch.equal(restored["params"]["embed"], p2["embed"])
    assert not any(str(f).endswith(".tmp.npz") for f in os.listdir(tmp_path))


def test_restore_python_scalar_leaves(tmp_path):
    state = {"w": torch.arange(4.0), "step": 3, "lr": 0.25, "done": False}
    path = str(tmp_path / "scalars.npz")
    ck.save(path, state, step=1)
    restored, step = ck.restore(path, state)
    assert step == 1
    assert restored["step"] == 3 and type(restored["step"]) is int
    assert restored["lr"] == 0.25 and type(restored["lr"]) is float
    assert restored["done"] is False
    assert torch.equal(restored["w"], state["w"])


def test_restore_names_missing_and_extra_keys(tmp_path):
    path = str(tmp_path / "drift.npz")
    ck.save(path, {"a": torch.zeros(2), "gone": torch.ones(3)}, step=4)
    with pytest.raises(ValueError) as ei:
        ck.restore(path, {"a": torch.zeros(2), "added": torch.zeros(1)})
    msg = str(ei.value)
    assert "added" in msg and "gone" in msg and "does not match" in msg


def test_restore_rejects_non_checkpoint(tmp_path):
    path = str(tmp_path / "not_ckpt.npz")
    np.savez(path, a=np.zeros(2))
    with pytest.raises(ValueError, match="__step__"):
        ck.restore(path, {"a": torch.zeros(2)})


def test_batched_trainer_state_roundtrip(tmp_path):
    """The engine's whole (S, R) carry of (params, opt_state) replicas
    round-trips, keeping the template's dtypes (int64 counters)."""
    params, opt = _train_state()
    scenarios = engine.stack_scenarios([
        engine.Scenario(price=engine.PriceSpec.uniform(0.2, 1.0), alpha=0.1,
                        bid_schedule=np.tile([0.8, 0.5], (6, 1)))
        for _ in range(2)], device="cpu")
    state = engine.initial_state(scenarios, (params, opt), 3, device="cpu")
    state = state._replace(t=state.t + 1.5, j=state.j + 2)
    path = str(tmp_path / "batched.npz")
    ck.save(path, state, step=17)
    restored, step = ck.restore(path, state)
    assert step == 17
    _assert_tree_equal(tuple(restored), tuple(state))
    assert restored.j.dtype == torch.int64 and restored.t.is_contiguous()


def test_trainer_resume_after_preemption(tmp_path):
    """Kill the legacy loop mid-job; a fresh trainer restores and continues
    from the checkpointed iteration, ending where an uninterrupted run
    ends, bit for bit."""
    from repro_torch.train.trainer import ElasticTrainer

    cfg = ARCHS["deepseek-7b"].reduced()
    job = JobConfig(model=cfg, shape=InputShape("t", 16, 4, "train"),
                    n_workers=2, learning_rate=0.05)
    rt = RuntimeModel(kind="det", r_const=1.0)
    path = str(tmp_path / "resume.npz")

    def make_trainer(ckpt=path):
        cluster = VolatileCluster(n_workers=2, runtime=rt, preempt_q=0.3,
                                  seed=5)
        return ElasticTrainer(job=job, cluster=cluster,
                              strategy=DynamicWorkers(n0=2, eta=1.0, J=10),
                              mode="preemptible", checkpoint_path=ckpt,
                              checkpoint_every=5, seed=1, device="cpu")

    t1 = make_trainer()
    t1.run(iterations=7)            # checkpoint written at j=5
    t2 = make_trainer()
    t2.restore()
    assert t2._j == 5
    # the cluster's own draws replay from its seed: step it to where the
    # checkpoint was taken, as the killed process's cluster was
    for j in range(5):
        t2.cluster.next_iteration_preemptible(j, 2)
    t2.run(iterations=7)
    assert t2._j == 7
    assert all(np.isfinite(e.loss) for e in t2.log)
    _assert_tree_equal(t2.params, t1.params)
    _assert_tree_equal(t2.opt_state, t1.opt_state)


# ---------------------------------------------------------------------------
# tests/test_checkpoint_steps.py
# ---------------------------------------------------------------------------


def _state(rows=9, fill=0.0):
    return {"a": torch.arange(rows * 2, dtype=torch.float32).reshape(rows, 2)
            + fill,
            "b": torch.full((rows, 3), fill)}


def _like(rows=9):
    return {k: torch.zeros_like(v) for k, v in _state(rows).items()}


def test_step_roundtrip_and_listing(tmp_path):
    root = str(tmp_path / "ckpt")
    for tick in (4, 8, 12):
        ck.save_step(root, _state(fill=float(tick)), tick)
    assert ck.list_steps(root) == [4, 8, 12]
    state, tick, path = ck.restore_newest(root, _like())
    assert tick == 12 and path == ck.step_path(root, 12)
    _assert_tree_equal(state, _state(fill=12.0))


@pytest.mark.parametrize("n_shards", [None, 3])
def test_keep_last_gc(tmp_path, n_shards):
    root = str(tmp_path / "ckpt")
    for tick in range(1, 6):
        ck.save_step(root, _state(fill=float(tick)), tick,
                     n_shards=n_shards, keep_last=2)
    assert ck.list_steps(root) == [4, 5]
    state, tick, _ = ck.restore_newest(root, _like())
    assert tick == 5
    _assert_tree_equal(state, _state(fill=5.0))


def test_incomplete_step_dir_is_invisible(tmp_path):
    """A step directory with only shard files (killed before the manifest
    landed) never shadows the previous complete step."""
    root = str(tmp_path / "ckpt")
    ck.save_step(root, _state(fill=1.0), 4, n_shards=3)
    d = ck.step_dir(root, 8)
    os.makedirs(d)
    with open(os.path.join(d, "ckpt.t8.shard00-of-03.npz"), "wb") as f:
        f.write(b"partial")
    assert ck.list_steps(root) == [4]
    _, tick, _ = ck.restore_newest(root, _like())
    assert tick == 4


def _corrupt_newest(root):
    corrupt_checkpoint(ck.step_path(root, 12), "truncate_shard",
                       np.random.default_rng(0))


def _three_steps(tmp_path, n_shards=3):
    root = str(tmp_path / "ckpt")
    for tick in (4, 8, 12):
        ck.save_step(root, _state(fill=float(tick)), tick, n_shards=n_shards)
    return root


def test_strict_restore_raises_on_corrupt_newest(tmp_path):
    root = _three_steps(tmp_path)
    _corrupt_newest(root)
    with pytest.raises(ck.CheckpointError, match="step 12"):
        ck.restore_newest(root, _like(), strict=True)


def test_fallback_restore_quarantines_and_uses_previous(tmp_path):
    root = _three_steps(tmp_path)
    _corrupt_newest(root)
    state, tick, _ = ck.restore_newest(root, _like(), strict=False)
    assert tick == 8
    _assert_tree_equal(state, _state(fill=8.0))
    assert ck.list_steps(root) == [4, 8]
    q = os.path.join(root, ck.QUARANTINE_DIRNAME, "step_00000012")
    assert os.path.isdir(q)
    assert open(os.path.join(q, "REASON.txt")).read()


def test_all_corrupt_raises_named_error(tmp_path):
    root = str(tmp_path / "ckpt")
    for tick in (4, 8):
        ck.save_step(root, _state(), tick)
        corrupt_checkpoint(ck.step_path(root, tick), "torn_manifest")
    with pytest.raises(ck.CheckpointError, match="corrupt"):
        ck.restore_newest(root, _like(), strict=False)
    with pytest.raises(ck.CheckpointError, match="no complete checkpoint"):
        ck.restore_newest(str(tmp_path / "empty"), _like(), strict=False)


_KILLER_PY = r"""
import os, signal, sys
sys.path.insert(0, {src!r})
import torch
from repro_torch.train import checkpoint as ck

root, offset = {root!r}, {offset}
state = {{"a": torch.arange(18, dtype=torch.float32).reshape(9, 2) + 2.0,
          "b": torch.full((9, 3), 2.0)}}

def killer_hook(tmp, write_fn):
    write_fn(tmp)                       # the bytes land in the .tmp file…
    size = os.path.getsize(tmp)
    with open(tmp, "r+b") as f:        # …but only a prefix survives…
        f.truncate(max(1, min(size - 1, offset)))
    os.kill(os.getpid(), signal.SIGKILL)   # …and the rename never runs

ck._write_hook = killer_hook
ck.save_step(root, state, 16, n_shards={n_shards})
"""


@pytest.mark.parametrize("n_shards", [0, 2])
def test_sigkill_mid_write_never_shadows_prior_step(n_shards):
    """A writer SIGKILLed inside `_atomic_write` — after writing a random
    prefix of the .tmp, before the rename — leaves step 16 invisible and
    step 8 restorable bit for bit, for flat and sharded formats alike."""
    rng = np.random.default_rng(7)
    for _ in range(2):
        with tempfile.TemporaryDirectory() as d:
            root = os.path.join(d, "ckpt")
            ck.save_step(root, _state(fill=1.0), 8,
                         n_shards=n_shards or None)
            script = _KILLER_PY.format(
                src=SRC, root=root, offset=int(rng.integers(1, 4096)),
                n_shards=n_shards or None)
            proc = subprocess.run([sys.executable, "-c", script],
                                  capture_output=True, text=True,
                                  timeout=120)
            assert proc.returncode == -signal.SIGKILL, proc.stderr
            assert ck.list_steps(root) == [8]
            leftovers = os.listdir(ck.step_dir(root, 16))
            assert leftovers and all(".tmp" in f for f in leftovers)
            state, tick, _ = ck.restore_newest(root, _like(),
                                               strict=False)
            assert tick == 8
            _assert_tree_equal(state, _state(fill=1.0))
            ck.save_step(root, _state(fill=3.0), 16,
                         n_shards=n_shards or None)
            assert not [f for f in os.listdir(ck.step_dir(root, 16))
                        if ".tmp" in f]
            state, tick, _ = ck.restore_newest(root, _like())
            assert tick == 16
            _assert_tree_equal(state, _state(fill=3.0))


def test_prune_steps_validates_and_keeps_newest(tmp_path):
    root = str(tmp_path / "ckpt")
    with pytest.raises(ValueError):
        ck.prune_steps(root, 0)
    for tick in (1, 2, 3):
        ck.save_step(root, _state(), tick)
    assert ck.prune_steps(root, 1) == [1, 2]
    assert ck.list_steps(root) == [3]


# ---------------------------------------------------------------------------
# tests/test_checkpoint_sharded.py, the non-mesh half
# ---------------------------------------------------------------------------


def _rows_state(rows=11):
    return {"a": torch.arange(rows * 2, dtype=torch.float32).reshape(rows, 2),
            "b": torch.ones(rows, 3, 4)
            * torch.arange(rows, dtype=torch.float32)[:, None, None]}


def _rows_like(rows=11):
    return {k: torch.zeros_like(v) for k, v in _rows_state(rows).items()}


def test_sharded_roundtrip_uneven_shards(tmp_path):
    p = str(tmp_path / "grid.ckpt")
    ck.save_sharded(p, _rows_state(), step=7, n_shards=4)
    manifest = json.load(open(p))
    assert manifest["format"] == ck.SHARDED_FORMAT
    assert [s["rows"] for s in manifest["shards"]] == [3, 3, 3, 2]
    got, step = ck.restore_sharded(p, _rows_like())
    assert step == 7
    _assert_tree_equal(got, _rows_state())


def test_restore_any_sniffs_both_formats(tmp_path):
    flat, sharded = str(tmp_path / "flat.npz"), str(tmp_path / "sh.ckpt")
    ck.save(flat, _rows_state(), step=3)
    ck.save_sharded(sharded, _rows_state(), step=5, n_shards=3)
    for path, want in [(flat, 3), (sharded, 5)]:
        got, step = ck.restore_any(path, _rows_like())
        assert step == want
        _assert_tree_equal(got, _rows_state())


def test_resave_prunes_stale_shards(tmp_path):
    p = str(tmp_path / "grid.ckpt")
    ck.save_sharded(p, _rows_state(), step=1, n_shards=4)
    ck.save_sharded(p, _rows_state(), step=2, n_shards=2)
    shard_files = [f for f in os.listdir(tmp_path) if ".shard" in f]
    assert len(shard_files) == 2 and all(".t2." in f for f in shard_files)
    assert ck.restore_sharded(p, _rows_like())[1] == 2


def test_sharded_save_rejects_ragged_leading_axis(tmp_path):
    with pytest.raises(ValueError, match="leading-axis"):
        ck.save_sharded(str(tmp_path / "x.ckpt"),
                        {"a": torch.ones(4, 2), "b": torch.ones(5, 2)},
                        step=0, n_shards=2)


def _saved(tmp_path):
    p = str(tmp_path / "grid.ckpt")
    ck.save_sharded(p, _rows_state(), step=4, n_shards=3)
    return p


def _rewrite(p, fn):
    manifest = json.load(open(p))
    fn(manifest)
    with open(p, "w") as f:
        json.dump(manifest, f)


@pytest.mark.parametrize("damage,match", [
    ("truncated", "manifest"), ("format", ck.SHARDED_FORMAT),
    ("field", "shards"), ("missing_shard", "refusing a partial restore"),
    ("rows", "promised")])
def test_corrupt_sharded_checkpoint_raises_named_error(tmp_path, damage,
                                                       match):
    """Each corruption of the manifest or its shard set raises a named
    `CheckpointError` before anything is restored (the reference's five
    corruption tests, one case each)."""
    p = _saved(tmp_path)
    if damage == "truncated":
        with open(p, "w") as f:
            f.write("{truncated")
    elif damage == "format":
        with open(p, "w") as f:
            json.dump({"format": "something-else"}, f)
    elif damage == "field":
        _rewrite(p, lambda m: m.pop("shards"))
    elif damage == "missing_shard":
        os.unlink(os.path.join(tmp_path,
                               json.load(open(p))["shards"][1]["file"]))
    else:
        _rewrite(p, lambda m: m["shards"][0].update(
            rows=m["shards"][0]["rows"] + 1))
    with pytest.raises(ck.CheckpointError, match=match):
        ck.restore_sharded(p, _rows_like())


def test_async_writer_writes_identically(tmp_path):
    pa, pb = str(tmp_path / "a.ckpt"), str(tmp_path / "b.npz")
    with ck.AsyncCheckpointWriter() as w:
        w.submit(pa, _rows_state(), 9, n_shards=3)
        w.submit(pb, _rows_state(), 10)
        w.wait()
        got, step = ck.restore_any(pa, _rows_like())
        assert step == 9
        _assert_tree_equal(got, _rows_state())
        assert ck.restore_any(pb, _rows_like())[1] == 10


def test_async_writer_surfaces_save_errors(tmp_path):
    w = ck.AsyncCheckpointWriter()
    w.submit(str(tmp_path / "unused.ckpt"),
             {"a": torch.ones(4, 2), "b": torch.ones(5, 2)}, 0, n_shards=2)
    with pytest.raises(ValueError, match="leading-axis"):
        w.wait()
    w.close()


def test_async_writer_owns_a_copy_of_the_carry(tmp_path):
    """The carry is updated in place after `submit` returns; the file
    holds the state as it was at submission."""
    state = _rows_state()
    want = {k: v.clone() for k, v in state.items()}
    path = str(tmp_path / "a.npz")
    with ck.AsyncCheckpointWriter() as w:
        w.submit(path, state, 1)
        for v in state.values():
            v.add_(100.0)
    _assert_tree_equal(ck.restore(path, _rows_like())[0], want)


# ---------------------------------------------------------------------------
# file interchange with the reference, both ways
# ---------------------------------------------------------------------------


class _Pair(NamedTuple):
    lo: object
    hi: object


def _mixed_tree(rng):
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    i32 = rng.integers(-9, 9, size=(4,)).astype(np.int32)
    bf = rng.normal(size=(2, 6)).astype(np.float32)
    # bf16 bits from float32 by truncation: both sides hold the same bits
    bf_bits = (bf.view(np.uint32) >> 16).astype(np.uint16)
    return f32, i32, bf_bits


def _jax_tree(f32, i32, bf_bits):
    bf = jnp.asarray(bf_bits.view(jnp.bfloat16))
    return {"w": jnp.asarray(f32),
            "pair": _Pair(lo=jnp.asarray(i32), hi=(bf, jnp.asarray(f32[0]))),
            "z": {"k": jnp.asarray(f32 * 2)}}


def _torch_tree(f32, i32, bf_bits):
    bf = torch.from_numpy(bf_bits.view(np.int16).copy()).view(torch.bfloat16)
    return {"w": torch.from_numpy(f32.copy()),
            "pair": _Pair(lo=torch.from_numpy(i32.copy()),
                          hi=(bf, torch.from_numpy(f32[0].copy()))),
            "z": {"k": torch.from_numpy(f32 * 2)}}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_same_bits(torch_tree, jax_tree):
    lt = tree_leaves(torch_tree)
    lj = jax.tree.leaves(jax_tree)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n_shards", [None, 2])
def test_reference_file_restores_in_the_port(tmp_path, n_shards):
    parts = _mixed_tree(np.random.default_rng(0))
    path = str(tmp_path / "ref.ckpt")
    tree = _jax_tree(*parts)
    if n_shards:
        jax_ck.save_sharded(path, {"w": tree["w"]}, 3, n_shards)
        got, step = ck.restore_any(path, {"w": torch.zeros(3, 5)})
        _assert_same_bits(got, {"w": tree["w"]})
        assert step == 3
        return
    jax_ck.save(path, tree, 3)
    like = _torch_tree(*[np.zeros_like(p) for p in parts])
    got, step = ck.restore(path, like)
    assert step == 3
    assert got["pair"].hi[0].dtype == torch.bfloat16
    _assert_same_bits(got, tree)


@pytest.mark.parametrize("n_shards", [None, 2])
def test_port_file_restores_in_the_reference(tmp_path, n_shards):
    parts = _mixed_tree(np.random.default_rng(1))
    path = str(tmp_path / "port.ckpt")
    tree = _torch_tree(*parts)
    if n_shards:
        ck.save_sharded(path, {"w": tree["w"]}, 5, n_shards)
        got, step = jax_ck.restore_any(path, {"w": jnp.zeros((3, 5))})
        _assert_same_bits({"w": tree["w"]}, got)
        assert step == 5
        return
    ck.save(path, tree, 5)
    like = _jax_tree(*[np.zeros_like(p) for p in parts])
    got, step = jax_ck.restore(path, like)
    assert step == 5
    assert got["pair"].hi[0].dtype == jnp.bfloat16
    _assert_same_bits(tree, got)


N_W = 4
J = 6


def _mega_jobs():
    kw = dict(num_layers=1, d_model=16, num_heads=2, num_kv_heads=1,
              d_ff=32, vocab_size=64, head_dim=8)
    jjob = JaxJob(model=JAX_ARCHS["qwen2-7b"].reduced().with_(**kw),
                  shape=JaxShape("t", 8, 4, "train"), n_workers=N_W,
                  learning_rate=0.1)
    job = JobConfig(model=ARCHS["qwen2-7b"].reduced().with_(**kw),
                    shape=InputShape("t", 8, 4, "train"), n_workers=N_W,
                    learning_rate=0.1)
    return jjob, job


def _rng_free(pkg):
    trace = np.random.default_rng(3).uniform(0.2, 1.0, 64).astype(
        np.float32)
    return [pkg.Scenario(price=pkg.PriceSpec.from_trace_ticks(trace),
                         alpha=0.1, bid_schedule=np.tile(b, (J, 1)),
                         rt_kind="det", rt_const=1.0, idle_step=0.5,
                         name=f"s{i}")
            for i, b in enumerate(([0.9, 0.9, 0.5, 0.5],
                                   [0.8, 0.8, 0.8, 0.3]))]


def _assert_state_bits(torch_state, jax_state):
    """The port's carry against the reference's, leaf for leaf, with the
    counters compared as values (int64 against int32)."""
    for name, a, b in zip(engine.SimState._fields, torch_state, jax_state):
        for x, y in zip(tree_leaves(a), jax.tree.leaves(b)):
            x, y = x.numpy(), np.asarray(y)
            if name in ("j", "bucket"):
                assert x.dtype == np.int64 and y.dtype == np.int32
                np.testing.assert_array_equal(x, y)
            else:
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                    name


@pytest.fixture(scope="module")
def megabatch_runs():
    """The same RNG-free megabatch grid from the same weights in both
    packages, snapshotted at tick 5."""
    jjob, job = _mega_jobs()
    model0 = mb.init_megabatch_state(job.model, job, 0, device="cpu")
    ours = trainer.train_batched(job, _rng_free(engine), 2, n_ticks=10,
                                 snapshot_every=5, megabatch=True,
                                 model0=model0, device="cpu")
    theirs = jax_trainer.train_batched(
        jjob, _rng_free(jax_engine), 2, n_ticks=10, snapshot_every=5,
        megabatch=True, donate=False,
        model0={k: jnp.asarray(v.numpy()) for k, v in model0.items()})
    return jjob, job, ours, theirs


def test_reference_simstate_restores_in_the_port(tmp_path, megabatch_runs):
    jjob, job, _, theirs = megabatch_runs
    path = str(tmp_path / "ref_grid.npz")
    tick = jax_trainer.save_batched(path, theirs, index=0)
    state, back = trainer.restore_batched(path, job, _rng_free(engine), 2,
                                          megabatch=True, device="cpu")
    assert back == tick == 5
    _assert_state_bits(state, jax_engine.snapshot_state(theirs, 0)[0])


def test_port_simstate_restores_in_the_reference(tmp_path, megabatch_runs):
    jjob, job, ours, _ = megabatch_runs
    path = str(tmp_path / "port_grid.npz")
    tick = trainer.save_batched(path, ours, index=0)
    state, back = jax_trainer.restore_batched(path, jjob,
                                              _rng_free(jax_engine), 2,
                                              megabatch=True)
    assert back == tick == 5
    jax_engine.assert_carry_dtypes(state)
    _assert_state_bits(engine.snapshot_state(ours, 0)[0], state)


def test_both_packages_write_the_same_keys(tmp_path, megabatch_runs):
    """One grid's checkpoint holds the same keys, shapes and bf16 table in
    both packages' files (the values differ by each package's float
    arithmetic, held elsewhere within tolerance)."""
    _, _, ours, theirs = megabatch_runs
    pa, pb = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    trainer.save_batched(pa, ours, index=1)
    jax_trainer.save_batched(pb, theirs, index=1)
    with np.load(pa) as a, np.load(pb) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
        assert int(a["__step__"]) == int(b["__step__"]) == 10
