"""The port's trainer and launcher: ``train_batched(megabatch=True)``
against the reference's from the same carried model, the CLI, the device
policy (no silent fallback) and the import rule (no ``jax``, no
``repro``)."""
import ast
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import InputShape as JaxShape
from repro.configs.base import JobConfig as JaxJob
from repro.core import bidding as jax_bidding
from repro.core import strategies as jax_strat
from repro.core.cost_model import RuntimeModel as JaxRuntime
from repro.sim import engine as jax_engine
from repro.train import megabatch as jax_mb
from repro.train import trainer as jax_trainer
from repro_torch import device as device_mod
from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape, JobConfig
from repro_torch.core import bidding, strategies as strat
from repro_torch.core.cost_model import RuntimeModel
from repro_torch.launch.mesh import make_scenario_replica_mesh
from repro_torch.sim import engine
from repro_torch.sim.cluster import VolatileCluster
from repro_torch.sim.spot_market import SpotMarket, TickPrices
from repro_torch.train import trainer
from repro_torch.train.trainer import (ElasticTrainer, train_batched,
                                       unpack_batched_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J = 6
N_W = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run beside XLA's thread pool and
    other test workers, and small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jobs():
    kw = dict(num_layers=1, d_model=16, num_heads=2, num_kv_heads=1,
              d_ff=32, vocab_size=64, head_dim=8)
    jjob = JaxJob(model=JAX_ARCHS["qwen2-7b"].reduced().with_(**kw),
                  shape=JaxShape("t", 8, 4, "train"), n_workers=N_W,
                  learning_rate=0.1)
    job = JobConfig(model=ARCHS["qwen2-7b"].reduced().with_(**kw),
                    shape=InputShape("t", 8, 4, "train"), n_workers=N_W,
                    learning_rate=0.1)
    return job, jjob


def _fixed(mod_bidding, mod_strat, bids):
    return mod_strat.FixedBids(mod_bidding.BidPlan(
        n=len(bids), n1=2, b1=float(bids[0]), b2=float(bids[-1]), J=J,
        expected_cost=0, expected_time=0, expected_error=0), name="fixed")


def _scenarios(mod_engine, mod_bidding, mod_strat, runtime, trace):
    """Tick-indexed trace prices and a deterministic runtime: the market
    draws nothing, so both packages see the same masks, clock and cost."""
    return [mod_engine.scenario_from_strategy(
        _fixed(mod_bidding, mod_strat, [0.9, 0.9, 0.5, 0.5]), alpha=0.1,
        rt=runtime(kind="det", r_const=1.0), n_max=N_W, idle_step=0.5,
        price_spec=mod_engine.PriceSpec.from_trace_ticks(trace),
        name="two-bids")]


@pytest.mark.parametrize("fused", [True, False])
def test_train_batched_megabatch_matches_reference(fused):
    job, jjob = _jobs()
    trace = np.random.default_rng(7).uniform(0.2, 1.0, 50).astype(np.float32)
    seeds = [0, 3]
    n_ticks = 2 * J + 4
    jmodel0 = jax_mb.init_megabatch_state(jjob.model, jjob,
                                          jax.random.PRNGKey(0))
    jres = jax_trainer.train_batched(
        jjob, _scenarios(jax_engine, jax_bidding, jax_strat, JaxRuntime,
                         trace),
        seeds, n_ticks=n_ticks, donate=False, megabatch=True,
        model0=jmodel0)
    model0 = {k: torch.from_numpy(np.array(v)) for k, v in jmodel0.items()}
    res = train_batched(
        job, _scenarios(engine, bidding, strat, RuntimeModel, trace), seeds,
        n_ticks=n_ticks, megabatch=True, use_fused_update=fused,
        model0=model0, device="cpu")

    assert (res.iterations == J).all()
    np.testing.assert_array_equal(res.iterations, jres.iterations)
    np.testing.assert_array_equal(res.ys, jres.ys)
    # the same f32 additions and products in the same order: equal bits
    np.testing.assert_array_equal(res.total_time, jres.total_time)
    np.testing.assert_array_equal(res.total_cost, jres.total_cost)
    np.testing.assert_array_equal(np.isnan(res.errors),
                                  np.isnan(jres.errors))
    np.testing.assert_allclose(np.nan_to_num(res.errors),
                               np.nan_to_num(jres.errors), rtol=0,
                               atol=5e-4)
    for k in ("p", "v"):
        np.testing.assert_allclose(res.final_model[k].numpy(),
                                   np.asarray(jres.final_model[k]),
                                   rtol=5e-4, atol=1e-5)
    params, opt = unpack_batched_model(res.final_model, job)
    assert params["lm_head"].shape == (1, 2, 16, 64)


def _trainer(**kw):
    job, _ = _jobs()
    trace = np.random.default_rng(1).uniform(0.2, 1.0, 40).astype(np.float32)
    cluster = VolatileCluster(n_workers=N_W,
                              runtime=RuntimeModel(kind="det", r_const=1.0),
                              market=SpotMarket(TickPrices(trace)),
                              idle_step=0.5)
    return ElasticTrainer(job=job, cluster=cluster,
                          strategy=_fixed(bidding, strat, [0.9] * N_W), **kw)


def test_run_batched_trains_and_builds_no_model_up_front():
    tr = _trainer(device="cpu")
    assert not hasattr(tr, "params")
    res = tr.run_batched(seeds=2, iterations=J, megabatch=True,
                         use_fused_update=True)
    s = res.run("fixed").summary
    assert s["completed"] == 1.0 and np.isfinite(s["final_err_mean"])
    losses = res.result.losses[0]
    assert np.isfinite(losses).all()
    # a fresh model's first loss is near ln V
    assert abs(losses[0, 0] - np.log(64)) < 1.0


def test_unported_paths_raise_naming_their_slice(tmp_path):
    """Every path of the trainer runs: the mesh (the megabatch grid and the
    durable loop over two host devices, bit for bit unsharded; the mesh
    tests live in tests/test_torch_sharded.py), the legacy loop, the
    per-cell program and snapshots (their parity lives in
    tests/test_torch_durable.py)."""
    tr = _trainer(device="cpu")
    two = make_scenario_replica_mesh(1, 2, device="cpu", host_devices=2)
    plain = tr.run_batched(seeds=2, iterations=2, megabatch=True).result
    sharded = tr.run_batched(seeds=2, iterations=2, megabatch=True,
                             mesh=two).result
    np.testing.assert_array_equal(sharded.errors, plain.errors)
    for k in ("p", "v"):
        assert torch.equal(sharded.final_model[k], plain.final_model[k])
    sc = [tr._scenario(tr.strategy, 2, "s")]
    durable = trainer.train_batched_durable(
        tr.job, sc, 2, mesh=two, checkpoint_path=str(tmp_path / "c.npz"),
        save_every=3, device="cpu")
    straight = train_batched(tr.job, sc, 2, device="cpu")
    np.testing.assert_array_equal(durable.errors, straight.errors)
    np.testing.assert_array_equal(durable.total_cost, straight.total_cost)
    res = tr.run_batched(seeds=1, iterations=2, megabatch=True,
                         snapshot_every=2)
    assert res.result.snapshot_ticks[0] == 2
    res = train_batched(tr.job, [tr._scenario(tr.strategy, 2, "s")], 1,
                        megabatch=False, n_ticks=3, device="cpu")
    assert np.isfinite(res.losses[0, 0, :res.iterations[0, 0]]).all()
    assert tr.run(iterations=2)["iterations"] == 2


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        _trainer()
    job, _ = _jobs()
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.stack_batches(job, 1)
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_launcher_cpu_run_prints_summary_without_jax():
    code = (
        "import sys\n"
        "from repro_torch.launch.train import main\n"
        "rc = main(['--batched', '--megabatch', '--fused-update', "
        "'--device', 'cpu', '--seeds', '1', '--iterations', '2', "
        "'--workers', '4', '--batch', '8', '--seq', '16'])\n"
        "print('JAX_LOADED', 'jax' in sys.modules, rc)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    body, last = out.stdout.rsplit("\n", 2)[0], out.stdout.splitlines()[-1]
    assert last == "JAX_LOADED False 0"
    summary = json.loads(body)
    assert summary["_engine"] == {"replicas": 1, "megabatch": True,
                                  "fused_update": True, "mesh": None}
    assert summary["optimal-two-bids"]["reps"] == 1


def test_launcher_refuses_unported_modes(monkeypatch, capsys):
    """Malformed flag sets and the dry run (the model-parallel slice) stop
    at parsing; ``--batched --mesh 2`` runs over two host devices, bit for
    bit the unsharded summary, and ``--jit-cache`` runs and changes
    nothing."""
    from repro_torch.launch.mesh import HOST_DEVICES_ENV
    from repro_torch.launch.train import parse_args, run

    for argv in (["--megabatch"], [], ["--fused-update", "--batched"],
                 ["--batched", "--megabatch", "--param-dtype", "bfloat16"],
                 ["--supervise"], ["--mesh", "2"],
                 ["--batched", "--mesh-replica", "2"]):
        with pytest.raises(SystemExit):
            parse_args(argv)
    assert "model-parallel slice" in capsys.readouterr().err
    small = ["--device", "cpu", "--seeds", "1", "--iterations", "2",
             "--workers", "4", "--batch", "8", "--seq", "16"]
    monkeypatch.setenv(HOST_DEVICES_ENV, "2")
    _, sharded = run(parse_args(["--batched", "--mesh", "2"] + small))
    _, plain = run(parse_args(["--batched", "--jit-cache"] + small))
    assert sharded.pop("_engine")["mesh"] == {"data": 2}
    assert plain.pop("_engine")["mesh"] is None
    assert json.dumps(sharded, sort_keys=True, default=float) == \
        json.dumps(plain, sort_keys=True, default=float)
    _, local = run(parse_args(["--local", "--jit-cache"] + small))
    assert local["iterations"] == 2


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
