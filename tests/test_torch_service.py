"""The port's bidding service (`service/`, `launch/bidserve.py`) against
the reference's, mirroring tests/test_serve.py (its single-device tests)
and tests/test_estimator.py.

The feed, the estimator and the planner's candidate slates are the same
numpy on both sides and are held exactly; candidate scoring is held
exactly on an RNG-free request (tick-indexed posterior prices, a
deterministic runtime, the exact gradient). The server itself draws
(exp runtimes, empirical posterior prices) from the port's generator, so
end to end it is held to the reference test's acceptance properties on
the regime-shift feed, on the CPU: both jobs finish within their
deadline, cheaper than every static paper plan, with regret reported, the
plans adapted after the shift, the ``decisions.jsonl`` schema, and a
bit-reproducible second run.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.cost_model import RuntimeModel as JaxRuntime
from repro.service import planner as jax_pl
from repro.service import stream as jax_stream
from repro.service.estimator import OnlineEstimator as JaxEstimator
from repro.service.server import demo_problem as jax_demo_problem
from repro.sim import engine as jax_engine
from repro.sim.traces import PriceTrace as JaxPriceTrace
from repro_torch.core.cost_model import RuntimeModel
from repro_torch.launch.mesh import make_scenario_mesh
from repro_torch.service import (BidServer, FeedExhaustedError,
                                 FeedMonotonicityError, JobSpec, PriceFeed,
                                 ServeConfig, feed_from_traces,
                                 synthetic_feed)
from repro_torch.service import planner as pl
from repro_torch.service.estimator import OnlineEstimator
from repro_torch.service.server import demo_problem
from repro_torch.sim import engine
from repro_torch.sim.spot_market import synthetic_history
from repro_torch.sim.traces import PriceTrace

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- stream -----------------------------------------------------------------


def test_feeds_match_reference():
    for kw in (dict(n_markets=2, n_ticks=300, seed=0),
               dict(n_markets=3, n_ticks=64, seed=4, q=[0.1, 0.0, 0.3])):
        ours, theirs = synthetic_feed(**kw), jax_stream.synthetic_feed(**kw)
        for m in range(kw["n_markets"]):
            np.testing.assert_array_equal(ours.market_prices(m),
                                          theirs.market_prices(m))
        a, b = ours.next_window(50), theirs.next_window(50)
        np.testing.assert_array_equal(a.prices, b.prices)
        np.testing.assert_array_equal(a.preempted, b.preempted)
        np.testing.assert_array_equal(a.times, b.times)
    tr = synthetic_history(hours=30, seed=2)
    ours = feed_from_traces([PriceTrace.regular(tr, step=0.5),
                             PriceTrace.regular(tr[::-1], step=1.0)])
    theirs = jax_stream.feed_from_traces(
        [JaxPriceTrace.regular(tr, step=0.5),
         JaxPriceTrace.regular(tr[::-1], step=1.0)])
    assert ours.n_ticks == theirs.n_ticks
    np.testing.assert_array_equal(ours.market_prices(1),
                                  theirs.market_prices(1))


def test_feed_monotone_clock_and_exhaustion():
    feed = synthetic_feed(n_markets=2, n_ticks=10, seed=0)
    w = feed.next_window(6)
    assert (w.k0, w.k1) == (0, 6) and feed.clock == 6.0
    w = feed.next_window(6)
    assert (w.k0, w.k1) == (6, 10) and len(w) == 4
    with pytest.raises(FeedExhaustedError):
        feed.next_window(1)
    with pytest.raises(FeedMonotonicityError, match="rewind"):
        feed.seek(3)
    fresh = feed.replay()
    assert fresh.cursor == 0 and feed.cursor == 10
    np.testing.assert_array_equal(fresh.market_prices(1),
                                  feed.market_prices(1))


# -- estimator --------------------------------------------------------------


def _estimator_pair(**kw):
    return OnlineEstimator(**kw), JaxEstimator(**kw)


def _assert_estimators_equal(a, b, m):
    np.testing.assert_array_equal(a.prices(), b.prices())
    np.testing.assert_array_equal(a.preempt_mean, b.preempt_mean)
    np.testing.assert_array_equal(a.rate_mean, b.rate_mean)
    np.testing.assert_array_equal(a.sample_grid(32), b.sample_grid(32))
    for i in range(m):
        assert a.summary(i) == b.summary(i)
        assert a.runtime_model(i).lam == b.runtime_model(i).lam
        np.testing.assert_array_equal(a.price_dist(i, 16).samples,
                                      b.price_dist(i, 16).samples)


def test_estimator_matches_reference_on_the_same_stream():
    rng = np.random.default_rng(3)
    prices = rng.uniform(0.05, 0.4, size=(301, 3))
    pre = rng.uniform(size=prices.shape) < 0.1
    ours, theirs = _estimator_pair(n_markets=3, window=64, delta=0.05)
    assert ours.summary(0) == theirs.summary(0)
    for k in range(0, 301, 37):
        ours.update(prices[k:k + 37], pre[k:k + 37])
        theirs.update(prices[k:k + 37], pre[k:k + 37])
        markets = rng.integers(0, 3, size=20)
        ys = rng.integers(0, 6, size=20)
        durs = 0.05 + rng.exponential(0.5, size=20)
        durs[::7] = np.nan
        ours.observe_durations(markets, durs, ys)
        theirs.observe_durations(markets, durs, ys)
        _assert_estimators_equal(ours, theirs, 3)
    np.testing.assert_array_equal(ours.quantile([0.1, 0.5]),
                                  theirs.quantile([0.1, 0.5]))


def test_batched_update_equals_sequential_and_window_ages_out():
    rng = np.random.default_rng(3)
    prices = rng.uniform(0.05, 0.4, size=(97, 3))
    pre = rng.uniform(size=prices.shape) < 0.1
    batched = OnlineEstimator(n_markets=3, window=64)
    batched.update(prices, pre)
    seq = OnlineEstimator(n_markets=3, window=64)
    for k in range(len(prices)):
        seq.update(prices[k], pre[k])
    np.testing.assert_array_equal(batched.prices(), seq.prices())
    np.testing.assert_array_equal(batched.pre_a, seq.pre_a)
    est = OnlineEstimator(n_markets=1, window=50)
    est.update(np.full((200, 1), 0.1))
    est.update(np.full((50, 1), 0.9))
    assert float(est.quantile(0.5)[0]) == 0.9
    with pytest.raises(ValueError, match="no price observations"):
        OnlineEstimator(n_markets=1).quantile(0.5)


# -- planner ----------------------------------------------------------------


def _slates(mod, cost_mod, dist_samples, **kw):
    _, _, prob = (demo_problem if mod is pl else jax_demo_problem)(seed=0)
    rt = cost_mod.RuntimeModel(kind="exp", lam=2.0, delta=0.05)
    return mod.generate_candidates(
        prob, dist=cost_mod.EmpiricalPrice(samples=dist_samples), rt=rt,
        **kw)


@pytest.mark.parametrize("case", ["posterior", "degenerate", "held"])
def test_candidate_slates_match_reference(case):
    import repro.core.cost_model as jax_cost
    import repro_torch.core.cost_model as cost

    samples = np.sort(np.random.default_rng(1).uniform(0.07, 0.2, 128))
    kw = dict(eps=0.5, theta_left=60.0, j_left=40, n=4, q_hat=0.1,
              multibid_partitions=((2, 2), (3, 1), (1, 1)),
              include_provision=True)
    if case == "degenerate":
        samples = np.full(16, 0.25)
    if case == "held":
        kw.update(current_bids=np.array([0.1, 0.1, 0.09, 0.09]),
                  theta_left=30.0, j_left=25)
    ours = _slates(pl, cost, samples, **kw)
    theirs = _slates(jax_pl, jax_cost, samples, **kw)
    assert len(ours) == pl.slate_size(kw["multibid_partitions"], True)
    assert [dataclasses.asdict(c) for c in ours] == \
        [dataclasses.asdict(c) for c in theirs]
    assert [c.describe() for c in ours] == [c.describe() for c in theirs]
    kinds = [c.kind for c in ours]
    assert kinds[0] == "hold" and kinds[1] == "no-interrupt"


def _requests(mod, eng, rt):
    """3 jobs × 4 candidates over tick-indexed posterior traces: a
    request that draws nothing, so both engines must agree exactly."""
    rng = np.random.default_rng(5)
    out = []
    for i in range(3):
        trace = rng.uniform(0.1 + 0.05 * i, 0.6, size=97).astype(np.float32)
        cands = [mod.Candidate(kind="uniform", bids=(b, b, b, b),
                               expected_error=0.1)
                 for b in (0.2, 0.35, 0.55)]
        cands.append(mod.Candidate(kind="provision", workers=3,
                                   expected_error=0.1))
        out.append(mod.PlanRequest(
            job=i, market=i, price_spec=eng.PriceSpec.from_trace_ticks(trace),
            rt=rt, q_hat=0.0, j_left=6 + 3 * i, theta_left=30.0 + 5 * i,
            eps=0.5, n_workers=4, candidates=cands))
    return out


def test_score_requests_matches_reference_on_rng_free_request():
    quad, w0, prob = demo_problem(seed=0)
    jquad, jw0, _ = jax_demo_problem(seed=0)
    kw = dict(alpha=prob.alpha, j_cap=16, n_cap=4, seeds=[1, 2],
              score_ticks=48, grad="full", batch=4, idle_step=0.5,
              on_demand_price=0.9)
    ours = pl.score_requests(
        _requests(pl, engine, RuntimeModel(kind="det", r_const=1.0)),
        model0=torch.as_tensor(w0, dtype=torch.float32),
        data=engine.torch_quadratic(quad, "cpu"),
        program=engine.quadratic_program("full", 4), device="cpu", **kw)
    theirs = jax_pl.score_requests(
        _requests(jax_pl, jax_engine, JaxRuntime(kind="det", r_const=1.0)),
        model0=jw0, data=jax_engine.jax_quadratic(jquad),
        program=jax_engine.quadratic_program("full", 4), **kw)
    assert ours.shape == (3, 4)
    assert np.isfinite(ours).any() and np.isinf(ours).any()
    np.testing.assert_array_equal(ours, theirs)
    picks = pl.choose(_requests(pl, engine, RuntimeModel()), ours)
    jpicks = jax_pl.choose(_requests(jax_pl, jax_engine, JaxRuntime()),
                           theirs)
    assert [(i, c.kind, c.bids) for i, c in picks] == \
        [(i, c.kind, c.bids) for i, c in jpicks]
    # the same slates over a mesh of two and of three host devices (the
    # 3 × 4 candidates split unevenly): the scores bit for bit
    for n in (2, 3):
        sharded = pl.score_requests(
            _requests(pl, engine, RuntimeModel(kind="det", r_const=1.0)),
            model0=torch.as_tensor(w0, dtype=torch.float32),
            data=engine.torch_quadratic(quad, "cpu"),
            program=engine.quadratic_program("full", 4),
            mesh=make_scenario_mesh(n, device="cpu", host_devices=n), **kw)
        np.testing.assert_array_equal(sharded, ours)


def test_choose_all_inf_falls_back_to_no_interrupt():
    hold = pl.Candidate(kind="hold", bids=(0.1,), safe_default=True)
    noint = pl.Candidate(kind="no-interrupt", bids=(0.4,),
                         safe_default=True)
    uni = pl.Candidate(kind="uniform", bids=(0.2,), expected_error=0.1)
    req = pl.PlanRequest(job=0, market=0, price_spec=None,
                         rt=RuntimeModel(kind="exp", lam=2.0, delta=0.05),
                         q_hat=0.0, j_left=5, theta_left=10.0, eps=0.5,
                         n_workers=1, candidates=[hold, noint, uni])
    [(idx, cand)] = pl.choose([req], np.full((1, 3), np.inf))
    assert cand.kind == "no-interrupt"
    [(idx, cand)] = pl.choose([req], np.array([[np.inf, 3.0, 1.0]]))
    assert cand.kind == "uniform"


# -- the server end to end ----------------------------------------------------


def _regime_shift_feed() -> PriceFeed:
    rng = np.random.default_rng(11)
    lo = 0.07 + 0.02 * rng.random((24, 2))
    hi = 0.32 + 0.06 * rng.random((96, 2))
    return PriceFeed(np.concatenate([lo, hi]), step=1.0)


def _run_service(out_dir=None, mesh=None) -> dict:
    quad, w0, prob = demo_problem(seed=0)
    jobs = [JobSpec(name="a", market=0, eps=0.5, theta=70.0, n_workers=4),
            JobSpec(name="b", market=1, eps=0.5, theta=70.0, n_workers=4)]
    cfg = ServeConfig(horizon=24, warmup=24, score_seeds=2, seed=0, batch=4,
                      idle_step=0.25, multibid_partitions=((2, 2),),
                      out_dir=out_dir)
    return BidServer(
        _regime_shift_feed(), jobs, prob=prob, quad=quad, w0=w0,
        alpha=prob.alpha,
        rt_true=RuntimeModel(kind="exp", lam=2.0, delta=0.05),
        cfg=cfg, mesh=mesh, device="cpu").run()


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    return _run_service(str(tmp_path_factory.mktemp("serve")))


def test_service_completes_and_beats_static_paper_baselines(report):
    for name, job in report["summary"]["jobs"].items():
        assert job["completed"] and job["deadline_met"], (name, job)
        assert job["iterations"] == job["target_J"]
        assert job["final_error"] is not None
        assert job["final_error"] <= job["eps"]
        assert job["best_static_paper_cost"] is not None, name
        assert job["cost"] <= job["best_static_paper_cost"] * (1 + 1e-6)
        assert job["regret_vs_static_paper"] < 0


def test_regret_vs_hindsight_reported(report):
    for name, job in report["summary"]["jobs"].items():
        assert job["hindsight_static_cost"] is not None, name
        assert job["regret_vs_hindsight"] == pytest.approx(
            job["cost"] - job["hindsight_static_cost"], abs=1e-5)
    assert {m["family"] for m in report["static"]} == {"hindsight",
                                                       "static-paper"}


def test_service_adapts_after_regime_shift(report):
    rows = [d for d in report["decisions"] if d["type"] == "decision"]
    h0 = [d for d in rows if d["horizon"] == 0]
    assert h0 and all(max(d["chosen"]["bids"]) < 0.15 for d in h0)
    adapted = [d for d in rows
               if d["horizon"] >= 1 and not d["done"]
               and d["chosen"]["bids"] is not None]
    assert adapted and any(max(d["chosen"]["bids"]) >= 0.3 for d in adapted)


def test_decisions_jsonl_schema(report):
    with open(report["decisions_path"]) as fh:
        rows = [json.loads(line) for line in fh]
    *body, last = rows
    assert last["type"] == "summary"
    for key in ("replan_p50_ms", "replan_p95_ms", "decisions_per_sec",
                "jobs", "ticks", "warmup", "horizon", "horizons", "n_jobs",
                "seed", "decisions"):
        assert key in last, key
    assert len(body) == last["decisions"] > 0
    need = {"type", "horizon", "tick", "job", "market", "done", "j_done",
            "j_left", "t", "theta_left", "posterior", "chosen",
            "chosen_index", "score", "scores", "replan_latency_s"}
    for row in body:
        assert need == set(row), need ^ set(row)
        assert {"n_samples", "price_q10", "price_q50", "price_q90",
                "preempt_mean", "rate_mean"} == set(row["posterior"])
        assert set(row["chosen"]) == {"kind", "bids", "workers",
                                      "expected_error", "expected_cost",
                                      "expected_time", "note"}
        assert row["replan_latency_s"] >= 0
    job = last["jobs"]["a"]
    assert set(job) == {"iterations", "target_J", "completed",
                        "deadline_met", "cost", "time", "final_error", "eps",
                        "hindsight_static_cost", "regret_vs_hindsight",
                        "best_static_paper_cost", "regret_vs_static_paper"}


def _strip(rep):
    rep = copy.deepcopy({"decisions": rep["decisions"],
                         "summary": rep["summary"]})
    for d in rep["decisions"]:
        d.pop("replan_latency_s")
    for k in ("replan_p50_ms", "replan_p95_ms", "decisions_per_sec"):
        rep["summary"].pop(k)
    return rep


def test_fixed_seed_bit_reproducible(report):
    again = _run_service()
    assert json.dumps(_strip(report), sort_keys=True) == \
        json.dumps(_strip(again), sort_keys=True)


def test_server_refuses_mesh_and_a_missing_card(report):
    """Scoring over a mesh of four host devices leaves every decision and
    the summary as the unsharded server's; without a card the server's
    default device raises."""
    sharded = _run_service(
        mesh=make_scenario_mesh(4, device="cpu", host_devices=4))
    assert json.dumps(_strip(sharded), sort_keys=True) == \
        json.dumps(_strip(report), sort_keys=True)
    quad, w0, prob = demo_problem(seed=0)
    kw = dict(prob=prob, quad=quad, w0=w0, alpha=prob.alpha,
              rt_true=RuntimeModel(kind="exp", lam=2.0, delta=0.05))
    jobs = [JobSpec(name="a")]
    if torch.cuda.is_available():
        assert BidServer(_regime_shift_feed(), jobs,
                         **kw).data.A.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            BidServer(_regime_shift_feed(), jobs, **kw)


# -- the launcher -------------------------------------------------------------


def _bidserve(*args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bidserve", *args],
        env=env, capture_output=True, text=True, timeout=600)


def test_bidserve_cli_on_the_cpu(tmp_path):
    out = _bidserve("--device", "cpu", "--ticks", "160", "--out",
                    str(tmp_path), "--multibid")
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout)
    assert summary["type"] == "summary" and summary["n_jobs"] == 2
    assert summary["ticks"] == 160 and summary["horizons"] == 4
    assert set(summary["jobs"]) == {"job0", "job1"}
    lines = (tmp_path / "decisions.jsonl").read_text().splitlines()
    assert len(lines) == summary["decisions"] + 1


@pytest.mark.parametrize("flags", [
    ("--mesh", "2", "--devices", "2"), ("--devices", "2"),
    ("--jit-cache",)])
def test_bidserve_refuses_unported_flags(flags, monkeypatch):
    """``--mesh``/``--devices`` and ``--jit-cache`` run: the summary is the
    default run's bit for bit. ``--mesh`` beyond the visible host devices,
    and ``--devices`` on the card, are refused; the default device is the
    card."""
    from repro_torch.launch import bidserve
    from repro_torch.launch.mesh import HOST_DEVICES_ENV

    monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
    base = ["--device", "cpu", "--ticks", "96", "--jobs", "1"]

    def summary(*extra):
        rep = bidserve.run(bidserve.build_parser().parse_args(
            base + list(extra)))
        return _strip(rep)

    assert json.dumps(summary(*flags), sort_keys=True) == \
        json.dumps(summary(), sort_keys=True)
    with pytest.raises(ValueError, match="needs 2 devices"):
        bidserve.run(bidserve.build_parser().parse_args(
            base + ["--mesh", "2"]))
    with pytest.raises(ValueError, match="--devices"):
        bidserve.run(bidserve.build_parser().parse_args(
            ["--devices", "2"]))
    assert bidserve.build_parser().parse_args([]).device == "cuda"
