"""The port's K-level bids (`core/multibid.py`) against the reference's,
mirroring tests/test_multibid.py.

Both sides are the same numpy, so every plan is held exactly: group sizes,
bid levels, shape vector and the expected cost, time and error. The
reference test's own properties (K=2 reproduces Theorem 3, finer
partitions never cost more, warm starts) are checked on the port, and the
K-level plans run on the port's engine.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import convergence as jax_conv
from repro.core import multibid as jax_multibid
from repro.core.cost_model import (EmpiricalPrice as JaxEmpirical,
                                   RuntimeModel as JaxRuntime,
                                   UniformPrice as JaxUniform)
from repro_torch.core import bidding, convergence as conv, multibid
from repro_torch.core import preemption, strategies as strat
from repro_torch.core.cost_model import (EmpiricalPrice, RuntimeModel,
                                         UniformPrice)
from repro_torch.data.synthetic import QuadraticProblem
from repro_torch.sim import engine
from repro_torch.sim.evaluate import calibrated_quadratic

PROB_KW = dict(alpha=0.05, c=1.0, mu=1.0, L=2.0, M=4.0, G0=10.0)
PROB, JPROB = conv.SGDProblem(**PROB_KW), jax_conv.SGDProblem(**PROB_KW)
RT = RuntimeModel(kind="exp", lam=2.0, delta=0.05)
JRT = JaxRuntime(kind="exp", lam=2.0, delta=0.05)
DIST, JDIST = UniformPrice(0.2, 1.0), JaxUniform(0.2, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_level_statistics_match_reference():
    for sizes in ((2, 6), (4, 4), (1, 7), (2, 3, 3), (1, 1, 2, 4)):
        for gam in (np.linspace(1.0, 0.2, len(sizes)),
                    np.r_[1.0, np.zeros(len(sizes) - 1)]):
            assert multibid.inv_y_multilevel(sizes, gam) == \
                jax_multibid.inv_y_multilevel(sizes, gam)
            assert multibid.expected_runtime_multilevel(sizes, gam, RT) == \
                jax_multibid.expected_runtime_multilevel(sizes, gam, JRT)
            assert multibid._expectations(sizes, gam, 0.7, 50, DIST, RT) == \
                jax_multibid._expectations(sizes, gam, 0.7, 50, JDIST, JRT)
    for n1, n2 in ((2, 6), (4, 4), (1, 7)):
        for gamma in (0.0, 0.4, 1.0):
            assert multibid.inv_y_multilevel(
                (n1, n2), np.array([1.0, gamma])) == pytest.approx(
                    preemption.inv_y_two_groups(n1, n1 + n2, gamma),
                    rel=1e-12)
    assert list(multibid._adjacent_merges((2, 2, 1))) == \
        list(jax_multibid._adjacent_merges((2, 2, 1)))


@pytest.mark.parametrize("sizes", [(8,), (2, 6), (4, 4), (2, 3, 3),
                                   (2, 2, 2, 2)])
@pytest.mark.parametrize("market", ["uniform", "empirical"])
def test_optimized_plan_equals_reference(sizes, market):
    eps, theta = 0.5, 500.0
    J = conv.phi_inverse(PROB, eps, 1.0 / sum(sizes)) + 10
    samples = np.sort(0.2 + 0.8 * np.random.default_rng(5).beta(2, 5, 128))
    dist, jdist = ((DIST, JDIST) if market == "uniform" else
                   (EmpiricalPrice(samples=samples),
                    JaxEmpirical(samples=samples)))
    ours = multibid.optimize_multibid(PROB, eps, theta, sizes, J, dist, RT)
    theirs = jax_multibid.optimize_multibid(JPROB, eps, theta, sizes, J,
                                            jdist, JRT)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    np.testing.assert_array_equal(ours.bids, theirs.bids)
    assert (np.diff(ours.bid_levels) <= 1e-9).all()
    assert ours.expected_error <= eps * (1 + 1e-6)
    assert ours.expected_time <= theta * (1 + 1e-6)


def test_k2_reproduces_theorem3_and_k4_never_worse():
    eps, theta, n = 0.5, 500.0, 8
    J = conv.phi_inverse(PROB, eps, 1.0 / n) + 10
    t3 = bidding.optimal_two_bids(PROB, eps, theta, 2, n, J, DIST, RT)
    mk = multibid.optimize_multibid(PROB, eps, theta, (2, 6), J, DIST, RT)
    assert mk.expected_cost == pytest.approx(t3.expected_cost, rel=2e-2)
    assert mk.bid_levels[0] == pytest.approx(t3.b1, abs=2e-2)
    assert mk.bid_levels[1] == pytest.approx(t3.b2, abs=2e-2)
    t3 = bidding.optimal_two_bids(PROB, eps, theta, 4, n, J, DIST, RT)
    k4 = multibid.optimize_multibid(PROB, eps, theta, (2, 2, 2, 2), J, DIST,
                                    RT)
    assert k4.expected_cost <= t3.expected_cost * (1 + 1e-6)
    bl = np.array(k4.bid_levels)
    assert bl.min() >= DIST.lo - 1e-9 and bl.max() <= DIST.hi + 1e-9


def test_warm_start_nested_split_matches_reference():
    """The fig3/fig4 calibration, where the nested-split regression was
    seen: (2,2,2,1,1) never above (4,4), and the same plans as the
    reference's."""
    _quad, _w0, prob, _batch = calibrated_quadratic()
    jprob = jax_conv.SGDProblem(**dataclasses.asdict(prob))
    n = 8
    floor = prob.B / (1 - prob.beta)
    eps = 5.0 * floor / n
    j_min = conv.phi_inverse(prob, eps, 1.0 / n)
    J, theta = j_min + 10, 3.0 * j_min * RT.expected(n)
    coarse = multibid.optimize_multibid(prob, eps, theta, (4, 4), J, DIST, RT)
    for g in [(2, 2, 2, 1, 1), (4, 2, 2)]:
        fine = multibid.optimize_multibid(prob, eps, theta, g, J, DIST, RT)
        assert fine.expected_cost <= coarse.expected_cost * (1 + 1e-6), g
        theirs = jax_multibid.optimize_multibid(jprob, eps, theta, g, J,
                                                JDIST, JRT)
        assert dataclasses.asdict(fine) == dataclasses.asdict(theirs)


def test_warm_start_opt_out_init_gammas_and_errors_match_reference():
    eps, theta = 0.5, 500.0
    J = conv.phi_inverse(PROB, eps, 1.0 / 8) + 10
    warm = multibid.optimize_multibid(PROB, eps, theta, (2, 2, 2, 2), J,
                                      DIST, RT)
    cold = multibid.optimize_multibid(PROB, eps, theta, (2, 2, 2, 2), J,
                                      DIST, RT, warm_start=False)
    jcold = jax_multibid.optimize_multibid(JPROB, eps, theta, (2, 2, 2, 2),
                                           J, JDIST, JRT, warm_start=False)
    assert dataclasses.asdict(cold) == dataclasses.asdict(jcold)
    assert warm.expected_cost <= cold.expected_cost * (1 + 1e-9)
    seeded = multibid.optimize_multibid(
        PROB, eps, theta, (2, 2, 2, 2), J, DIST, RT, warm_start=False,
        init_gammas=warm.gammas)
    assert seeded.expected_cost <= warm.expected_cost * (1 + 1e-9)
    for mod, prob, dist, rt in [(multibid, PROB, DIST, RT),
                                (jax_multibid, JPROB, JDIST, JRT)]:
        with pytest.raises(ValueError, match="init_gammas"):
            mod.optimize_multibid(prob, eps, theta, (4, 4), J, dist, rt,
                                  init_gammas=[0.5, 1.0])
        with pytest.raises(ValueError, match="can't reach"):
            mod.optimize_multibid(prob, 1e-4, theta, (4, 4), 5, dist, rt)


def test_k_level_plans_on_the_port_engine():
    """K=1..4 optimized plans run as FixedBids scenarios on the port's
    engine: every K completes, the seed-mean simulated cost tracks the
    plan's expectation, and more levels never cost meaningfully more."""
    quad = QuadraticProblem(dim=6, n_samples=64, cond=5.0, noise=0.2, seed=0)
    eps, theta, n = 0.5, 800.0, 8
    J = conv.phi_inverse(PROB, eps, 1.0 / n) + 10
    groups = {1: (8,), 2: (4, 4), 3: (2, 3, 3), 4: (2, 2, 2, 2)}
    plans = {k: multibid.optimize_multibid(PROB, eps, theta, g, J, DIST, RT)
             for k, g in groups.items()}
    scenarios = [engine.scenario_from_strategy(
        strat.FixedBids(plans[k], name=f"K{k}"), alpha=0.4 / quad.L, rt=RT,
        dist=DIST, n_max=n) for k in groups]
    f_min = min(DIST.cdf(p.bid_levels[0]) for p in plans.values())
    res = engine.simulate(scenarios, quad, quad.w_star + 1.0, 12,
                          engine.SimConfig(n_ticks=int(3 * J / f_min) + 64,
                                           grad="full"), device="cpu")
    assert res.completed.all()
    sim_cost = res.total_cost.mean(axis=1)
    for i, k in enumerate(groups):
        assert sim_cost[i] == pytest.approx(plans[k].expected_cost, rel=0.25)
    assert sim_cost[3] <= sim_cost[0] * 1.05
    assert sim_cost[1] <= sim_cost[0] * 1.05
