"""The six ``examples/*_torch.py`` on the CPU, and the port's isolation.

Each example runs with ``--device cpu`` at small arguments in a child
process with its own time limit and must exit 0. Where a printed line
comes from numpy alone it equals the line the reference's own functions
give for the same arguments, computed here without running the JAX
example: quickstart's two-bid plan and spot_bidding's ``calibrated:``
line. Without ``--device cpu`` on a host with no card an example stops
with the port's device error. Then a scan of the port's sources,
``chip_smoke.py`` and the six examples for an import of ``jax`` or of the
reference package."""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
EXAMPLES = ("quickstart", "scenario_sweep", "spot_bidding",
            "elastic_training_e2e", "train_grid", "serve_batched")


def _run(name, *args, device="cpu", timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    argv = [sys.executable, os.path.join(ROOT, "examples",
                                         f"{name}_torch.py"), *args]
    if device is not None:
        argv += ["--device", device]
    return subprocess.run(argv, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def _ok(out):
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout.splitlines()


def test_quickstart_prints_the_references_bid_plan():
    from repro.core import bidding, convergence as conv
    from repro.core.cost_model import RuntimeModel, UniformPrice

    lines = _ok(_run("quickstart"))
    prob = conv.SGDProblem(alpha=0.05, c=1.0, mu=1.0, L=2.0, M=4.0, G0=10.0)
    plan = bidding.co_optimize_two_bids(
        prob, 0.5, 800.0, 4, UniformPrice(0.2, 1.0),
        RuntimeModel(kind="exp", lam=2.0, delta=0.05))
    assert lines[0] == (f"two-bid plan: n1={plan.n1} b1={plan.b1:.3f} "
                        f"b2={plan.b2:.3f} J={plan.J}")
    assert lines[1] == (f"  expected cost={plan.expected_cost:.1f} "
                        f"time={plan.expected_time:.1f} "
                        f"error≤{plan.expected_error:.3f}")
    assert lines[2].startswith("ran 15 iterations on cpu")
    ys = re.fullmatch(r"active workers per iteration: \[(.*)\]", lines[3])
    assert ys and len(ys.group(1).split(",")) == 15


def test_spot_bidding_prints_the_references_calibration():
    from repro.sim.evaluate import calibrated_quadratic

    lines = _ok(_run("spot_bidding", "--reps", "1", "--eps", "3"))
    _, _, prob, _ = calibrated_quadratic()
    assert lines[0] == (f"calibrated: c={prob.c:.2f} L={prob.L:.2f} "
                        f"M={prob.M:.2f} G0={prob.G0:.2f} "
                        f"beta={prob.beta:.4f}")
    for market in ("uniform", "gaussian", "trace"):
        assert f"=== {market} prices ===" in lines
    assert sum("cost_to_emp=" in ln for ln in lines) == 12


def test_scenario_sweep_runs_and_prints_a_frontier():
    lines = _ok(_run("scenario_sweep"))
    assert re.match(r"# 200 scenarios x 4 seeds in .* on cpu\), "
                    r"completed=", lines[0])
    head = lines.index("name,cost,final_err,mean_active,idle")
    assert len(lines) > head + 1
    costs = [float(ln.split(",")[2]) for ln in lines[head + 1:]]
    assert costs == sorted(costs)          # cheapest first


def test_elastic_training_e2e_runs_and_checkpoints(tmp_path):
    ckpt = tmp_path / "e2e.npz"       # written every 50 steps
    lines = _ok(_run("elastic_training_e2e", "--tiny", "--steps", "50",
                     "--ckpt", str(ckpt)))
    assert lines[0].startswith("model: qwen2-7b-e2e")
    assert any(ln.startswith("loss: first10=") for ln in lines)
    assert ckpt.exists()


def test_train_grid_resumes_bit_exact():
    lines = _ok(_run("train_grid", "--seeds", "2", "--steps", "6",
                     "--snapshot-every", "4"))
    assert lines[-1].endswith("bit-exact with the uninterrupted run: True")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2-7b",
                                  "deepseek-v2-lite-16b"])
def test_serve_batched_runs(arch):
    lines = _ok(_run("serve_batched", "--arch", arch, "--batch", "2",
                     "--prompt-len", "8", "--gen", "4"))
    assert lines[0].startswith("prefill(8 tok, one pass):")
    seqs = [ln for ln in lines if ln.startswith("  seq")]
    assert len(seqs) == 2 and all(len(s.split(",")) == 4 for s in seqs)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
def test_examples_refuse_to_fall_back_to_the_cpu():
    out = _run("quickstart", device=None)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def _port_files():
    for base, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    for name in EXAMPLES:
        yield os.path.join(ROOT, "examples", f"{name}_torch.py")


#: an import of jax (or a jax package) or of the reference package
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)"
                       r"|from\s+(jax|repro)(\.|\s+import)(?!_torch))",
                       re.MULTILINE)


def test_the_port_imports_neither_jax_nor_the_reference():
    files = list(_port_files())
    assert len(files) > 60
    bad = {}
    for path in files:
        with open(path) as f:
            hits = FORBIDDEN.findall(f.read())
        if hits:
            bad[os.path.relpath(path, ROOT)] = hits
    assert not bad, bad
    # the pattern itself catches what it is for
    for line in ("import jax", "import jax.numpy as jnp", "from jax import "
                 "lax", "from repro.models import moe", "import repro.sim",
                 "    from repro.configs import ARCHS"):
        assert FORBIDDEN.search(line), line
    for line in ("from repro_torch.models import moe", "import repro_torch",
                 "# jax is the reference"):
        assert not FORBIDDEN.search(line), line
