"""Serving under a mesh: ``model_zoo.prefill`` and two ``decode_step``s
of the port on CPU meshes of 8 host devices against the reference under
Auto-typed meshes of the same shapes (tests/torch_mesh_ref.py, one child
process for the module).

Cases: reduced DeepSeek-V2-Lite (MLA's latent cache and MoE), the reduced
Qwen2-MoE by the psum and by the all-to-all route (its 16-token prefill
takes the all-to-all, its decode the psum: one token does not split over
the model axis), and reduced Qwen2-7B (4 query heads over 2 KV heads: at
tp 4 every rank keeps the KV heads whole). Meshes (data 2, model 4) and
(data 1, model 4) at batch 4, and a batch of 3 on (2, 4), which does not
split over data. The reference's MoE models under a mesh count capacity
per data rank, so their logits differ from the reference's own unmeshed
run; the port is held against the meshed run. Held: the prefill's logits,
every leaf of the cache it returns, each decode step's logits and every
leaf of the cache after the second (tests/torch_mesh_ref.py's
tolerances: logits within 1e-4 of the largest, leaves at rtol 1e-4 plus
1e-4 of the leaf's largest entry, positions exactly)."""
import pytest
import torch

import torch_mesh_ref as mr

CASES = [
    {"name": "dsv2", "arch": "deepseek-v2-lite-16b"},
    {"name": "qmoe_psum", "arch": "qwen2-moe-a2.7b",
     "moe": {"parallelism": "psum"}},
    {"name": "qmoe_a2a", "arch": "qwen2-moe-a2.7b",
     "moe": {"parallelism": "alltoall"}},
    {"name": "qwen", "arch": "qwen2-7b"},
]
RUNS = [("2x4", 4), ("1x4", 4), ("2x4", 3)]
for c in CASES:
    c.update(meshes=["2x4", "1x4"], batches=[4, 3], fns=["serve"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return mr.run_reference(CASES, tmp_path_factory.mktemp("serve_mesh")
                            / "ref.npz")


@pytest.mark.parametrize("tag,b", RUNS)
@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_prefill_and_decode_match_reference_under_mesh(reference, case, tag,
                                                       b):
    out = mr.port_run(reference, case, tag, b, ["serve"])
    mr.check_against_reference(reference, case, tag, b, out)


def test_moe_mesh_differs_from_no_mesh_as_the_reference_does(reference):
    """The reason the port is held against the meshed reference: with
    capacity counted per data rank, the MoE model's meshed prefill is not
    its unmeshed one (on both sides)."""
    case = CASES[1]
    meshed = mr.port_run(reference, case, "2x4", 4, ["serve"])["prefill"]
    alone = mr.port_run(reference, case, None, 4, ["serve"])["prefill"]
    want = reference["qmoe_psum/2x4/b4/prefill"]
    assert float((meshed - alone).abs().max()) > 1e-2 * abs(want).max()
