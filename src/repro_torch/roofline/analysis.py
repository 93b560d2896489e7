"""Roofline accounting of one training or serving step, from the model's
definition alone (the counterpart of the reference's
``roofline/analysis.py``).

Two terms per (arch × shape × mesh), in seconds per step on one device:

  compute = model FLOPs / (chips × the card's bf16 tensor-core peak)
  memory  = argument bytes per device / the card's HBM bandwidth

The model FLOPs are the 6·N·D (training) / 2·N·D (inference) convention
over the parameters a token touches. The argument bytes are the step's
inputs as the reference's dry run lowers them — parameters and optimizer
state under their logical layout, caches, batch, mask and step — each
leaf's shard on one device. What the reference reads from XLA's compiled
program (HLO FLOPs and bytes, collective bytes, temporaries) has no
counterpart here: those keys are None, and the collective term with
them.

The peaks come from the card's name (NVIDIA data sheets, dense, no
sparsity), never from the reference's TPU constants."""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional


class CardPeaks(NamedTuple):
    """Peak rates of a card: HBM bytes/s, float32 FLOP/s outside the
    tensor cores, bf16 and TF32 tensor-core FLOP/s, and its label."""

    hbm: float
    f32: float
    bf16: float
    tf32: float
    label: str


#: peak rates by a substring of the card's name, the first match winning
PEAKS = [("H200", 4.8e12, 67e12, 989e12, 495e12, "H200 SXM"),
         ("NVL", 3.9e12, 60e12, 835e12, 418e12, "H100 NVL"),
         ("PCIe", 2.0e12, 51e12, 756e12, 378e12, "H100 PCIe"),
         ("H100", 3.35e12, 67e12, 989e12, 495e12, "H100 SXM")]


def card_peaks(name: str) -> CardPeaks:
    """The peaks of the card called ``name``
    (``torch.cuda.get_device_name``); an unrecognised card gets the H100
    SXM's, labelled so."""
    for key, *rates, label in PEAKS:
        if key in name:
            return CardPeaks(*rates, label)
    return CardPeaks(*PEAKS[-1][1:5], "H100 SXM (card not recognised)")


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for inference
    (forward only), D = processed tokens per step."""
    n_active = active_param_count(cfg)
    if shape.is_decode:
        tokens = shape.global_batch            # one token per sequence
        mult = 2.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    return mult * n_active * tokens


def active_param_count(cfg) -> float:
    """Parameters touched per token (MoE counts shared + top_k routed
    experts only; embeddings excluded by convention). The definitions are
    read under the current mesh context, as the reference reads them."""
    from repro_torch.models import model_zoo
    from repro_torch.models.common import param_count

    total = param_count(model_zoo.param_defs(cfg))
    # subtract embedding / lm head (not matmul FLOPs per token in 6ND)
    emb = cfg.vocab_size * cfg.d_model
    total -= emb
    if not cfg.tie_embeddings:
        total -= emb
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert
        total -= cfg.num_layers * m.num_experts * per_expert
        total += cfg.num_layers * m.top_k * per_expert
    return float(max(total, 0))


#: the reference's record keys that it reads from XLA's compiled program
HLO_KEYS = ("flops_per_device", "bytes_per_device", "xla_flops_uncorrected",
            "xla_bytes_uncorrected", "collective_bytes_per_device",
            "collectives", "t_collective_s", "hlo_flops_global",
            "useful_flops_ratio", "temp_bytes_per_device",
            "output_bytes_per_device", "peak_bytes_per_device")


def analyze_abstract(cfg, shape, mesh, rules=None, fsdp: bool = True,
                     peaks: Optional[CardPeaks] = None) -> Dict:
    """The roofline record of one step of ``cfg`` at ``shape`` laid out
    over ``mesh`` (a `launch.mesh.Mesh` or `AbstractMesh`) by ``rules``:
    the reference's ``analyze_compiled`` keys, with None where the value
    would come from XLA's program. ``peaks``: a `CardPeaks` (required)."""
    from repro_torch.launch.dryrun import arg_bytes, step_arguments
    from repro_torch.models.common import mesh_context

    if peaks is None:
        raise ValueError("analyze_abstract needs the card's peaks "
                         "(roofline.analysis.card_peaks(name))")
    chips = int(math.prod(mesh.shape.values()))
    with mesh_context(mesh, rules):
        args = step_arguments(cfg, shape, mesh, rules, fsdp)
    arg_dev = arg_bytes(args)
    mf = model_flops(cfg, shape)
    t_compute = mf / chips / peaks.bf16
    t_memory = arg_dev / peaks.hbm
    terms = {"compute": t_compute, "memory": t_memory}
    record = {k: None for k in HLO_KEYS}
    record.update({
        "chips": chips,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "dominant": max(terms, key=terms.get),
        "model_flops_global": mf,
        "arg_bytes_per_device": arg_dev,
        "card": peaks.label,
        "peak_bf16_flops": peaks.bf16,
        "hbm_bytes_per_s": peaks.hbm,
    })
    return record


def step_time_bound(record: Dict) -> float:
    """Lower-bound step time = max of the terms present (no overlap
    model)."""
    return max(record[k] for k in ("t_compute_s", "t_memory_s",
                                   "t_collective_s")
               if record.get(k) is not None)
