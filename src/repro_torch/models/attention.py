"""GQA attention parameter definitions. The attention forward itself is
ported with the vmapped/legacy slice; the megabatch trainer computes its
blocked attention in ``train.megabatch``."""
from __future__ import annotations

from repro_torch.models.common import ParamSpec, dense_spec


def attn_defs(cfg, cross: bool = False):
    """ParamSpecs for one attention block. The port runs on one device, so
    query heads are never padded for a tensor-parallel axis (the
    reference's ``padded_heads`` is the identity without a mesh)."""
    del cross
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq = cfg.num_heads
    hkv = cfg.num_kv_heads
    defs = {
        "wq": dense_spec(d, hq * dh),
        "wk": dense_spec(d, hkv * dh),
        "wv": dense_spec(d, hkv * dh),
        "wo": dense_spec(hq * dh, d, logical=("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamSpec((hq * dh,), ("tp",), init="zeros")
        defs["bk"] = ParamSpec((hkv * dh,), (("tp", None),), init="zeros")
        defs["bv"] = ParamSpec((hkv * dh,), (("tp", None),), init="zeros")
    return defs
