"""Decoder-only transformer LM: parameter definitions of the dense
family. The forward pass comes with the vmapped/legacy slice; MoE and MLA
blocks with the model-zoo slice."""
from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models.common import ParamSpec, dense_spec, stack_specs


def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_spec(d, f),
        "w_up": dense_spec(d, f),
        "w_down": dense_spec(f, d, logical=("tp", "fsdp")),
    }


def layer_defs(cfg):
    if cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError(
            "MLA and MoE blocks come with the model-zoo slice of the port")
    d = cfg.d_model
    return {"ln1": ParamSpec((d,), (None,), init="ones"),
            "ln2": ParamSpec((d,), (None,), init="ones"),
            "attn": attn.attn_defs(cfg),
            "mlp": mlp_defs(cfg)}


def lm_defs(cfg):
    d, v = cfg.d_model, cfg.vocab_size
    defs = {
        "embed": ParamSpec((v, d), ("tp", None), scale=0.02),
        "layers": stack_specs(layer_defs(cfg), cfg.num_layers),
        "ln_f": ParamSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = dense_spec(d, v)
    return defs
