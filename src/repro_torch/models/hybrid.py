"""The Mamba2 layer shared by the SSM and hybrid families: a pre-norm
residual around `models.ssm.ssm_block`. The rest of the hybrid (Zamba2)
backbone — its super-groups with one shared attention/MLP block — comes
with the zoo-families slice of the port."""
from __future__ import annotations

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamSpec, rms_norm


def ssm_layer_defs(cfg):
    return {
        "ln": ParamSpec((cfg.d_model,), (None,), init="ones"),
        "ssm": ssm_mod.ssm_defs(cfg),
    }


def _ssm_layer(p, cfg, x, cache=None):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, new_cache = ssm_mod.ssm_block(p["ssm"], cfg, h, cache=cache)
    return x + y, new_cache
