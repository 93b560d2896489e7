"""Unified model API over the families the port runs.

* ``param_defs(cfg)``   -> ParamSpec nested dict
* ``forward(params, cfg, batch)``  -> (logits, moe_aux)   [training]

The dense and VLM families are ported (a VLM batch carries its projected
patch embeddings as a prefix). MoE blocks and the SSM, hybrid and enc-dec
families come with the zoo-families slice, and the decode path
(``decode_step``, ``prefill``, ``cache_defs``) with the serving slice."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import transformer as tf_mod

_PORTED = ("dense", "vlm")


def _family(cfg) -> None:
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported to repro_torch yet: "
            "it comes with the zoo-families slice")


def param_defs(cfg):
    _family(cfg)
    return tf_mod.lm_defs(cfg)


def forward(params, cfg, batch: Dict[str, torch.Tensor], remat: str = "none"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch keys: tokens (B, S); vlm additionally patches (B, P, d)."""
    _family(cfg)
    prefix = batch.get("patches") if cfg.family == "vlm" else None
    return tf_mod.lm_forward(params, cfg, batch["tokens"],
                             prefix_embeds=prefix, remat=remat)

