"""How the program under test (`repro_torch`) runs configuration
``qwen2-7b``: its model config, the launcher's flags that name it, and the
map between the reference's leaf paths and the program's parameter tree.

The reference (``bench/configs/qwen2-7b.py``) names its leaves as the
port's dense decoder does (``embed``, ``layers.attn.wq.<l>``, ...), so the
map is `weights.nest` and its inverse."""
from __future__ import annotations

from typing import Dict, List

from bench.harness import weights as wmod

#: published config key → the port's ModelConfig field
HF_TO_PORT = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
              "num_attention_heads": "num_heads",
              "num_key_value_heads": "num_kv_heads",
              "intermediate_size": "d_ff", "vocab_size": "vocab_size",
              "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
              "tie_word_embeddings": "tie_embeddings"}


def model_config(conf: Dict, traffic: Dict):
    """The port's ModelConfig of the configuration file, at the traffic's
    precision; its head width is checked against the file's."""
    from repro_torch.configs import get_config

    kw = {HF_TO_PORT[k]: v for k, v in conf.items() if k in HF_TO_PORT}
    dh = conf["hidden_size"] // conf["num_attention_heads"]
    cfg = get_config(conf["port_arch"]).with_(
        head_dim=dh, dtype=traffic["dtype"], param_dtype=traffic["dtype"],
        use_flash_attention=bool(traffic.get("flash_attention", False)),
        **kw)
    if cfg.resolved_head_dim != dh:
        raise ValueError(f"head_dim {cfg.resolved_head_dim} != {dh}")
    return cfg


def launcher_args(conf: Dict) -> List[str]:
    """The flags of ``python -m repro_torch.launch.train`` that name the
    model."""
    return ["--config", conf["port_arch"],
            "--reduce-depth", str(conf["num_hidden_layers"])]


def to_program(flat):
    """The reference's {path: leaf} as the program's parameter tree."""
    return wmod.nest(flat)


def from_program(tree, lead: int):
    """The program's parameter tree (leaves with ``lead`` leading axes) as
    {path: view}."""
    return wmod.flat_views(tree, lead)
