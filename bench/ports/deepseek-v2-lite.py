"""How the program under test (`repro_torch`) runs configuration
``deepseek-v2-lite``: its model config (the registry's DeepSeek-V2-Lite
made the published block: a leading dense layer, top-k weights not
renormalised, YaRN's rope, the experts this chip holds), the launcher's
flags that name it, and the map between the reference's leaf paths and the
program's parameter tree.

The reference (``bench/configs/deepseek-v2-lite.py``) names the MoE
layers' leaves as the port's decoder does (``layers.mla.wq.<l>``, ...) and
the leading dense layers' as ``dense_layers.<...>.<l>``, which the port
stacks under ``dense_layers``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from bench.harness import weights as wmod

#: published keys whose values the port's block fixes: a file that states
#: others names a block the port does not run
FIXED = {"q_lora_rank": None, "scoring_func": "softmax",
         "topk_method": "greedy", "routed_scaling_factor": 1, "n_group": 1,
         "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu",
         "attention_bias": False}

DENSE = "dense_layers"


def model_config(conf: Dict, traffic: Dict):
    """The port's ModelConfig of the configuration file, at the traffic's
    precision."""
    from repro_torch.configs import MLAConfig, YaRNConfig, get_config

    wrong = {k: conf[k] for k, v in FIXED.items() if conf[k] != v}
    if wrong or conf["rope_scaling"]["type"] != "yarn":
        raise ValueError(f"not the port's DeepSeek-V2 block: {wrong}")
    base = get_config(conf["port_arch"])
    f, rs = conf["moe_intermediate_size"], conf["rope_scaling"]
    moe = dataclasses.replace(
        base.moe, num_experts=conf["router_experts"],
        num_experts_unpadded=conf["router_experts"],
        top_k=conf["num_experts_per_tok"], d_ff_expert=f,
        num_shared_experts=conf["n_shared_experts"],
        d_ff_shared=conf["n_shared_experts"] * f,
        capacity_factor=conf["capacity_factor"],
        aux_loss_weight=conf["aux_loss_weight"],
        norm_topk_prob=conf["norm_topk_prob"],
        experts_held=conf["n_routed_experts"])
    mla = MLAConfig(
        kv_lora_rank=conf["kv_lora_rank"],
        qk_nope_head_dim=conf["qk_nope_head_dim"],
        qk_rope_head_dim=conf["qk_rope_head_dim"],
        v_head_dim=conf["v_head_dim"],
        yarn=YaRNConfig(
            factor=rs["factor"],
            original_max_position=rs["original_max_position_embeddings"],
            beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
            mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"]))
    return base.with_(
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        num_heads=conf["num_attention_heads"],
        num_kv_heads=conf["num_key_value_heads"], d_ff=f,
        first_dense_layers=conf["first_k_dense_replace"],
        d_ff_dense=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        rope_theta=conf["rope_theta"], norm_eps=conf["rms_norm_eps"],
        tie_embeddings=conf["tie_word_embeddings"], moe=moe, mla=mla,
        dtype=traffic["dtype"], param_dtype=traffic["dtype"],
        use_flash_attention=bool(traffic.get("flash_attention", False)))


def launcher_args(conf: Dict) -> List[str]:
    """The flags of ``python -m repro_torch.launch.train`` that name the
    model."""
    return ["--config", conf["port_arch"],
            "--reduce-depth", str(conf["num_hidden_layers"])]


def to_program(flat):
    """The reference's {path: leaf} as the program's parameter tree."""
    dense = {"layers" + k[len(DENSE):]: v for k, v in flat.items()
             if k.startswith(DENSE + ".")}
    tree = wmod.nest({k: v for k, v in flat.items()
                      if not k.startswith(DENSE + ".")})
    if dense:
        tree[DENSE] = wmod.nest(dense)["layers"]
    return tree


def from_program(tree, lead: int):
    """The program's parameter tree (leaves with ``lead`` leading axes) as
    {path: view}."""
    out = wmod.flat_views({k: v for k, v in tree.items() if k != DENSE},
                          lead)
    if DENSE in tree:
        out.update({DENSE + k[len("layers"):]: v for k, v in
                    wmod.flat_views({"layers": tree[DENSE]}, lead).items()})
    return out
