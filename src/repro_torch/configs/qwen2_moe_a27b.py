"""qwen2-moe-a2.7b [moe]  [hf:Qwen/Qwen1.5-MoE-A2.7B]

24L, d_model=2048, 16 heads (GQA kv=16), expert d_ff=1408, vocab=151936,
MoE: 60 routed experts top-4 + 4 shared experts (shared hidden 4*1408=5632).
Routed experts are padded 60 -> 64 so the expert dim shards evenly over the
16-way model axis; the pad experts receive zero router weight.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(
        num_experts=64,
        num_experts_unpadded=60,
        top_k=4,
        d_ff_expert=1408,
        num_shared_experts=4,
        d_ff_shared=5632,
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
