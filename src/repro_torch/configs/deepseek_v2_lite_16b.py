"""deepseek-v2-lite-16b [moe + MLA]  [arXiv:2405.04434]

27L, d_model=2048, 16 heads (GQA kv=16 at the MLA latent), expert d_ff=1408,
vocab=102400. MLA with kv_lora_rank=512 (compressed KV cache of
512+64 per token). MoE: 64 routed experts top-6 + 2 shared experts.

NOTE on the assignment sheet: it lists both "MoE 64e top-6" and
"2 shared+160 routed top-6". The released DeepSeek-V2-Lite has 64 routed
experts (160 belongs to full V2); we follow the 64e figure and record the
discrepancy here and in DESIGN.md.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        num_experts=64,
        num_experts_unpadded=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        d_ff_shared=2816,
    ),
    source="arXiv:2405.04434 (DeepSeek-V2-Lite)",
)
