"""zamba2-7b [hybrid: Mamba2 backbone + shared attention]  [arXiv:2411.15242]

81 Mamba2 layers, d_model=3584, ssm_state=64; ONE shared attention+MLP block
(32 heads, GQA kv=32, d_ff=14336) whose parameters are reused at every 6th
layer. vocab=32000. Simplification vs. the released model: we reuse the
shared block directly (no per-site LoRA adapters) — noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,                 # 3584 / 32
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=256),
    attn_every=6,
    source="arXiv:2411.15242 (Zamba2-7B)",
)
