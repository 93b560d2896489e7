"""mamba2-1.3b [ssm, attention-free]  [arXiv:2405.21060]

48L, d_model=2048, ssm_state=128, vocab=50280, no attention, no MLP
(d_ff=0; the Mamba2 block is the whole layer). SSD (state-space duality)
with d_inner = 2*d_model = 4096, head_dim P=64 -> 64 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=64,                 # SSD heads = expand*d_model / head_dim
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
    source="arXiv:2405.21060 (Mamba-2 1.3B)",
)
