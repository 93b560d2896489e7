"""internvl2-1b [vlm]  [arXiv:2404.16821]

Language backbone (Qwen2-0.5B-style): 24L, d_model=896, 14 heads (GQA kv=2),
d_ff=4864, vocab=151655. The InternViT vision tower + MLP projector is a STUB
per the assignment: ``input_specs`` provides projected patch embeddings of
shape (B, 256, 896) which are prefixed to the text token embeddings.
"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    vision=VisionStubConfig(num_patches=256),
    source="arXiv:2404.16821 (InternVL2-1B; InternViT-300M + Qwen2-0.5B)",
)
