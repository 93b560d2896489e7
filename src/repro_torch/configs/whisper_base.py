"""whisper-base [audio enc-dec]  [arXiv:2212.04356]

6L encoder + 6L decoder, d_model=512, 8 heads (kv=8), d_ff=2048,
vocab=51865. The mel-spectrogram + conv frontend is a STUB per the
assignment: ``input_specs`` provides precomputed frame embeddings of shape
(B, 1500, 512).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,                 # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    rope_theta=0.0,               # whisper uses absolute (sinusoidal) positions
    encoder=EncoderConfig(num_layers=6, src_len=1500),
    source="arXiv:2212.04356 (Whisper); base size table",
)
