"""Architecture registry: the 10 assigned configs + the paper's own workload."""
from repro_torch.configs import (
    deepseek_7b,
    deepseek_v2_lite_16b,
    internvl2_1b,
    mamba2_13b,
    mistral_large_123b,
    qwen2_7b,
    qwen2_moe_a27b,
    whisper_base,
    yi_34b,
    zamba2_7b,
)
from repro_torch.configs.base import (
    InputShape,
    JobConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    ShardingConfig,
    SSMConfig,
    YaRNConfig,
)
from repro_torch.configs.shapes import DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        whisper_base,
        deepseek_7b,
        mistral_large_123b,
        qwen2_moe_a27b,
        internvl2_1b,
        qwen2_7b,
        yi_34b,
        mamba2_13b,
        zamba2_7b,
        deepseek_v2_lite_16b,
    )
}

# Default sliding window applied to non-subquadratic archs for long_500k.
LONG_CONTEXT_WINDOW = 8192


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


def config_for_shape(name: str, shape: InputShape) -> ModelConfig:
    """Resolve the model config for a given input shape.

    ``long_500k`` requires sub-quadratic attention: SSM archs run natively;
    every other family (incl. the hybrid's shared attention block) switches to
    the sliding-window attention variant (window=LONG_CONTEXT_WINDOW). This
    mirrors DESIGN.md §Arch-applicability.
    """
    cfg = get_config(name)
    if shape.name == "long_500k" and cfg.family != "ssm":
        cfg = cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


__all__ = [
    "ARCHS",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "get_config",
    "config_for_shape",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "YaRNConfig",
    "InputShape",
    "ShardingConfig",
    "JobConfig",
    "LONG_CONTEXT_WINDOW",
]
