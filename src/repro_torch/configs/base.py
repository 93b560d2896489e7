"""Config dataclasses for the model zoo, input shapes, and jobs.

Every assigned architecture gets a ``ModelConfig`` in ``configs/<id>.py`` with
the exact dimensions from the assignment sheet (source cited per file). The
same dataclass drives smoke-test reduction (``reduced()``) and the dry-run
(full dims, ShapeDtypeStruct only).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


class DtypeError(ValueError):
    """A config names a dtype that does not resolve to a torch dtype.

    Configs carry dtypes as *strings* ("bfloat16", "float32") so they stay
    hashable/serializable; every consumer (model init, abstract params, the
    train step, the zoo↔engine adapter) must resolve them through
    `resolve_dtype` so a typo fails here with the offending value named —
    not deep inside a kernel with an opaque ``TypeError``."""


#: accepted shorthand spellings for config dtype strings
_DTYPE_ALIASES = {
    "bf16": "bfloat16",
    "fp16": "float16", "f16": "float16", "half": "float16",
    "fp32": "float32", "f32": "float32",
    "fp64": "float64", "f64": "float64",
}

#: the floating dtypes a config may name, by their canonical spelling
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
}


def resolve_dtype(dtype: Any, *, where: str = "") -> torch.dtype:
    """Resolve a config-carried dtype (string name, ``torch.dtype`` or
    numpy dtype) to a concrete ``torch.dtype``.

    The single choke point for every place a ``ModelConfig`` dtype string
    is consumed. Raises `DtypeError` naming the bad value (and, via
    ``where``, the field it came from)."""
    ctx = f" ({where})" if where else ""
    if dtype is None:
        raise DtypeError(f"dtype is None{ctx}: expected a dtype name such "
                         "as 'bfloat16' or 'float32'")
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = _DTYPE_ALIASES.get(dtype.strip().lower(), dtype.strip())
    else:
        name = getattr(dtype, "name", None) or getattr(dtype, "__name__", "")
    if name not in _TORCH_DTYPES:
        raise DtypeError(f"unresolvable dtype {dtype!r}{ctx}: expected one "
                         f"of {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (GShard-style capacity routing)."""

    num_experts: int              # routed experts (may be padded for sharding)
    num_experts_unpadded: int     # the paper/model-card value, pre-padding
    top_k: int
    d_ff_expert: int              # per-expert FFN hidden dim
    num_shared_experts: int = 0   # always-on shared experts
    d_ff_shared: int = 0          # total hidden dim of the shared expert MLP
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # expert-parallel flavor: "psum" (tokens replicated over the model axis,
    # each rank computes its local experts, one psum combines — no dispatch
    # collectives) or "alltoall" (GShard-style: tokens sharded over the
    # model axis, dispatch/return all-to-alls — ~k·cf/tp of the psum bytes
    # for top-k routing; EXPERIMENTS.md §Perf pair 3, Q4).
    parallelism: str = "psum"
    # renormalise the top-k weights to sum to 1 (DeepSeek-V2 does not)
    norm_topk_prob: bool = True
    # the experts this device holds without a mesh: the first
    # ``experts_held`` of them (None: every expert). The router keeps all
    # ``num_experts`` outputs; the block gives the held experts' share of
    # the routed output (one rank's part under expert parallelism).
    experts_held: Optional[int] = None

    def __post_init__(self):
        if not 0 < self.held <= self.num_experts:
            raise ValueError(f"{self.held} experts held of "
                             f"{self.num_experts}")

    @property
    def held(self) -> int:
        return self.num_experts if self.experts_held is None \
            else self.experts_held


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN's rope scaling (arXiv:2309.00071), as DeepSeek-V2's
    ``rope_scaling`` states it: the rotary frequencies ramp between plain
    and divided by ``factor`` over the dimensions whose wavelengths lie
    between ``beta_fast`` and ``beta_slow`` rotations of the
    ``original_max_position`` context, and the softmax scale gains
    ``mscale(factor, mscale_all_dim)²``. cos and sin are scaled by
    ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``, which the
    port takes as 1: the two must be equal."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0

    def __post_init__(self):
        if self.mscale != self.mscale_all_dim:
            raise ValueError("YaRN with mscale != mscale_all_dim scales cos "
                             "and sin, which the port does not")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2) config."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    yarn: Optional[YaRNConfig] = None   # None: plain rope


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD config."""

    d_state: int = 128
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    chunk_size: int = 256
    d_conv: int = 4
    ngroups: int = 1              # B/C groups


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). Frontend is a stub:
    the input is precomputed frame embeddings of shape (B, src_len, d_model)."""

    num_layers: int
    src_len: int                  # e.g. 1500 mel frames for whisper


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """VLM vision-tower stub: ``input_specs`` provides projected patch
    embeddings of shape (B, num_patches, d_model) prefixed to the text."""

    num_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0           # hybrid: shared attn block after every k SSM layers
    # MoE: the first k of the num_layers layers run a dense SwiGLU MLP of
    # width d_ff_dense in place of the experts (DeepSeek's
    # first_k_dense_replace)
    first_dense_layers: int = 0
    d_ff_dense: int = 0
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None
    # long_500k support: dense archs switch attention to a sliding window.
    sliding_window: Optional[int] = None
    # beyond-paper sharding option: shard attention over the query-sequence
    # dim instead of (padded) heads — removes pad-head compute waste for
    # archs whose head count doesn't divide the tp axis (whisper: 8 heads
    # on a 16-way axis). See EXPERIMENTS.md §Perf.
    attn_seq_shard: bool = False
    # decode-cache sharding over the model axis: "heads" shards kv-heads /
    # the MLA latent dim (memory-balanced default), "seq" shards the cache
    # sequence dim (flash-decode style: distributed softmax via small psums
    # instead of cache all-gathers), "none" replicates over tp
    # (EXPERIMENTS.md §Perf pair 2).
    kv_cache_shard: str = "heads"
    max_seq_len: int = 524288
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "bfloat16"
    # route full-sequence self-attention through the flash-attention kernel
    # (K2: kernels.ops.flash_mha, hand-written CUDA on the card)
    use_flash_attention: bool = False
    source: str = ""              # citation from the assignment sheet

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this config decode at 500k tokens? SSM/hybrid natively; others
        only with a sliding window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def activation_dtype(self):
        return resolve_dtype(self.dtype, where=f"{self.name}.dtype")

    def resolved_param_dtype(self):
        return resolve_dtype(self.param_dtype,
                             where=f"{self.name}.param_dtype")

    def reduced(self) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests:
        <=2 layers, d_model<=512, <=4 routed experts."""
        kw = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=min(self.d_ff, 512),
            d_ff_dense=min(self.d_ff_dense, 512),
            first_dense_layers=min(self.first_dense_layers, 1),
            vocab_size=min(self.vocab_size, 512),
            head_dim=64,
            max_seq_len=4096,
            dtype="float32",
            param_dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                num_experts_unpadded=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=128,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_shared=128,
                experts_held=None,
            )
        if self.mla is not None:
            kw["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=32, head_dim=32, chunk_size=64)
        if self.encoder is not None:
            kw["encoder"] = dataclasses.replace(
                self.encoder, num_layers=1, src_len=64)
        if self.vision is not None:
            kw["vision"] = dataclasses.replace(self.vision, num_patches=16)
        if self.attn_every:
            kw["attn_every"] = 2
        if self.sliding_window is not None:
            kw["sliding_window"] = min(self.sliding_window, 128)
        return self.with_(**kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """How to lay the model on the mesh.

    * ``data_axes``: mesh axes carrying the batch (elastic worker axis).
    * ``model_axes``: mesh axes carrying tensor/expert parallelism.
    * ``fsdp_params``: shard params (and optimizer state) over the data axes
      too (ZeRO-3 style); otherwise params are only sharded over model axes.
    * ``remat``: activation checkpointing policy name.
    """

    data_axes: Tuple[str, ...] = ("data",)
    model_axes: Tuple[str, ...] = ("model",)
    fsdp_params: bool = True
    remat: str = "full"           # "none" | "dots" | "full"
    scan_layers: bool = True

    @property
    def dp(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def tp(self):
        return self.model_axes if len(self.model_axes) > 1 else self.model_axes[0]


@dataclasses.dataclass(frozen=True)
class JobConfig:
    """Top-level training/serving job description (the unit the paper's
    optimizers configure: bids / worker counts / schedules attach here)."""

    model: ModelConfig
    shape: InputShape
    sharding: ShardingConfig = ShardingConfig()
    n_workers: int = 16           # elastic worker slices on the data axis
    learning_rate: float = 0.1
    momentum: float = 0.9
    optimizer: str = "sgd"        # paper uses SGD
    microbatch: int = 1           # gradient-accumulation chunks per step
    seed: int = 0
