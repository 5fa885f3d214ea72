"""Config system of the PyTorch port: model architecture, input shapes,
parallelism, training.

The port keeps its own copy of the reference package's config dataclasses
(``repro/configs/base.py``) so that it imports nothing from that package.
The fields and defaults are the reference's, field for field, and every
architecture of the reference is registered (``repro_torch.configs``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

Family = Literal["dense", "moe", "vlm", "audio", "hybrid", "ssm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    gated_mlp: bool = True             # SwiGLU; False -> plain GELU MLP
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # hybrid (recurrentgemma): repeating block pattern + tail
    block_pattern: tuple[str, ...] = ()
    d_rnn: int = 0
    conv_width: int = 4
    local_window: int = 0

    # ssm (xlstm)
    slstm_every: int = 0
    proj_factor: float = 2.0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    num_frames: int = 1500

    # vlm
    num_patches: int = 0

    # numerics / runtime
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_quant: bool = False                # int8 KV cache (+bf16 scales)
    remat: bool = True
    remat_policy: str = "full"            # "full" (save nothing) | "dots"
    attention_impl: str = "reference"     # "reference" | "pallas"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1)/O(window) in context length."""
        return self.family in ("hybrid", "ssm")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def applicable_shapes(cfg: ModelConfig) -> list[ShapeConfig]:
    """The production shape cells this architecture runs: ``long_500k``
    needs sub-quadratic attention, so the pure full-attention archs skip
    it."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        shapes.append(LONG_500K)
    return shapes


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh axes and policy switches for the distributed runtime."""

    data: int = 1
    model: int = 1
    pods: int = 1
    fsdp: bool = False
    seq_sharding: bool = False
    zero: int = 1
    dp_sync: str = "gspmd"             # "gspmd" | "hier_baseline" | "themis"
    chunks_per_collective: int = 16
    compression: str = "none"          # "none" | "int8"
    remat_policy: str = "dots"         # "none" | "dots" | "full"

    @property
    def mesh_shape(self) -> tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.pods > 1 else (self.data, self.model)

    @property
    def mesh_axes(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    microbatch: int = 0                # 0 = no gradient accumulation
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3


# -- registry ---------------------------------------------------------------
_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    reduced: ModelConfig


def register(config: ModelConfig, reduced: ModelConfig) -> ArchSpec:
    spec = ArchSpec(config, reduced)
    _REGISTRY[config.name] = spec
    return spec


def get_arch(name: str, *, reduced: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (trigger registration)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    spec = _REGISTRY[name]
    return spec.reduced if reduced else spec.config


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
