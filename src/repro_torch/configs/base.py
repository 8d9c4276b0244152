"""Architecture config schema + input-shape cells (a copy of the
reference's ``repro/configs/base.py``).

Every architecture is a frozen `ArchConfig`; the four input shapes are
`ShapeCell`s. `runnable()` encodes the skip rules (long_500k needs
sub-quadratic attention; decode needs a decoder).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    norm: str = "rmsnorm"        # rmsnorm | nonparam_ln
    mlp: str = "swiglu"          # swiglu | gelu (2-matrix)
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid / linear-attn
    ssm_state: int = 0
    attn_every: int = 0          # hybrid: shared attn after every N ssm blocks
    # enc-dec / frontends
    encoder_layers: int = 0
    frontend: str = ""           # "" | audio_stub | vision_stub
    frontend_dim: int = 0        # stub embedding dim
    frontend_len: int = 0        # stub sequence length (frames / patches)
    # capabilities
    sub_quadratic: bool = False  # can run long_500k
    has_decoder: bool = True     # encoder-only archs skip decode shapes
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def runnable(arch: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-not)."""
    if shape.kind == "decode" and not arch.has_decoder:
        return False, "encoder-only arch: no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (assignment skip rule)")
    return True, ""


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # populate registry lazily
    from repro_torch import configs as _c  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    from repro_torch import configs as _c  # noqa: F401
    return tuple(sorted(_REGISTRY))
