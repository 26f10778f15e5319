"""Architecture configuration — one dataclass covering all assigned families.

A copy of ``repro/models/config.py`` (pure Python). Every architecture is an
``ArchConfig``; the port's ``configs/<id>.py`` hold them all, and reduced
variants (``smoke()``) instantiate the same family at toy scale for CPU
tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # dispatch groups: routing sort/pack runs independently per group so the
    # sort stays shard-local under GSPMD (set = data-parallel degree)
    dispatch_groups: int = 16


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""

    state_dim: int = 128            # N
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: mamba backbone + shared attention block every K layers."""

    attn_every: int = 6             # one shared attn+mlp block per 6 mamba layers
    shared_d_ff: int = 0            # 0 -> 4 * d_model


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder (frontend stubbed)."""

    encoder_layers: int = 6
    encoder_seq: int = 1500         # frames after conv frontend (stub input)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    mlp_type: str = "swiglu"        # swiglu | gelu (2-matrix, gpt-bigcode style)
    dtype: str = "bfloat16"
    # attention-free archs (mamba2) set n_heads = 0
    notes: str = ""

    @property
    def attn_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (long_500k eligibility)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs generate tokens (whisper = enc-dec)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_count(self) -> int:
        from . import registry  # local import to avoid cycle

        return registry.param_count(self)

    def active_param_count(self) -> int:
        from . import registry

        return registry.param_count(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ArchConfig) -> Tuple[ShapeConfig, ...]:
    """Assigned shapes minus documented skips (DESIGN.md §4):
    long_500k only for sub-quadratic archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)
