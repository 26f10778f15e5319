"""Architecture registry: name -> config + family dispatch + param counting.

A port of ``repro/models/registry.py``: ``get_config`` and
``get_smoke_config`` read the port's copies of the reference's ``configs/``,
``family_module`` sends the audio family to ``whisper``, hybrid to
``hybrid``, ssm to ``mamba`` and dense, moe and vlm to ``transformer``, and
``param_count`` is the reference's pure-Python count.
"""
from __future__ import annotations

import importlib

from .config import ArchConfig

ARCH_IDS = (
    "arctic_480b",
    "deepseek_v2_lite_16b",
    "chameleon_34b",
    "zamba2_2p7b",
    "granite_34b",
    "command_r_plus_104b",
    "granite_20b",
    "stablelm_3b",
    "whisper_base",
    "mamba2_130m",
)

_ALIASES = {
    "arctic-480b": "arctic_480b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "chameleon-34b": "chameleon_34b",
    "zamba2-2.7b": "zamba2_2p7b",
    "granite-34b": "granite_34b",
    "command-r-plus-104b": "command_r_plus_104b",
    "granite-20b": "granite_20b",
    "stablelm-3b": "stablelm_3b",
    "whisper-base": "whisper_base",
    "mamba2-130m": "mamba2_130m",
}


def normalize(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def _config_module(name: str):
    return importlib.import_module(f"..configs.{normalize(name)}", __package__)


def get_config(name: str) -> ArchConfig:
    return _config_module(name).config()


def get_smoke_config(name: str) -> ArchConfig:
    return _config_module(name).smoke()


def family_module(cfg: ArchConfig):
    from . import hybrid, mamba, transformer, whisper

    if cfg.family == "audio":
        return whisper
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "ssm":
        return mamba
    return transformer  # dense | moe | vlm


# --------------------------------------------------------------------------
# Parameter counting (analytic — used for roofline MODEL_FLOPS = 6 N D)
# --------------------------------------------------------------------------

def _attn_params(cfg: ArchConfig) -> int:
    if cfg.mla is not None:
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        return (
            cfg.d_model * cfg.n_heads * qd
            + cfg.d_model * (m.kv_lora_rank + m.qk_rope_head_dim)
            + m.kv_lora_rank * cfg.n_heads * m.qk_nope_head_dim
            + m.kv_lora_rank * cfg.n_heads * m.v_head_dim
            + cfg.n_heads * m.v_head_dim * cfg.d_model
        )
    dh = cfg.attn_head_dim
    return cfg.d_model * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * dh * cfg.d_model


def _dense_mlp_params(cfg: ArchConfig, d_ff: int) -> int:
    mult = 2 if cfg.mlp_type == "gelu" else 3
    return mult * cfg.d_model * d_ff


def _moe_params(cfg: ArchConfig, active_only: bool) -> int:
    m = cfg.moe
    n_exp = m.top_k if active_only else m.num_experts
    total = cfg.d_model * m.num_experts                  # router
    total += n_exp * 3 * cfg.d_model * m.d_ff_expert     # routed experts (swiglu)
    if m.num_shared_experts:
        f_sh = m.d_ff_shared or m.d_ff_expert * m.num_shared_experts
        total += 3 * cfg.d_model * f_sh
    return total


def _ssm_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    N = s.state_dim
    conv_ch = di + 2 * N
    return (
        cfg.d_model * (di + conv_ch + H)     # split z | xBC | dt projections
        + s.conv_width * conv_ch + conv_ch
        + 3 * H
        + di
        + di * cfg.d_model
    )


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    D, V = cfg.d_model, cfg.vocab
    embed = V * D * (1 if cfg.tie_embeddings else 2)

    if cfg.family == "audio":
        enc = cfg.encdec.encoder_layers * (_attn_params(cfg) + _dense_mlp_params(cfg, cfg.d_ff) + 4 * D)
        dec = cfg.n_layers * (2 * _attn_params(cfg) + _dense_mlp_params(cfg, cfg.d_ff) + 6 * D)
        return V * D + 4096 * D + enc + dec + 4 * D

    if cfg.family == "ssm":
        per_layer = _ssm_params(cfg) + D
        return embed + cfg.n_layers * per_layer + D

    if cfg.family == "hybrid":
        per_layer = _ssm_params(cfg) + D
        f_sh = cfg.hybrid.shared_d_ff or 4 * D
        shared = _attn_params(cfg) + 3 * D * f_sh + 2 * D
        return embed + cfg.n_layers * per_layer + shared + D

    # dense / moe / vlm
    per_layer = _attn_params(cfg) + 2 * D
    if cfg.moe is not None:
        per_layer += _moe_params(cfg, active_only)
        if cfg.d_ff:
            per_layer += _dense_mlp_params(cfg, cfg.d_ff)
    else:
        per_layer += _dense_mlp_params(cfg, cfg.d_ff)
    return embed + cfg.n_layers * per_layer + D
