"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]"""
from ..models.config import ArchConfig, HybridConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
        hybrid=HybridConfig(attn_every=6, shared_d_ff=10240),
        notes="54 Mamba2 layers; ONE shared attention+MLP block applied every "
              "6 layers (per-application LoRA deltas omitted; ~2.4B of the "
              "2.7B captured)",
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=32),
        hybrid=HybridConfig(attn_every=2, shared_d_ff=128),
    )
