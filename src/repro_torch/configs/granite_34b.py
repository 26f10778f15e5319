"""granite-34b [dense] — gpt-bigcode-style MQA (kv=1), 2-matrix GELU MLP
(param math: 88 x (attn 77M + mlp 302M) + embeddings = 34B). [arXiv:2405.04324; hf]"""
from ..models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab=49152,
        mlp_type="gelu",
        notes="MQA code model; 2-matrix MLP matches the 34B total "
              "(a SwiGLU MLP would give 47B)",
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256,
    )
