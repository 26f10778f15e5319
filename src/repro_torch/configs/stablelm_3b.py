"""stablelm-3b [dense]. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from ..models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab=50304,
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=256,
    )
