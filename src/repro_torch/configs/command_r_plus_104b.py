"""command-r-plus-104b [dense] — GQA, no-bias, 256k vocab (the largest
embedding surface of the pool: 3.1 GB table -> prime hot-pinning target).
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from ..models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab=256000,
        notes="256k vocab: vocab-parallel embedding + chunked CE are "
              "mandatory at this scale",
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
    )
