"""mamba2-130m [ssm] — attention-free SSD. [arXiv:2405.21060; unverified]"""
from ..models.config import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,                       # attention-free
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        tie_embeddings=True,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4),
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, vocab=256,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=32),
    )
