"""whisper-base [audio] — enc-dec; conv/mel frontend STUBBED (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from ..models.config import ArchConfig, EncDecConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,                      # decoder layers
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab=51865,
        tie_embeddings=True,
        encdec=EncDecConfig(encoder_layers=6, encoder_seq=1500),
        notes="frontend stub per brief: encoder consumes precomputed "
              "(B, 1500, 512) frame embeddings",
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        encdec=EncDecConfig(encoder_layers=2, encoder_seq=64),
    )
