"""chameleon-34b [vlm] — early-fusion: VQ image tokens share the text vocab;
the VQ tokenizer frontend is a stub (tokens arrive pre-quantized).
[arXiv:2405.09818; unverified]"""
from ..models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab=65536,
        notes="early-fusion VLM == decoder LM over a mixed text+VQ-code vocab; "
              "the skewed-code reuse story maps directly onto EONSim's "
              "embedding traces",
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
    )
