"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 2 shared + 64 routed
experts top-6. [arXiv:2405.04434; hf]"""
from ..models.config import ArchConfig, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,                          # FFN is fully MoE (shared + routed)
        vocab=102400,
        mla=MLAConfig(
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=64, top_k=6, d_ff_expert=1408,
            num_shared_experts=2, d_ff_shared=2816,
        ),
        notes="MLA latent-KV attention; serving caches the 512+64-wide latent "
              "instead of full per-head KV",
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, vocab=256, n_kv_heads=4,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=48,
                      num_shared_experts=1, d_ff_shared=48,
                      capacity_factor=4.0, dispatch_groups=2),
    )
