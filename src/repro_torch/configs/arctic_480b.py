"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP per layer.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from ..models.config import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,                       # dense residual MLP
        vocab=32000,
        moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864),
        notes="dense-MoE hybrid: every layer has a dense SwiGLU residual in "
              "parallel with the 128-expert top-2 MoE FFN",
    )


def smoke() -> ArchConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=256,
        # dropless at smoke scale so serve-vs-forward is exact
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=96,
                      capacity_factor=4.0, dispatch_groups=2),
    )
