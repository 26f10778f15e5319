"""Models of the port: the DLRM and the LM families (dense, moe, vlm, ssm,
hybrid, audio)."""
from .config import ALL_SHAPES, SHAPES_BY_NAME, ArchConfig, ShapeConfig, shapes_for
from .dlrm import DLRM, DLRMConfig, bce_loss, interact, smoke_config
from .registry import ARCH_IDS, family_module, get_config, get_smoke_config, param_count

__all__ = [
    "ALL_SHAPES", "SHAPES_BY_NAME", "ArchConfig", "ShapeConfig", "shapes_for",
    "DLRM", "DLRMConfig", "bce_loss", "interact", "smoke_config",
    "ARCH_IDS", "family_module", "get_config", "get_smoke_config", "param_count",
]
