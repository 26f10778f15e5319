"""Models of the port: the DLRM so far (the LM families come later)."""
from .dlrm import DLRM, DLRMConfig, bce_loss, interact, smoke_config

__all__ = ["DLRM", "DLRMConfig", "bce_loss", "interact", "smoke_config"]
