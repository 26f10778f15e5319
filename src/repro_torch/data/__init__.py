"""Data pipelines of the port: the synthetic DLRM click log and LM tokens."""
from .dlrm_data import DLRMDataConfig, dlrm_batch
from .lm import LMDataConfig, lm_batch

__all__ = ["DLRMDataConfig", "dlrm_batch", "LMDataConfig", "lm_batch"]
