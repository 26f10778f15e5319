"""Data pipelines of the port: the synthetic DLRM click log."""
from .dlrm_data import DLRMDataConfig, dlrm_batch

__all__ = ["DLRMDataConfig", "dlrm_batch"]
