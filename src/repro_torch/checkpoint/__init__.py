"""Checkpoints of train states (a port of ``repro/checkpoint``)."""
from .manager import CheckpointManager, CheckpointConfig

__all__ = ["CheckpointManager", "CheckpointConfig"]
