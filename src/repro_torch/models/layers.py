"""Layers of the model zoo. Only the initialiser the DLRM needs is ported
so far; the LM layers come with the LM families."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def _dense_init(shape: Sequence[int], *, generator: torch.Generator, device: torch.device,
                scale: Optional[float] = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``randn(shape) * scale`` in f32 from ``generator`` on ``device``, cast
    to ``dtype``; ``scale`` defaults to ``1 / sqrt(shape[0])``."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    x = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)
