"""Device selection for the PyTorch port.

The port's entry points run on the card. ``resolve_device`` returns the CUDA
device, or raises when there is none; the CPU is used only when the caller
asks for it by name (the CPU tests do). There is no silent fallback: a
missing GPU is an error, not a slower run.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def indexed_device(device: DeviceLike = "cuda") -> torch.device:
    """``resolve_device(device)`` with a CUDA device's index made explicit
    (``cuda`` is the current device, ``cuda:0`` on a fresh thread), so two
    spellings of one card compare equal: ``torch.device("cuda") !=
    torch.device("cuda:0")``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
