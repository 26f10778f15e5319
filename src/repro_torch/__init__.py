"""EONSim on PyTorch: the simulator of ``repro`` ported to PyTorch and CUDA.

The module layout mirrors ``repro`` (``core/``, ``core/memory/``,
``kernels/``, ``launch/``), so each file has an obvious counterpart there.
This package imports ``torch`` and numpy only; the hand-written CUDA kernels
live in ``csrc/`` and are built with ``nvcc`` at first use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
