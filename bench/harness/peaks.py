"""Published peaks of the chips the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives. NVIDIA's H100 SXM data sheet, dense
rates without sparsity, at the full 700 W power limit."""
from __future__ import annotations

from typing import Optional

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops": 989e12,
    "f32_flops": 67e12,
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def peaks(device_name: str) -> Optional[dict]:
    """The chip's peaks, or None for a chip the table does not hold (its
    roofline metrics then read nothing)."""
    return PEAKS.get(device_name)
