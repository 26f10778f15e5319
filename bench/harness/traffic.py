"""Samplers that traffic kinds share, on the device.

The Zipf sampler is the inverse-CDF sampler of the simulator's
``generate_zipf_trace`` (a float64 CDF over ranks 1..R with p ~ r^-s, one
uniform draw a lookup, the first rank whose CDF exceeds it), done on the
device with one generator.
"""
from __future__ import annotations

import torch


def zipf_cdf(rows: int, s: float, device) -> torch.Tensor:
    """float64 CDF over popularity ranks 0..rows-1, p(r) ~ (r + 1)^-s."""
    ranks = torch.arange(1, rows + 1, dtype=torch.float64, device=device)
    p = ranks.pow_(-float(s))
    cdf = torch.cumsum(p, 0)
    return cdf.div_(cdf[-1].clone())


def zipf_ranks(n: int, cdf: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``n`` popularity ranks (int64, 0 most popular) by inverse CDF."""
    u = torch.rand(n, dtype=torch.float64, device=cdf.device, generator=generator)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)
