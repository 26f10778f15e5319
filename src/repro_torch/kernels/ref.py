"""Plain torch oracles of the embedding kernels (the allclose targets).

Ports of ``embedding_bag_ref``, ``embedding_gather_ref`` and
``embedding_bag_pinned_ref`` of ``repro/kernels/ref.py``: one gather of
every row, then one reduction over L, in whatever order torch sums. The
attention and SSD oracles come with the LM kernels.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table (T*R, D), indices (B, T, L) pre-offset -> (B, T, D) sum-pool."""
    gathered = table[indices.long()]                  # (B, T, L, D)
    return gathered.float().sum(dim=2).to(table.dtype)


def embedding_gather_ref(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    return table[indices.long()]


def embedding_bag_pinned_ref(
    hot_table: torch.Tensor,     # (H, D)
    positions: torch.Tensor,     # (B, T, L) position in hot table (0 if cold)
    mask: torch.Tensor,          # (B, T, L) 1 = hot
) -> torch.Tensor:
    rows = hot_table[positions.long()].float()       # (B, T, L, D)
    rows = rows * mask[..., None].float()
    return rows.sum(dim=2).to(hot_table.dtype)
