"""The ops of the port around its kernels: the embedding ops (per-table
offsets, hot/cold split, the hot-pinned path) over K3, K4 and K5, and the
attention and SSD ops over K6, K7 and K8.

Ports of ``repro/kernels/ops.py``. The reference chooses between its Pallas
kernels and a jnp path with ``use_pallas``, and sends shapes its kernels do
not tile (S % 128, S_max % 512, S % chunk) to its oracles; the port has no
such switch and no such branch: every op goes through its kernel's wrapper,
which launches the CUDA kernel for CUDA tensors and runs the plain torch
version for CPU tensors. The CUDA kernels take any D and any length, so
nothing is padded to the TPU's 128 lanes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .decode_attention import decode_attention_kernel
from .embedding_bag import (
    embedding_bag_kernel,
    embedding_gather_kernel,
    vmem_gather_pool_kernel,
)
from .flash_attention import flash_attention_kernel
from .mamba2_ssd import mamba2_ssd_kernel


def _flat_indices(indices: torch.Tensor, rows_per_table: int) -> torch.Tensor:
    """Per-table row ids ``(B, T, L)`` -> ids into the stacked table."""
    T = indices.shape[1]
    offset = torch.arange(T, dtype=torch.int32, device=indices.device) * rows_per_table
    return (indices.to(torch.int32) + offset[None, :, None]).contiguous()


def embedding_bag(
    table: torch.Tensor,       # (T*R, D)
    indices: torch.Tensor,     # (B, T, L) per-table row ids (NOT offset)
    rows_per_table: int,
) -> torch.Tensor:             # (B, T, D)
    return embedding_bag_kernel(table, _flat_indices(indices, rows_per_table))


def embedding_gather(
    table: torch.Tensor,       # (R, D)
    indices: torch.Tensor,     # (...,) row ids
) -> torch.Tensor:             # (..., D)
    shape = indices.shape
    flat = indices.reshape(-1).to(torch.int32).contiguous()
    return embedding_gather_kernel(table, flat).reshape(*shape, table.shape[1])


def split_hot_cold(
    indices: np.ndarray,    # (B, T, L) per-table row ids
    hot_ids: np.ndarray,    # (n_hot,) sorted GLOBAL ids (t * rows + r)
    rows_per_table: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side prep for the pinned path: position-in-hot-table (or 0) and a
    hot mask, per lookup. Mirrors core.memory.policies pinning semantics."""
    t_ids = np.arange(indices.shape[1], dtype=np.int64)[None, :, None]
    glob = t_ids * rows_per_table + indices.astype(np.int64)
    pos = np.searchsorted(hot_ids, glob)
    pos = np.clip(pos, 0, max(len(hot_ids) - 1, 0))
    is_hot = len(hot_ids) > 0
    mask = (hot_ids[pos] == glob) if is_hot else np.zeros_like(glob, dtype=bool)
    return pos.astype(np.int32), mask.astype(np.int32)


def embedding_bag_pinned(
    table: torch.Tensor,       # (T*R, D) full table in device memory
    hot_table: torch.Tensor,   # (H, D) pinned hot rows (= table[hot_ids])
    indices: torch.Tensor,     # (B, T, L) per-table row ids
    positions: torch.Tensor,   # (B, T, L) position in hot_table
    mask: torch.Tensor,        # (B, T, L) 1 = hot
    rows_per_table: int,
) -> torch.Tensor:
    """Paper's Profiling policy: hot lookups never read the full table.

    The reference's kernel route: K5 pools the hot lookups from the hot
    table held on chip; hot lookups are redirected to row 0 and K4 gathers
    every lookup's row of the full table; a masked f32 sum over L (plain
    torch, as in the reference) keeps the cold ones. The hot sum is cast to
    the table dtype before it is added, as the reference rounds it.
    """
    flat_idx = _flat_indices(indices, rows_per_table)
    mask = mask.to(torch.int32).contiguous()
    hot = vmem_gather_pool_kernel(hot_table, positions.to(torch.int32).contiguous(), mask)
    cold_idx = flat_idx.masked_fill(mask == 1, 0)
    cold_all = embedding_gather_kernel(table, cold_idx.reshape(-1)).reshape(*cold_idx.shape, -1)
    cold = (cold_all.float() * (1 - mask)[..., None].float()).sum(dim=2)
    return (hot.float() + cold).to(table.dtype)


# --------------------------------------------------------------------------
# Attention / SSD
# --------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Hq, S, dq), k (B, Hkv, Sk, dq), v (B, Hkv, Sk, dv) -> (B, Hq, S,
    dv), through K6 (causal needs Sk == S). K6 has one head width, so a
    narrower v (MLA: dq 192, dv 128) goes in padded with zero columns to dq
    and the output comes back sliced to dv: exact, as the padded columns'
    sums are zero, for dq / dv (1.5 at MLA) times the p.v work of a native
    dv. The reference sends dv != dq to its chunked oracle, which rounds p
    to v's dtype before p.v, as K6's bf16 route does; on the CPU
    ``round_p`` makes K6's plain version round there too."""
    dq, dv = q.shape[-1], v.shape[-1]
    if dv == dq:
        return flash_attention_kernel(q, k, v, causal=causal)
    if dv > dq:
        raise ValueError(f"flash_attention: v's head dim {dv} exceeds q's {dq}")
    return flash_attention_kernel(q, k, F.pad(v, (0, dq - dv)), causal=causal,
                                  round_p=True)[..., :dv]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: int) -> torch.Tensor:
    """q (B, Hq, dh) over the cache's first ``valid_len`` positions (a host
    int) of k, v (B, Hkv, S_max, dh), through K7."""
    return decode_attention_kernel(q, k, v, valid_len)


def mamba2_ssd(x: torch.Tensor, adt: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
               C: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """x (B, H, S, P), adt and dt (B, H, S) f32, Bm and C (B, S, N) ->
    y (B, H, S, P), through K8."""
    return mamba2_ssd_kernel(x, adt, dt, Bm, C, chunk=chunk)
