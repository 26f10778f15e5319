"""K2: the LRU stack-distance kernel and its plain torch version.

Replaces the Pallas kernel ``_stack_distance_kernel`` of
``repro/kernels/stack_distance.py`` (``cache_backend="stack_pallas"``).
Per set-group sub-trace it keeps a recency-ordered tag list per set (way 0
= MRU); per access the tag's position is the LRU stack distance, capped at
``ways`` (a W-way hit iff ``dist < W``), then the list rotate-inserts the
tag toward MRU. A miss into a full set evicts; a padded slot reports
distance ``ways``.

``stack_distance_groups`` launches the CUDA kernel
(``csrc/stack_distance.cu``) for CUDA tensors and runs
``stack_distance_plain`` for CPU tensors; there is no other route. The
kernel's bound (latency of L dependent updates per row, not bytes) and its
design are noted in the source.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_rows, load_library

_MAX_SHARED_BYTES = 48 * 1024


def stack_distance_plain(sets, tags, valid, num_sets: int, ways: int):
    """Plain torch recency-list scan: ``(dist int32, evict bool)``, ``(B, L)``."""
    B, L = sets.shape
    dev = sets.device
    lists = torch.full((B, num_sets, ways), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    way_idx = torch.arange(ways, dtype=torch.int32, device=dev)[None, :]
    dist = torch.full((B, L), ways, dtype=torch.int32, device=dev)
    evicts = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for i in range(L):
        s = sets[:, i].long()
        tag = tags[:, i].to(torch.int32)[:, None]
        v = valid[:, i]
        row = lists[rows, s]
        hit_vec = row == tag
        found = hit_vec.any(dim=1)
        pos = torch.where(hit_vec, way_idx, 0).sum(dim=1, dtype=torch.int32)
        d = torch.where(found, pos, ways)
        # Rotate-insert toward MRU: ways [1, limit] take their left
        # neighbour, way 0 takes the tag; ways beyond the hit position (or
        # everything on a miss, dropping the LRU way) stay put.
        limit = torch.where(found, pos, ways - 1)[:, None]
        rolled = torch.roll(row, 1, dims=1)
        new_row = torch.where(
            way_idx == 0, tag, torch.where(way_idx <= limit, rolled, row)
        )
        evicts[:, i] = v & ~found & (row[:, ways - 1] >= 0)
        lists[rows, s] = torch.where(v[:, None], new_row, row)
        dist[:, i] = torch.where(v, d, ways)
    return dist, evicts


def _launcher():
    fn = load_library("stack_distance").stack_distance_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stack_distance_groups(sets, tags, valid, num_sets: int, ways: int):
    """Run B padded set-group sub-traces through the stack-distance scan.

    Inputs as ``cache_scan.cache_scan_groups``. Returns int32 distances
    capped at ``ways`` and bool eviction flags, ``(B, L)`` on the inputs'
    device: the CUDA kernel for CUDA tensors, ``stack_distance_plain`` for
    CPU tensors. A failed build or launch raises.
    """
    check_rows("stack_distance", sets, tags, valid)
    if sets.device.type == "cpu":
        return stack_distance_plain(sets, tags, valid, num_sets, ways)
    if num_sets < 1 or ways < 1 or num_sets * ways * 4 > _MAX_SHARED_BYTES:
        raise ValueError(
            f"stack_distance takes 1 <= num_sets, 1 <= ways and "
            f"num_sets * ways * 4 <= {_MAX_SHARED_BYTES} bytes; got "
            f"num_sets={num_sets}, ways={ways}"
        )
    B, L = sets.shape
    dist = torch.empty((B, L), dtype=torch.int32, device=sets.device)
    evict = torch.empty((B, L), dtype=torch.bool, device=sets.device)
    if B == 0 or L == 0:
        return dist, evict
    err = _launcher()(
        sets.data_ptr(), tags.data_ptr(), valid.data_ptr(), dist.data_ptr(),
        evict.data_ptr(), B, L, int(num_sets), int(ways),
        torch.cuda.current_stream(sets.device).cuda_stream,
    )
    check_launch("stack_distance", err)
    stack_distance_groups.launches += 1
    return dist, evict


stack_distance_groups.launches = 0
