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
kernel's bound (the latency of the longest set's dependent updates, not
bytes) and its design are noted in the source: K1's walk, a team of lanes
per set, with the list held as each way's tag and rank (its position).
``stack_distance_by_set_plain`` is that decomposition in torch, which the
CPU tests hold equal to ``stack_distance_plain`` and the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_rows, count_launch, load_library, on_device
from .cache_scan import MAX_THREADS, MAX_WAYS, set_sequences, team_lanes


def stack_distance_plain(sets, tags, valid, num_sets: int, ways: int):
    """Plain torch recency-list scan: ``(dist int32, evict bool)``, ``(B, L)``.

    An access to a set outside ``[0, num_sets)`` is padding, as in the
    kernel."""
    B, L = sets.shape
    dev = sets.device
    lists = torch.full((B, num_sets, ways), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    way_idx = torch.arange(ways, dtype=torch.int32, device=dev)[None, :]
    dist = torch.full((B, L), ways, dtype=torch.int32, device=dev)
    evicts = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for i in range(L):
        s = sets[:, i].long()
        in_range = (s >= 0) & (s < num_sets)
        s = torch.where(in_range, s, 0)
        tag = tags[:, i].to(torch.int32)[:, None]
        v = valid[:, i] & in_range
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


def stack_distance_by_set_plain(sets, tags, valid, num_sets: int, ways: int):
    """``stack_distance_plain`` computed as the kernel's teams compute it.

    Each row is split into its per-set sub-sequences (``set_sequences``),
    and every (row, set) sequence walks one recency list alone, held as a
    permutation: each way has a tag and a rank (its position; initially
    rank = way, tag -1). Per access the distance is the sum of the ranks
    whose tag matches (the reference sums positions), or ``ways`` if none
    does; with ``limit`` = the distance on a hit, at most ``ways - 1``,
    ``ways - 1`` on a miss, the way at rank ``limit`` takes rank 0 and the
    tag (evicting, on a miss, a tag >= 0) and ranks below ``limit`` move one
    down. Returns ``(dist int32, evict bool)`` ``(B, L)``, equal to
    ``stack_distance_plain``'s.
    """
    B, L = sets.shape
    dev = sets.device
    seq = set_sequences(sets, valid, num_sets)
    n_teams = seq.shape[0]
    flat_tags = tags.reshape(-1).to(torch.int32)
    state_tags = torch.full((n_teams, ways), -1, dtype=torch.int32, device=dev)
    rank = torch.arange(ways, dtype=torch.int32, device=dev).repeat(n_teams, 1)
    dist = torch.full((B * L,), ways, dtype=torch.int32, device=dev)
    evicts = torch.zeros(B * L, dtype=torch.bool, device=dev)
    for j in range(seq.shape[1]):
        at = seq[:, j]
        live = at >= 0
        idx = at.clamp_min(0)
        match = state_tags == flat_tags[idx][:, None]
        found = match.any(dim=1)
        d = torch.where(found, torch.where(match, rank, 0).sum(dim=1, dtype=torch.int32), ways)
        limit = d.clamp_max(ways - 1)[:, None]
        top = rank == limit
        evict = live & ~found & (top & (state_tags >= 0)).any(dim=1)
        upd = live[:, None]
        state_tags = torch.where(upd & top, flat_tags[idx][:, None], state_tags)
        rank = torch.where(upd, torch.where(top, 0, torch.where(rank < limit, rank + 1, rank)),
                           rank)
        dist[idx[live]] = d[live]
        evicts[idx[live]] = evict[live]
    return dist.reshape(B, L), evicts.reshape(B, L)


def _launcher():
    fn = load_library("stack_distance").stack_distance_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(L: int, num_sets: int, ways: int) -> int:
    """Blocks (rows) of one launch of this shape resident on one SM of the
    current card."""
    fn = load_library("stack_distance").stack_distance_occupancy
    blocks = ctypes.c_int(0)
    check_launch("stack_distance (occupancy)", fn(
        ctypes.c_int(L), ctypes.c_int(num_sets), ctypes.c_int(ways), ctypes.byref(blocks)))
    return blocks.value


def stack_distance_groups(sets, tags, valid, num_sets: int, ways: int):
    """Run B padded set-group sub-traces through the stack-distance scan.

    Inputs as ``cache_scan.cache_scan_groups``. Returns int32 distances
    capped at ``ways`` and bool eviction flags, ``(B, L)`` on the inputs'
    device: the CUDA kernel for CUDA tensors, ``stack_distance_plain`` for
    CPU tensors. The kernel takes ``1 <= ways <= MAX_WAYS`` and ``num_sets x
    team_lanes(ways) <= MAX_THREADS`` (K1's teams); a CUDA call outside
    them, or a failed build or launch, raises.
    """
    check_rows("stack_distance", sets, tags, valid)
    if sets.device.type == "cpu":
        return stack_distance_plain(sets, tags, valid, num_sets, ways)
    if not (num_sets >= 1 and 1 <= ways <= MAX_WAYS
            and num_sets * team_lanes(ways) <= MAX_THREADS):
        raise ValueError(
            f"stack_distance takes 1 <= ways <= {MAX_WAYS} and num_sets x team <= "
            f"{MAX_THREADS} threads (team = ways rounded up to a power of two, at most "
            f"32); got num_sets={num_sets}, ways={ways}"
        )
    B, L = sets.shape
    dist = torch.empty((B, L), dtype=torch.int32, device=sets.device)
    evict = torch.empty((B, L), dtype=torch.bool, device=sets.device)
    if B == 0 or L == 0:
        return dist, evict
    with on_device(sets.device):
        err = _launcher()(
            sets.data_ptr(), tags.data_ptr(), valid.data_ptr(), dist.data_ptr(),
            evict.data_ptr(), B, L, int(num_sets), int(ways),
            torch.cuda.current_stream(sets.device).cuda_stream,
        )
    check_launch("stack_distance", err)
    count_launch(stack_distance_groups)
    return dist, evict


stack_distance_groups.launches = 0
