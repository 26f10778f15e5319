"""K1: the set-associative cache-scan kernel and its plain torch version.

Replaces the Pallas kernel ``_cache_scan_kernel`` of
``repro/kernels/cache_scan.py`` (``HardwareConfig.cache_backend="pallas"``).
Each of the B rows of the ``(B, L)`` inputs is one padded set-group
sub-trace; a row walks its accesses in order against a ``(num_sets, ways)``
tag + metadata state (ChampSim LRU / SRRIP / FIFO) and reports per-access
hit and evict.

``cache_scan_groups`` launches the CUDA kernel (``csrc/cache_scan.cu``) for
CUDA tensors and runs ``cache_scan_plain`` for CPU tensors; there is no
other route. What bounds the kernel on the card and how its design answers
that is noted in the source: a row is L dependent state updates, so the
bound is latency, not bytes.

``cache_scan_plain`` is a torch loop over L vectorised over the B rows,
with the same first-match tie-breaks (lowest way index) and padding rules
as the kernel. It is also the ``"scan"`` backend of ``memory/cache.py``
(the reference's ``_simulate_many``), on whatever device the caller picked.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, check_rows, load_library

MAX_RRPV = 3  # 2-bit SRRIP

POLICY_IDS = {"lru": 0, "srrip": 1, "fifo": 2}
_MAX_SHARED_BYTES = 48 * 1024


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Mask selecting the first True along the last axis."""
    return mask & (torch.cumsum(mask.to(torch.int32), dim=-1) == 1)


def cache_scan_plain(sets, tags, valid, num_sets: int, ways: int, policy: str = "lru"):
    """Plain torch cache scan: ``(hit, evict)`` bool ``(B, L)`` tensors.

    ``t`` (the LRU/FIFO timestamp) is the access index, padding included.
    Padded accesses leave the state untouched and report a miss.
    """
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    B, L = sets.shape
    dev = sets.device
    state_tags = torch.full((B, num_sets, ways), -1, dtype=torch.int32, device=dev)
    meta0 = MAX_RRPV if policy == "srrip" else -1
    meta = torch.full((B, num_sets, ways), meta0, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    hits = torch.zeros((B, L), dtype=torch.bool, device=dev)
    evicts = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for i in range(L):
        s = sets[:, i].long()
        tag = tags[:, i].to(torch.int32)[:, None]
        v = valid[:, i]
        row_tags = state_tags[rows, s]
        row_meta = meta[rows, s]
        hit_vec = row_tags == tag
        hit = hit_vec.any(dim=1)
        hit_mask = _first_true(hit_vec)
        if policy == "srrip":
            inc = (MAX_RRPV - row_meta.amax(dim=1)).clamp_min(0)
            aged = row_meta + inc[:, None]
            victim_mask = _first_true(aged == MAX_RRPV)
            new_meta_hit = torch.where(hit_mask, 0, row_meta)
            new_meta_miss = torch.where(victim_mask, MAX_RRPV - 1, aged)
        else:
            # Invalid ways carry -1 < any timestamp, so the first minimum is
            # the first invalid way when one exists (ChampSim behaviour).
            masked = torch.where(row_tags < 0, -1, row_meta)
            victim_mask = _first_true(masked == masked.amin(dim=1, keepdim=True))
            if policy == "lru":
                new_meta_hit = torch.where(hit_mask, i, row_meta)
            else:  # fifo: hits do not touch metadata
                new_meta_hit = row_meta
            new_meta_miss = torch.where(victim_mask, i, row_meta)
        evict = v & ~hit & (victim_mask & (row_tags >= 0)).any(dim=1)
        hit_b = hit[:, None]
        new_meta = torch.where(hit_b, new_meta_hit, new_meta_miss)
        new_tags = torch.where(hit_b, row_tags, torch.where(victim_mask, tag, row_tags))
        upd = v[:, None]
        state_tags[rows, s] = torch.where(upd, new_tags, row_tags)
        meta[rows, s] = torch.where(upd, new_meta, row_meta).to(torch.int32)
        hits[:, i] = hit & v
        evicts[:, i] = evict
    return hits, evicts


def _launcher():
    fn = load_library("cache_scan").cache_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cache_scan_groups(sets, tags, valid, num_sets: int, ways: int, policy: str = "lru"):
    """Run B padded set-group sub-traces through the cache scan.

    ``sets``/``tags`` are int32 ``(B, L)``, ``valid`` bool ``(B, L)``, all on
    one device and contiguous. Returns ``(hit, evict)`` bool ``(B, L)`` on
    that device: the CUDA kernel for CUDA tensors, ``cache_scan_plain`` for
    CPU tensors. A failed build or launch raises.
    """
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    check_rows("cache_scan", sets, tags, valid)
    if sets.device.type == "cpu":
        return cache_scan_plain(sets, tags, valid, num_sets, ways, policy)
    shared = 2 * num_sets * ways * 4
    if num_sets < 1 or ways < 1 or shared > _MAX_SHARED_BYTES:
        raise ValueError(
            f"cache_scan takes 1 <= num_sets, 1 <= ways and "
            f"2 * num_sets * ways * 4 <= {_MAX_SHARED_BYTES} bytes; got "
            f"num_sets={num_sets}, ways={ways}"
        )
    B, L = sets.shape
    hit = torch.empty((B, L), dtype=torch.bool, device=sets.device)
    evict = torch.empty((B, L), dtype=torch.bool, device=sets.device)
    if B == 0 or L == 0:
        return hit, evict
    err = _launcher()(
        sets.data_ptr(), tags.data_ptr(), valid.data_ptr(), hit.data_ptr(),
        evict.data_ptr(), B, L, int(num_sets), int(ways), POLICY_IDS[policy],
        torch.cuda.current_stream(sets.device).cuda_stream,
    )
    check_launch("cache_scan", err)
    cache_scan_groups.launches += 1
    return hit, evict


cache_scan_groups.launches = 0
