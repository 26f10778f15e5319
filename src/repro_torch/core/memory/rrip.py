"""Analytic SRRIP/FIFO classification engines (compressed per-set state,
no full-trace sequential scan).

The Mattson stack-distance engine (``stack.py``) classifies LRU for every
associativity from one shared pass per (stream, num_sets), but SRRIP and
FIFO are not stack algorithms: their hit sets are not nested in ``ways``,
so no single distance number classifies all associativities. Sets are
independent under both policies, so instead of one O(n)-step scan over the
interleaved trace this module runs one *short* scan per set, batched across
every set of every config in the call:

* **shared presort** per (stream, num_sets): one stable sort into
  (set, time) order, run-compression of consecutive same-line accesses
  within a set (guaranteed hits: FIFO keeps only the first access of a
  run — FIFO hits never touch state; SRRIP keeps the first two — position
  1 refreshes the key, positions >= 2 are idempotent), and dense per-set
  segment ids. Every ways-variant of the same (stream, num_sets) reuses
  the pass, mirroring ``classify_lru_stack_many``; ``analytic_pass_count``
  exposes the counter so tests can assert sharing. The presort stays numpy
  on the host: its sort order is what makes the result bitwise.
* **vectorized flat packing**: per-set rows from *all* configs of the call
  are grouped by ways and scattered into one flat buffer (each row padded
  to a multiple of 16 steps) with a single vectorized pass per config — no
  per-row host loop. The buffer goes to the device once, each ways group is
  ONE call of the row scan D2 (``kernels/rrip_scan.py``: the CUDA kernels
  on the card, their plain torch versions on the CPU; one launch for short
  rows, two where a row is long enough for the chunked route), and the
  hits come back in one copy; rows from different configs share launches.
* **compressed per-set state**:
  - FIFO: a ring buffer of ``ways`` tags plus a head pointer. Fills land
    at the head in arrival order, so the head is always the oldest fill —
    exactly ChampSim's min-fill-timestamp victim (invalid ways fill in
    index order during warmup).
  - SRRIP: ``ways`` (tag, key) pairs plus a scalar age ``A`` with
    ``rrpv_w = A - key_w``. Hit: ``key = A``. Miss with an invalid way:
    fill ``key = A - 2`` (rrpv 2). Warm miss: ``m = min(keys)``, evict the
    *first* argmin way (ChampSim's first-rrpv-3-after-aging victim), set
    ``A = m + 3`` (the persistent aging increment) and fill ``key = m +
    1``. ``A`` grows at most 3 per miss, so int32 state is exact for any
    trace that passes the int32 line guard.

Evictions for both policies are ``sum_s max(0, misses_s - ways)``: ways
fill once and never go invalid again, so every warm miss evicts. Both
engines are bit-exact against the ChampSim-semantics golden model and the
sequential scan engine (``cache.py``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...kernels.rrip_scan import POLICY_IDS, RowTable, rrip_scan_flat
from ..profiling import is_active as _profiling_active, stage

__all__ = [
    "analytic_pass_count",
    "classify_analytic_many",
    "classify_fifo_many",
    "classify_srrip_many",
]

_GROUP = 16           # rows are padded to a multiple of the kernel's step group
_PAD_TAG = -2         # never matches a real tag (>=0) nor invalid (-1)
_DEPTH = {"fifo": 1, "srrip": 2}   # run prefix a policy must keep

_passes = 0


def analytic_pass_count() -> int:
    """Total shared presort passes computed (monotone; tests read deltas)."""
    return _passes


def _check_int32(lines: np.ndarray) -> np.ndarray:
    lines = np.ascontiguousarray(lines).astype(np.int64, copy=False)
    if lines.size and (lines.max() >= 2**31 or lines.min() < 0):
        raise ValueError("line numbers exceed int32 range; rebase the trace")
    return lines


class _Presort:
    """Shared per-(stream, num_sets, depth) compression of a stream into
    dense per-set segments of kept accesses."""

    __slots__ = ("kept_pos", "kept_tag", "sg", "ps", "seg_len", "n")

    def __init__(self, lines: np.ndarray, num_sets: int, depth: int):
        n = lines.size
        self.n = n
        if n == 0:
            z = np.zeros(0, np.int64)
            self.kept_pos, self.sg, self.ps = z, z, z
            self.kept_tag = z.astype(np.int32)
            self.seg_len = z
            return
        set_idx = lines % num_sets
        ord_set = np.argsort(set_idx, kind="stable")
        ss = set_idx[ord_set]
        lso = lines[ord_set]
        new_set = np.empty(n, bool)
        new_set[0] = True
        np.not_equal(ss[1:], ss[:-1], out=new_set[1:])
        new_run = new_set.copy()
        np.logical_or(new_run[1:], lso[1:] != lso[:-1], out=new_run[1:])
        idx = np.arange(n)
        run_start = np.maximum.accumulate(np.where(new_run, idx, 0))
        keep = (idx - run_start) < depth
        self.kept_pos = ord_set[keep]
        self.kept_tag = lso[keep].astype(np.int32)
        k_new_set = new_set[keep]
        k_idx = np.arange(self.kept_pos.size)
        self.sg = np.cumsum(k_new_set) - 1
        seg_base = np.maximum.accumulate(np.where(k_new_set, k_idx, 0))
        self.ps = k_idx - seg_base
        self.seg_len = np.bincount(self.sg)


def pack_rows(presorts: Sequence[_Presort], ways: Sequence[int]):
    """The flat buffer of several (presort, ways) configs and its launches.

    Every per-set segment of every config is one row, padded with invalid
    steps to a multiple of 16 (the kernel's group of steps); rows are
    grouped by ways, longest first within a group (a block of the kernel
    walks neighbouring rows), and laid out in that order. Returns
    ``(tags, valid, groups, elem_pos)``: the flat host arrays (int32 tags,
    ``_PAD_TAG`` in padding; bool valid), one ``(base, RowTable)`` per
    distinct ways (its rows are steps ``[base, base + table.total)``, one
    launch of D2, two on its chunked route), and per config the flat slot
    of each kept access.
    """
    seg_counts = [p.seg_len.size for p in presorts]
    row_base = np.cumsum([0] + seg_counts)
    n_rows = int(row_base[-1])
    if not n_rows:
        return (np.zeros(0, np.int32), np.zeros(0, bool), [],
                [np.zeros(0, np.int64) for _ in presorts])
    row_len = np.concatenate([p.seg_len for p in presorts])
    row_ways = np.repeat(np.asarray(ways, np.int64), seg_counts)
    row_pad = (row_len + _GROUP - 1) // _GROUP * _GROUP
    order = np.lexsort((-row_len, row_ways))
    pad_sorted = row_pad[order]
    off_sorted = np.cumsum(pad_sorted) - pad_sorted
    total = int(off_sorted[-1] + pad_sorted[-1])
    off_row = np.empty(n_rows, np.int64)
    off_row[order] = off_sorted
    tags_flat = np.full(total, _PAD_TAG, np.int32)
    valid_flat = np.zeros(total, bool)
    elem_pos: List[np.ndarray] = []
    for c, p in enumerate(presorts):
        pos = off_row[row_base[c] + p.sg] + p.ps
        tags_flat[pos] = p.kept_tag
        valid_flat[pos] = True
        elem_pos.append(pos)
    ways_sorted = row_ways[order]
    bnd = np.flatnonzero(np.concatenate(([True], ways_sorted[1:] != ways_sorted[:-1])))
    bnd = np.append(bnd, n_rows)
    groups = []
    for i0, i1 in zip(bnd[:-1], bnd[1:]):
        base = int(off_sorted[i0])
        groups.append((base, RowTable(off_sorted[i0:i1] - base, pad_sorted[i0:i1],
                                      int(ways_sorted[i0]))))
    return tags_flat, valid_flat, groups, elem_pos


def row_plan(lines: np.ndarray, num_sets: int, ways: int, policy: str):
    """What classifying ``lines`` under ``(num_sets, ways)`` gives D2:
    ``pack_rows``'s ``(tags, valid, groups)`` for that one config (one
    group)."""
    presort = _Presort(_check_int32(np.asarray(lines).reshape(-1)), int(num_sets),
                       _DEPTH[policy])
    return pack_rows([presort], [int(ways)])[:3]


def scan_rows(tags: np.ndarray, valid: np.ndarray, groups, policy: str,
              device: torch.device) -> np.ndarray:
    """D2 over ``pack_rows``'s flat buffer: the buffer and each group's row
    table go to ``device`` once, one call of the row scan per group, and
    the hits come back in one copy."""
    if not tags.size:
        return np.zeros(0, bool)
    tags_d = torch.from_numpy(tags).to(device)
    valid_d = torch.from_numpy(valid).to(device)
    hits_d = torch.empty(tags.size, dtype=torch.bool, device=device)
    for base, table in groups:
        sl = slice(base, base + table.total)
        rrip_scan_flat(tags_d[sl], valid_d[sl], table, policy, out=hits_d[sl])
    if _profiling_active() and device.type == "cuda":
        # Attribute async device compute to "cache_scan", not to the
        # extraction below (profiling sessions only).
        torch.cuda.synchronize(device)
    with stage("host_sync"):
        return hits_d.cpu().numpy()


def _stream_id(arr: np.ndarray) -> tuple:
    i = arr.__array_interface__
    return (i["data"][0], arr.shape, arr.dtype.str, i.get("strides"))


def _classify_many(
    streams: Sequence[np.ndarray],
    geometries: Sequence[Tuple[int, int]],
    policy: str,
    device: torch.device,
) -> List[Tuple[np.ndarray, int]]:
    global _passes
    depth = _DEPTH[policy]
    out: List = [None] * len(streams)

    # unique configs + shared presorts
    presorts: Dict[tuple, _Presort] = {}
    cfg_idx: Dict[tuple, int] = {}
    cfg_sid: List[tuple] = []
    cfg_ways: List[int] = []
    cfg_out: List[List[int]] = []
    with stage("stack_distance"):
        for i, (s, (num_sets, ways)) in enumerate(zip(streams, geometries)):
            lines = _check_int32(s)
            sid = (_stream_id(lines), int(num_sets))
            if sid not in presorts:
                presorts[sid] = _Presort(lines, int(num_sets), depth)
                _passes += 1
            c = cfg_idx.get((sid, int(ways)))
            if c is None:
                c = cfg_idx[(sid, int(ways))] = len(cfg_sid)
                cfg_sid.append(sid)
                cfg_ways.append(int(ways))
                cfg_out.append([])
            cfg_out[c].append(i)

    with stage("cache_scan"):
        tags, valid, groups, elem_pos = pack_rows(
            [presorts[sid] for sid in cfg_sid], cfg_ways)
        hits_flat = scan_rows(tags, valid, groups, policy, device)
        # per-config gather + eviction counts
        for c, sid in enumerate(cfg_sid):
            p = presorts[sid]
            ways = cfg_ways[c]
            if p.n == 0:
                res = (np.zeros(0, bool), 0)
            else:
                h_kept = hits_flat[elem_pos[c]]
                hits = np.ones(p.n, bool)   # dropped positions surely hit
                hits[p.kept_pos] = h_kept
                # misses only occur at kept positions; count per segment
                mc = np.bincount(
                    p.sg[~h_kept], minlength=p.seg_len.size or 1
                )
                ev = int(np.maximum(mc - ways, 0).sum())
                res = (hits, ev)
            for i in cfg_out[c]:
                out[i] = res
    return out


def classify_fifo_many(
    streams: Sequence[np.ndarray],
    geometries: Sequence[Tuple[int, int]],
    *,
    device: DeviceLike = "cuda",
) -> List[Tuple[np.ndarray, int]]:
    """FIFO-classify ``streams[i]`` under ``geometries[i] = (num_sets,
    ways)``; returns ``[(hits bool (n,), evictions int)]``."""
    return _classify_many(streams, geometries, "fifo", resolve_device(device))


def classify_srrip_many(
    streams: Sequence[np.ndarray],
    geometries: Sequence[Tuple[int, int]],
    *,
    device: DeviceLike = "cuda",
) -> List[Tuple[np.ndarray, int]]:
    """SRRIP-classify ``streams[i]`` under ``geometries[i]``; see
    ``classify_fifo_many``."""
    return _classify_many(streams, geometries, "srrip", resolve_device(device))


def classify_analytic_many(
    streams: Sequence[np.ndarray],
    geometries: Sequence[Tuple[int, int]],
    policy: str,
    *,
    device: DeviceLike = "cuda",
) -> List[Tuple[np.ndarray, int]]:
    """Dispatch to the policy-specific analytic engine."""
    if policy not in POLICY_IDS:
        raise ValueError(f"no analytic engine for policy {policy!r}")
    return _classify_many(streams, geometries, policy, resolve_device(device))
