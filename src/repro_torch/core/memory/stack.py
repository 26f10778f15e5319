"""Analytic LRU stack-distance engine (Mattson classification, no scan).

LRU is a *stack algorithm*: at any point the cache set holds exactly the
``ways`` most recently used distinct lines mapping to it. An access therefore
hits a W-way LRU cache iff its **stack distance** — the number of distinct
same-set lines touched since the previous access to the same line — is
``< W``. One distance computation over a trace classifies the access for
EVERY associativity at once (Mattson's inclusion property), which is exactly
the amortization a DSE grid sweeping the ways axis wants: the distance pass
depends only on ``(stream, num_sets)``, never on ``ways``.

The pass itself is *analytic* — a handful of argsorts and prefix sums, no
sequential scan over the trace:

  1. ``prev[i]``: previous access to the same line (one stable argsort by
     (line, time); shared across every geometry of a stream).
  2. ``win[i]``: same-set accesses strictly inside ``(prev[i], i)`` from the
     per-set access rank (one stable argsort by (set, time)).
  3. ``T[i] = #{k < i, same set : prev[k] > prev[i]}`` — the accesses inside
     the window whose own previous access is ALSO inside it (duplicates).
     Then ``distance = win - T``. ``T`` is a segmented per-element inversion
     count of the ``prev`` sequence, computed with a two-level radix
     decomposition over the *rank of last access* (the lexicographic
     (set, prev) rank): a cross-bucket histogram + suffix prefix-sum plus two
     small block-local masked compare-reductions — all O(N * block) work in
     fully vectorized form.

Evictions are analytic too: LRU never invalidates, so a miss evicts iff the
set already holds ``ways`` distinct lines, i.e. iff the number of distinct
same-set lines seen before the access is ``>= ways``.

Two executions of the same math, bit-exact with each other:

  * ``stack_distances_np``    — numpy host twin; the CPU path.
  * ``stack_distances_torch`` — the same pass in torch on the card (sorts
    and prefix sums on the device; padded to a bucketed length).

The recency-list kernel (``kernels/stack_distance.py``) computes the same
capped distances by a sequential scan for ``cache_backend="stack_pallas"``.

``classify_lru_stack_many`` is the entry the cache engine routes
``cache_backend="stack"`` through: it memoizes distance passes by
``(stream, num_sets)`` within the call, so all same-``num_sets`` geometries
classify from ONE shared distance computation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..profiling import is_active as _profiling_active, stage

# Cold (first-ever) accesses get this sentinel distance: larger than any real
# associativity, so they miss for every ways value.
DIST_COLD = np.int32(2**30)

_BS = 128          # minimum radix block size for the inversion count (pow2)
_BIG_I32 = np.int32(np.iinfo(np.int32).max)


def _block_size(n: int) -> int:
    """Radix block size for an n-element inversion count.

    Grows as a power of two >= sqrt(n)/2 (floor ``_BS``) so the cross-bucket
    (chunk, bucket) histogram stays O(n) elements — with a FIXED block the
    table is O((n/bs)^2), which would make million-access traces allocate
    hundreds of MB. Block-local compare work is O(n * bs); at the default
    sweep scales (n ~ 5e4) this resolves to the measured-fastest bs=128.
    """
    b = _BS
    while b * b * 4 < n:
        b *= 2
    return b

# --------------------------------------------------------------------------
# numpy twin (the CPU path)
# --------------------------------------------------------------------------

def _inv_prev_larger_np(rk: np.ndarray, bs: Optional[int] = None) -> np.ndarray:
    """cnt[i] = #{k < i : rk[k] > rk[i]} for a permutation ``rk`` of [0, N).

    Two-level radix decomposition: bucket ranks into blocks of ``bs``; count
    cross-bucket pairs with a chunked histogram + suffix prefix sums, and
    same-bucket / same-chunk pairs with block-local masked compare-reductions
    (each O(N * bs) fully vectorized work; the histogram is O(N) elements by
    the ``_block_size`` scaling).
    """
    N = rk.size
    if N == 0:
        return np.zeros(0, dtype=np.int32)
    if bs is None:
        bs = _block_size(N)
    G = -(-N // bs)
    N_pad = G * bs
    # Padding ranks N..N_pad-1 sit at the END of the time axis: never
    # "previous" to a real element, so they contribute to no count.
    rk_p = np.concatenate([rk, np.arange(N, N_pad, dtype=np.int32)])
    g = rk_p >> int(np.log2(bs))

    # Same value-bucket, earlier time, larger rank.
    ordg = np.argsort(g, kind="stable")            # (bucket, time) order
    V = rk_p[ordg].reshape(G, bs)
    tri = np.arange(bs)[:, None] < np.arange(bs)[None, :]
    cnt = np.zeros(N_pad, dtype=np.int32)
    cnt[ordg] = _prev_larger_in_blocks_np(V, tri).reshape(-1)

    # Strictly higher bucket, earlier time: full earlier chunks via a
    # (chunk, bucket) histogram, the residual chunk via a local compare.
    NC = N_pad // bs
    rowflat = np.repeat(np.arange(NC, dtype=np.int64), bs) * G + g
    hist = np.bincount(rowflat, minlength=NC * G).reshape(NC, G)
    before = np.cumsum(hist, axis=0) - hist
    suf = before[:, ::-1].cumsum(axis=1)[:, ::-1] - before
    cnt += suf.reshape(-1)[rowflat].astype(np.int32)
    Gt = g.reshape(NC, bs)
    cnt += _prev_larger_in_blocks_np(Gt, tri).reshape(-1)
    return cnt[:N]


# Peak transient elements of one block-compare slab (16M bools = 16 MB):
# caps the (slab, bs, bs) boolean tensors regardless of trace length.
_SLAB_ELEMS = 1 << 24


def _prev_larger_in_blocks_np(V: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Per row of ``V``: count, for each position b, earlier positions a < b
    with V[a] > V[b] — processed in row slabs so the (slab, bs, bs) boolean
    intermediates stay bounded (identical results to one full broadcast)."""
    G, bs = V.shape
    out = np.empty((G, bs), dtype=np.int32)
    slab = max(1, _SLAB_ELEMS // (bs * bs))
    for lo in range(0, G, slab):
        W = V[lo:lo + slab]
        out[lo:lo + slab] = ((W[:, :, None] > W[:, None, :]) & tri).sum(
            axis=1, dtype=np.int32
        )
    return out


def stack_distances_np(
    lines: np.ndarray, num_sets: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact per-access LRU stack distance + distinct-lines-seen-before count.

    Returns ``(dist, distinct_before)``; cold accesses report ``DIST_COLD``.
    ``dist[i] < ways``  <=>  the access hits a (num_sets, ways) LRU cache.
    """
    lines = np.ascontiguousarray(lines).reshape(-1)
    N = lines.size
    if N == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy()
    idx = np.arange(N, dtype=np.int32)
    set_idx = (lines % num_sets).astype(np.int32)

    order = np.argsort(lines, kind="stable")       # (line, time) order
    ls = lines[order]
    same = np.zeros(N, dtype=bool)
    same[1:] = ls[1:] == ls[:-1]
    tmp = np.full(N, -1, dtype=np.int32)
    tmp[1:][same[1:]] = order[:-1][same[1:]].astype(np.int32)
    prev = np.empty(N, dtype=np.int32)
    prev[order] = tmp

    order2 = np.argsort(set_idx, kind="stable")    # (set, time) order
    ss = set_idx[order2]
    start = np.ones(N, dtype=bool)
    start[1:] = ss[1:] != ss[:-1]
    grp = np.maximum.accumulate(np.where(start, idx, 0))
    r = np.empty(N, dtype=np.int32)
    r[order2] = idx - grp

    valid = prev >= 0
    win = np.where(valid, r - r[np.maximum(prev, 0)] - 1, 0)

    # Lexicographic (set, prev) rank — the "rank of last access" — via two
    # stable argsorts; counting inversions in the (set, time) layout keeps
    # smaller-set elements below the composite order (never counted) and
    # compares same-set elements on prev: one pass segments by set for free.
    o1 = np.argsort(prev, kind="stable")
    p = o1[np.argsort(set_idx[o1], kind="stable")]
    rk = np.empty(N, dtype=np.int32)
    rk[p] = idx
    T = np.empty(N, dtype=np.int32)
    T[order2] = _inv_prev_larger_np(rk[order2])
    dist = np.where(valid, (win - T).astype(np.int32), DIST_COLD)

    firsts = (~valid)[order2].astype(np.int32)
    cs = np.cumsum(firsts, dtype=np.int64)
    seg_base = np.maximum.accumulate(np.where(start, cs - firsts, 0))
    distinct_before = np.empty(N, dtype=np.int32)
    distinct_before[order2] = cs - firsts - seg_base
    return dist, distinct_before



# --------------------------------------------------------------------------
# torch pass (device-resident; the numpy twin is the test-enforced golden)
# --------------------------------------------------------------------------

def _prev_larger_in_blocks_torch(V: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """torch twin of ``_prev_larger_in_blocks_np`` (same slab bound)."""
    G, bs = V.shape
    slab = max(1, _SLAB_ELEMS // (bs * bs))
    return torch.cat([
        ((V[lo:lo + slab, :, None] > V[lo:lo + slab, None, :]) & tri).sum(
            dim=1, dtype=torch.int32)
        for lo in range(0, G, slab)
    ])


def _inv_prev_larger_torch(rk: torch.Tensor, bs: int) -> torch.Tensor:
    N = rk.shape[0]
    dev = rk.device
    G = N // bs
    g = rk // bs
    ordg = torch.argsort(g, stable=True)           # (bucket, time)
    V = rk[ordg].reshape(G, bs)
    ar = torch.arange(bs, device=dev)
    tri = ar[:, None] < ar[None, :]
    cnt = torch.zeros(N, dtype=torch.int32, device=dev)
    cnt[ordg] = _prev_larger_in_blocks_torch(V, tri).reshape(-1)
    NC = N // bs
    rowflat = (torch.arange(NC, dtype=torch.int64, device=dev).repeat_interleave(bs)
               * G + g.long())
    hist = torch.bincount(rowflat, minlength=NC * G).reshape(NC, G)
    before = hist.cumsum(dim=0) - hist
    suf = before.flip(1).cumsum(dim=1).flip(1) - before
    cnt = cnt + suf.reshape(-1)[rowflat].to(torch.int32)
    Gt = g.reshape(NC, bs)
    return cnt + _prev_larger_in_blocks_torch(Gt, tri).reshape(-1)


def _stack_pass_torch(lines: torch.Tensor, num_sets: int, n_real: int, bs: int):
    """Padded device pass over int32 ``lines`` (the first ``n_real`` real)."""
    N = lines.shape[0]
    dev = lines.device
    i32 = torch.int32
    idx = torch.arange(N, dtype=i32, device=dev)
    real = idx < n_real
    set_idx = torch.where(real, lines % num_sets, num_sets).to(i32)

    order = torch.argsort(torch.where(real, lines, int(_BIG_I32)), stable=True)
    ls = lines[order]
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                      (ls[1:] == ls[:-1]) & real[order][1:]])
    prev_sorted = torch.where(
        same, torch.cat([torch.zeros(1, dtype=i32, device=dev), order[:-1].to(i32)]), -1)
    prev = torch.empty(N, dtype=i32, device=dev)
    prev[order] = prev_sorted

    order2 = torch.argsort(set_idx, stable=True)     # (set, time)
    ss = set_idx[order2]
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ss[1:] != ss[:-1]])
    grp = torch.cummax(torch.where(start, idx, 0), dim=0).values
    r = torch.empty(N, dtype=i32, device=dev)
    r[order2] = idx - grp

    valid = prev >= 0
    win = torch.where(valid, r - r[prev.clamp_min(0).long()] - 1, 0)

    o1 = torch.argsort(prev, stable=True)
    p = o1[torch.argsort(set_idx[o1], stable=True)]
    rk = torch.empty(N, dtype=i32, device=dev)
    rk[p] = idx
    T = torch.empty(N, dtype=i32, device=dev)
    T[order2] = _inv_prev_larger_torch(rk[order2], bs)
    dist = torch.where(valid, win - T, int(DIST_COLD)).to(i32)

    firsts = (~valid & real)[order2].to(i32)
    cs = torch.cumsum(firsts, dim=0, dtype=i32)
    seg_base = torch.cummax(torch.where(start, cs - firsts, 0), dim=0).values
    distinct_before = torch.empty(N, dtype=i32, device=dev)
    distinct_before[order2] = cs - firsts - seg_base
    return dist, distinct_before


def _pad_len(n: int) -> int:
    """Power-of-two length bucketing, as in cache.py."""
    b = _BS
    while b < n:
        b *= 2
    return b


def stack_distances_torch(
    lines: np.ndarray, num_sets: int, device: torch.device
) -> Tuple[np.ndarray, np.ndarray]:
    """``stack_distances_np`` computed by the torch pass on ``device``."""
    lines = np.ascontiguousarray(lines).reshape(-1)
    n = lines.size
    if n == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy()
    if lines.dtype != np.int32 and int(lines.max()) >= int(_BIG_I32):
        # The device pass is int32; silently wrapping here would diverge
        # from the int64-capable numpy twin.
        raise ValueError("line numbers exceed int32 range; rebase the trace")
    N = _pad_len(n)
    lp = np.zeros(N, dtype=np.int32)
    lp[:n] = lines
    d, db = _stack_pass_torch(
        torch.from_numpy(lp).to(device), int(num_sets), n, _block_size(N)
    )
    if _profiling_active() and device.type == "cuda":
        torch.cuda.synchronize(device)
    with stage("host_sync"):
        return d[:n].cpu().numpy(), db[:n].cpu().numpy()


# --------------------------------------------------------------------------
# Classification entry point (what cache_backend="stack" routes through)
# --------------------------------------------------------------------------

_distance_passes = 0


def distance_pass_count() -> int:
    """Total distance passes computed (monotone; tests read deltas)."""
    return _distance_passes


def stack_distances(
    lines: np.ndarray, num_sets: int, device: torch.device
) -> Tuple[np.ndarray, np.ndarray]:
    """The torch pass on the card, the numpy twin on the CPU (equal results)."""
    global _distance_passes
    _distance_passes += 1
    if device.type == "cuda":
        return stack_distances_torch(lines, num_sets, device)
    return stack_distances_np(lines, num_sets)


def classify_lru_stack_many(
    streams: Sequence[np.ndarray],
    geometries: Sequence,                      # Sequence[CacheGeometry]
    device: torch.device,
) -> List[Tuple[np.ndarray, int]]:
    """Per-access LRU hits + eviction count for several (trace, geometry)
    pairs from shared stack-distance passes.

    The distance pass depends only on ``(stream, num_sets)`` — every ways
    value (and every geometry that degenerates to the same num_sets)
    classifies from one memoized computation. Bit-exact with the scan
    engine / ``GoldenCache``.
    """
    # Memoize by the stream's underlying buffer + num_sets; ``streams``
    # keeps the keyed arrays alive for the whole call, so pointers are stable.
    as_i32: Dict[tuple, np.ndarray] = {}
    memo: Dict[Tuple[tuple, int], Tuple[np.ndarray, np.ndarray]] = {}
    out: List[Tuple[np.ndarray, int]] = []
    for stream, geom in zip(streams, geometries):
        arr = np.asarray(stream)
        # Strides are part of the key: two views can share (pointer, size,
        # dtype) yet read different elements (e.g. a[:500] vs a[::2]).
        sid = (arr.__array_interface__["data"][0], arr.shape, arr.dtype.str,
               arr.strides)
        lines32 = as_i32.get(sid)
        if lines32 is None:
            lines64 = np.asarray(arr, dtype=np.int64).reshape(-1)
            if lines64.size and int(lines64.max()) >= int(_BIG_I32):
                raise ValueError(
                    "line numbers exceed int32 range; rebase the trace"
                )
            lines32 = lines64.astype(np.int32)
            as_i32[sid] = lines32
        key = (sid, geom.num_sets)
        dist_pass = memo.get(key)
        if dist_pass is None:
            with stage("stack_distance"):
                dist_pass = stack_distances(lines32, geom.num_sets, device)
            memo[key] = dist_pass
        dist, distinct_before = dist_pass
        hits = dist < np.int32(min(geom.ways, int(DIST_COLD) - 1))
        evictions = int(((~hits) & (distinct_before >= geom.ways)).sum())
        out.append((hits, evictions))
    return out
