"""Set-associative cache engine (the paper's cycle-level memory sim core).

The paper validates EONSim's on-chip cache model against ChampSim and reports
*identical* hit/miss counts under LRU and SRRIP (Fig. 4a). This engine keeps
that bar: every backend is bit-exact against a sequential model written to
ChampSim's replacement semantics (the reference package's ``GoldenCache``).

Structure (shared by the ``scan``, ``pallas`` and ``stack_pallas``
backends):

  1. **Set-group partitioning.** Accesses interact only within a cache set,
     so the set space is split into groups of ``_GROUP_SETS`` sets; each
     group's sub-trace is one row with a tiny state (group_sets x ways).
  2. **Length-bucketed padding.** Group sub-traces are padded to power-of-two
     lengths (floor ``_MIN_BUCKET = 64``) with masked no-op accesses, and
     every bucket of same (length, sets, ways) rows goes to the device as
     ONE ``(B, L)`` tensor each for sets, tags and validity.

Backends: ``"scan"`` runs ``cache_scan_plain``, K1's plain version: a torch
loop over L vectorised over the B rows, step for step the reference's
``lax.scan`` engine ``_simulate_many``. It is a backend the caller chooses,
never a stand-in for a kernel that failed. ``"pallas"`` runs the cache
scan kernel K1 (CUDA on the card, its plain version for CPU tensors).
Under ``"stack"`` (the default) and ``"stack_pallas"`` every policy
classifies without a full-trace sequential scan: LRU through the analytic
Mattson stack-distance pass (``memory/stack.py``; ``"stack_pallas"`` runs
the distance pass as the stack-distance kernel K2), srrip/fifo through the
compressed per-set engines (``memory/rrip.py``: a shared presort per
(stream, num_sets), then short per-set row scans on the kernel D2).

Replacement semantics (matching ChampSim):
  * LRU   — victim = first invalid way, else least-recently-used way.
  * SRRIP — 2-bit RRPV, init 3 (= maxRRPV, so invalid lines are immediate
            victims); hit -> RRPV=0; fill -> RRPV=maxRRPV-1; victim = first
            way with RRPV==maxRRPV, aging all ways up when none qualifies
            (the aging persists).
  * FIFO  — victim = first invalid way, else oldest fill.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ...kernels.cache_scan import MAX_RRPV, POLICY_IDS, cache_scan_groups, cache_scan_plain
from ...kernels.stack_distance import stack_distance_groups
from ..hardware import CACHE_BACKENDS
from ..profiling import is_active as _profiling_active, stage

__all__ = [
    "CACHE_BACKENDS", "MAX_RRPV", "CacheGeometry", "CacheResult",
    "classify_streams", "simulate_cache", "simulate_cache_many",
]

_GROUP_SETS = 16        # sets per scan group (state = 16 x ways ints x 2)
_MIN_BUCKET = 64        # smallest padded sub-trace length (<= ~2x padding)


@dataclass(frozen=True)
class CacheGeometry:
    num_sets: int
    ways: int
    line_bytes: int

    @property
    def capacity_bytes(self) -> int:
        return self.num_sets * self.ways * self.line_bytes

    @staticmethod
    def from_capacity(capacity_bytes: int, line_bytes: int, ways: int) -> "CacheGeometry":
        num_lines = capacity_bytes // line_bytes
        num_sets = max(1, num_lines // ways)
        return CacheGeometry(num_sets=num_sets, ways=ways, line_bytes=line_bytes)


@dataclass
class CacheResult:
    hits: np.ndarray          # bool (N,) per-access hit flag
    num_hits: int
    num_misses: int
    num_evictions: int

    @property
    def accesses(self) -> int:
        return self.num_hits + self.num_misses

    @property
    def hit_rate(self) -> float:
        return self.num_hits / max(self.accesses, 1)


def _bucket_len(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def _validate(policy: str, backend: str) -> None:
    if policy not in POLICY_IDS:
        raise ValueError(f"unknown policy {policy!r}; options: {sorted(POLICY_IDS)}")
    if backend not in CACHE_BACKENDS:
        raise ValueError(
            f"unknown cache backend {backend!r}; options: {CACHE_BACKENDS}"
        )


def _effective_backend(policy: str, backend: str) -> str:
    """Resolve the stack variants per policy: only the LRU distance pass has
    a kernel variant, so ``"stack_pallas"`` resolves to ``"stack"`` for
    srrip/fifo."""
    if backend == "stack_pallas" and policy != "lru":
        return "stack"
    return backend


def simulate_cache(
    lines: np.ndarray,
    geometry: CacheGeometry,
    policy: str = "lru",
    backend: str = "scan",
    *,
    device: DeviceLike = "cuda",
) -> CacheResult:
    """Run the trace through the cache; returns per-access hits + counts."""
    return simulate_cache_many(
        [lines], [geometry], policy, backend=backend, device=device
    )[0]


def _build_tasks(lines_list, geometries):
    """Set-group scan tasks for independent (trace, geometry) pairs.

    Each task is ``(cfg, idx-or-None, local_sets, tags, n_sets_g, ways)`` —
    one sub-trace confined to a group of ``_GROUP_SETS`` sets.
    """
    tasks = []
    for cfg, (lines_np, geom) in enumerate(zip(lines_list, geometries)):
        n = lines_np.size
        if n == 0:
            continue
        if int(lines_np.max()) >= np.iinfo(np.int32).max:
            raise ValueError("line numbers exceed int32 range; rebase the trace")
        S, W = geom.num_sets, geom.ways
        set_idx = (lines_np % S).astype(np.int32)
        tag = lines_np.astype(np.int32)
        if S <= _GROUP_SETS:
            tasks.append((cfg, None, set_idx, tag, S, W))
        else:
            group = set_idx // _GROUP_SETS
            order = np.argsort(group, kind="stable")
            g_sorted = group[order]
            bounds = np.searchsorted(g_sorted, np.arange(group.max() + 2))
            for g in range(int(group.max()) + 1):
                lo, hi = bounds[g], bounds[g + 1]
                if lo == hi:
                    continue
                idx = order[lo:hi]
                n_sets_g = min(_GROUP_SETS, S - g * _GROUP_SETS)
                tasks.append(
                    (cfg, idx, set_idx[idx] - g * _GROUP_SETS, tag[idx], n_sets_g, W)
                )
    return tasks


def bucket_rows(lines_list, geometries):
    """Set-group tasks bucketed by padded (length, sets, ways) shape.

    Yields ``(tasks, sets, tags, valid, num_sets, ways)`` per bucket: the
    bucket's tasks and its ``(B, L)`` host arrays (int32, int32, bool), the
    exact rows one backend launch receives.
    """
    tasks = _build_tasks(lines_list, geometries)
    buckets: "dict[tuple, list]" = {}
    for t in tasks:
        m = t[2].size
        buckets.setdefault((_bucket_len(m), t[4], t[5]), []).append(t)
    for (L, S_g, W), ts in buckets.items():
        B = len(ts)
        s_b = np.zeros((B, L), dtype=np.int32)
        t_b = np.full((B, L), -2, dtype=np.int32)
        v_b = np.zeros((B, L), dtype=bool)
        for row, (_, _, s_loc, tags, _, _) in enumerate(ts):
            m = s_loc.size
            s_b[row, :m] = s_loc
            t_b[row, :m] = tags
            v_b[row, :m] = True
        yield ts, s_b, t_b, v_b, S_g, W


def _run_buckets(lines_list, geometries, policy: str, backend: str,
                 device: torch.device):
    """Run each shape bucket as ONE ``(B, L)`` launch of the selected
    backend on ``device``.

    Returns ``(tasks, hits, evicts)`` per bucket with hits/evicts still
    device-resident ``(B, L)`` tensors — callers decide when to sync.
    ``backend`` must already be resolved (scan | pallas | stack_pallas).
    """
    out = []
    for ts, s_b, t_b, v_b, S_g, W in bucket_rows(lines_list, geometries):
        with stage("cache_scan"):
            s_d = torch.from_numpy(s_b).to(device)
            t_d = torch.from_numpy(t_b).to(device)
            v_d = torch.from_numpy(v_b).to(device)
            if backend == "pallas":
                h, e = cache_scan_groups(s_d, t_d, v_d, S_g, W, policy)
            elif backend == "stack_pallas":
                d, e = stack_distance_groups(s_d, t_d, v_d, S_g, W)
                h = d < W
            else:
                h, e = cache_scan_plain(s_d, t_d, v_d, S_g, W, policy)
            if _profiling_active() and device.type == "cuda":
                # Attribute async device compute to "cache_scan", not to the
                # extraction in the caller (profiling sessions only).
                torch.cuda.synchronize(device)
        out.append((ts, h, e))
    return out


def _classify_analytic(lines_list, geometries, policy, device):
    """(hits, evictions) pairs from the policy's analytic engine: Mattson
    stack distances for LRU, compressed per-set engines for srrip/fifo."""
    if policy == "lru":
        from .stack import classify_lru_stack_many

        return classify_lru_stack_many(lines_list, geometries, device)
    from .rrip import classify_analytic_many

    return classify_analytic_many(
        lines_list, [(g.num_sets, g.ways) for g in geometries], policy, device=device
    )


def simulate_cache_many(
    streams: "list[np.ndarray]",
    geometries: "list[CacheGeometry]",
    policy: str = "lru",
    backend: str = "scan",
    *,
    device: DeviceLike = "cuda",
) -> "list[CacheResult]":
    """Run several independent (trace, geometry) pairs under one policy.

    Semantically identical to ``[simulate_cache(s, g, policy) ...]``, but
    every set-group sub-scan across ALL pairs is bucketed by its padded
    (length, sets, ways) shape and each bucket runs as ONE launch.
    """
    _validate(policy, backend)
    dev = resolve_device(device)
    lines_list = [np.asarray(s, dtype=np.int64).reshape(-1) for s in streams]
    if len(lines_list) != len(geometries):
        raise ValueError("streams and geometries length mismatch")
    backend = _effective_backend(policy, backend)
    if backend == "stack":
        pairs = _classify_analytic(lines_list, geometries, policy, dev)
        return [
            CacheResult(
                hits=h,
                num_hits=int(h.sum()),
                num_misses=h.size - int(h.sum()),
                num_evictions=ev,
            )
            for h, ev in pairs
        ]

    hits_out = [np.zeros(l.size, dtype=bool) for l in lines_list]
    evict_out = [0] * len(lines_list)

    for ts, h_d, e_d in _run_buckets(lines_list, geometries, policy, backend, dev):
        with stage("host_sync"):
            h = h_d.cpu().numpy()
            e = e_d.cpu().numpy()
        for row, (cfg, idx, s_loc, _, _, _) in enumerate(ts):
            m = s_loc.size
            if idx is None:
                hits_out[cfg] = h[row, :m].copy()
            else:
                hits_out[cfg][idx] = h[row, :m]
            evict_out[cfg] += int(e[row].sum())  # padded slots never evict

    return [
        CacheResult(
            hits=hits,
            num_hits=int(hits.sum()),
            num_misses=hits.size - int(hits.sum()),
            num_evictions=ev,
        )
        for hits, ev in zip(hits_out, evict_out)
    ]


def classify_streams(
    streams: "list[np.ndarray]",
    geometries: "list[CacheGeometry]",
    policy: str = "lru",
    backend: str = "scan",
    *,
    device: DeviceLike = "cuda",
) -> "list[np.ndarray]":
    """Per-access hit arrays for several (trace, geometry) pairs.

    The classification-only surface the MemorySystem hot path consumes: the
    same bucketed launches as ``simulate_cache_many``, but skips eviction
    accounting and performs exactly ONE blocking device->host extraction per
    bucket.
    """
    _validate(policy, backend)
    dev = resolve_device(device)
    lines_list = [np.asarray(s, dtype=np.int64).reshape(-1) for s in streams]
    if len(lines_list) != len(geometries):
        raise ValueError("streams and geometries length mismatch")
    backend = _effective_backend(policy, backend)
    if backend == "stack":
        return [h for h, _ in _classify_analytic(lines_list, geometries, policy, dev)]
    hits_out = [np.zeros(l.size, dtype=bool) for l in lines_list]
    for ts, h_d, _ in _run_buckets(lines_list, geometries, policy, backend, dev):
        with stage("host_sync"):
            h = h_d.cpu().numpy()
        for row, (cfg, idx, s_loc, _, _, _) in enumerate(ts):
            m = s_loc.size
            if idx is None:
                hits_out[cfg] = h[row, :m].copy()
            else:
                hits_out[cfg][idx] = h[row, :m]
    return hits_out
