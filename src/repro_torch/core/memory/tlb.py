"""NeuMMU-style address-translation engine (TLB hierarchy + page walks).

Embedding gathers are the pathological case for NPU address translation
(PAPERS.md, arXiv:1911.06859 "NeuMMU"): irregular, data-dependent accesses
whose page working set routinely exceeds any affordable TLB reach. This
module models a central MMU at the memory-controller side of the hierarchy:
the *off-chip miss stream* — every line the on-chip policy could not serve —
is translated virtual->physical through a set-associative L1 TLB, optionally
backed by a unified L2 TLB; L1 misses pay the L2 lookup latency, L2 misses
pay a full page-table walk. On-chip hits never translate (the on-chip memory
is virtually indexed at the simulator's level of abstraction), which is what
lets translation sit *between* row classification and DRAM request
construction as a pure trace transform in the ``trace.PlacementMap`` mold:

  * it observes the VIRTUAL miss-line stream, before ``PlacementMap``
    relocates lines — translation is therefore placement-invariant, and one
    charge is shared across every placement sibling of a sweep memo group;
  * it never adds, drops, or reorders DRAM requests — it only charges stall
    cycles alongside them — so every cache backend, placement policy,
    cluster topology, and the serving scheduler compose with it untouched;
  * ``translation=None`` skips this module entirely and is the exact
    pre-translation engine (differential-enforced).

Classification reuses the analytic cache machinery: LRU TLBs classify
through shared Mattson stack-distance passes (``memory/stack.py``, numpy
numpy twin on the CPU, torch pass on the card; one pass per (page stream,
num_sets) covers every associativity), FIFO TLBs through the compressed
per-set engine (``memory/rrip.py``, whose row scans run on the kernel D2).
``golden_tlb_hits`` is the sequential reference both are test-pinned
against (ChampSim-matching replacement semantics, the same bar the on-chip
cache engine meets).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ...device import DeviceLike, resolve_device
from ..hardware import TranslationConfig
from ..profiling import stage
from .rrip import classify_fifo_many
from .stack import DIST_COLD, stack_distances

__all__ = [
    "TranslationCharge",
    "charge_cache_lookup",
    "charge_translation",
    "classify_tlb",
    "golden_tlb_hits",
    "tlb_pages",
    "translation_saturated",
]

_BIG_I32 = np.int32(np.iinfo(np.int32).max)


def tlb_pages(
    lines: np.ndarray, line_bytes: int, page_bytes: int
) -> np.ndarray:
    """int64 page number per line access (the TLB's reference stream).

    A line's translation is keyed by its base address's page; ``page_bytes``
    must cover a whole line so each line access is exactly one translation
    (validated here rather than in ``TranslationConfig`` because
    ``line_bytes`` is an on-chip parameter the config cannot see).
    """
    if page_bytes < line_bytes:
        raise ValueError(
            f"page_bytes ({page_bytes}) must be >= the on-chip line size "
            f"({line_bytes}): a line must not span pages")
    lines = np.asarray(lines, dtype=np.int64).reshape(-1)
    if line_bytes and page_bytes % line_bytes == 0:
        return lines // (page_bytes // line_bytes)
    return (lines * line_bytes) // page_bytes


def golden_tlb_hits(
    pages: np.ndarray, num_sets: int, ways: int, replacement: str = "lru"
) -> np.ndarray:
    """Sequential set-associative TLB reference — bool (N,) hit per access.

    Replacement semantics match the cache engine's golden model (ChampSim):
    victim = first invalid way, else least-recently-used (``lru``) / oldest
    fill (``fifo``). The analytic ``classify_tlb`` is test-pinned to this.
    """
    pages = np.asarray(pages, dtype=np.int64).reshape(-1)
    tags = [[None] * ways for _ in range(num_sets)]
    meta = [[-1] * ways for _ in range(num_sets)]   # last-use / fill time
    hits = np.zeros(pages.size, dtype=bool)
    for t, p in enumerate(pages):
        s = int(p) % num_sets
        tag = int(p) // num_sets
        row_t, row_m = tags[s], meta[s]
        if tag in row_t:
            w = row_t.index(tag)
            hits[t] = True
            if replacement == "lru":
                row_m[w] = t
            continue
        if None in row_t:
            w = row_t.index(None)
        else:
            w = int(np.argmin(row_m))                # LRU way / oldest fill
        row_t[w] = tag
        row_m[w] = t
    return hits


def classify_tlb(
    pages: np.ndarray,
    num_sets: int,
    ways: int,
    replacement: str = "lru",
    *,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Analytic per-access TLB hits — bool (N,).

    LRU runs on the stack-distance engine (the numpy twin on the CPU, the
    torch pass on the card); FIFO on the compressed per-set engine, whose
    row scans are the kernel D2 on the card. Both are bit-exact with
    ``golden_tlb_hits``.
    """
    pages = np.asarray(pages, dtype=np.int64).reshape(-1)
    dev = resolve_device(device)
    if pages.size == 0:
        return np.zeros(0, dtype=bool)
    if int(pages.max()) >= int(_BIG_I32):
        raise ValueError("page numbers exceed int32 range; rebase the trace")
    if replacement == "lru":
        dist, _ = stack_distances(pages.astype(np.int32), int(num_sets), dev)
        return dist < np.int32(min(int(ways), int(DIST_COLD) - 1))
    if replacement == "fifo":
        hits, _ = classify_fifo_many(
            [pages], [(int(num_sets), int(ways))], device=dev)[0]
        return hits
    raise ValueError(
        f"unknown TLB replacement {replacement!r}; options: lru, fifo")


@dataclass(frozen=True)
class TranslationCharge:
    """Per-batch translation outcome for one classified miss stream.

    Arrays are indexed by batch. ``hits`` are L1 TLB hits (free — the
    lookup pipelines under the DRAM access), ``misses`` are L1 misses
    (each pays the L2 lookup when an L2 exists), ``walks`` are full
    page-table walks (L2 misses, or every L1 miss without an L2), and
    ``cycles`` is the total stall the memory system adds to the batch's
    DRAM path: ``misses * l2_latency + walks * walk_latency``.
    """

    hits: np.ndarray      # int64 (B,)
    misses: np.ndarray    # int64 (B,)
    walks: np.ndarray     # int64 (B,)
    cycles: np.ndarray    # float64 (B,)


def charge_translation(
    miss_lines: np.ndarray,
    miss_batch: np.ndarray,
    num_batches: int,
    line_bytes: int,
    cfg: TranslationConfig,
    *,
    device: DeviceLike = "cuda",
) -> TranslationCharge:
    """Translate one miss-line stream through the TLB hierarchy.

    ``miss_lines``/``miss_batch`` are the classified off-chip stream in
    trace order (the exact arrays the DRAM request is built from — virtual,
    pre-``PlacementMap``). The L2 TLB, when configured, observes the
    subsequence of L1 misses, exactly like a hardware second-level TLB.
    """
    with stage("translate"):
        pages = tlb_pages(miss_lines, line_bytes, cfg.page_bytes)
        l1_hits = classify_tlb(
            pages, cfg.num_sets, cfg.ways, cfg.replacement, device=device
        )
        miss_batch = np.asarray(miss_batch, dtype=np.int64).reshape(-1)
        nb = int(num_batches)
        hits = np.bincount(miss_batch[l1_hits], minlength=nb)
        misses = np.bincount(miss_batch[~l1_hits], minlength=nb)
        if cfg.l2_entries:
            l2_sub = ~l1_hits
            l2_hits = classify_tlb(
                pages[l2_sub], cfg.l2_num_sets, cfg.l2_ways,
                cfg.replacement, device=device,
            )
            walk_mask = np.zeros(pages.size, dtype=bool)
            walk_mask[np.flatnonzero(l2_sub)[~l2_hits]] = True
            walks = np.bincount(miss_batch[walk_mask], minlength=nb)
            l2_lat = float(cfg.l2_latency_cycles)
        else:
            walks = misses
            l2_lat = 0.0
        cycles = (misses * l2_lat
                  + walks * float(cfg.walk_latency_cycles)).astype(np.float64)
        return TranslationCharge(
            hits=hits.astype(np.int64),
            misses=misses.astype(np.int64),
            walks=walks.astype(np.int64),
            cycles=cycles,
        )


def translation_saturated(
    unique_pages: np.ndarray, cfg: TranslationConfig
) -> bool:
    """True when the L1 TLB provably never takes a non-compulsory miss.

    Exact condition: no L1 set is ever offered more distinct pages than it
    has ways. Then — for LRU and FIFO alike, since both insert only on miss
    and evict only when the set is full — no entry is ever evicted, so every
    non-first access hits, for ANY subsequence of the trace's accesses.
    Every saturated config's outcome collapses to first-touch-only walks:
    hits/misses/walks depend only on ``page_bytes`` and the charged cycles
    only on ``miss_latency_cycles`` (an L1-cold translation is L2-cold too,
    because the L2 observes only L1 misses), which is what lets the sweep
    canonicalize all such configs onto one memo key — the TLB analogue of
    on-chip capacity saturation.
    """
    up = np.asarray(unique_pages, dtype=np.int64).reshape(-1)
    if up.size == 0:
        return True
    per_set = np.bincount(up % int(cfg.num_sets))
    return int(per_set.max()) <= int(cfg.ways)


def charge_cache_lookup(
    cache: Dict[tuple, TranslationCharge],
    miss_lines: np.ndarray,
    miss_batch: np.ndarray,
    num_batches: int,
    line_bytes: int,
    cfg: TranslationConfig,
    *,
    device: DeviceLike = "cuda",
) -> TranslationCharge:
    """Memoized ``charge_translation`` — keyed by the config's canonical
    tuple, stored on the classified stream so placement/topology siblings
    of a sweep memo group (which share the classified stream, and whose
    translation outcome is identical by placement-invariance) compute each
    TLB configuration once."""
    charge = cache.get(cfg.key)
    if charge is None:
        charge = cache[cfg.key] = charge_translation(
            miss_lines, miss_batch, num_batches, line_bytes, cfg, device=device
        )
    return charge
