"""Request-level traffic generation for serving simulation.

The paper (and the rest of this repo up to now) evaluates fixed embedding
traces: a workload IS a trace. Production DLRM serving is a *stream of
requests* — Poisson/diurnal/bursty arrivals, per-request table subsets and
lookup counts, and popularity that drifts over the day. This module generates
such streams, fully seeded and deterministic, and lowers admitted request
batches onto the existing ``FullTrace``/``ConcatTrace`` per-batch-boundary
seam so the unmodified memory system provides service times.

Layering (see docs/architecture.md "Serving under stress")::

    TrafficConfig -> generate_requests() -> [Request...]      (this module)
        -> serving.scheduler (admission/batching/policies)
        -> lower_batch() -> FullTrace per served batch        (this module)
        -> ConcatTrace -> MemorySystem.simulate_embedding     (untouched)

Determinism contract: every sampled quantity is drawn from a
``np.random.default_rng`` seeded by an integer tuple derived from
``(cfg.seed, request id, ...)`` — no global RNG state, no wall clock, no
str-hashing (PYTHONHASHSEED-proof), so the same config always yields the
same byte-identical stream, including each request's row ids (a retried
request re-submits the *same* rows, as a real client would).

A copy of the JAX package's ``repro.core.requests``: host numpy throughout
(no draw moves to torch), so both packages generate the same stream bit for
bit. Module-level names (the seed tags, ``_zipf_cdf``, ``_DRIFT_GRID``) are
kept as they are there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .trace import FullTrace, zipf_probs
from .workload import EmbeddingOpSpec

__all__ = [
    "ARRIVAL_PATTERNS",
    "BatchLowering",
    "Request",
    "TrafficConfig",
    "drift_exponents",
    "generate_arrivals",
    "generate_requests",
    "hot_table_set",
    "lower_batch",
]

ARRIVAL_PATTERNS = ("poisson", "diurnal", "bursty")

# Sub-stream tags mixed into rng seeds so the arrival process, per-request
# shape, and per-request rows never share a stream (adding a knob to one can
# never silently reshuffle another).
_ARRIVAL_TAG = 0xA221
_SHAPE_TAG = 0x517A
_ROWS_TAG = 0xB0B
_PERM_TAG = 0x9E12


@dataclass(frozen=True)
class TrafficConfig:
    """One seeded request-traffic scenario (the arrival half of a serving
    scenario; the robustness-policy half lives in ``serving.scheduler``).

    * ``pattern`` — ``poisson`` (memoryless gaps), ``diurnal`` (Poisson with
      a sinusoidally modulated rate: rush hour vs. night), ``bursty``
      (on/off bursts of ``burst_len`` back-to-back requests).
    * ``mean_gap_cycles`` — mean inter-arrival gap; 1/rate in cycles, the
      same unit the memory system charges service time in, so overload is
      just ``mean_gap_cycles < service_per_request``.
    * ``tables_per_request`` / ``lookups_per_table`` — per-request shape:
      each request touches a seeded subset of the op's tables (``None`` =
      all of them) with that many pooled lookups per touched table.
    * ``zipf_s`` + ``zipf_drift`` — popularity skew at stream start, and a
      linear drift of the exponent across the stream (popularity sharpens
      or flattens over the "day"). The drifting exponent is *quantized to
      drift epochs* (see ``drift_exponents``): every request in an epoch
      shares one exponent, so the per-exponent CDF cache stays bounded by
      the epoch count instead of growing one entry per request.
    * ``drift_period`` — every that-many requests the hot-id permutation is
      re-drawn (which rows are hot rotates, the cache's working set moves)
      and, when drifting, the Zipf exponent steps to its next value; 0 keeps
      one permutation for the whole stream (a drifting exponent then steps
      on a fixed ``_DRIFT_GRID``-epoch grid).
    """

    pattern: str = "poisson"
    mean_gap_cycles: float = 2_000.0
    num_requests: int = 256
    seed: int = 0
    tables_per_request: Optional[int] = None
    lookups_per_table: Optional[int] = None
    zipf_s: float = 0.8
    zipf_drift: float = 0.0
    drift_period: int = 0
    diurnal_period_cycles: float = 250_000.0
    diurnal_amplitude: float = 0.5
    burst_len: int = 8
    burst_gap_scale: float = 0.1

    def __post_init__(self) -> None:
        if self.pattern not in ARRIVAL_PATTERNS:
            raise ValueError(
                f"unknown arrival pattern {self.pattern!r}; "
                f"options: {ARRIVAL_PATTERNS}")
        if self.num_requests < 1:
            raise ValueError("num_requests must be >= 1")
        if self.mean_gap_cycles <= 0:
            raise ValueError("mean_gap_cycles must be > 0")

    @property
    def key(self) -> tuple:
        """Canonical value tuple (memo keys / checkpoint fingerprints)."""
        return (
            "traffic", self.pattern, float(self.mean_gap_cycles),
            int(self.num_requests), int(self.seed),
            self.tables_per_request, self.lookups_per_table,
            float(self.zipf_s), float(self.zipf_drift),
            int(self.drift_period), float(self.diurnal_period_cycles),
            float(self.diurnal_amplitude), int(self.burst_len),
            float(self.burst_gap_scale),
        )


@dataclass(frozen=True)
class Request:
    """One inference request: arrival instant + its exact lookup payload.

    ``ranks`` carries each lookup's popularity rank (0 = hottest) alongside
    the row id, so graceful degradation ("hot rows only") can truncate a
    request without re-deriving popularity — and do it identically on
    replay.
    """

    rid: int
    arrival: int                 # cycles
    table_ids: np.ndarray        # int32 (T_r,) touched tables, sorted
    rows: np.ndarray             # int64 (T_r, L) row ids per touched table
    ranks: np.ndarray            # int64 (T_r, L) popularity rank per lookup

    @property
    def num_lookups(self) -> int:
        return int(self.rows.size)


# --------------------------------------------------------------------------
# Arrival processes
# --------------------------------------------------------------------------

def generate_arrivals(cfg: TrafficConfig) -> np.ndarray:
    """int64 (num_requests,) sorted arrival cycles — deterministic in cfg."""
    rng = np.random.default_rng((cfg.seed, _ARRIVAL_TAG))
    n = cfg.num_requests
    if cfg.pattern == "poisson":
        gaps = rng.exponential(cfg.mean_gap_cycles, size=n)
    elif cfg.pattern == "bursty":
        # On/off: bursts of burst_len back-to-back requests (gap shrunk by
        # burst_gap_scale) separated by long idle gaps sized to keep the
        # configured mean rate.
        u = rng.exponential(1.0, size=n)
        L = max(1, int(cfg.burst_len))
        head = (np.arange(n) % L) == 0
        idle = cfg.mean_gap_cycles * (
            L - (L - 1) * cfg.burst_gap_scale
        )
        gaps = np.where(head, u * idle,
                        u * cfg.mean_gap_cycles * cfg.burst_gap_scale)
    else:  # diurnal — inhomogeneous Poisson, rate modulated by a sinusoid.
        u = rng.exponential(1.0, size=n)
        gaps = np.empty(n, dtype=np.float64)
        t = 0.0
        base_rate = 1.0 / cfg.mean_gap_cycles
        for i in range(n):
            mod = 1.0 + cfg.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / max(cfg.diurnal_period_cycles, 1e-9)
            )
            rate = max(base_rate * mod, 1e-12)
            g = u[i] / rate
            gaps[i] = g
            t += g
    return np.floor(np.cumsum(gaps)).astype(np.int64)


# --------------------------------------------------------------------------
# Request payload generation (table subsets, Zipf rows with drift)
# --------------------------------------------------------------------------

def _zipf_cdf(num_rows: int, s: float, cache: Dict[float, np.ndarray]) -> np.ndarray:
    cdf = cache.get(s)
    if cdf is None:
        cdf = cache[s] = np.cumsum(zipf_probs(num_rows, s))
    return cdf


# Epoch grid for a drifting exponent when drift_period is 0 (no explicit
# epoch length configured): the stream is cut into this many equal epochs.
_DRIFT_GRID = 64


def drift_exponents(cfg: TrafficConfig) -> np.ndarray:
    """float64 (num_requests,) — each request's Zipf exponent.

    With ``zipf_drift == 0`` every entry is exactly ``cfg.zipf_s`` (the
    generated stream is bitwise identical to a drift-free config; test-
    enforced). With drift, the linear schedule ``zipf_s + zipf_drift *
    (i / (n-1))`` is evaluated at each drift epoch's *first* request and
    held constant across the epoch (epoch length = ``drift_period``, or an
    ``n/_DRIFT_GRID`` grid when no period is configured). Distinct values
    are therefore bounded by the epoch count — which is what keeps the
    per-exponent CDF cache in ``generate_requests`` bounded and actually
    hitting, instead of recomputing an O(rows_per_table) cumsum per request.
    """
    n = cfg.num_requests
    if cfg.zipf_drift == 0.0:
        return np.full(n, float(cfg.zipf_s))
    period = cfg.drift_period if cfg.drift_period > 0 else max(
        1, -(-n // _DRIFT_GRID))
    i = np.arange(n, dtype=np.int64)
    epoch_start = (i // period) * period
    return cfg.zipf_s + cfg.zipf_drift * (epoch_start / max(n - 1, 1))


def _epoch_perm(
    seed: int, epoch: int, table: int, num_rows: int,
    cache: Dict[Tuple[int, int], np.ndarray],
) -> np.ndarray:
    """Popularity-rank -> row-id permutation for (epoch, table). Re-drawn per
    drift epoch so the hot set rotates; per table so tables have independent
    hot sets (same posture as ``expand_trace``)."""
    perm = cache.get((epoch, table))
    if perm is None:
        prng = np.random.default_rng((seed, _PERM_TAG, epoch, table))
        perm = cache[(epoch, table)] = prng.permutation(num_rows)
    return perm


def generate_requests(
    spec: EmbeddingOpSpec, cfg: TrafficConfig
) -> List[Request]:
    """The full seeded request stream for one embedding op.

    Deterministic in ``(spec, cfg)``: arrivals from ``generate_arrivals``,
    per-request table subset + rows from per-request seeded sub-streams. A
    request's rows are a pure function of ``(cfg.seed, rid)`` — a retry
    re-submits identical rows.
    """
    arrivals = generate_arrivals(cfg)
    n = cfg.num_requests
    # `is None` (not falsy-or): an explicit 0 must hit the range error below,
    # not silently mean "unset".
    tpr = (spec.num_tables if cfg.tables_per_request is None
           else cfg.tables_per_request)
    if not (1 <= tpr <= spec.num_tables):
        raise ValueError(
            f"tables_per_request={tpr} outside [1, {spec.num_tables}]")
    lpt = (spec.lookups_per_sample if cfg.lookups_per_table is None
           else cfg.lookups_per_table)
    if lpt < 1:
        raise ValueError("lookups_per_table must be >= 1")

    cdf_cache: Dict[float, np.ndarray] = {}
    perm_cache: Dict[Tuple[int, int], np.ndarray] = {}
    exponents = drift_exponents(cfg)
    out: List[Request] = []
    for i in range(n):
        s_i = float(exponents[i])
        epoch = (i // cfg.drift_period) if cfg.drift_period > 0 else 0
        cdf = _zipf_cdf(spec.rows_per_table, s_i, cdf_cache)
        rng = np.random.default_rng((cfg.seed, _SHAPE_TAG, i))
        if tpr == spec.num_tables:
            tabs = np.arange(spec.num_tables, dtype=np.int32)
        else:
            tabs = np.sort(rng.choice(
                spec.num_tables, size=tpr, replace=False
            )).astype(np.int32)
        rrng = np.random.default_rng((cfg.seed, _ROWS_TAG, i))
        u = rrng.random((tpr, lpt))
        # cdf[-1] can sit a few ulps below 1.0; clamp so a u in that sliver
        # maps to the coldest rank instead of indexing past the table.
        ranks = np.minimum(
            np.searchsorted(cdf, u, side="right").astype(np.int64),
            spec.rows_per_table - 1,
        )
        rows = np.empty_like(ranks)
        for j, t in enumerate(tabs):
            rows[j] = _epoch_perm(
                cfg.seed, epoch, int(t), spec.rows_per_table, perm_cache
            )[ranks[j]]
        out.append(Request(rid=i, arrival=int(arrivals[i]),
                           table_ids=tabs, rows=rows, ranks=ranks))
    return out


def hot_table_set(
    requests: Sequence[Request], spec: EmbeddingOpSpec, keep_fraction: float
) -> np.ndarray:
    """bool (num_tables,) — the "hot" tables the cache keeps serving under
    ``cache_bypass`` degradation: the top ``ceil(num_tables*keep_fraction)``
    tables by total offered lookups over the whole stream (ties break toward
    the lower table id, so the set is deterministic in the stream)."""
    counts = np.zeros(spec.num_tables, dtype=np.int64)
    for r in requests:
        np.add.at(counts, r.table_ids.astype(np.int64), r.rows.shape[1])
    k = max(1, min(spec.num_tables,
                   int(math.ceil(spec.num_tables * keep_fraction))))
    order = np.lexsort((np.arange(spec.num_tables), -counts))
    hot = np.zeros(spec.num_tables, dtype=bool)
    hot[order[:k]] = True
    return hot


# --------------------------------------------------------------------------
# Lowering: a batch of requests -> FullTrace (the ConcatTrace seam)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BatchLowering:
    """One served batch lowered onto the trace seam, plus what degradation
    removed from it (the scheduler charges the bypass penalty and reports
    the drop counters from these)."""

    full: FullTrace
    lookups: int            # lookups actually in the trace
    dropped_cold_rows: int  # hot_rows_only truncation victims
    bypassed_lookups: int   # cache_bypass lookups routed around the cache


def lower_batch(
    requests: Sequence[Request],
    spec: EmbeddingOpSpec,
    hot_rank_limit: Optional[int] = None,
    bypass_tables: Optional[np.ndarray] = None,
) -> BatchLowering:
    """Lower one admitted batch (one request per batch slot) to a FullTrace.

    Lookup order is batch-major like ``expand_trace``: request 0's tables in
    ascending order, then request 1, ... — the order an embedding-bag kernel
    walks a ragged batch. With both degradation arguments ``None`` the
    lowering is the exact identity on the requests' payloads (no lookup
    added, dropped, or reordered) — the all-policies-off serving path feeds
    these traces to ``simulate_embedding`` unchanged (differential-enforced).

    ``hot_rank_limit`` keeps only lookups with popularity rank below it
    (hot-rows-only truncated pooling). ``bypass_tables`` (bool mask over
    table ids) removes those tables' lookups from the *cached* stream; the
    scheduler charges them a flat DRAM-bypass cost instead.
    """
    if not requests:
        raise ValueError("lower_batch needs at least one request")
    tab_parts: List[np.ndarray] = []
    row_parts: List[np.ndarray] = []
    dropped = 0
    bypassed = 0
    for r in requests:
        tabs = np.repeat(r.table_ids.astype(np.int32), r.rows.shape[1])
        rows = r.rows.reshape(-1)
        keep = np.ones(rows.size, dtype=bool)
        if hot_rank_limit is not None:
            cold = r.ranks.reshape(-1) >= hot_rank_limit
            dropped += int(np.count_nonzero(keep & cold))
            keep &= ~cold
        if bypass_tables is not None:
            by = bypass_tables[tabs]
            bypassed += int(np.count_nonzero(keep & by))
            keep &= ~by
        tab_parts.append(tabs[keep])
        row_parts.append(rows[keep])
    table_ids = (np.concatenate(tab_parts) if tab_parts
                 else np.empty(0, dtype=np.int32))
    row_ids = (np.concatenate(row_parts) if row_parts
               else np.empty(0, dtype=np.int64))
    full = FullTrace(
        table_ids=table_ids.astype(np.int32),
        row_ids=row_ids.astype(np.int64),
        batch_size=len(requests),
        num_tables=spec.num_tables,
        lookups_per_sample=max(
            1, (requests[0].rows.shape[1] if requests else 1)
        ),
    )
    return BatchLowering(
        full=full,
        lookups=int(row_ids.size),
        dropped_cold_rows=dropped,
        bypassed_lookups=bypassed,
    )
