"""Index-trace handling (paper Sec. III, "Simulation flow").

EONSim operates on *hardware-agnostic embedding index traces*:

  1. a single-table index-level trace (from a file or a synthetic generator),
  2. expanded to a full multi-table trace per the workload configuration,
  3. translated into memory *line addresses* using the memory-system
     configuration (vector dim, dtype, line granularity, contiguous layout).

Synthetic traces use a Zipf distribution, the standard model for the skewed
reuse the paper describes (Reuse High ~4% of vectors dominate, Low ~46%).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from .workload import EmbeddingOpSpec


# --------------------------------------------------------------------------
# Synthetic index-trace generation
# --------------------------------------------------------------------------

def zipf_probs(num_rows: int, s: float) -> np.ndarray:
    """p(rank r) ∝ 1 / r^s over ``num_rows`` ranks."""
    ranks = np.arange(1, num_rows + 1, dtype=np.float64)
    p = 1.0 / np.power(ranks, s)
    return p / p.sum()


def generate_zipf_trace(
    num_accesses: int,
    num_rows: int,
    s: float,
    seed: int = 0,
    shuffle_ids: bool = True,
) -> np.ndarray:
    """Sample ``num_accesses`` row indices with Zipf(s) popularity.

    ``shuffle_ids`` decorrelates popularity rank from row id (hot rows are
    spread over the table, as in real embedding tables).
    """
    rng = np.random.default_rng(seed)
    p = zipf_probs(num_rows, s)
    # Inverse-CDF sampling (vectorized, reproducible).
    cdf = np.cumsum(p)
    u = rng.random(num_accesses)
    ranks = np.searchsorted(cdf, u, side="right")
    if shuffle_ids:
        perm = rng.permutation(num_rows)
        return perm[ranks].astype(np.int64)
    return ranks.astype(np.int64)


def generate_uniform_trace(num_accesses: int, num_rows: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_rows, size=num_accesses, dtype=np.int64)


def dominance_fraction(trace: np.ndarray, num_rows: int, coverage: float = 0.8) -> float:
    """Fraction of *distinct accessed rows* that carry ``coverage`` of accesses.

    The paper: "In Reuse High, about 4% of vectors dominate accesses, while
    Reuse Low distributes them across 46%".
    """
    counts = np.bincount(trace, minlength=num_rows)
    counts = np.sort(counts[counts > 0])[::-1]
    if counts.size == 0:
        return 0.0
    csum = np.cumsum(counts)
    k = int(np.searchsorted(csum, coverage * csum[-1])) + 1
    return k / counts.size


# Zipf exponents calibrated (tests pin these) so that the top slice of rows
# covering 80% of accesses matches the paper's reuse levels on the DLRM table
# geometry (1M accesses over 1M rows):  High ≈ 4%, Mid ≈ 20%, Low ≈ 46%.
REUSE_LEVELS = {
    "reuse_high": 1.10,
    "reuse_mid": 1.00,
    "reuse_low": 0.81,
}


def reuse_trace(level: str, num_accesses: int, num_rows: int, seed: int = 0) -> np.ndarray:
    return generate_zipf_trace(num_accesses, num_rows, REUSE_LEVELS[level], seed=seed)


# --------------------------------------------------------------------------
# Trace expansion: single table -> full workload trace
# --------------------------------------------------------------------------

def validate_indices(
    indices: np.ndarray, upper: int, what: str = "embedding index"
) -> None:
    """Reject out-of-range / negative indices with a clear error at trace
    construction. Historically an out-of-range index wrapped modulo the
    table size at translate time — simulating a *valid but wrong* row, which
    corrupts hit rates silently. Raise early instead."""
    arr = np.asarray(indices)
    if arr.size == 0:
        return
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0:
        raise ValueError(
            f"negative {what} {lo} (valid range [0, {upper})): embedding "
            "indices must be non-negative — fix the trace generator rather "
            "than relying on wrap-around")
    if hi >= upper:
        raise ValueError(
            f"{what} {hi} out of range [0, {upper}): the trace references "
            "rows past the end of the table — fix the trace (or the "
            "spec's rows_per_table) rather than relying on wrap-around")


@dataclass(frozen=True)
class FullTrace:
    """Expanded trace: one row per lookup, in execution order.

    ``table_ids[i]``/``row_ids[i]`` identify lookup i. Execution order is
    batch-major: sample 0 table 0 lookups, sample 0 table 1, ... (the order
    an embedding-bag kernel walks the indices).
    """

    table_ids: np.ndarray   # int32 (N,)
    row_ids: np.ndarray     # int64 (N,)
    batch_size: int
    num_tables: int
    lookups_per_sample: int

    def __len__(self) -> int:
        return self.row_ids.shape[0]


def expand_trace(
    single_table_trace: np.ndarray,
    spec: EmbeddingOpSpec,
    batch_size: int,
    seed: int = 1,
) -> FullTrace:
    """Paper: "processes an embedding vector index-level access trace for a
    single table to a full access trace, based on the workload configuration".

    Each table reuses the same index stream through a per-table permutation of
    the row space — preserving the skew profile while decorrelating *which*
    rows are hot across tables (real tables have independent hot sets).

    Indices must lie in ``[0, spec.rows_per_table)``; out-of-range or
    negative indices raise ``ValueError`` here rather than silently wrapping
    into valid rows (a wrapped index simulates the wrong row — and the wrong
    hit rate — with no error anywhere downstream).
    """
    validate_indices(single_table_trace, spec.rows_per_table,
                     what="single_table_trace index")
    n_needed = batch_size * spec.num_tables * spec.lookups_per_sample
    reps = int(np.ceil(n_needed / max(len(single_table_trace), 1)))
    base = np.tile(single_table_trace, reps)[:n_needed]
    base = base.reshape(batch_size, spec.num_tables, spec.lookups_per_sample)

    rng = np.random.default_rng(seed)
    rows = np.empty_like(base)
    for t in range(spec.num_tables):
        perm = rng.permutation(spec.rows_per_table)
        rows[:, t, :] = perm[base[:, t, :]]

    table_ids = np.broadcast_to(
        np.arange(spec.num_tables, dtype=np.int32)[None, :, None], base.shape
    )
    return FullTrace(
        table_ids=table_ids.reshape(-1).copy(),
        row_ids=rows.reshape(-1).astype(np.int64),
        batch_size=batch_size,
        num_tables=spec.num_tables,
        lookups_per_sample=spec.lookups_per_sample,
    )


@dataclass(frozen=True)
class ConcatTrace:
    """Concatenation of per-batch FullTraces with *true* per-batch boundaries.

    The on-chip policy simulation runs once over the concatenated multi-batch
    stream (state persists across inference batches); timing and counts are
    attributed per batch afterwards via ``boundaries`` — which carries the
    real per-batch lookup offsets, so heterogeneous per-batch trace lengths
    are attributed exactly (a derived uniform batch_size would be silently
    wrong there).
    """

    table_ids: np.ndarray        # int32 (N,) over all batches, batch-major
    row_ids: np.ndarray          # int64 (N,)
    boundaries: np.ndarray       # int64 (num_batches + 1,) lookup offsets
    batch_sizes: Tuple[int, ...]  # samples per batch (workload batching)
    num_tables: int
    lookups_per_sample: int

    def __len__(self) -> int:
        return self.row_ids.shape[0]

    @property
    def num_batches(self) -> int:
        return len(self.boundaries) - 1

    @property
    def lookups_per_batch(self) -> np.ndarray:
        return np.diff(self.boundaries)

    @property
    def lookup_batch(self) -> np.ndarray:
        """int64 (N,) batch index of every lookup."""
        return np.repeat(
            np.arange(self.num_batches, dtype=np.int64), self.lookups_per_batch
        )

    @staticmethod
    def from_traces(traces: Sequence[FullTrace]) -> "ConcatTrace":
        if not traces:
            raise ValueError("need at least one batch trace")
        lens = np.array([len(t) for t in traces], dtype=np.int64)
        boundaries = np.concatenate(([0], np.cumsum(lens)))
        return ConcatTrace(
            table_ids=np.concatenate([t.table_ids for t in traces]),
            row_ids=np.concatenate([t.row_ids for t in traces]),
            boundaries=boundaries,
            batch_sizes=tuple(t.batch_size for t in traces),
            num_tables=traces[0].num_tables,
            lookups_per_sample=traces[0].lookups_per_sample,
        )


# --------------------------------------------------------------------------
# Per-core trace sharding (multi-core CoreCluster topology)
# --------------------------------------------------------------------------

# Knuth multiplicative hash constant — decorrelates the table->core mapping
# from table-id parity/stride patterns while staying fully deterministic.
_TABLE_HASH_MULT = 2654435761


def _div_fast(x: np.ndarray, d: int) -> np.ndarray:
    """``x // d`` for non-negative ints; power-of-two divisors use a shift
    (int64 division is the hot op in per-line address transforms)."""
    if d & (d - 1) == 0:
        return x >> (d.bit_length() - 1)
    return x // d


def _divmod_fast(x: np.ndarray, d: int):
    """``(x // d, x % d)`` for non-negative ints; pow2 uses shift/mask."""
    if d & (d - 1) == 0:
        return x >> (d.bit_length() - 1), x & (d - 1)
    return x // d, x % d


def table_core_of(table_ids: np.ndarray, num_cores: int) -> np.ndarray:
    """Deterministic table_id -> core hash (model-parallel table sharding)."""
    t = np.asarray(table_ids, dtype=np.uint64)
    return (((t * np.uint64(_TABLE_HASH_MULT)) >> np.uint64(16))
            % np.uint64(num_cores)).astype(np.int32)


def shard_lookup_cores(
    concat: ConcatTrace, num_cores: int, mode: str = "batch"
) -> np.ndarray:
    """int32 (N,) core id per lookup — deterministic in (trace, num_cores, mode).

    ``batch``       round-robin over batch *samples*: sample s of every batch
                    runs on core ``s % num_cores`` (data-parallel inference,
                    each core pools full samples).
    ``table_hash``  hash of ``table_id`` -> core: each embedding table lives
                    on exactly one core (model-parallel table sharding, the
                    TensorDIMM/RecNMP placement for giant tables).
    """
    if num_cores < 1:
        raise ValueError(f"num_cores must be >= 1, got {num_cores}")
    n = len(concat)
    if num_cores == 1:
        return np.zeros(n, dtype=np.int32)
    if mode == "batch":
        per_sample = concat.num_tables * concat.lookups_per_sample
        starts = np.repeat(concat.boundaries[:-1], concat.lookups_per_batch)
        pos_in_batch = np.arange(n, dtype=np.int64) - starts
        sample = pos_in_batch // max(per_sample, 1)
        return (sample % num_cores).astype(np.int32)
    if mode == "table_hash":
        return table_core_of(concat.table_ids, num_cores)
    raise ValueError(f"unknown sharding mode {mode!r}; options: batch, table_hash")


@dataclass(frozen=True)
class TraceShard:
    """One core's slice of a ConcatTrace, with true per-batch boundaries.

    ``lookup_index`` maps each shard lookup back to its global position in the
    parent trace — the key to deterministic cross-core interleaving when the
    cores' miss bursts are merged for shared-DRAM timing.
    """

    core_id: int
    concat: ConcatTrace
    lookup_index: np.ndarray     # int64 (n_i,) global lookup positions

    def __len__(self) -> int:
        return len(self.concat)


def shard_trace(
    concat: ConcatTrace,
    num_cores: int,
    mode: str = "batch",
    core_of: Optional[np.ndarray] = None,
) -> "list[TraceShard]":
    """Partition a ConcatTrace into ``num_cores`` per-core shards.

    Each shard preserves the parent's per-batch structure: shard batch b holds
    exactly the core's lookups from parent batch b, in parent order, so
    heterogeneous per-batch lengths survive sharding and per-core per-batch
    attribution stays exact. Shards may be empty (e.g. table_hash with fewer
    tables than cores). ``core_of`` lets a caller that already computed
    ``shard_lookup_cores`` reuse it.
    """
    core = core_of if core_of is not None else shard_lookup_cores(concat, num_cores, mode)
    lb = concat.lookup_batch
    shards = []
    for c in range(num_cores):
        idx = np.nonzero(core == c)[0].astype(np.int64)
        counts = np.bincount(lb[idx], minlength=concat.num_batches)
        sub = ConcatTrace(
            table_ids=concat.table_ids[idx],
            row_ids=concat.row_ids[idx],
            boundaries=np.concatenate(([0], np.cumsum(counts))),
            batch_sizes=concat.batch_sizes,
            num_tables=concat.num_tables,
            lookups_per_sample=concat.lookups_per_sample,
        )
        shards.append(TraceShard(core_id=c, concat=sub, lookup_index=idx))
    return shards


# --------------------------------------------------------------------------
# NUMA placement: embedding row -> (channel-group, rank) home
# --------------------------------------------------------------------------

# Fraction of distinct vectors (by access frequency) replicated across the
# whole channel group under ``placement="hot_replicate"`` — TensorDIMM
# replicates the hottest embeddings across ranks so any rank can serve them.
HOT_REPLICATE_FRACTION = 0.05


def profile_hot_vectors(
    vec_ids: np.ndarray, fraction: float = HOT_REPLICATE_FRACTION
) -> np.ndarray:
    """The hottest distinct vector ids of a trace, sorted — deterministic in
    the trace (frequency desc, vector id asc on ties)."""
    uniq, counts = np.unique(np.asarray(vec_ids, dtype=np.int64), return_counts=True)
    if uniq.size == 0:
        return uniq
    k = max(1, int(uniq.size * fraction))
    order = np.argsort(-counts, kind="stable")
    return np.sort(uniq[order[:k]])


@dataclass(frozen=True, eq=False)
class PlacementMap:
    """Maps embedding line addresses to their NUMA (channel-group, rank) home.

    The map is a pure address transform applied to miss traces *before* DRAM
    timing: a placed line decomposes (``DramModel.decompose``) to a channel
    inside the request's affine channel group, with the bank ("rank") and row
    chosen by the placement mode. Routing therefore rides through the
    existing contended/batched DRAM engines untouched — they already scan
    channels independently, so disjoint channel groups simply stop contending.

    Channel groups are strided: group ``g`` of ``G`` owns channels
    ``{g, g + G, g + 2G, ...}``. The degenerate ``symmetric``/``interleave``
    configuration is the *identity* transform (``place`` returns its input),
    which is what makes the placement layer bitwise invisible by default
    (test-enforced).

    ``per_core`` routes by REQUESTER, not by data home: a line accessed from
    two cores places at two distinct addresses (one per group), modeling
    per-core-private replicas of shared rows at zero storage/coherence cost.
    That is the intended TensorDIMM pairing with ``table_hash`` sharding
    (requester == table owner, nothing shared); under ``batch`` sharding use
    ``per_table`` for a single-copy data home.

    Placement modes within the group (see ``hardware.PLACEMENTS``):

    * ``interleave``    — blocks stripe across the group's channels, then
      banks, then rows: exactly the symmetric layout restricted to the group.
    * ``table_rank``    — TensorDIMM-style: each table is homed to ONE rank
      (bank index = ``hash(table) % banks``); its blocks stripe across the
      group's channels but stay in that rank, in a per-table private row
      range (no cross-table row aliasing by construction).
    * ``hot_replicate`` — ``table_rank`` for cold rows; vectors in
      ``hot_vecs`` stripe across every (channel, rank) of the group at full
      width, in a row range disjoint from every cold table's.

    The transform is injective (distinct lines never merge), so run
    compression, chunking, and row-hit accounting downstream stay exact.
    """

    channels: int
    banks: int
    lines_per_block: int
    blocks_per_row: int
    line_bytes: int
    num_groups: int
    affinity: str
    placement: str
    table_bytes: int
    vector_bytes: int
    num_tables: int
    hot_vecs: Optional[np.ndarray] = None    # sorted global vector ids

    @staticmethod
    def from_model(
        model,
        hw,
        spec,
        hot_vecs: Optional[np.ndarray] = None,
    ) -> "PlacementMap":
        """Build from a ``DramModel``-like object (single source of the
        channel/bank/row derivations), the hardware config, and the op spec."""
        affinity = hw.channel_affinity
        num_groups = 1 if affinity == "symmetric" else int(hw.num_cores)
        if num_groups > 1 and model.channels % num_groups != 0:
            raise ValueError(
                f"channel affinity {affinity!r} needs channels "
                f"({model.channels}) divisible by num_cores ({num_groups})"
            )
        return PlacementMap(
            channels=model.channels,
            banks=model.banks_per_channel,
            lines_per_block=model.lines_per_block,
            blocks_per_row=max(1, model.lines_per_row // model.lines_per_block),
            line_bytes=model.line_bytes,
            num_groups=num_groups,
            affinity=affinity,
            placement=hw.placement,
            table_bytes=spec.table_bytes,
            vector_bytes=spec.vector_bytes,
            num_tables=spec.num_tables,
            hot_vecs=hot_vecs,
        )

    @property
    def group_size(self) -> int:
        """Channels per group."""
        return self.channels // self.num_groups

    @property
    def effective_placement(self) -> str:
        """The placement mode after degeneracy collapse.

        Modes whose address transform provably equals a simpler mode's for
        this topology canonicalize to that mode, so memo layers (the sweep)
        can collapse such configs onto one entry instead of re-simulating:

        * ``hot_replicate`` with no hot vectors is exactly ``table_rank``
          (the replica branch can never fire).
        * ``table_rank`` (and hot-set-free ``hot_replicate``) with a single
          rank AND a single table is exactly ``interleave``: the rank home
          degenerates to the only bank, table 0's private block range starts
          at q == 0, and ``pack`` reproduces the plain group striping.

        ``place`` dispatches on this property, so the collapse is bitwise by
        construction, not merely approximate.
        """
        plc = self.placement
        if plc == "hot_replicate" and (
            self.hot_vecs is None or self.hot_vecs.size == 0
        ):
            plc = "table_rank"
        if plc == "table_rank" and self.banks == 1 and self.num_tables == 1:
            plc = "interleave"
        return plc

    @property
    def is_identity(self) -> bool:
        """True when ``place`` is the exact identity (the degenerate config)."""
        return self.num_groups == 1 and self.effective_placement == "interleave"

    # q-space spans: each table owns a private range of block-sequence ids so
    # tables (and the replicated hot set) can never alias rows of each other.
    # The span is rounded up to a whole number of rows — otherwise two tables
    # homed to the same rank could share the row straddling their boundary,
    # counting a spurious cross-table row hit per boundary.
    @property
    def _table_span(self) -> int:
        ib = self.lines_per_block * self.line_bytes
        span = self.table_bytes // ib + 2
        bpr = self.blocks_per_row
        return -(-span // bpr) * bpr

    @property
    def _hot_q_base(self) -> int:
        return self._table_span * (self.num_tables + 1)

    def affine_channels(self, group: int) -> np.ndarray:
        """The channel ids group ``group`` may route to (strided grouping)."""
        return np.arange(self.group_size, dtype=np.int64) * self.num_groups + int(group)

    def table_of(self, lines: np.ndarray) -> np.ndarray:
        """Table id of each line (from its start byte; contiguous layout)."""
        return (np.asarray(lines, dtype=np.int64) * self.line_bytes) // self.table_bytes

    def rank_of_table(self, table_ids: np.ndarray) -> np.ndarray:
        """Deterministic table -> rank (bank index) home, TensorDIMM-style."""
        return table_core_of(table_ids, self.banks).astype(np.int64)

    def group_of(
        self,
        lines: np.ndarray,
        src: Optional[np.ndarray] = None,
        table_ids: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Affine channel-group of each request (total: every line maps).

        ``table_ids`` optionally passes precomputed ``table_of(lines)`` so
        hot-path callers (``place``) don't rederive the per-line division.
        """
        lines = np.asarray(lines, dtype=np.int64).reshape(-1)
        if self.num_groups == 1:
            return np.zeros(lines.size, dtype=np.int64)
        if self.affinity == "per_core":
            if src is None:
                # Silently homing everything to group 0 would quietly inflate
                # finish cycles; per_core routing REQUIRES source-core tags.
                raise ValueError(
                    "per_core channel affinity needs per-request source-core "
                    "tags; route through the multi-core pipeline "
                    "(memory_system_for) instead of a bare MemorySystem"
                )
            return np.asarray(src, dtype=np.int64).reshape(-1) % self.num_groups
        # per_table: the table's home group, independent of the issuing core
        # (same hash as table_hash lookup sharding, so a table's core and its
        # channel group coincide under model-parallel sharding). The hash is
        # a function of the (few) table ids — gathered, not rederived.
        t = self.table_of(lines) if table_ids is None else table_ids
        tmap = table_core_of(
            np.arange(self.num_tables + 1), self.num_groups
        ).astype(np.int64)
        return tmap[t]

    def place(
        self,
        lines: np.ndarray,
        src: Optional[np.ndarray] = None,
        cache: Optional[dict] = None,
    ) -> np.ndarray:
        """Placed line addresses: ``DramModel.decompose`` of the result lands
        on the request's affine channels with the mode's (rank, row) home.
        Identity (input returned unchanged) for ``symmetric``/``interleave``.

        ``cache`` (optional dict) memoizes the group-independent half of the
        transform across placement siblings that share one classified miss
        stream: for a fixed (effective placement, num_groups) the placed
        address is ``base(lines) + g*lines_per_block`` and only ``g`` reads
        the channel affinity, so siblings reuse ``base`` (and the per-line
        table ids) verbatim. Callers own the cache's lifetime — it must be
        scoped to ONE ``lines`` array.
        """
        lines = np.asarray(lines, dtype=np.int64).reshape(-1)
        if self.is_identity or lines.size == 0:
            return lines
        G = self.num_groups
        plc = self.effective_placement
        t = None
        if plc != "interleave" or self.affinity == "per_table":
            if cache is not None:
                t = cache.get("t")
            if t is None:
                t = self.table_of(lines)
                if cache is not None:
                    cache["t"] = t
        base = cache.get((plc, G)) if cache is not None else None
        if base is None:
            base = self._place_base(lines, plc, t)
            if cache is not None:
                cache[(plc, G)] = base
        if G == 1:
            return base                   # g == 0 everywhere
        g = self.group_of(lines, src, table_ids=t)
        return base + g * self.lines_per_block

    def _place_base(
        self, lines: np.ndarray, plc: str, t: Optional[np.ndarray]
    ) -> np.ndarray:
        """The group-independent part of ``place``: the placed address with
        ``g == 0`` (adding ``g*lines_per_block`` yields the full transform).
        """
        lpb = self.lines_per_block
        C, B, G = self.channels, self.banks, self.num_groups
        Cg = self.group_size
        blk, off = _divmod_fast(lines, lpb)

        # The canonical layout is new_blk = (q*B + bk)*C + (ch*G + g), with
        # q the block-sequence id within (channel, bank) — the exact inverse
        # of decompose_blocks.  Because C == Cg*G the (q, bk, ch) splits fold
        # algebraically; each branch notes its fold from the canonical form,
        # so what remains is a handful of per-line vector ops.

        if plc == "interleave":
            # q, ch = divmod(blk, Cg); qb, bk = divmod(q, B):
            #   (qb*B + bk)*C + ch*G + g == q*C + ch*G + g == blk*G + g.
            return blk * (G * lpb) + off

        # Table homes (private q span, rank) are functions of the few table
        # ids — the per-table head (span*B + rank)*C is gathered; only the
        # within-table remainder is per-line arithmetic.
        tab = np.arange(self.num_tables + 1, dtype=np.int64)
        tstart = ((tab * self.table_bytes) // (lpb * self.line_bytes))[t]
        blk_local = blk - tstart
        if Cg & (Cg - 1) == 0:
            ch_idx = blk_local & (Cg - 1)
        else:
            ch_idx = blk_local % Cg
        # ql, ch = divmod(blk_local, Cg); q = span_t + ql:
        #   (q*B + rank_t)*C + ch*G + g
        #     == (span_t*B + rank_t)*C + (ql*Cg*B + ch)*G + g,
        # and ql*Cg == blk_local - ch.
        head = ((tab * self._table_span) * B + self.rank_of_table(tab)) * C
        base = (
            head[t] + ((blk_local - ch_idx) * B + ch_idx) * G
        ) * lpb + off
        if (
            plc == "hot_replicate"
            and self.hot_vecs is not None
            and self.hot_vecs.size
        ):
            lpv = self.vector_bytes // self.line_bytes
            if lpv * self.line_bytes == self.vector_bytes:
                vec = _div_fast(lines, lpv)
            else:
                vec = (lines * self.line_bytes) // self.vector_bytes
            mask = self._hot_mask
            hot = mask[np.minimum(vec, mask.size - 1)]
            if np.any(hot):
                # qh, ch = divmod(blk, Cg); qhb, bk = divmod(qh, B):
                #   ((hot_q_base + qhb)*B + bk)*C + ch*G + g
                #     == hot_q_base*B*C + blk*G + g.
                base = np.where(
                    hot,
                    (blk * G + self._hot_q_base * B * C) * lpb + off,
                    base,
                )
        return base

    @property
    def _hot_mask(self) -> np.ndarray:
        """Membership mask over vector ids for the (sorted) hot set.

        One boolean gather per ``place`` call instead of a searchsorted;
        built lazily and cached on the instance (frozen dataclass, so via
        ``object.__setattr__``)."""
        cached = self.__dict__.get("_hot_mask_cache")
        if cached is None:
            cached = np.zeros(int(self.hot_vecs.max()) + 2, dtype=bool)
            cached[np.asarray(self.hot_vecs, dtype=np.int64)] = True
            object.__setattr__(self, "_hot_mask_cache", cached)
        return cached


# --------------------------------------------------------------------------
# Address translation: index trace -> line-address trace
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AddressTrace:
    """Line-granular address trace (one entry per on-chip-line access)."""

    lines: np.ndarray        # int64 (M,) line numbers (byte_addr // line_bytes)
    line_bytes: int
    lines_per_vector: int
    vector_of_line: np.ndarray  # int64 (M,) index into the FullTrace lookup

    def __len__(self) -> int:
        return self.lines.shape[0]


def translate(
    full: Union[FullTrace, ConcatTrace],
    spec: EmbeddingOpSpec,
    line_bytes: int,
    base_address: int = 0,
) -> AddressTrace:
    """Index-level -> address-level trace.

    EONSim "assumes that an NPU stores embedding vectors in consecutive
    virtual memory addresses": table t, row r starts at
      base + t * table_bytes + r * vector_bytes
    and a vector touches ceil(vector_bytes / line_bytes) consecutive lines.
    """
    vb = spec.vector_bytes
    lines_per_vec = -(-vb // line_bytes)
    start = (
        base_address
        + full.table_ids.astype(np.int64) * spec.table_bytes
        + full.row_ids * vb
    )
    start_line = start // line_bytes
    offsets = np.arange(lines_per_vec, dtype=np.int64)
    lines = (start_line[:, None] + offsets[None, :]).reshape(-1)
    vector_of_line = np.repeat(np.arange(len(full), dtype=np.int64), lines_per_vec)
    return AddressTrace(
        lines=lines,
        line_bytes=line_bytes,
        lines_per_vector=lines_per_vec,
        vector_of_line=vector_of_line,
    )


def load_index_trace(path: str) -> np.ndarray:
    """Load an index trace from .npy or whitespace/newline-separated text."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.int64).reshape(-1)
    return np.loadtxt(path, dtype=np.int64).reshape(-1)
