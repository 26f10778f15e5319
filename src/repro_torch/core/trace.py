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
# NUMA placement: embedding row -> (channel-group, rank) home
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class PlacementMap:
    """Maps embedding line addresses to their NUMA (channel-group, rank) home.

    The map is a pure address transform applied to miss traces *before* DRAM
    timing. This package carries the identity case only: one channel group
    with the ``interleave`` placement (or a placement that degenerates to
    it), where ``place`` returns its input unchanged. Every other placement
    raises ``NotImplementedError`` until the placement slice of the port.
    """

    channels: int
    banks: int
    num_groups: int
    affinity: str
    placement: str
    num_tables: int
    hot_vecs: Optional[np.ndarray] = None    # sorted global vector ids

    @staticmethod
    def from_model(model, hw, spec, hot_vecs: Optional[np.ndarray] = None) -> "PlacementMap":
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
            num_groups=num_groups,
            affinity=affinity,
            placement=hw.placement,
            num_tables=spec.num_tables,
            hot_vecs=hot_vecs,
        )

    @property
    def effective_placement(self) -> str:
        """The placement mode after degeneracy collapse (see the reference's
        ``PlacementMap.effective_placement``)."""
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

    def place(self, lines: np.ndarray, src: Optional[np.ndarray] = None,
              cache: Optional[dict] = None) -> np.ndarray:
        lines = np.asarray(lines, dtype=np.int64).reshape(-1)
        if self.is_identity or lines.size == 0:
            return lines
        raise NotImplementedError(
            f"placement {self.placement!r} with channel affinity "
            f"{self.affinity!r} is not ported yet (placement slice of the "
            "port; see ROADMAP.md)"
        )

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
