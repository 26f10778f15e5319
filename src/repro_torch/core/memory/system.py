"""Unified MemorySystem: the classify -> miss-trace -> DRAM-timing pipeline.

This is the layer the paper's Fig. 2 "Simulation" stage describes for
embedding operations, extracted behind one owner so every on-chip policy and
memory geometry goes through the same path:

  ConcatTrace (lookups, true per-batch boundaries)
      |  [lane transform, when exact]    vector-granular stream
      |  [otherwise]                     line-granular stream (translate)
      v
  MemoryPolicy.run  — pluggable registry (policies.py), shared accounting
      v
  miss line trace + per-batch attribution     (ClassifiedStream)
      v
  dram_timing_single — ONE batched event scan for all batches
      v
  per-batch EmbeddingBatchStats (cycles, access counts, DRAM row stats)

Lane-decomposition transform: when the cache geometry satisfies
``num_sets % lines_per_vector == 0`` and vectors are line-aligned, the
line-level set-associative cache decomposes into ``lines_per_vector``
independent "lane" sub-caches that each observe the same vector-granular
stream. Simulating ONE lane at vector granularity and scaling counts is then
*bit-exact* vs line-level simulation and cuts scan length by
lines_per_vector (8x for DLRM's 512 B vectors / 64 B lines). The transform
is applied transparently to any policy that declares
``supports_lane_transform``.

Per-batch DRAM timing: each batch's miss burst is timed against fresh DRAM
state (double-buffered streaming, the memory-bound regime), and all batches
run as one segmented scan.

Per-table policy mixes (``hw.onchip.policy_mix``): tables are partitioned
into policy groups; each group classifies its sub-stream under a
set-proportional slice of the on-chip capacity (``PolicyContext.scaled``),
and the groups' miss streams merge back in global trace order.

Address translation (``hw.translation``, ``memory/tlb.py``): the virtual
miss-line stream goes through the TLB hierarchy before placement, and each
batch's page-walk stall is added to its DRAM path. ``None`` skips it.

Many configurations of one policy (``classify_embedding_many``,
``prepare_embedding_many``, ``simulate_embedding_many``) classify through
one ``MemoryPolicy.run_many`` and time DRAM through one
``dram_timing_many``; results are bitwise those of per-system calls.

This package runs the single-core pipeline on ``device``. Multi-core
clusters and non-identity NUMA placements raise ``NotImplementedError``
until their slices are ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ..hardware import HardwareConfig, Topology
from ..profiling import stage
from ..trace import (
    AddressTrace,
    ConcatTrace,
    FullTrace,
    PlacementMap,
    translate,
    validate_indices,
)
from ..workload import EmbeddingOpSpec
from .cache import CacheGeometry
from .dram import DramModel, DramRequest, dram_timing_many, dram_timing_single
from .policies import (
    MemoryPolicy,
    PolicyContext,
    PolicyOutcome,
    get_policy,
    resolve_policy_mix,
)
from .tlb import charge_cache_lookup, tlb_pages

# --------------------------------------------------------------------------
# Lane-decomposition transform
# --------------------------------------------------------------------------

def lane_geometry(hw: HardwareConfig, spec: EmbeddingOpSpec) -> Optional[CacheGeometry]:
    """Vector-granular lane geometry when the decomposition is exact."""
    line = hw.onchip.line_bytes
    if spec.vector_bytes % line != 0:
        return None
    lpv = spec.vector_bytes // line
    full_geom = CacheGeometry.from_capacity(hw.onchip.capacity_bytes, line, hw.onchip.ways)
    if lpv <= 1 or full_geom.num_sets % lpv != 0:
        return None
    return CacheGeometry(
        num_sets=full_geom.num_sets // lpv,
        ways=full_geom.ways,
        line_bytes=spec.vector_bytes,
    )


# --------------------------------------------------------------------------
# Per-batch stats (the MemorySystem accounting contract)
# --------------------------------------------------------------------------

@dataclass
class CoreBatchStats:
    """Per-core detail for one batch under a multi-core topology (the
    checkpoint journal's codec names it; no multi-core path is ported yet)."""

    core_id: int
    lookups: int = 0
    onchip_reads: int = 0
    cache_misses: int = 0
    onchip_cycles: float = 0.0
    vector_cycles: float = 0.0
    dram_finish_cycles: float = 0.0   # this core's last miss completion
                                      # under shared-DRAM contention


@dataclass
class EmbeddingBatchStats:
    cycles: float = 0.0
    vector_cycles: float = 0.0
    dram_cycles: float = 0.0
    onchip_cycles: float = 0.0
    onchip_reads: int = 0
    onchip_writes: int = 0
    offchip_reads: int = 0
    cache_hits: int = 0          # line-granular
    cache_misses: int = 0
    dram_row_hits: int = 0
    dram_row_misses: int = 0
    # Address-translation detail (all zero when hw.translation is None —
    # the exact-identity default; see memory/tlb.py).
    tlb_hits: int = 0            # L1 TLB hits (free, pipelined)
    tlb_misses: int = 0          # L1 TLB misses
    tlb_walks: int = 0           # full page-table walks
    translation_cycles: float = 0.0   # stall added to the DRAM path
    per_core: Optional[List[CoreBatchStats]] = None   # multi-core detail


def _vector_compute_cycles(spec: EmbeddingOpSpec, batch_size: int, hw: HardwareConfig) -> float:
    """Stage-3 vector arithmetic (Fig. 1): pooling on the VPU."""
    flops = spec.reduction_flops(batch_size)
    return flops / max(hw.vector_unit.throughput, 1)


# --------------------------------------------------------------------------
# Shared trace bundle
# --------------------------------------------------------------------------

class EmbeddingTrace:
    """One embedding op's concatenated multi-batch trace + cached streams.

    The derived streams (vector-id stream, line-address trace) are
    independent of the on-chip policy/capacity/associativity, so they are
    built once per op and cached here.
    """

    def __init__(self, spec: EmbeddingOpSpec, traces: Sequence[FullTrace]):
        self.spec = spec
        self.concat = ConcatTrace.from_traces(traces)
        validate_indices(self.concat.row_ids, spec.rows_per_table,
                         what="row index")
        validate_indices(self.concat.table_ids, spec.num_tables,
                         what="table id")
        self._vec_ids: Optional[np.ndarray] = None
        self._lookup_batch: Optional[np.ndarray] = None
        self._atraces: Dict[int, AddressTrace] = {}
        self._unique_lines: Dict[int, int] = {}
        self._unique_pages: Dict[Tuple[int, int], np.ndarray] = {}

    @property
    def num_batches(self) -> int:
        return self.concat.num_batches

    @property
    def lookup_batch(self) -> np.ndarray:
        if self._lookup_batch is None:
            self._lookup_batch = self.concat.lookup_batch
        return self._lookup_batch

    @property
    def vec_ids(self) -> np.ndarray:
        """Globally unique vector id per lookup (lane-transform stream)."""
        if self._vec_ids is None:
            with stage("trace_gen"):
                self._vec_ids = (
                    self.concat.table_ids.astype(np.int64) * self.spec.rows_per_table
                    + self.concat.row_ids
                )
        return self._vec_ids

    def address_trace(self, line_bytes: int) -> AddressTrace:
        at = self._atraces.get(line_bytes)
        if at is None:
            with stage("trace_gen"):
                at = translate(self.concat, self.spec, line_bytes)
            self._atraces[line_bytes] = at
        return at

    def unique_line_count(self, line_bytes: int) -> int:
        """Distinct on-chip lines this op's whole trace touches — the line
        footprint. A ``capacity_saturates`` policy classifies identically at
        any capacity at or above it. Hardware-independent apart from the line
        geometry, so cached."""
        n = self._unique_lines.get(line_bytes)
        if n is None:
            n = int(np.unique(self.address_trace(line_bytes).lines).size)
            self._unique_lines[line_bytes] = n
        return n

    def unique_pages(self, line_bytes: int, page_bytes: int) -> np.ndarray:
        """Distinct translation pages this op's whole trace touches — the
        page footprint, sorted. Every miss stream is a subsequence of this
        trace, so a TLB that ``tlb.translation_saturated`` says the
        footprint never evicts from classifies every config identically
        (first-touch-only walks). Cached like the line footprint."""
        key = (line_bytes, page_bytes)
        up = self._unique_pages.get(key)
        if up is None:
            up = np.unique(
                tlb_pages(self.address_trace(line_bytes).lines,
                          line_bytes, page_bytes))
            self._unique_pages[key] = up
        return up


# --------------------------------------------------------------------------
# Classification result (decoupled from DRAM timing)
# --------------------------------------------------------------------------

@dataclass
class ClassifiedStream:
    """Per-batch accounting + the miss line trace of one classify pipeline.

    ``miss_pos`` (optional) is the global line-slot of each miss —
    ``global_lookup * lines_per_vector + line_offset`` — unique per line
    access, so independently classified sub-streams (policy groups) merge
    back into ONE deterministic stream for DRAM timing by sorting on it.
    """

    num_batches: int
    hit_lines: np.ndarray            # (B,) line-granular hits per batch
    miss_count: np.ndarray           # (B,) line-granular misses per batch
    reads: np.ndarray                # (B,) line-granular on-chip reads per batch
    setup_writes: int
    miss_lines: np.ndarray           # (M,) line addresses, stream order
    miss_batch: np.ndarray           # (M,) batch of each miss line
    miss_pos: Optional[np.ndarray] = None   # (M,) global line-slot
    # Shared memo for the group-independent half of the placement transform
    # (PlacementMap.place), reused across placement siblings of this stream.
    place_cache: dict = field(default_factory=dict)
    # Memoized translation charges keyed by TranslationConfig.key —
    # translation observes the VIRTUAL miss stream (pre-placement), so
    # placement siblings sharing this stream share each TLB configuration's
    # charge too (memory/tlb.py).
    tlb_cache: dict = field(default_factory=dict)


def _lane_context(
    hw: HardwareConfig,
    lane: CacheGeometry,
    lpv: int,
    pinned_lines: Optional[np.ndarray],
    device: torch.device,
) -> PolicyContext:
    """Policy context for the vector-granular lane sub-cache."""
    return PolicyContext(
        geometry=lane,
        capacity_units=hw.onchip.num_lines // lpv,
        pinned_lines=pinned_lines,
        backend=hw.cache_backend,
        device=device,
    )


def _expand_lane_misses(
    concat: ConcatTrace,
    spec: EmbeddingOpSpec,
    mi: np.ndarray,
    line: int,
    lpv: int,
    lookup_index: Optional[np.ndarray],
):
    """Expand vector-granular miss lookups ``mi`` to line addresses (+ global
    line-slot positions when ``lookup_index`` is given) — the single owner of
    the contiguous-layout address arithmetic for the lane path."""
    miss_base = (
        concat.table_ids.astype(np.int64)[mi] * spec.table_bytes
        + concat.row_ids[mi] * spec.vector_bytes
    ) // line
    offs = np.arange(lpv, dtype=np.int64)
    miss_lines = (miss_base[:, None] + offs[None, :]).reshape(-1)
    miss_pos = None
    if lookup_index is not None:
        miss_pos = (lookup_index[mi][:, None] * lpv + offs[None, :]).reshape(-1)
    return miss_lines, miss_pos


def _merge_miss_streams(m_lines, m_batch, m_pos):
    """Merge independently classified miss streams into global trace order.

    Positions are unique line slots (``global_lookup * lpv + offset``), so a
    stable argsort reconstructs the exact order the merged bursts reach the
    memory controller. Returns ``(lines, batch, pos)``.
    """
    empty = np.zeros(0, dtype=np.int64)
    lines = np.concatenate(m_lines) if m_lines else empty
    batch = np.concatenate(m_batch) if m_batch else empty
    pos = np.concatenate(m_pos) if m_pos else empty
    order = np.argsort(pos, kind="stable")
    return lines[order], batch[order], pos[order]


@dataclass
class _PreparedStream:
    """Stream + context resolved for one (etrace, hardware) pair."""

    stream: np.ndarray
    ctx: PolicyContext
    unit: int                        # lines represented by one stream access
    acc_batch: np.ndarray            # batch of each stream access
    use_lane: bool
    at: Optional[AddressTrace]       # line trace (line-granular path only)


@dataclass
class PendingEmbedding:
    """A classified embedding op whose DRAM timing has not yet run.

    ``request`` is the deferred ``dram_timing_contended`` dispatch;
    ``finalize`` assembles per-batch stats from the request's results.
    """

    request: DramRequest
    _finalize: Callable

    def finalize(self, drams, finish) -> "List[EmbeddingBatchStats]":
        return self._finalize(drams, finish)


# --------------------------------------------------------------------------
# MemorySystem (single core)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MemorySystem:
    """Owns the whole on-chip + off-chip memory pipeline for one hardware
    configuration: policy classification, lane transform, miss-trace
    construction, and segmented DRAM timing with per-batch attribution.
    The cache engines and the DRAM scan run on ``device``."""

    hw: HardwareConfig
    policy: MemoryPolicy
    dram: DramModel
    device: torch.device

    @staticmethod
    def from_hardware(hw: HardwareConfig, device: DeviceLike = "cuda") -> "MemorySystem":
        return MemorySystem(
            hw=hw,
            policy=get_policy(hw.onchip.policy),
            dram=DramModel.from_hardware(hw),
            device=resolve_device(device),
        )

    # -- line-trace entry point (run_policy equivalent) ---------------------
    def classify(
        self, atrace: AddressTrace, pinned_lines: Optional[np.ndarray] = None
    ) -> PolicyOutcome:
        return self.policy.run(
            atrace.lines,
            PolicyContext.from_hardware(self.hw, pinned_lines, self.device),
        )

    # -- stream preparation -------------------------------------------------
    def _prepare_stream(
        self,
        etrace: EmbeddingTrace,
        pinned_lines: Optional[np.ndarray],
        allow_lane: bool,
    ) -> _PreparedStream:
        spec = etrace.spec
        hw = self.hw
        line = hw.onchip.line_bytes
        lpv = max(1, -(-spec.vector_bytes // line))
        lookup_batch = etrace.lookup_batch

        lane = lane_geometry(hw, spec) if allow_lane else None
        use_lane = lane is not None and self.policy.supports_lane_transform

        if use_lane:
            # Transparent transform: hand the policy the vector-granular
            # stream under the lane sub-cache geometry; every access stands
            # for ``lpv`` line accesses.
            return _PreparedStream(
                stream=etrace.vec_ids,
                ctx=_lane_context(hw, lane, lpv, pinned_lines, self.device),
                unit=lpv,
                acc_batch=lookup_batch,
                use_lane=True,
                at=None,
            )
        at = etrace.address_trace(line)
        return _PreparedStream(
            stream=at.lines,
            ctx=PolicyContext.from_hardware(hw, pinned_lines, self.device),
            unit=1,
            acc_batch=np.repeat(lookup_batch, at.lines_per_vector),
            use_lane=False,
            at=at,
        )

    # -- per-batch accounting ------------------------------------------------
    def _account(
        self,
        etrace: EmbeddingTrace,
        prep: _PreparedStream,
        out: PolicyOutcome,
        lookup_index: Optional[np.ndarray],
    ) -> ClassifiedStream:
        """Shared accounting contract, per batch: reads = every consumed
        line, writes = fills/stages (+ one-time setup on batch 0), offchip =
        miss fetches. ``unit`` scales vector-granular counts back to lines."""
        spec = etrace.spec
        line = self.hw.onchip.line_bytes
        lpv = max(1, -(-spec.vector_bytes // line))
        num_batches = etrace.num_batches
        unit, acc_batch = prep.unit, prep.acc_batch
        hits = out.hits
        misses = ~hits

        hit_lines = np.bincount(acc_batch[hits], minlength=num_batches) * unit
        miss_count = np.bincount(acc_batch[misses], minlength=num_batches) * unit
        reads = np.bincount(acc_batch, minlength=num_batches) * unit

        miss_pos = None
        if prep.use_lane:
            # Expand vector-granular misses to line addresses for DRAM timing.
            mi = np.nonzero(misses)[0]
            miss_lines, miss_pos = _expand_lane_misses(
                etrace.concat, spec, mi, line, lpv, lookup_index
            )
            miss_batch = np.repeat(acc_batch[misses], unit)
        else:
            miss_lines = out.miss_lines
            miss_batch = acc_batch[misses]
            if lookup_index is not None:
                midx = np.nonzero(misses)[0]
                vec = prep.at.vector_of_line[midx]
                miss_pos = lookup_index[vec] * lpv + midx % lpv

        return ClassifiedStream(
            num_batches=num_batches,
            hit_lines=hit_lines,
            miss_count=miss_count,
            reads=reads,
            setup_writes=out.setup_writes,
            miss_lines=miss_lines,
            miss_batch=miss_batch,
            miss_pos=miss_pos,
        )

    # -- classification (mix-aware) -----------------------------------------
    def classify_embedding(
        self,
        etrace: EmbeddingTrace,
        pinned_lines: Optional[np.ndarray] = None,
        allow_lane: bool = True,
        lookup_index: Optional[np.ndarray] = None,
    ) -> ClassifiedStream:
        """Run the on-chip classification pipeline over all batches.

        ``lookup_index`` maps this trace's lookups to global positions; when
        given, the result carries ``miss_pos`` so several classified streams
        can merge deterministically for DRAM timing.
        """
        if self.hw.onchip.policy_mix:
            return self._classify_mixed(etrace, pinned_lines, allow_lane, lookup_index)
        prep = self._prepare_stream(etrace, pinned_lines, allow_lane)
        out = self.policy.run(prep.stream, prep.ctx)
        return self._account(etrace, prep, out, lookup_index)

    def _classify_mixed(
        self,
        etrace: EmbeddingTrace,
        pinned_lines: Optional[np.ndarray],
        allow_lane: bool,
        lookup_index: Optional[np.ndarray],
    ) -> ClassifiedStream:
        """Per-table policy mix: classify each policy group's sub-stream under
        a capacity partition, then merge miss streams in global trace order."""
        spec = etrace.spec
        hw = self.hw
        concat = etrace.concat
        line = hw.onchip.line_bytes
        lpv = max(1, -(-spec.vector_bytes // line))
        num_batches = etrace.num_batches
        lookup_batch = etrace.lookup_batch
        if lookup_index is None:
            # Positions are needed regardless: the merged miss stream must be
            # in trace order for DRAM timing.
            lookup_index = np.arange(len(concat), dtype=np.int64)

        groups = resolve_policy_mix(
            hw.onchip.policy_mix, hw.onchip.policy, spec.num_tables
        )
        gid_of_table = np.empty(spec.num_tables, dtype=np.int32)
        for gi, g in enumerate(groups):
            gid_of_table[list(g.table_ids)] = gi
        gid = gid_of_table[concat.table_ids]

        lane = lane_geometry(hw, spec) if allow_lane else None
        hit_lines = np.zeros(num_batches, dtype=np.int64)
        miss_count = np.zeros(num_batches, dtype=np.int64)
        reads = np.zeros(num_batches, dtype=np.int64)
        setup = 0
        m_lines, m_batch, m_pos = [], [], []
        at: Optional[AddressTrace] = None
        offs = np.arange(lpv, dtype=np.int64)

        for gi, g in enumerate(groups):
            lidx = np.nonzero(gid == gi)[0].astype(np.int64)
            if lidx.size == 0:
                continue
            use_lane = lane is not None and g.policy.supports_lane_transform
            if use_lane:
                stream = etrace.vec_ids[lidx]
                ctx = _lane_context(
                    hw, lane, lpv, pinned_lines, self.device
                ).scaled(g.fraction)
                unit = lpv
                acc_batch = lookup_batch[lidx]
            else:
                if at is None:
                    at = etrace.address_trace(line)
                line_idx = (lidx[:, None] * lpv + offs[None, :]).reshape(-1)
                stream = at.lines[line_idx]
                ctx = PolicyContext.from_hardware(
                    hw, pinned_lines, self.device
                ).scaled(g.fraction)
                unit = 1
                acc_batch = np.repeat(lookup_batch[lidx], lpv)

            out = g.policy.run(stream, ctx)
            hits = out.hits
            misses = ~hits
            hit_lines += np.bincount(acc_batch[hits], minlength=num_batches) * unit
            miss_count += np.bincount(acc_batch[misses], minlength=num_batches) * unit
            reads += np.bincount(acc_batch, minlength=num_batches) * unit
            setup += out.setup_writes

            if use_lane:
                mi = lidx[np.nonzero(misses)[0]]
                g_lines, g_pos = _expand_lane_misses(
                    concat, spec, mi, line, lpv, lookup_index
                )
                m_lines.append(g_lines)
                m_batch.append(np.repeat(acc_batch[misses], unit))
                m_pos.append(g_pos)
            else:
                midx = line_idx[np.nonzero(misses)[0]]
                m_lines.append(at.lines[midx])
                m_batch.append(acc_batch[misses])
                m_pos.append(lookup_index[at.vector_of_line[midx]] * lpv + midx % lpv)

        all_lines, all_batch, all_pos = _merge_miss_streams(m_lines, m_batch, m_pos)
        return ClassifiedStream(
            num_batches=num_batches,
            hit_lines=hit_lines,
            miss_count=miss_count,
            reads=reads,
            setup_writes=setup,
            miss_lines=all_lines,
            miss_batch=all_batch,
            miss_pos=all_pos,
        )

    # -- stats assembly -----------------------------------------------------
    def _assemble_stats(
        self, etrace: EmbeddingTrace, cs: ClassifiedStream, drams, tlb=None
    ) -> List[EmbeddingBatchStats]:
        hw = self.hw
        line = hw.onchip.line_bytes
        onchip_bw = max(hw.onchip.read_bw_bytes_per_cycle, 1)
        stats: List[EmbeddingBatchStats] = []
        for b in range(cs.num_batches):
            s = EmbeddingBatchStats()
            d = drams[b]
            s.dram_cycles = d.finish_cycle
            s.dram_row_hits = d.row_hits
            s.dram_row_misses = d.row_misses
            s.onchip_reads = int(cs.reads[b])
            s.onchip_writes = int(cs.miss_count[b]) + (cs.setup_writes if b == 0 else 0)
            s.offchip_reads = int(cs.miss_count[b])
            s.cache_hits = int(cs.hit_lines[b])
            s.cache_misses = int(cs.miss_count[b])
            s.onchip_cycles = s.onchip_reads * line / onchip_bw + hw.onchip.latency_cycles
            s.vector_cycles = _vector_compute_cycles(
                etrace.spec, etrace.concat.batch_sizes[b], hw
            )
            # on-chip service, off-chip service and pooling overlap in a
            # double-buffered stream; the slowest stage bounds the batch.
            s.cycles = max(s.onchip_cycles, s.dram_cycles, s.vector_cycles)
            if tlb is not None:
                # Page walks serialize with the off-chip path: a miss line
                # cannot issue to DRAM before its physical address exists.
                s.tlb_hits = int(tlb.hits[b])
                s.tlb_misses = int(tlb.misses[b])
                s.tlb_walks = int(tlb.walks[b])
                s.translation_cycles = float(tlb.cycles[b])
                s.cycles = max(
                    s.onchip_cycles,
                    s.dram_cycles + s.translation_cycles,
                    s.vector_cycles,
                )
            stats.append(s)
        return stats

    def _charge_translation(self, cs: ClassifiedStream):
        """Memoized TLB charge for this stream, or None without translation."""
        tcfg = self.hw.translation
        if tcfg is None:
            return None
        return charge_cache_lookup(
            cs.tlb_cache, cs.miss_lines, cs.miss_batch, cs.num_batches,
            self.hw.onchip.line_bytes, tcfg, device=self.device,
        )

    # -- deferred-DRAM pipeline ---------------------------------------------
    def classify_for_pending(
        self,
        etrace: EmbeddingTrace,
        pinned_lines: Optional[np.ndarray] = None,
        allow_lane: bool = True,
    ) -> ClassifiedStream:
        """The placement-invariant half of ``prepare_embedding``.

        Classification never reads the NUMA axes (``channel_affinity`` /
        ``placement``), which only remap miss-line addresses on the way to
        DRAM, so one classified stream serves every placement variant of a
        config through ``pending_from``.
        """
        return self.classify_embedding(etrace, pinned_lines, allow_lane)

    def pending_from(
        self, etrace: EmbeddingTrace, cs: ClassifiedStream
    ) -> PendingEmbedding:
        """Apply THIS config's placement transform to an already classified
        stream and package the deferred DRAM dispatch. ``cs`` may come from a
        placement sibling (same config up to affinity/placement), bit-exact
        with classifying under this config directly."""
        return self._pending(etrace, cs)

    def prepare_embedding(
        self,
        etrace: EmbeddingTrace,
        pinned_lines: Optional[np.ndarray] = None,
        allow_lane: bool = True,
    ) -> PendingEmbedding:
        """Classify all batches and package the deferred DRAM dispatch."""
        cs = self.classify_embedding(etrace, pinned_lines, allow_lane)
        return self._pending(etrace, cs)

    # -- NUMA placement (channel affinity + row homes) ----------------------
    def placement_map(self, etrace: EmbeddingTrace) -> Optional[PlacementMap]:
        """The row->(channel-group, rank) map for this config, or ``None``
        for the degenerate ``symmetric``/``interleave`` pair — the miss trace
        then reaches DRAM untransformed, byte for byte the historical path."""
        hw = self.hw
        if hw.channel_affinity == "symmetric" and hw.placement == "interleave":
            return None
        if hw.placement == "hot_replicate":
            raise NotImplementedError(
                "placement 'hot_replicate' is not ported yet (see ROADMAP.md)"
            )
        return PlacementMap.from_model(self.dram, hw, etrace.spec)

    def _place_misses(
        self,
        etrace: EmbeddingTrace,
        miss_lines: np.ndarray,
        miss_src: Optional[np.ndarray],
        place_cache: Optional[dict] = None,
    ) -> np.ndarray:
        pm = self.placement_map(etrace)
        if pm is None:
            return miss_lines
        return pm.place(miss_lines, miss_src, cache=place_cache)

    def _pending(self, etrace: EmbeddingTrace, cs: ClassifiedStream) -> PendingEmbedding:
        # Translation observes the VIRTUAL miss stream, before PlacementMap
        # relocates lines: the charge is placement-invariant and memoized
        # on the classified stream.
        tlb = self._charge_translation(cs)
        req = DramRequest(
            lines=self._place_misses(
                etrace, cs.miss_lines, None, place_cache=cs.place_cache
            ),
            seg=cs.miss_batch,
            src=np.zeros(cs.miss_lines.size, dtype=np.int64),
            num_segments=cs.num_batches,
            num_sources=1,
            model=self.dram,
        )
        return PendingEmbedding(
            request=req,
            _finalize=lambda drams, finish: self._assemble_stats(
                etrace, cs, drams, tlb
            ),
        )

    # -- multi-batch embedding-op pipeline ----------------------------------
    def simulate_embedding(
        self,
        etrace: EmbeddingTrace,
        pinned_lines: Optional[np.ndarray] = None,
        allow_lane: bool = True,
    ) -> List[EmbeddingBatchStats]:
        """Simulate one embedding op over all batches with persistent on-chip
        state; returns per-batch stats.

        ``allow_lane=False`` forces the line-granular path (used by parity
        tests; results are identical when the lane transform applies).
        """
        p = self.prepare_embedding(etrace, pinned_lines, allow_lane)
        return p.finalize(*dram_timing_single(p.request, self.device))


def classify_embedding_many(
    systems: Sequence[MemorySystem],
    etrace: EmbeddingTrace,
    allow_lane: bool = True,
) -> List[ClassifiedStream]:
    """Batched classification across configurations of ONE policy on ONE
    device — the placement-invariant half of ``prepare_embedding_many``.

    All systems must share the same registered policy and device (and carry
    no policy mix); their classification runs through
    ``MemoryPolicy.run_many``, which shares shape-bucket launches and
    analytic passes across them. Per-system results are bit-exact with
    independent ``classify_embedding`` calls.
    """
    if not systems:
        return []
    policy = systems[0].policy
    if any(ms.policy is not policy for ms in systems):
        raise ValueError("classify_embedding_many requires one shared policy")
    if any(ms.device != systems[0].device for ms in systems):
        raise ValueError("classify_embedding_many requires one shared device")
    if any(ms.hw.onchip.policy_mix for ms in systems):
        raise ValueError("policy-mix configs must use the unbatched path")
    preps = [ms._prepare_stream(etrace, None, allow_lane) for ms in systems]
    outs = policy.run_many([p.stream for p in preps], [p.ctx for p in preps])
    return [
        ms._account(etrace, prep, out, None)
        for ms, prep, out in zip(systems, preps, outs)
    ]


def prepare_embedding_many(
    systems: Sequence[MemorySystem],
    etrace: EmbeddingTrace,
    allow_lane: bool = True,
) -> List[PendingEmbedding]:
    """Batched classification across configurations of ONE policy, with DRAM
    timing deferred (``classify_embedding_many`` + per-system packaging)."""
    return [
        ms._pending(etrace, cs)
        for ms, cs in zip(
            systems, classify_embedding_many(systems, etrace, allow_lane)
        )
    ]


def simulate_embedding_many(
    systems: Sequence[MemorySystem],
    etrace: EmbeddingTrace,
    allow_lane: bool = True,
) -> List[List[EmbeddingBatchStats]]:
    """Batched ``simulate_embedding`` across configurations of ONE policy:
    ``prepare_embedding_many`` + one batched DRAM dispatch."""
    pending = prepare_embedding_many(systems, etrace, allow_lane)
    if not pending:
        return []
    return [
        p.finalize(*out)
        for p, out in zip(
            pending,
            dram_timing_many([p.request for p in pending], device=systems[0].device),
        )
    ]


def memory_system_for(hw: HardwareConfig, device: DeviceLike = "cuda") -> MemorySystem:
    """The memory pipeline for a hardware config: the single-core
    ``MemorySystem``. Multi-core clusters are not ported yet."""
    if hw.num_cores == 1 and hw.topology == Topology.PRIVATE:
        return MemorySystem.from_hardware(hw, device)
    raise NotImplementedError(
        "MultiCoreMemorySystem (num_cores > 1 or a shared topology) is not "
        "ported yet (multi-core slice of the port; see ROADMAP.md)"
    )

