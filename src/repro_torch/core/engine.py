"""EONSim simulation entry point (paper Fig. 2 "Simulation" stage).

Pipeline per the paper:
  index trace  ->  full trace (workload config)  ->  address trace (memory
  config)  ->  on-chip policy classification (hits / miss trace)  ->  DRAM
  timing for misses  ->  per-batch timing + access counts + energy.

The embedding memory path (classification, lane transform, segmented DRAM
timing, per-batch attribution) lives in ``memory.system.MemorySystem``; this
module drives it, runs the analytical matrix model, and assembles results.
Matrix ops run through the analytical model (matrix_model.py) and are summed
with embedding time per batch (DLRM: embedding gather/pool feeds interaction
and the top MLP — dependent stages, so times add).

On-chip state persists across inference batches: the policy simulation runs
once over the concatenated multi-batch trace and timing/counts are attributed
per batch afterwards.

The trace-building / matrix-summary / result-assembly stages are exposed
separately so a caller can share generated traces and matrix results across
many configurations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from .energy import EnergyTable, estimate_energy
from .hardware import HardwareConfig
from .matrix_model import simulate_matrix_op
from .profiling import stage
from .memory.system import (
    EmbeddingBatchStats,
    EmbeddingTrace,
    memory_system_for,
)
from .results import BatchResult, SimResult
from .trace import FullTrace, expand_trace, generate_zipf_trace
from .workload import EmbeddingOpSpec, Workload

__all__ = [
    "MatrixSummary",
    "assemble_result",
    "build_embedding_traces",
    "simulate",
    "simulate_embedding_op",
    "summarize_matrix_ops",
]


def simulate_embedding_op(
    spec: EmbeddingOpSpec,
    traces: List[FullTrace],
    hw: HardwareConfig,
    pinned_lines: Optional[np.ndarray] = None,
    *,
    device: DeviceLike = "cuda",
) -> List[EmbeddingBatchStats]:
    """Simulate one embedding op over ``len(traces)`` inference batches.

    Returns per-batch stats; on-chip state persists across batches (the
    policy runs once over the concatenated trace).
    """
    ms = memory_system_for(hw, device)
    return ms.simulate_embedding(EmbeddingTrace(spec, traces), pinned_lines=pinned_lines)


# --------------------------------------------------------------------------
# Matrix side (analytical, identical per batch)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MatrixSummary:
    """Per-batch matrix-op aggregates (analytical model, batch-invariant)."""

    cycles: float
    onchip_reads: int
    onchip_writes: int
    dram_lines: int
    macs_per_batch: float


def summarize_matrix_ops(workload: Workload, hw: HardwareConfig) -> MatrixSummary:
    results = [simulate_matrix_op(op, hw) for op in workload.matrix_ops]
    return MatrixSummary(
        cycles=sum(r.total_cycles for r in results),
        onchip_reads=sum(r.onchip_reads for r in results),
        onchip_writes=sum(r.onchip_writes for r in results),
        dram_lines=sum(
            math.ceil(r.dram_bytes / hw.onchip.line_bytes) for r in results
        ),
        macs_per_batch=sum(r.flops for r in results) / 2,
    )


# --------------------------------------------------------------------------
# Trace building (hardware-independent; shared across sweep configs)
# --------------------------------------------------------------------------

def build_embedding_traces(
    workload: Workload,
    index_trace: Optional[np.ndarray] = None,
    seed: int = 0,
    zipf_s: float = 0.8,
) -> List[EmbeddingTrace]:
    """Build one multi-batch ``EmbeddingTrace`` per embedding op spec.

    Deterministic in ``(workload, index_trace, seed, zipf_s)`` and independent
    of the hardware config — the basis for trace sharing across a DSE sweep.
    """
    with stage("trace_gen"):
        etraces: List[EmbeddingTrace] = []
        for spec in workload.embedding_ops:
            traces = []
            for bi in range(workload.num_batches):
                if index_trace is None:
                    n_acc = spec.lookups_per_batch(workload.batch_size)
                    it = generate_zipf_trace(
                        n_acc, spec.rows_per_table, s=zipf_s, seed=seed + bi
                    )
                else:
                    it = index_trace
                traces.append(
                    expand_trace(it, spec, workload.batch_size, seed=seed + bi)
                )
            etraces.append(EmbeddingTrace(spec, traces))
        return etraces


# --------------------------------------------------------------------------
# Result assembly
# --------------------------------------------------------------------------

def assemble_result(
    workload: Workload,
    hw: HardwareConfig,
    matrix: MatrixSummary,
    per_spec_stats: List[List[EmbeddingBatchStats]],
    energy_table: EnergyTable = EnergyTable(),
) -> SimResult:
    result = SimResult(
        workload=workload.name,
        hardware=hw.name,
        policy=hw.onchip.policy.value,
        clock_ghz=hw.clock_ghz,
        num_cores=hw.num_cores,
        topology=hw.topology.value,
    )
    total_vec_ops = 0.0
    for bi in range(workload.num_batches):
        br = BatchResult(batch_index=bi)
        br.matrix_cycles = matrix.cycles
        br.onchip_reads = matrix.onchip_reads
        br.onchip_writes = matrix.onchip_writes
        br.offchip_reads = matrix.dram_lines
        for spec, stats in zip(workload.embedding_ops, per_spec_stats):
            s = stats[bi]
            br.embedding_cycles += s.cycles
            br.onchip_reads += s.onchip_reads
            br.onchip_writes += s.onchip_writes
            br.offchip_reads += s.offchip_reads
            br.cache_hits += s.cache_hits
            br.cache_misses += s.cache_misses
            br.dram_row_hits += s.dram_row_hits
            br.dram_row_misses += s.dram_row_misses
            br.tlb_hits += s.tlb_hits
            br.tlb_misses += s.tlb_misses
            br.tlb_walks += s.tlb_walks
            br.translation_cycles += s.translation_cycles
            br.vector_ops += int(spec.reduction_flops(workload.batch_size))
        br.total_cycles = br.embedding_cycles + matrix.cycles
        total_vec_ops += br.vector_ops
        result.batches.append(br)

    line = hw.onchip.line_bytes
    energy = estimate_energy(
        hw,
        macs=matrix.macs_per_batch * workload.num_batches,
        vector_ops=total_vec_ops,
        onchip_read_bytes=result.onchip_reads * line,
        onchip_write_bytes=result.onchip_writes * line,
        offchip_bytes=result.offchip_reads * line,
        total_cycles=result.total_cycles,
        tlb_walks=float(result.tlb_walks),
        table=energy_table,
    )
    result.energy_pj = energy.total_pj
    return result


# --------------------------------------------------------------------------
# Full-workload simulation
# --------------------------------------------------------------------------

def simulate(
    workload: Workload,
    hw: HardwareConfig,
    index_trace: Optional[np.ndarray] = None,
    seed: int = 0,
    energy_table: EnergyTable = EnergyTable(),
    zipf_s: float = 0.8,
    *,
    device: DeviceLike = "cuda",
) -> SimResult:
    """Run a full EONSim simulation: all batches, matrix + embedding ops.

    The cache engines and the DRAM event scan run on ``device``: the CUDA
    card by default (raises when there is none), the CPU only when asked.
    """
    ms = memory_system_for(hw, resolve_device(device))
    matrix = summarize_matrix_ops(workload, hw)
    etraces = build_embedding_traces(workload, index_trace, seed, zipf_s)
    per_spec_stats = [ms.simulate_embedding(et) for et in etraces]
    return assemble_result(workload, hw, matrix, per_spec_stats, energy_table)
