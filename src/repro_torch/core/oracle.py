"""Independent TPUv6e timing oracle — the "measured hardware" proxy.

The paper validates EONSim against wall-clock TPUv6e measurements (Fig. 3).
No TPUv6e measurements are available offline, so the validation compares
EONSim against THIS model: a closed-form, vector-granular timing model of the
same TPUv6e configuration, written as a separate code path from the engine
(no event scan, no cache machinery, aggregate bandwidth reasoning — the way a
performance engineer would hand-model the chip). Agreement between two
independently-built models of the same machine is the strongest validation
available offline; the residual disagreement is reported as the validation
error, mirroring the paper's sim-vs-hardware metric.

TPUv6e embedding path (paper Sec. IV): single core, no global buffer,
scratchpad staging, "fetching all vectors from off-chip memory regardless of
hotness" — i.e. every lookup is an HBM gather. The TPUv6e here is the
*simulated* NPU (``hardware.tpuv6e``), not the machine the simulator runs on.
A copy of the JAX package's ``repro.core.oracle``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .hardware import HardwareConfig
from .workload import EmbeddingOpSpec, MatrixOpSpec, Workload


@dataclass
class OracleResult:
    embedding_cycles: float
    matrix_cycles: float
    onchip_accesses: int
    offchip_accesses: int

    @property
    def total_cycles(self) -> float:
        return self.embedding_cycles + self.matrix_cycles


def _embedding_cycles(spec: EmbeddingOpSpec, batch_size: int, hw: HardwareConfig) -> float:
    """Closed-form gather time: random vector gathers from HBM.

    A vector spans ``ceil(vec/interleave)`` interleave blocks, each one row
    activate on some bank plus line bursts on that channel's bus; random
    gathers make essentially every block a fresh activate. Per channel the
    bound is max(bus occupancy, activate serialization over banks).
    """
    line = hw.onchip.line_bytes
    off = hw.offchip
    lpv = math.ceil(spec.vector_bytes / line)
    blocks_per_vec = max(1, math.ceil(spec.vector_bytes / off.interleave_bytes))
    n_vec = spec.lookups_per_batch(batch_size)
    n_lines = n_vec * lpv
    n_blocks = n_vec * blocks_per_vec

    bus_cyc = line / off.channel_bytes_per_cycle(hw.clock_ghz)
    act = off.t_rp_cycles + off.t_rcd_cycles
    lines_per_chan = n_lines / off.channels
    blocks_per_bank = n_blocks / (off.channels * off.banks_per_channel)
    lines_per_bank = n_lines / (off.channels * off.banks_per_channel)
    bus_bound = lines_per_chan * bus_cyc
    bank_bound = blocks_per_bank * act + lines_per_bank * bus_cyc
    mem = max(bus_bound, bank_bound) + off.base_latency_cycles + off.t_cas_cycles

    pool_flops = spec.reduction_flops(batch_size)
    compute = pool_flops / max(hw.vector_unit.throughput, 1)
    return max(mem, compute)


def _matrix_cycles(op: MatrixOpSpec, hw: HardwareConfig) -> float:
    """Roofline max(compute, memory) per GEMM — deliberately simpler than the
    engine's systolic fold model."""
    mu = hw.matrix_unit
    peak_macs = mu.rows * mu.cols
    compute = op.flops / 2 / peak_macs
    d = op.input_bytes + op.weight_bytes + op.output_bytes
    mem = d / hw.offchip.bytes_per_cycle(hw.clock_ghz) + hw.offchip.base_latency_cycles
    return max(compute, mem) * op.count


def oracle_run(workload: Workload, hw: HardwareConfig) -> OracleResult:
    """TPUv6e-proxy execution time for the workload (per the SPM config)."""
    emb = sum(
        _embedding_cycles(spec, workload.batch_size, hw)
        for spec in workload.embedding_ops
    ) * workload.num_batches
    mat = sum(_matrix_cycles(op, hw) for op in workload.matrix_ops) * workload.num_batches

    line = hw.onchip.line_bytes
    onchip = 0
    offchip = 0
    for spec in workload.embedding_ops:
        lpv = math.ceil(spec.vector_bytes / line)
        n_lines = spec.lookups_per_batch(workload.batch_size) * lpv * workload.num_batches
        offchip += n_lines          # every vector fetched from HBM
        onchip += 2 * n_lines       # staged write + consumed read
    for op in workload.matrix_ops:
        d_in = op.input_bytes + op.weight_bytes
        d_out = op.output_bytes
        offchip += math.ceil((d_in + d_out) / line) * op.count * workload.num_batches
        onchip += (
            math.ceil(d_in / line) + math.ceil((d_in + d_out) / line)
        ) * op.count * workload.num_batches
    return OracleResult(
        embedding_cycles=emb,
        matrix_cycles=mat,
        onchip_accesses=onchip,
        offchip_accesses=offchip,
    )
