"""Analytical matrix-operation model (paper Sec. III, "Simulation flow").

"For matrix operations, EONSim integrates an analytical performance model
from prior work [SCALE-Sim, LLMCompass]. This approach combines a
SCALE-Sim-based model for computation cycles with an analytical model for
memory operation cycles. The memory model calculates the data transfer time
T = D/B + L."

Compute cycles follow SCALE-Sim's systolic-array timing:

  Weight-stationary (R x C array, GEMM (M,K)@(K,N)):
    folds = ceil(K/R) * ceil(N/C); per fold a K_t x N_t weight tile loads in
    K_t cycles, then M activations stream through with pipeline skew:
      t_fold = K_t + M + K_t + C_t - 2   (fill + stream + drain)

  Output-stationary:
    folds = ceil(M/R) * ceil(N/C); K streams:
      t_fold = K + R_t + C_t - 2  (+ R_t drain for accumulator read-out)

Memory cycles use T = D/B + L per tile, double-buffered against compute
(max(compute, memory) steady state + prologue) — the paper's SPM baseline
for matrix tiles.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .hardware import Dataflow, HardwareConfig
from .memory.dram import bulk_transfer_cycles
from .workload import MatrixOpSpec


@dataclass(frozen=True)
class MatrixOpResult:
    name: str
    compute_cycles: float
    memory_cycles: float
    total_cycles: float
    flops: int
    dram_bytes: int
    onchip_reads: int            # line-granular on-chip reads (operands)
    onchip_writes: int           # line-granular on-chip writes (fills + outputs)

    @property
    def utilization(self) -> float:
        """Achieved MAC utilization vs ideal (flops / (2*macs*cycles))."""
        return self.flops / max(self.total_cycles, 1e-9)


def _ws_fold_cycles(k_t: int, c_t: int, m: int) -> float:
    # fill K_t rows of weights, stream M rows with K_t+C_t-2 skew/drain
    return k_t + m + k_t + c_t - 2


def _os_fold_cycles(r_t: int, c_t: int, k: int) -> float:
    return k + r_t + c_t - 2 + r_t


def matrix_compute_cycles(op: MatrixOpSpec, hw: HardwareConfig) -> float:
    mu = hw.matrix_unit
    R, C = mu.rows, mu.cols
    M, N, K = op.m, op.n, op.k
    if mu.dataflow == Dataflow.WS:
        folds_k = math.ceil(K / R)
        folds_n = math.ceil(N / C)
        # last-fold tiles may be ragged; model exactly by summing edge tiles
        total = 0.0
        for ik in range(folds_k):
            k_t = min(R, K - ik * R)
            for in_ in range(folds_n):
                c_t = min(C, N - in_ * C)
                total += _ws_fold_cycles(k_t, c_t, M)
        return total * op.count
    else:  # OS
        folds_m = math.ceil(M / R)
        folds_n = math.ceil(N / C)
        total = 0.0
        for im in range(folds_m):
            r_t = min(R, M - im * R)
            for in_ in range(folds_n):
                c_t = min(C, N - in_ * C)
                total += _os_fold_cycles(r_t, c_t, K)
        return total * op.count


def matrix_memory_cycles(op: MatrixOpSpec, hw: HardwareConfig) -> float:
    """T = D/B + L per operand tile, summed (weights + inputs + outputs)."""
    d_total = op.input_bytes + op.weight_bytes + op.output_bytes
    return bulk_transfer_cycles(d_total, hw) * op.count


def simulate_matrix_op(op: MatrixOpSpec, hw: HardwareConfig) -> MatrixOpResult:
    comp = matrix_compute_cycles(op, hw)
    mem = matrix_memory_cycles(op, hw)
    # Double buffering overlaps tile fetch with compute: steady state is
    # bounded by the slower of the two; the first tile fetch is exposed.
    mu = hw.matrix_unit
    folds = max(
        1,
        math.ceil(op.k / mu.rows) * math.ceil(op.n / mu.cols)
        if mu.dataflow == Dataflow.WS
        else math.ceil(op.m / mu.rows) * math.ceil(op.n / mu.cols),
    )
    prologue = mem / max(folds, 1)  # first tile's fetch is not hidden
    total = prologue + max(comp, mem)
    line = hw.onchip.line_bytes
    d_in = op.input_bytes + op.weight_bytes
    d_out = op.output_bytes
    return MatrixOpResult(
        name=op.name,
        compute_cycles=comp,
        memory_cycles=mem,
        total_cycles=total,
        flops=op.flops,
        dram_bytes=(d_in + d_out) * op.count,
        onchip_reads=math.ceil(d_in / line) * op.count,
        onchip_writes=math.ceil((d_in + d_out) / line) * op.count,
    )
