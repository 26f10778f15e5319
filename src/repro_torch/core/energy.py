"""Accelergy-style energy estimation (paper Sec. III, "Simulation output").

"We integrate an Accelergy-based energy estimator into EONSim to estimate
energy consumption according to the hardware configuration and operation
counts."

Accelergy's methodology: energy = sum over components of
(action count x per-action energy). Per-action energies below are embedded
(no external tool offline) from published 7nm-class accelerator + HBM2e
numbers (Accelergy/Timeloop tables, ~0.5-4 pJ on-chip, ~3.9 pJ/bit DRAM);
absolute values are configuration inputs, not model outputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .hardware import HardwareConfig


@dataclass(frozen=True)
class EnergyTable:
    """Per-action energies in pJ."""

    mac_bf16: float = 0.8                 # one MAC in the systolic array
    vector_op: float = 0.2                # one VPU lane-op
    onchip_read_per_byte: float = 0.05    # SRAM read, large array
    onchip_write_per_byte: float = 0.06
    offchip_per_byte: float = 31.2        # HBM2e ~3.9 pJ/bit
    leakage_pj_per_cycle: float = 50.0
    # One full page-table walk (NeuMMU-style translation stage): a few
    # dependent DRAM/cache accesses by the walker. TLB *lookups* ride the
    # SRAM numbers above and are not billed separately.
    tlb_walk_pj: float = 120.0


@dataclass
class EnergyBreakdown:
    compute_pj: float = 0.0
    vector_pj: float = 0.0
    onchip_pj: float = 0.0
    offchip_pj: float = 0.0
    leakage_pj: float = 0.0
    translation_pj: float = 0.0   # page-table walks (0.0 without translation)

    @property
    def total_pj(self) -> float:
        return (
            self.compute_pj
            + self.vector_pj
            + self.onchip_pj
            + self.offchip_pj
            + self.leakage_pj
            + self.translation_pj
        )

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_pj": self.compute_pj,
            "vector_pj": self.vector_pj,
            "onchip_pj": self.onchip_pj,
            "offchip_pj": self.offchip_pj,
            "leakage_pj": self.leakage_pj,
            "translation_pj": self.translation_pj,
            "total_pj": self.total_pj,
        }


def estimate_energy(
    hw: HardwareConfig,
    *,
    macs: float,
    vector_ops: float,
    onchip_read_bytes: float,
    onchip_write_bytes: float,
    offchip_bytes: float,
    total_cycles: float,
    tlb_walks: float = 0.0,
    table: EnergyTable = EnergyTable(),
) -> EnergyBreakdown:
    return EnergyBreakdown(
        compute_pj=macs * table.mac_bf16,
        vector_pj=vector_ops * table.vector_op,
        onchip_pj=(
            onchip_read_bytes * table.onchip_read_per_byte
            + onchip_write_bytes * table.onchip_write_per_byte
        ),
        offchip_pj=offchip_bytes * table.offchip_per_byte,
        leakage_pj=total_cycles * table.leakage_pj_per_cycle,
        translation_pj=tlb_walks * table.tlb_walk_pj,
    )
