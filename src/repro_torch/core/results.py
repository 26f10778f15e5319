"""Simulation result containers + CSV/JSON emit (paper "Simulation output").

"EONSim outputs both overall and per-batch results. Each result consists of
various metrics, including execution time, the on-chip and off-chip memory
access ratio, and the operation count for each memory and vector operation."
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class BatchResult:
    batch_index: int
    embedding_cycles: float = 0.0
    matrix_cycles: float = 0.0
    total_cycles: float = 0.0
    onchip_reads: int = 0
    onchip_writes: int = 0
    offchip_reads: int = 0
    vector_ops: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    dram_row_hits: int = 0
    dram_row_misses: int = 0
    # Address-translation detail (all zero when hw.translation is None).
    tlb_hits: int = 0
    tlb_misses: int = 0
    tlb_walks: int = 0
    translation_cycles: float = 0.0

    @property
    def onchip_accesses(self) -> int:
        return self.onchip_reads + self.onchip_writes

    @property
    def onchip_ratio(self) -> float:
        total = self.onchip_accesses + self.offchip_reads
        return self.onchip_accesses / max(total, 1)


@dataclass
class SimResult:
    workload: str
    hardware: str
    policy: str
    batches: List[BatchResult] = field(default_factory=list)
    energy_pj: float = 0.0
    clock_ghz: float = 1.0
    num_cores: int = 1
    topology: str = "private"

    # ---- aggregates -------------------------------------------------------
    @property
    def total_cycles(self) -> float:
        return sum(b.total_cycles for b in self.batches)

    @property
    def total_seconds(self) -> float:
        return self.total_cycles / (self.clock_ghz * 1e9)

    @property
    def embedding_cycles(self) -> float:
        return sum(b.embedding_cycles for b in self.batches)

    @property
    def matrix_cycles(self) -> float:
        return sum(b.matrix_cycles for b in self.batches)

    @property
    def onchip_reads(self) -> int:
        return sum(b.onchip_reads for b in self.batches)

    @property
    def onchip_writes(self) -> int:
        return sum(b.onchip_writes for b in self.batches)

    @property
    def onchip_accesses(self) -> int:
        return sum(b.onchip_accesses for b in self.batches)

    @property
    def offchip_reads(self) -> int:
        return sum(b.offchip_reads for b in self.batches)

    @property
    def onchip_ratio(self) -> float:
        total = self.onchip_accesses + self.offchip_reads
        return self.onchip_accesses / max(total, 1)

    @property
    def cache_hits(self) -> int:
        return sum(b.cache_hits for b in self.batches)

    @property
    def cache_misses(self) -> int:
        return sum(b.cache_misses for b in self.batches)

    @property
    def tlb_hits(self) -> int:
        return sum(b.tlb_hits for b in self.batches)

    @property
    def tlb_misses(self) -> int:
        return sum(b.tlb_misses for b in self.batches)

    @property
    def tlb_walks(self) -> int:
        return sum(b.tlb_walks for b in self.batches)

    @property
    def translation_cycles(self) -> float:
        return sum(b.translation_cycles for b in self.batches)

    def summary(self) -> Dict:
        return {
            "workload": self.workload,
            "hardware": self.hardware,
            "policy": self.policy,
            "num_cores": self.num_cores,
            "topology": self.topology,
            "total_cycles": self.total_cycles,
            "total_seconds": self.total_seconds,
            "embedding_cycles": self.embedding_cycles,
            "matrix_cycles": self.matrix_cycles,
            "onchip_reads": self.onchip_reads,
            "onchip_writes": self.onchip_writes,
            "offchip_reads": self.offchip_reads,
            "onchip_ratio": self.onchip_ratio,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "tlb_hits": self.tlb_hits,
            "tlb_misses": self.tlb_misses,
            "tlb_walks": self.tlb_walks,
            "translation_cycles": self.translation_cycles,
            "energy_pj": self.energy_pj,
            "num_batches": len(self.batches),
        }

    def to_json(self, path: Optional[str] = None) -> str:
        payload = {
            "summary": self.summary(),
            "batches": [dataclasses.asdict(b) for b in self.batches],
        }
        text = json.dumps(payload, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def diff(self, other: "SimResult") -> Dict[str, tuple]:
        """Field-by-field comparison of summaries + per-batch records.

        Returns ``{field: (self_value, other_value)}`` for every mismatching
        field — empty when the two results are bit-exact. Used by the DSE
        sweep's parity tests against independent ``simulate()`` runs.
        """
        mismatches: Dict[str, tuple] = {}
        a, b = self.summary(), other.summary()
        for k in a:
            if a[k] != b[k]:
                mismatches[k] = (a[k], b[k])
        if len(self.batches) != len(other.batches):
            mismatches["num_batch_records"] = (len(self.batches), len(other.batches))
            return mismatches
        for i, (ba, bb) in enumerate(zip(self.batches, other.batches)):
            da, db = dataclasses.asdict(ba), dataclasses.asdict(bb)
            for k in da:
                if da[k] != db[k]:
                    mismatches[f"batch{i}.{k}"] = (da[k], db[k])
        return mismatches

    @staticmethod
    def csv_header() -> str:
        return (
            "workload,hardware,policy,total_cycles,total_seconds,"
            "onchip_accesses,offchip_reads,onchip_ratio,cache_hits,cache_misses,energy_pj"
        )

    def to_csv_row(self) -> str:
        s = self.summary()
        return (
            f'{s["workload"]},{s["hardware"]},{s["policy"]},{s["total_cycles"]:.0f},'
            f'{s["total_seconds"]:.6e},{self.onchip_accesses},{s["offchip_reads"]},'
            f'{s["onchip_ratio"]:.4f},{s["cache_hits"]},{s["cache_misses"]},{s["energy_pj"]:.3e}'
        )
