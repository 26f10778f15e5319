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

import numpy as np


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


@dataclass
class ServingResult:
    """One serving scenario's outcome on one hardware config.

    Produced by ``serving.scheduler.simulate_serving``. Deterministic: the
    same scenario + hardware + seed reproduces every field bitwise, latency
    arrays included — ``diff()`` returning ``{}`` is the reproducibility
    assertion used by tests and the serving-smoke CI job.

    ``batch_stats`` is the identity surface: with all robustness policies
    off it is exactly the ``List[EmbeddingBatchStats]`` the plain
    fixed-trace ``simulate_embedding`` path yields for the same lowered
    ``ConcatTrace`` (differential-enforced). Latency/queue/service arrays
    are in completion order, one entry per completed request, in cycles.
    """

    scenario: str
    hardware: str
    policy: str
    clock_ghz: float
    offered: int                  # requests submitted (first attempts)
    completed: int                # requests served to completion
    shed: int                     # admission-control rejections (all attempts)
    timed_out: int                # deadline abandonments while queued
    retries: int                  # client re-submissions scheduled
    abandoned: int                # attempts failed with no retry budget left
    degraded_batches: int
    dropped_cold_rows: int        # lookups truncated by hot_rows_only
    bypassed_lookups: int         # lookups routed around the cache
    num_batches: int
    makespan_cycles: int          # first arrival -> last batch completion
    goodput: float                # in-deadline completions / offered
    latency_cycles: np.ndarray    # int64, completion order
    queue_cycles: np.ndarray      # int64, served attempt's queueing delay
    service_cycles: np.ndarray    # int64, served batch's service time
    batch_stats: List = field(default_factory=list)
    batch_service_cycles: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    batch_start_cycles: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))

    # ---- latency distribution --------------------------------------------
    def latency_percentile(self, q: float) -> float:
        if self.latency_cycles.size == 0:
            return float("nan")
        return float(np.percentile(self.latency_cycles, q))

    @property
    def p50_cycles(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p95_cycles(self) -> float:
        return self.latency_percentile(95.0)

    @property
    def p99_cycles(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def mean_queue_cycles(self) -> float:
        if self.queue_cycles.size == 0:
            return float("nan")
        return float(self.queue_cycles.mean())

    @property
    def mean_service_cycles(self) -> float:
        if self.service_cycles.size == 0:
            return float("nan")
        return float(self.service_cycles.mean())

    # ---- throughput -------------------------------------------------------
    # The scheduler never emits makespan_cycles == 0 (it clamps to >= 1),
    # but externally-constructed / journal-replayed results can carry it —
    # nan, like the other empty-distribution properties, not a raise.
    @property
    def sustained_qps_per_mcycle(self) -> float:
        """Completed requests per million cycles — clock-independent."""
        if self.makespan_cycles == 0:
            return float("nan")
        return self.completed / (self.makespan_cycles / 1e6)

    @property
    def sustained_qps(self) -> float:
        """Completed requests per wall second at ``clock_ghz``."""
        if self.makespan_cycles == 0:
            return float("nan")
        return self.completed / (self.makespan_cycles / (self.clock_ghz * 1e9))

    @property
    def total_cycles(self) -> float:
        """Makespan, under the name ``SweepResult.best``/``speedup_over``
        read off every entry result."""
        return float(self.makespan_cycles)

    def cycles_to_us(self, cycles: float) -> float:
        return cycles / (self.clock_ghz * 1e3)

    # ---- emit -------------------------------------------------------------
    def summary(self) -> Dict:
        return {
            "scenario": self.scenario,
            "hardware": self.hardware,
            "policy": self.policy,
            "offered": self.offered,
            "completed": self.completed,
            "shed": self.shed,
            "timed_out": self.timed_out,
            "retries": self.retries,
            "abandoned": self.abandoned,
            "degraded_batches": self.degraded_batches,
            "dropped_cold_rows": self.dropped_cold_rows,
            "bypassed_lookups": self.bypassed_lookups,
            "num_batches": self.num_batches,
            "makespan_cycles": self.makespan_cycles,
            "total_cycles": self.total_cycles,
            "goodput": self.goodput,
            "p50_cycles": self.p50_cycles,
            "p95_cycles": self.p95_cycles,
            "p99_cycles": self.p99_cycles,
            "mean_queue_cycles": self.mean_queue_cycles,
            "mean_service_cycles": self.mean_service_cycles,
            "sustained_qps_per_mcycle": self.sustained_qps_per_mcycle,
            "sustained_qps": self.sustained_qps,
        }

    def to_json(self, path: Optional[str] = None) -> str:
        payload = {
            "summary": self.summary(),
            "latency_cycles": self.latency_cycles.tolist(),
            "queue_cycles": self.queue_cycles.tolist(),
            "service_cycles": self.service_cycles.tolist(),
            "batch_service_cycles": self.batch_service_cycles.tolist(),
            "batch_start_cycles": self.batch_start_cycles.tolist(),
        }
        text = json.dumps(payload, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def diff(self, other: "ServingResult") -> Dict[str, tuple]:
        """Bitwise comparison: summary fields, per-request arrays, and the
        per-batch memory-system stats. Empty dict == identical results."""
        mismatches: Dict[str, tuple] = {}
        a, b = self.summary(), other.summary()
        for k in a:
            av, bv = a[k], b[k]
            same = (av == bv) or (
                isinstance(av, float) and isinstance(bv, float)
                and np.isnan(av) and np.isnan(bv))
            if not same:
                mismatches[k] = (av, bv)
        for name in ("latency_cycles", "queue_cycles", "service_cycles",
                     "batch_service_cycles", "batch_start_cycles"):
            xa, xb = getattr(self, name), getattr(other, name)
            if xa.shape != xb.shape or not np.array_equal(xa, xb):
                mismatches[name] = (xa.tolist(), xb.tolist())
        if len(self.batch_stats) != len(other.batch_stats):
            mismatches["num_batch_stats"] = (
                len(self.batch_stats), len(other.batch_stats))
            return mismatches
        for i, (sa, sb) in enumerate(zip(self.batch_stats, other.batch_stats)):
            da, db = dataclasses.asdict(sa), dataclasses.asdict(sb)
            if da != db:
                mismatches[f"batch_stats{i}"] = (da, db)
        return mismatches
