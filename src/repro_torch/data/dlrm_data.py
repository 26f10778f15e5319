"""Deterministic synthetic DLRM click-log pipeline (paper's workload).

Sparse indices follow the same Zipf machinery as core.trace (the simulator
and the runtime consume the *same* access distributions — the point of the
paper's hardware-agnostic traces). Labels correlate with hot-feature overlap
so training has signal. Host numpy, equal to the reference's batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..core.trace import generate_zipf_trace


@dataclass(frozen=True)
class DLRMDataConfig:
    num_tables: int
    rows_per_table: int
    lookups_per_table: int
    dense_features: int = 13
    batch_size: int = 32
    zipf_s: float = 1.0
    seed: int = 0


def dlrm_batch(cfg: DLRMDataConfig, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((cfg.seed, step))
    B, T, L = cfg.batch_size, cfg.num_tables, cfg.lookups_per_table
    dense = rng.standard_normal((B, cfg.dense_features)).astype(np.float32)
    idx = generate_zipf_trace(
        B * T * L, cfg.rows_per_table, cfg.zipf_s, seed=int(rng.integers(1 << 31))
    ).reshape(B, T, L)
    # label: clicks correlate with the first dense feature and with how
    # "hot" the accessed rows are — a learnable but non-trivial signal
    hotness = 1.0 / (1.0 + idx.astype(np.float64).mean(axis=(1, 2)) / cfg.rows_per_table)
    z = (hotness - hotness.mean()) / (hotness.std() + 1e-9)
    prob = 1 / (1 + np.exp(-(2.5 * dense[:, 0] + 1.0 * z)))
    labels = (rng.random(B) < prob).astype(np.float32)
    return {"dense": dense, "sparse": idx.astype(np.int32), "labels": labels}
