"""Workload descriptions for EONSim.

The paper's "workload configuration" input (Sec. III):
  * matrix operations in generalized MNK format (M x K input @ N x K weight)
  * embedding vector operations: vector dim, #tables, rows/table, pooling
    factor, vector op (sum/mean/concat), batching hyper-parameters.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence


class VectorOp(str, enum.Enum):
    SUM = "sum"          # embedding bag sum-pooling (DLRM)
    MEAN = "mean"
    CONCAT = "concat"    # no reduction (pure gather, e.g. LM token embedding)
    DOT = "dot"          # similarity scoring (RAG retrieval)


@dataclass(frozen=True)
class MatrixOpSpec:
    """One GEMM in MNK form: (M x K) @ (K x N) -> (M x N)."""

    m: int
    n: int
    k: int
    name: str = "gemm"
    dtype_bytes: int = 2     # bf16 weights/activations by default
    count: int = 1           # repeated instances (e.g. per-layer)

    @property
    def flops(self) -> int:
        return 2 * self.m * self.n * self.k * self.count

    @property
    def input_bytes(self) -> int:
        return self.m * self.k * self.dtype_bytes

    @property
    def weight_bytes(self) -> int:
        return self.k * self.n * self.dtype_bytes

    @property
    def output_bytes(self) -> int:
        return self.m * self.n * self.dtype_bytes


@dataclass(frozen=True)
class EmbeddingOpSpec:
    """One embedding vector operation (paper Fig. 1).

    ``lookups_per_sample`` is the pooling factor: indices gathered per sample
    per table, reduced with ``vector_op``.
    """

    num_tables: int
    rows_per_table: int
    dim: int
    lookups_per_sample: int
    vector_op: VectorOp = VectorOp.SUM
    dtype_bytes: int = 4     # DLRM uses fp32 embedding vectors
    name: str = "embedding"

    @property
    def vector_bytes(self) -> int:
        return self.dim * self.dtype_bytes

    @property
    def table_bytes(self) -> int:
        return self.rows_per_table * self.vector_bytes

    @property
    def total_bytes(self) -> int:
        return self.num_tables * self.table_bytes

    def lookups_per_batch(self, batch_size: int) -> int:
        return batch_size * self.num_tables * self.lookups_per_sample

    def gathered_bytes(self, batch_size: int) -> int:
        return self.lookups_per_batch(batch_size) * self.vector_bytes

    def reduction_flops(self, batch_size: int) -> int:
        """Vector-wise arithmetic after the gather (stage 3 of Fig. 1)."""
        if self.vector_op in (VectorOp.SUM, VectorOp.MEAN):
            per_bag = (self.lookups_per_sample - 1) * self.dim
            return batch_size * self.num_tables * max(per_bag, 0)
        if self.vector_op == VectorOp.DOT:
            return batch_size * self.num_tables * self.lookups_per_sample * 2 * self.dim
        return 0


@dataclass(frozen=True)
class Workload:
    """A full inference/training step: matrix ops + embedding ops + batching."""

    name: str
    matrix_ops: Sequence[MatrixOpSpec] = ()
    embedding_ops: Sequence[EmbeddingOpSpec] = ()
    batch_size: int = 32
    num_batches: int = 1

    @property
    def matrix_flops(self) -> int:
        return sum(op.flops for op in self.matrix_ops)


def dlrm_rmc2_small(
    num_tables: int = 60,
    rows_per_table: int = 1_000_000,
    dim: int = 128,
    lookups: int = 120,
    batch_size: int = 32,
    num_batches: int = 1,
) -> Workload:
    """Paper Table I: DLRM-RMC2-small.

    60 embedding tables, 1M rows/table, 128-dim vectors, 120 lookups/table,
    bottom MLP 256-128-128, top MLP 128-64-1.
    """
    bottom_dims = [256, 128, 128]
    top_dims = [128, 64, 1]

    def mlp_ops(dims, in_dim, prefix):
        ops = []
        d = in_dim
        for i, out in enumerate(dims):
            ops.append(
                MatrixOpSpec(m=batch_size, n=out, k=d, name=f"{prefix}{i}", dtype_bytes=4)
            )
            d = out
        return ops

    # Dense features: 13 continuous inputs -> bottom MLP; interaction output
    # feeds the top MLP (dot-interaction of #tables+1 vectors of dim 128).
    n_vec = num_tables + 1
    interact_dim = n_vec * (n_vec - 1) // 2 + dim
    matrix_ops = (
        mlp_ops(bottom_dims, 13, "bottom_mlp")
        + [
            MatrixOpSpec(
                m=batch_size * n_vec, n=n_vec, k=dim, name="interaction", dtype_bytes=4
            )
        ]
        + mlp_ops(top_dims, interact_dim, "top_mlp")
    )
    embedding = EmbeddingOpSpec(
        num_tables=num_tables,
        rows_per_table=rows_per_table,
        dim=dim,
        lookups_per_sample=lookups,
        vector_op=VectorOp.SUM,
        dtype_bytes=4,
        name="dlrm_embedding",
    )
    return Workload(
        name=f"dlrm_rmc2_small_t{num_tables}_b{batch_size}",
        matrix_ops=tuple(matrix_ops),
        embedding_ops=(embedding,),
        batch_size=batch_size,
        num_batches=num_batches,
    )
