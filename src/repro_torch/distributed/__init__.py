"""Scaling the DSE sweep across devices: the memo-key sharding of
``core.sweep`` (``sweep_shard``). The model-sharding modules of the JAX
package (``sharding``, ``collective_matmul``) are not ported yet."""
from .sweep_shard import (
    ShardPlan,
    evaluate_sharded,
    partition_by_class_key,
    resolve_shard_plan,
    shard_key_totals,
)

__all__ = [
    "ShardPlan",
    "evaluate_sharded",
    "partition_by_class_key",
    "resolve_shard_plan",
    "shard_key_totals",
]
