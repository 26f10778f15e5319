"""Distribution: the sharding rules of the models (``sharding``: partition
specs per architecture, DTensor placements on a ``DeviceMesh``, the in-model
hints), the overlapped collective matmul (``collective_matmul``) and the
memo-key sharding of the DSE sweep (``sweep_shard``)."""
from .sharding import (
    NamedSharding,
    PartitionSpec,
    batch_spec,
    kv_cache_spec,
    make_sharding,
    param_specs,
    tree_shardings,
)
from .sweep_shard import (
    ShardPlan,
    evaluate_sharded,
    partition_by_class_key,
    resolve_shard_plan,
    shard_key_totals,
)

__all__ = [
    "NamedSharding",
    "PartitionSpec",
    "ShardPlan",
    "batch_spec",
    "evaluate_sharded",
    "kv_cache_spec",
    "make_sharding",
    "param_specs",
    "partition_by_class_key",
    "resolve_shard_plan",
    "shard_key_totals",
    "tree_shardings",
]
