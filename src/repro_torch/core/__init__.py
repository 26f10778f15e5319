"""EONSim core on PyTorch: the NPU simulator that models both matrix and
embedding vector operations over a configurable memory hierarchy."""

from .hardware import (
    CACHE_BACKENDS,
    CHANNEL_AFFINITIES,
    Dataflow,
    HardwareConfig,
    LookupSharding,
    MatrixUnit,
    OffChipMemory,
    OnChipMemory,
    OnChipPolicy,
    PLACEMENTS,
    TLB_REPLACEMENTS,
    Topology,
    TranslationConfig,
    VectorUnit,
    tpuv6e,
)
from .workload import (
    EmbeddingOpSpec,
    MatrixOpSpec,
    VectorOp,
    Workload,
    dlrm_rmc2_small,
)
from .engine import simulate, simulate_embedding_op
from .memory import (
    MemoryPolicy,
    MemorySystem,
    available_policies,
    get_policy,
    memory_system_for,
    register_policy,
)
from .results import BatchResult, SimResult
from .faults import (
    CheckpointLockedError,
    FaultEvent,
    FaultPlan,
    FaultTelemetry,
    FaultTolerance,
    FaultToleranceExhausted,
    ShardEvaluationError,
)
from .sweep import SweepConfig, SweepEntry, SweepResult, grid_configs, sweep
from .sweep_ckpt import SweepCheckpoint
from .search import SearchResult, pareto_front, search

__all__ = [
    "CACHE_BACKENDS",
    "CHANNEL_AFFINITIES",
    "Dataflow",
    "HardwareConfig",
    "LookupSharding",
    "PLACEMENTS",
    "TLB_REPLACEMENTS",
    "Topology",
    "TranslationConfig",
    "MatrixUnit",
    "OffChipMemory",
    "OnChipMemory",
    "OnChipPolicy",
    "VectorUnit",
    "tpuv6e",
    "EmbeddingOpSpec",
    "MatrixOpSpec",
    "VectorOp",
    "Workload",
    "dlrm_rmc2_small",
    "simulate",
    "simulate_embedding_op",
    "BatchResult",
    "SimResult",
    "MemoryPolicy",
    "MemorySystem",
    "available_policies",
    "get_policy",
    "memory_system_for",
    "register_policy",
    "CheckpointLockedError",
    "FaultEvent",
    "FaultPlan",
    "FaultTelemetry",
    "FaultTolerance",
    "FaultToleranceExhausted",
    "ShardEvaluationError",
    "SweepConfig",
    "SweepEntry",
    "SweepResult",
    "SweepCheckpoint",
    "SearchResult",
    "grid_configs",
    "pareto_front",
    "search",
    "sweep",
]
