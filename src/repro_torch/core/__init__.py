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
]
