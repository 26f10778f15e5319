"""Hardware configuration for EONSim.

Mirrors the paper's three input categories (Sec. III, "Simulation input"):
  * accelerator-level parameters  (clock, #cores, memory hierarchy)
  * core settings                 (vector / matrix units)
  * memory system parameters      (capacity, latency, bandwidth, granularity)

All timing inside the simulator is in *core cycles*; helpers convert to
seconds through ``clock_ghz``.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field


class OnChipPolicy(str, enum.Enum):
    """On-chip memory management policy (paper Sec. III / IV)."""

    SPM = "spm"            # scratchpad staging, double-buffered (TPU baseline)
    LRU = "lru"            # cache mode, LRU replacement
    SRRIP = "srrip"        # cache mode, SRRIP replacement (MTIA LLC-like)
    FIFO = "fifo"          # cache mode, FIFO replacement
    PINNING = "pinning"    # "Profiling": pin hottest vectors up to capacity


class Dataflow(str, enum.Enum):
    WS = "ws"              # weight stationary
    OS = "os"              # output stationary


class Topology(str, enum.Enum):
    """Multi-core on-chip memory topology.

    PRIVATE — each core owns an ``OnChipMemory`` of the configured size and
    classifies only its own lookup shard (ONNXim-style per-core scratchpad).
    SHARED  — one last-level on-chip memory of the configured size serves the
    interleaved lookup stream of every core (MTIA LLC-like).
    """

    PRIVATE = "private"
    SHARED = "shared"


class LookupSharding(str, enum.Enum):
    """How embedding lookups are distributed across cores (trace.py)."""

    BATCH = "batch"            # round-robin over batch samples (data parallel)
    TABLE_HASH = "table_hash"  # hash table_id -> core (model parallel)


# DRAM channel-affinity modes (NUMA-style routing of embedding miss traffic):
#   "symmetric" — every request may use every channel (classic interleaved
#                 DRAM; the default and the historical engine behaviour).
#   "per_core"  — channels partition into ``num_cores`` strided groups and
#                 core c's requests route ONLY to group c's channels (private
#                 memory channels per core, ONNXim/TensorDIMM-style NUMA).
#                 Routing is by REQUESTER: a row touched by two cores is
#                 homed in both cores' groups, i.e. the model assumes
#                 per-core-private replicas of shared data (free of storage/
#                 coherence cost). Pair it with table_hash sharding, where
#                 requester == owner and nothing is shared; for a single-copy
#                 home under batch sharding use "per_table" instead.
#   "per_table" — requests route to the channel group owned by their TABLE
#                 (hash(table_id) -> group, the same hash as table_hash
#                 lookup sharding), regardless of the issuing core — the
#                 single-copy data-home placement.
# Affinity changes WHERE miss traffic lands, never how much of it there is —
# classification is upstream and untouched. The degenerate "symmetric" mode
# is bitwise identical to the pre-placement engine (test-enforced).
CHANNEL_AFFINITIES = ("symmetric", "per_core", "per_table")

# Embedding-row placement within the affine channel group:
#   "interleave"    — block-granular striping across the group's channels
#                     (the classic layout; identity under "symmetric").
#   "table_rank"    — TensorDIMM-style per-rank table placement: each table
#                     is homed to ONE rank (modelled as a bank index) of its
#                     group's channels; its blocks stripe across the group's
#                     channels but stay within that rank, maximizing per-table
#                     row-buffer locality and isolating tables from each
#                     other's row conflicts.
#   "hot_replicate" — "table_rank" for cold rows + the hottest vectors
#                     replicated across every (channel, rank) of the group so
#                     hot traffic stripes at full width (TensorDIMM's hot-
#                     embedding replication); the hot set is profiled from
#                     the trace deterministically.
PLACEMENTS = ("interleave", "table_rank", "hot_replicate")


# Cache-engine backends for the simulator's set-associative classification
# (memory/cache.py):
#   "scan"         — the sequential reference engine: a torch loop over the
#                    padded sub-trace, vectorised over the set-group rows.
#   "pallas"       — the cache-scan kernel (kernels/cache_scan.py; CUDA on
#                    the card, its plain torch version on the CPU). The name
#                    is kept so one configuration drives both packages.
#   "stack"        — analytic engines (the default): LRU via the
#                    stack-distance engine (memory/stack.py; one sort-based
#                    distance pass per (stream, num_sets) classifies EVERY
#                    associativity), srrip/fifo via the compressed per-set
#                    engines (memory/rrip.py; shared presort per (stream,
#                    num_sets), short per-set row scans on the kernel D2).
#   "stack_pallas" — like "stack", but the LRU distance pass runs the
#                    stack-distance kernel (kernels/stack_distance.py);
#                    identical to "stack" for srrip/fifo.
# Every backend is bit-exact against the golden model — the knob trades
# execution strategy, never results.
CACHE_BACKENDS = ("scan", "pallas", "stack", "stack_pallas")

# TLB replacement policies the analytic translation engine supports
# (memory/tlb.py): LRU via the stack-distance engine, FIFO via the
# compressed per-set engine — the same machinery as the on-chip cache.
TLB_REPLACEMENTS = ("lru", "fifo")


@dataclass(frozen=True)
class TranslationConfig:
    """NeuMMU-style address-translation stage (PAPERS.md, arXiv:1911.06859).

    Embedding gathers are the worst case for NPU address translation —
    irregular, data-dependent, TLB-hostile — so the simulator models a
    central MMU at the memory-controller side of the hierarchy: every
    off-chip miss line is translated through a set-associative L1 TLB
    (``entries`` x ``ways`` over ``page_bytes`` pages), optionally backed
    by a unified L2 TLB; L1 misses pay the L2 lookup, L2 misses pay a full
    ``walk_latency_cycles`` page-table walk. Translation is a *pure trace
    transform* between row classification and DRAM request construction
    (the ``trace.PlacementMap`` mold), so it composes untouched with every
    cache backend, placement policy, cluster topology, and the serving
    path. ``HardwareConfig.translation = None`` (the default) is the exact
    identity — differential-enforced, like every prior axis.

    Build through ``HardwareConfig.with_translation`` for the same
    validation-at-construction posture as the other axes.
    """

    entries: int = 64                 # L1 TLB entries
    ways: int = 4                     # L1 associativity
    page_bytes: int = 4096            # translation granularity
    walk_latency_cycles: int = 100    # full page-table walk (charged per walk)
    l2_entries: int = 0               # 0 = no L2 TLB
    l2_ways: int = 8
    l2_latency_cycles: int = 8        # L2 lookup, charged per L1 miss
    replacement: str = "lru"

    def __post_init__(self) -> None:
        if self.entries < 1:
            raise ValueError(f"TLB entries must be >= 1, got {self.entries}")
        if self.ways < 1:
            raise ValueError(f"TLB ways must be >= 1, got {self.ways}")
        if self.entries % self.ways:
            raise ValueError(
                f"TLB entries ({self.entries}) must be a multiple of "
                f"ways ({self.ways})")
        if self.page_bytes < 1 or (self.page_bytes & (self.page_bytes - 1)):
            raise ValueError(
                f"page_bytes must be a power of two, got {self.page_bytes}")
        if self.walk_latency_cycles < 0:
            raise ValueError("walk_latency_cycles must be >= 0")
        if self.l2_entries < 0:
            raise ValueError("l2_entries must be >= 0")
        if self.l2_entries:
            if self.l2_ways < 1:
                raise ValueError(f"l2_ways must be >= 1, got {self.l2_ways}")
            if self.l2_entries % self.l2_ways:
                raise ValueError(
                    f"l2_entries ({self.l2_entries}) must be a multiple of "
                    f"l2_ways ({self.l2_ways})")
        if self.l2_latency_cycles < 0:
            raise ValueError("l2_latency_cycles must be >= 0")
        if self.replacement not in TLB_REPLACEMENTS:
            raise ValueError(
                f"unknown TLB replacement {self.replacement!r}; "
                f"options: {TLB_REPLACEMENTS}")

    @property
    def num_sets(self) -> int:
        return max(1, self.entries // self.ways)

    @property
    def l2_num_sets(self) -> int:
        return max(1, self.l2_entries // self.l2_ways) if self.l2_entries else 0

    @property
    def reach_bytes(self) -> int:
        """Address span one full L1 TLB maps (entries x page size)."""
        return self.entries * self.page_bytes

    @property
    def miss_latency_cycles(self) -> int:
        """Cycles an L1-missing, fully-cold translation costs (the L2
        lookup when an L2 exists, plus the page walk)."""
        return self.walk_latency_cycles + (
            self.l2_latency_cycles if self.l2_entries else 0)

    @property
    def key(self) -> tuple:
        """Canonical value tuple (sweep memo keys / checkpoint
        fingerprints); ``from_key`` inverts it."""
        return (
            int(self.entries), int(self.ways), int(self.page_bytes),
            int(self.walk_latency_cycles), int(self.l2_entries),
            int(self.l2_ways), int(self.l2_latency_cycles),
            str(self.replacement),
        )

    @classmethod
    def from_key(cls, key: tuple) -> "TranslationConfig":
        return cls(*key)


@dataclass(frozen=True)
class MatrixUnit:
    """Systolic array description (SCALE-Sim-compatible)."""

    rows: int = 256
    cols: int = 256
    dataflow: Dataflow = Dataflow.WS

    @property
    def macs(self) -> int:
        return self.rows * self.cols


@dataclass(frozen=True)
class VectorUnit:
    """TPU-style VPU: ``lanes`` ALUs x ``sublanes`` (8x128 on TPU)."""

    lanes: int = 128
    sublanes: int = 8
    ops_per_cycle_per_lane: int = 1

    @property
    def throughput(self) -> int:
        """Elementwise ops per cycle."""
        return self.lanes * self.sublanes * self.ops_per_cycle_per_lane


@dataclass(frozen=True)
class OnChipMemory:
    """Local (per-core) on-chip memory."""

    capacity_bytes: int = 128 * 1024 * 1024   # 128 MB (TPUv6e local buffer)
    line_bytes: int = 64                      # access granularity
    ways: int = 16                            # associativity in cache mode
    latency_cycles: int = 8
    # on-chip SRAM streams far faster than HBM (~7.7 TB/s at 0.94 GHz)
    read_bw_bytes_per_cycle: int = 8192
    write_bw_bytes_per_cycle: int = 8192
    policy: OnChipPolicy = OnChipPolicy.SPM
    # Per-table policy mix: ((table_id, policy_name), ...) pairs; tables not
    # listed fall back to ``policy``. Kept as a sorted tuple so the config
    # stays hashable (sweep memoization keys include it). Build through
    # ``HardwareConfig.with_policy_mix`` rather than by hand.
    policy_mix: "tuple[tuple[int, str], ...] | None" = None

    @property
    def num_lines(self) -> int:
        return self.capacity_bytes // self.line_bytes

    @property
    def num_sets(self) -> int:
        return max(1, self.num_lines // self.ways)


@dataclass(frozen=True)
class OffChipMemory:
    """Off-chip (HBM/DRAM) parameters — DRAMSim-lite inputs."""

    capacity_bytes: int = 32 * (1 << 30)      # 32 GB (TPUv6e)
    bandwidth_gbps: float = 1600.0            # GB/s aggregate
    channels: int = 16
    banks_per_channel: int = 8
    row_bytes: int = 2048                     # row-buffer size
    interleave_bytes: int = 512               # channel-interleave granularity
    t_cas_cycles: int = 22                    # row-hit latency (core cycles)
    t_rcd_cycles: int = 22
    t_rp_cycles: int = 22
    base_latency_cycles: int = 120            # controller + interconnect overhead

    def bytes_per_cycle(self, clock_ghz: float) -> float:
        return self.bandwidth_gbps / clock_ghz  # GB/s / Gcycle/s = B/cycle

    def channel_bytes_per_cycle(self, clock_ghz: float) -> float:
        return self.bytes_per_cycle(clock_ghz) / self.channels


@dataclass(frozen=True)
class HardwareConfig:
    """Full accelerator description."""

    name: str = "tpuv6e"
    clock_ghz: float = 0.94                   # TPUv6e core clock ~940 MHz
    num_cores: int = 1
    topology: Topology = Topology.PRIVATE
    lookup_sharding: LookupSharding = LookupSharding.BATCH
    matrix_unit: MatrixUnit = field(default_factory=MatrixUnit)
    vector_unit: VectorUnit = field(default_factory=VectorUnit)
    # PRIVATE topology: ``onchip`` is each core's private memory.
    # SHARED topology: ``onchip`` is the one shared last-level memory.
    onchip: OnChipMemory = field(default_factory=OnChipMemory)
    offchip: OffChipMemory = field(default_factory=OffChipMemory)
    # NUMA placement axes (see CHANNEL_AFFINITIES / PLACEMENTS): how embedding
    # miss traffic is routed across DRAM channels and where rows are homed.
    # The defaults reproduce the historical symmetric interleaved engine
    # bitwise. Build through ``with_placement`` for validation.
    channel_affinity: str = "symmetric"
    placement: str = "interleave"
    # Simulator-engine knob (not a hardware parameter): which cache-engine
    # backend classifies set-associative accesses. See CACHE_BACKENDS. The
    # default "stack" classifies every policy analytically (stack-distance
    # passes for LRU, compressed per-set engines for srrip/fifo) — results
    # are bit-exact across all backends.
    cache_backend: str = "stack"
    # Address-translation stage between row classification and DRAM request
    # construction (see TranslationConfig). None — the default — skips
    # translation entirely and is bitwise identical to the pre-translation
    # engine (differential-enforced). Build through ``with_translation``.
    translation: "TranslationConfig | None" = None

    def cycles_to_seconds(self, cycles: float) -> float:
        return cycles / (self.clock_ghz * 1e9)

    def seconds_to_cycles(self, seconds: float) -> float:
        return seconds * self.clock_ghz * 1e9

    def replace(self, **kw) -> "HardwareConfig":
        return dataclasses.replace(self, **kw)

    def with_onchip(self, **onchip_kw) -> "HardwareConfig":
        """Replace on-chip memory parameters (capacity, ways, policy, ...).

        Unknown keys raise ``ValueError`` up front with the valid field list —
        cluster-level knobs (``num_cores``, ``topology``, ...) live on
        ``HardwareConfig`` itself, an easy mix-up once topology is in play.
        """
        valid = {f.name for f in dataclasses.fields(OnChipMemory)}
        unknown = set(onchip_kw) - valid
        if unknown:
            top_level = {f.name for f in dataclasses.fields(HardwareConfig)}
            hint = ""
            misplaced = sorted(unknown & top_level)
            if misplaced:
                hint = (
                    f"; {misplaced} are HardwareConfig fields — use"
                    " .replace()/.with_cluster() instead"
                )
            raise ValueError(
                f"unknown OnChipMemory parameter(s) {sorted(unknown)};"
                f" valid: {sorted(valid)}{hint}"
            )
        return dataclasses.replace(
            self, onchip=dataclasses.replace(self.onchip, **onchip_kw)
        )

    def with_policy(self, policy: OnChipPolicy, **onchip_kw) -> "HardwareConfig":
        return self.with_onchip(policy=OnChipPolicy(policy), **onchip_kw)

    def with_cluster(
        self,
        num_cores: int,
        topology: "Topology | str" = None,
        lookup_sharding: "LookupSharding | str" = None,
    ) -> "HardwareConfig":
        """Replace the core-cluster topology (count, on-chip sharing, sharding)."""
        if num_cores < 1:
            raise ValueError(f"num_cores must be >= 1, got {num_cores}")
        kw = {"num_cores": int(num_cores)}
        if topology is not None:
            kw["topology"] = Topology(topology)
        if lookup_sharding is not None:
            kw["lookup_sharding"] = LookupSharding(lookup_sharding)
        return dataclasses.replace(self, **kw)

    def with_placement(
        self,
        channel_affinity: "str | None" = None,
        placement: "str | None" = None,
    ) -> "HardwareConfig":
        """Select the DRAM channel-affinity and row-placement modes.

        ``channel_affinity`` routes requests to channel groups (see
        ``CHANNEL_AFFINITIES``); ``placement`` homes rows within the group
        (see ``PLACEMENTS``). ``per_core`` affinity requires ``channels`` to
        split evenly over ``num_cores`` — checked when the memory system is
        built, since the cluster shape may change after this call. The
        default ``symmetric``/``interleave`` pair is bitwise identical to the
        pre-placement engine (test-enforced).
        """
        kw = {}
        if channel_affinity is not None:
            if channel_affinity not in CHANNEL_AFFINITIES:
                raise ValueError(
                    f"unknown channel affinity {channel_affinity!r}; "
                    f"options: {CHANNEL_AFFINITIES}"
                )
            kw["channel_affinity"] = channel_affinity
        if placement is not None:
            if placement not in PLACEMENTS:
                raise ValueError(
                    f"unknown placement {placement!r}; options: {PLACEMENTS}"
                )
            kw["placement"] = placement
        return dataclasses.replace(self, **kw)

    def with_cache_backend(self, backend: str) -> "HardwareConfig":
        """Select the cache-engine backend (see ``CACHE_BACKENDS``).

        Results are bit-exact across backends (test-enforced); this only
        chooses how set-associative classification executes. The "stack"
        variants cover every policy analytically (stack distances for LRU,
        compressed per-set engines for srrip/fifo); "stack_pallas" differs
        from "stack" only in LRU's distance pass, which runs as the K2
        kernel.
        """
        if backend not in CACHE_BACKENDS:
            raise ValueError(
                f"unknown cache backend {backend!r}; options: {CACHE_BACKENDS}"
            )
        return dataclasses.replace(self, cache_backend=backend)

    def with_translation(
        self, translation: "TranslationConfig | None" = None, **tlb_kw
    ) -> "HardwareConfig":
        """Attach (or clear) the address-translation stage.

        Either pass a ready ``TranslationConfig``, or keyword fields to
        build one (``with_translation(entries=128, page_bytes=4096)``);
        ``with_translation(None)`` with no keywords clears the stage back
        to the exact-identity default. Unknown keys raise with the valid
        field list, pointing misplaced ``HardwareConfig`` fields at the
        right method — the ``with_onchip`` idiom.
        """
        if translation is not None and tlb_kw:
            raise ValueError(
                "pass either a TranslationConfig or keyword fields, not both")
        if translation is None and tlb_kw:
            valid = {f.name for f in dataclasses.fields(TranslationConfig)}
            unknown = set(tlb_kw) - valid
            if unknown:
                top_level = {f.name for f in dataclasses.fields(HardwareConfig)}
                hint = ""
                misplaced = sorted(unknown & top_level)
                if misplaced:
                    hint = (
                        f"; {misplaced} are HardwareConfig fields — use"
                        " .replace() instead"
                    )
                raise ValueError(
                    f"unknown TranslationConfig parameter(s) {sorted(unknown)};"
                    f" valid: {sorted(valid)}{hint}"
                )
            translation = TranslationConfig(**tlb_kw)
        return dataclasses.replace(self, translation=translation)

    def with_policy_mix(
        self, mix: "dict[int, OnChipPolicy | str] | None"
    ) -> "HardwareConfig":
        """Assign on-chip policies per table id; unlisted tables keep
        ``onchip.policy``. ``None`` clears the mix."""
        if mix is None:
            return self.with_onchip(policy_mix=None)
        norm = tuple(
            sorted((int(t), OnChipPolicy(p).value) for t, p in mix.items())
        )
        if len({t for t, _ in norm}) != len(norm):
            raise ValueError("duplicate table ids in policy mix")
        return self.with_onchip(policy_mix=norm)


def tpuv6e() -> HardwareConfig:
    """Paper Table I: TPUv6e configuration used for validation."""
    return HardwareConfig(
        name="tpuv6e",
        clock_ghz=0.94,
        num_cores=1,
        matrix_unit=MatrixUnit(rows=256, cols=256, dataflow=Dataflow.WS),
        vector_unit=VectorUnit(lanes=128, sublanes=8),
        onchip=OnChipMemory(
            capacity_bytes=128 * 1024 * 1024,
            line_bytes=64,
            ways=16,
            latency_cycles=8,
            read_bw_bytes_per_cycle=8192,
            write_bw_bytes_per_cycle=8192,
            policy=OnChipPolicy.SPM,
        ),
        offchip=OffChipMemory(
            capacity_bytes=32 * (1 << 30),
            bandwidth_gbps=1600.0,
        ),
    )
