"""Batched design-space-exploration (DSE) sweep engine.

EONSim's stated purpose is "to enable flexible exploration and design of
emerging NPU architectures". A DSE study evaluates a *grid* of memory-system
configurations — on-chip policy x capacity x associativity x workload x reuse
level — and calling ``simulate()`` per point repeats all the
hardware-independent work N times. ``sweep()`` evaluates the whole grid in
one pass while staying **bit-exact** with independent ``simulate()`` calls
(tests enforce this per config):

  * **Trace sharing** — index-trace generation + multi-table expansion +
    concatenation (``EmbeddingTrace``) depend only on (workload, seed,
    zipf_s), so they are built once per (workload, reuse level) and shared by
    every (policy, capacity, ways) point. The derived vector-id stream and
    line-address trace are cached inside the ``EmbeddingTrace`` too.
  * **Matrix-model sharing** — the analytical matrix model is independent of
    the swept on-chip parameters (policy/capacity/ways), so it runs once per
    workload.
  * **Shape-bucket launch sharing** — all distinct single-core grid points
    of one cache-engine policy classify through ``classify_embedding_many``:
    their set-group sub-scans are bucketed by padded shape and each bucket
    runs as ONE kernel launch (K1 under ``pallas``, K2 under
    ``stack_pallas``) instead of one per (config, group)
    (``batch_scans=False`` falls back to per-config scans; results are
    bit-exact either way).
  * **Analytic classification sharing** — under the default
    ``cache_backend="stack"`` every cache-engine policy classifies
    analytically: LRU from one stack-distance pass per (stream, num_sets)
    covering EVERY associativity in the grid (Mattson inclusion), srrip/fifo
    from shared compressed per-set passes (``memory.rrip``, the row-scan
    kernel D2) batched across configs — no sequential scan on the sweep
    path at all.
  * **Placement-invariant classification** — the NUMA axes
    (``channel_affinity`` / ``placement``) only remap miss-line addresses on
    the way to DRAM, so grid points differing only in those axes share ONE
    classification (``classify_for_pending``) and fan out per-placement DRAM
    requests from it (``pending_from``); configs whose placement transform
    is provably the identity for the topology collapse onto the base-grid
    memo entry outright.
  * **Degenerate memo-key canonicalization** — grid points whose swept
    parameters provably cannot change classification collapse onto one memo
    key: SPM reads neither capacity nor ways (``sensitive_params = ()``),
    PINNING never reads ways, and a PINNING capacity large enough to pin the
    slice's whole line footprint is canonicalized to a saturation marker so
    every such capacity shares one classification + DRAM timing
    (``MemoryPolicy.capacity_saturates``; collapse-is-bitwise test-enforced).
  * **Cross-config DRAM batching** — classification and DRAM timing are
    decoupled (``PendingEmbedding``): every memo key's miss-trace dispatch
    of a (workload, zipf) slice runs through ONE ``dram_timing_many`` call,
    bit-exact vs per-key dispatch (``batch_dram=False`` is that reference
    path).

The grid also spans the CoreCluster axes: ``num_cores`` and ``topologies``
(private per-core on-chip vs shared LLC) sweep through the multi-core
MemorySystem with shared-DRAM contention — and the NUMA placement axes
``channel_affinities`` / ``placements`` (symmetric | per_core | per_table x
interleave | table_rank | hot_replicate), which participate in the memo keys
and ride the same batched ``dram_timing_many`` dispatch (placement is pure
address remapping upstream of DRAM timing) — plus the address-translation
axis ``translations`` (``TranslationConfig`` | None): translation is a pure
charge on the classified miss stream, so translation siblings share ONE
classification, ``translation=None`` keys exactly like the base grid, and
TLBs whose reach saturates the slice's page footprint collapse onto one
first-touch-only memo key (``memory.tlb.translation_saturated``).

Scaling the sweep itself (the "week-long sweeps that survive preemption"
posture — see docs/architecture.md "Scaling the DSE"):

  * **Device sharding** (``devices=``) — the memo-key space partitions into
    shards (whole class-key groups, so placement siblings stay co-located
    with their shared classification); each shard runs its own batched
    classification and ``dram_timing_many`` dispatch on one torch device
    (its own memory systems, a CUDA stream of its own), concurrently with
    the others, and the per-key stats gather back into the single result.
    Because every batching layer is bit-exact regardless of batch
    composition, the sharded sweep is bitwise identical to the
    single-device path (differential-enforced).
  * **Checkpointed resumability** (``checkpoint=``) — completed memo keys
    journal to a ``SweepCheckpoint`` (``core.sweep_ckpt``) in cadence-sized
    rounds; a killed sweep resumes by restoring journaled keys and
    re-evaluating only the remainder, and the resumed ``SweepResult`` is
    bitwise identical to an uninterrupted run (differential-enforced).
  * **Explicit config lists** (``configs=``) — the successive-halving
    search (``core.search``) evaluates arbitrary subsets of the grid
    through the same memoized engine; ``grid_configs()`` exposes the
    exhaustive list.

Typical use (the paper's Fig. 4 case study is one call — the JAX
package's ``examples/fig4_sweep.py`` makes it)::

    result = sweep(
        workload,
        base_hw=tpuv6e(),
        policies=("spm", "lru", "srrip", "pinning"),
        capacities=(1 << 20, 4 << 20, 16 << 20),
        ways=(8, 16),
    )                                   # on the card; device="cpu" to ask
    best = result.best("total_cycles")

Every hardware axis runs, cluster shapes (``num_cores``, ``topologies``)
and NUMA placements (``channel_affinities``, ``placements``) included.
Serving-scenario sweeps (``scenarios=``, which need the request-level
serving simulator) raise ``NotImplementedError``.
"""
from __future__ import annotations

import itertools
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, indexed_device
from .energy import EnergyTable
from .faults import (
    FaultInjector,
    FaultPlan,
    FaultTelemetry,
    FaultTolerance,
    ShardEvaluationError,
)
from .engine import (
    assemble_result,
    build_embedding_traces,
    summarize_matrix_ops,
)
from .hardware import (
    HardwareConfig,
    OnChipPolicy,
    Topology,
    TranslationConfig,
    tpuv6e,
)
from .memory.dram import dram_timing_many
from .memory.policies import available_policies
from .memory.tlb import translation_saturated
from .memory.system import (
    MemorySystem,
    classify_embedding_many,
    memory_system_for,
)
from .results import SimResult
from .sweep_ckpt import SweepCheckpoint
from .workload import Workload

DEFAULT_POLICIES = ("spm", "lru", "srrip", "fifo", "pinning")

# Canonical memo-key marker for a capacity that saturates classification
# (``MemoryPolicy.capacity_saturates`` + capacity >= the slice's whole line
# footprint): every such capacity classifies identically, so they share one
# key instead of re-timing byte-identical stats per capacity.
_CAP_SATURATED = "cap_saturated"

# Canonical memo-key marker for a saturated TLB (reach >= the slice's page
# footprint in every set): the charge collapses to first-touch-only walks,
# identical for EVERY saturated geometry — see ``memory.tlb.
# translation_saturated``. Key carries the two parameters the collapsed
# charge still depends on: (marker, page_bytes, miss_latency_cycles).
_TLB_SATURATED = "tlb_sat"


def _tr_key(tr: "TranslationConfig | None") -> tuple:
    """Canonical translation-axis key: ``()`` for off (kept a tuple, not
    None, so combo lists stay sortable in checkpoint fingerprints), else
    the config's primitive 8-tuple."""
    if tr is None:
        return ()
    if not isinstance(tr, TranslationConfig):
        raise TypeError(
            f"translations entries must be TranslationConfig or None, "
            f"got {type(tr).__name__}")
    return tr.key


def _tr_from_key(trk: tuple) -> Optional[TranslationConfig]:
    return None if not trk else TranslationConfig.from_key(trk)


@dataclass(frozen=True)
class SweepConfig:
    """One grid point of the design space."""

    policy: str
    capacity_bytes: int
    ways: int
    workload: str
    zipf_s: float
    num_cores: int = 1
    topology: str = "private"
    channel_affinity: str = "symmetric"
    placement: str = "interleave"
    # Address-translation layer (None = virtual==physical, the exact
    # pre-translation engine; see ``hardware.TranslationConfig``).
    translation: Optional[TranslationConfig] = None
    # Serving-scenario name when this grid point came from a scenario sweep
    # (``sweep(scenarios=...)``); "" on plain fixed-trace sweeps.
    scenario: str = ""

    @property
    def label(self) -> str:
        cap_mb = self.capacity_bytes / (1 << 20)
        base = f"{self.workload}/{self.policy}/{cap_mb:g}MB/{self.ways}w/z{self.zipf_s:g}"
        if self.num_cores != 1 or self.topology != "private":
            base += f"/{self.num_cores}c-{self.topology}"
        if self.channel_affinity != "symmetric" or self.placement != "interleave":
            base += f"/{self.channel_affinity}-{self.placement}"
        if self.translation is not None:
            t = self.translation
            base += f"/tlb:{t.entries}e{t.ways}w-{t.page_bytes}p"
            if t.l2_entries:
                base += f"+l2:{t.l2_entries}e"
        if self.scenario:
            base += f"/sv:{self.scenario}"
        return base


@dataclass
class SweepEntry:
    config: SweepConfig
    result: SimResult
    # The (workload, zipf)-scoped memo key this entry's embedding stats came
    # from — engine metadata (search groups by it; differential comparisons
    # ignore it), NOT part of the row() record.
    memo_key: Optional[tuple] = None

    def row(self) -> Dict:
        """Flat record: config fields + result summary (JSON/CSV friendly)."""
        d = dict(asdict(self.config))
        # Keep the record flat: the translation axis serializes to its
        # canonical key string ("" when off), not a nested dict.
        tr = self.config.translation
        d["translation"] = "" if tr is None else ":".join(map(str, tr.key))
        d.update(self.result.summary())
        return d


@dataclass
class SweepResult:
    entries: List[SweepEntry] = field(default_factory=list)
    wall_seconds: float = 0.0
    # Engine metadata (how the grid was evaluated — never affects entries):
    device_count: int = 1          # distinct torch devices the sweep ran on
    sharded: bool = False          # memo-key space partitioned across devices
    distinct_memo_keys: int = 0    # classification+DRAM evaluations performed
    resumed_keys: int = 0          # memo keys restored from a checkpoint
    # How the sweep survived (or didn't need to survive) faults: retry /
    # failover / degraded-device counters + per-shard wall/retry stats.
    # All-zero on a fault-free run; never affects entries.
    telemetry: FaultTelemetry = field(default_factory=FaultTelemetry)

    @property
    def num_configs(self) -> int:
        return len(self.entries)

    def best(self, metric: str = "total_cycles", minimize: bool = True) -> SweepEntry:
        """Grid point optimizing a ``SimResult`` summary metric."""
        if not self.entries:
            raise ValueError("empty sweep")
        key = lambda e: e.result.summary()[metric]
        return min(self.entries, key=key) if minimize else max(self.entries, key=key)

    def rows(self) -> List[Dict]:
        return [e.row() for e in self.entries]

    def speedup_over(self, baseline_policy: str = "spm") -> List[Dict]:
        """Per-config speedup vs the same-(workload, capacity, ways, zipf)
        grid point under ``baseline_policy`` (the paper's Fig. 4b metric)."""
        base: Dict[tuple, float] = {}
        for e in self.entries:
            c = e.config
            if c.policy == baseline_policy:
                base[(c.workload, c.capacity_bytes, c.ways, c.zipf_s,
                      c.num_cores, c.topology, c.channel_affinity,
                      c.placement, _tr_key(c.translation),
                      c.scenario)] = e.result.total_cycles
        out = []
        for e in self.entries:
            c = e.config
            ref = base.get((c.workload, c.capacity_bytes, c.ways, c.zipf_s,
                            c.num_cores, c.topology, c.channel_affinity,
                            c.placement, _tr_key(c.translation), c.scenario))
            if ref is None:
                continue
            r = e.row()
            r[f"speedup_vs_{baseline_policy}"] = ref / max(e.result.total_cycles, 1e-12)
            out.append(r)
        return out

    def to_json(self, path: Optional[str] = None) -> str:
        payload = {
            "num_configs": self.num_configs,
            "wall_seconds": self.wall_seconds,
            "device_count": self.device_count,
            "sharded": self.sharded,
            "distinct_memo_keys": self.distinct_memo_keys,
            "resumed_keys": self.resumed_keys,
            "fault_telemetry": self.telemetry.to_dict(),
            "rows": self.rows(),
        }
        text = json.dumps(payload, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text


def _as_tuple(x, default):
    if x is None:
        return tuple(default)
    if isinstance(x, (str, bytes)) or not isinstance(x, (list, tuple)):
        return (x,)
    return tuple(x)


def _resolve_axes(
    base_hw: HardwareConfig,
    policies,
    capacities,
    ways,
    num_cores,
    topologies,
    channel_affinities,
    placements,
    translations=None,
) -> Tuple[tuple, ...]:
    """Normalize + validate the eight hardware axes (shared by ``sweep`` and
    ``grid_configs`` so the exhaustive list can never drift from the engine).

    The translation axis is carried as canonical key tuples (``()`` = off),
    so combos stay hashable/sortable for memo keys and checkpoint
    fingerprints; entries must be ``TranslationConfig`` or ``None``."""
    pol_names = tuple(
        p.value if isinstance(p, OnChipPolicy) else str(p)
        for p in _as_tuple(policies, DEFAULT_POLICIES)
    )
    unknown = set(pol_names) - set(available_policies())
    if unknown:
        raise ValueError(f"unregistered policies: {sorted(unknown)}")
    caps = _as_tuple(capacities, (base_hw.onchip.capacity_bytes,))
    ways_t = _as_tuple(ways, (base_hw.onchip.ways,))
    cores_t = tuple(int(c) for c in _as_tuple(num_cores, (base_hw.num_cores,)))
    topo_t = tuple(
        Topology(t).value for t in _as_tuple(topologies, (base_hw.topology.value,))
    )
    aff_t = tuple(
        str(a) for a in _as_tuple(channel_affinities, (base_hw.channel_affinity,))
    )
    plc_t = tuple(str(p) for p in _as_tuple(placements, (base_hw.placement,)))
    tr_t = tuple(
        _tr_key(t) for t in _as_tuple(translations, (base_hw.translation,))
    )
    return pol_names, caps, ways_t, cores_t, topo_t, aff_t, plc_t, tr_t


def grid_configs(
    workloads: Union[Workload, Sequence[Workload]],
    base_hw: Optional[HardwareConfig] = None,
    policies: Sequence[Union[str, OnChipPolicy]] = DEFAULT_POLICIES,
    capacities: Optional[Sequence[int]] = None,
    ways: Optional[Sequence[int]] = None,
    zipf_s: Union[float, Sequence[float]] = 0.8,
    num_cores: Optional[Sequence[int]] = None,
    topologies: Optional[Sequence[Union[str, Topology]]] = None,
    channel_affinities: Optional[Sequence[str]] = None,
    placements: Optional[Sequence[str]] = None,
    translations: Optional[Sequence[Optional[TranslationConfig]]] = None,
) -> List[SweepConfig]:
    """The exhaustive ``SweepConfig`` list ``sweep()`` evaluates for these
    axes, in sweep entry order — ``sweep(wls, hw, configs=grid_configs(...))``
    is bitwise identical to the axes call (test-enforced). ``core.search``
    builds its starting population from this."""
    base_hw = base_hw or tpuv6e()
    wls = _as_tuple(workloads, ())
    if not wls:
        raise ValueError("need at least one workload")
    axes = _resolve_axes(base_hw, policies, capacities, ways, num_cores,
                         topologies, channel_affinities, placements,
                         translations)
    zipfs = _as_tuple(zipf_s, (0.8,))
    return [
        SweepConfig(
            policy=pol, capacity_bytes=cap, ways=w, workload=wl.name,
            zipf_s=z, num_cores=nc, topology=topo,
            channel_affinity=aff, placement=plc,
            translation=_tr_from_key(trk),
        )
        for wl in wls
        for z in zipfs
        for pol, cap, w, nc, topo, aff, plc, trk in itertools.product(*axes)
    ]


# --------------------------------------------------------------------------
# Slice planning: (workload, zipf) slices of the grid
# --------------------------------------------------------------------------

# One slice = every grid point sharing (workload, zipf): they share traces,
# the matrix summary, and the memo-key space. ``combos`` are the eight
# hardware-axis values per grid point (the last a canonical translation key
# tuple, ``()`` = off); ``indices`` the entries' positions in the final
# result (so an explicit ``configs`` list keeps its order).
_Combo = Tuple[str, int, int, int, str, str, str, tuple]


@dataclass
class _Slice:
    workload: Workload
    zipf_s: float
    combos: List[_Combo]
    indices: List[int]

    @property
    def slice_id(self) -> tuple:
        return (self.workload.name, float(self.zipf_s))


def _slices_from_axes(wls, zipfs, axes) -> List[_Slice]:
    combos = list(itertools.product(*axes))
    out, pos = [], 0
    for wl in wls:
        for z in zipfs:
            out.append(_Slice(wl, float(z), list(combos),
                              list(range(pos, pos + len(combos)))))
            pos += len(combos)
    return out


def _slices_from_configs(wls, configs: Sequence[SweepConfig]) -> List[_Slice]:
    by_name: Dict[str, Workload] = {}
    for wl in wls:
        if wl.name in by_name and by_name[wl.name] is not wl:
            raise ValueError(f"ambiguous workload name {wl.name!r}")
        by_name[wl.name] = wl
    unknown_pols = {c.policy for c in configs} - set(available_policies())
    if unknown_pols:
        raise ValueError(f"unregistered policies: {sorted(unknown_pols)}")
    slices: Dict[tuple, _Slice] = {}
    for i, c in enumerate(configs):
        wl = by_name.get(c.workload)
        if wl is None:
            raise ValueError(
                f"config references unknown workload {c.workload!r}; "
                f"known: {sorted(by_name)}"
            )
        sid = (c.workload, float(c.zipf_s))
        sl = slices.get(sid)
        if sl is None:
            sl = slices[sid] = _Slice(wl, float(c.zipf_s), [], [])
        sl.combos.append((c.policy, c.capacity_bytes, c.ways, c.num_cores,
                          Topology(c.topology).value, str(c.channel_affinity),
                          str(c.placement), _tr_key(c.translation)))
        sl.indices.append(i)
    return list(slices.values())


# --------------------------------------------------------------------------
# Memo-key grid construction (per slice)
# --------------------------------------------------------------------------

def _capacity_saturated(etraces, hw: HardwareConfig) -> bool:
    """True when ``hw``'s capacity covers every etrace's whole line footprint
    — a ``capacity_saturates`` policy then classifies identically for ANY
    capacity at or above it (PINNING pins all unique lines: every access
    hits, setup writes equal the footprint), so such capacities share one
    canonical memo key. Per-core shards only shrink the footprint, so the
    collapse holds for every cluster shape."""
    cap_units = hw.onchip.num_lines
    line = hw.onchip.line_bytes
    return all(et.unique_line_count(line) <= cap_units for et in etraces)


def _build_grid(base_hw: HardwareConfig, combos: Sequence[_Combo], etraces,
                device: torch.device):
    """Resolve each combo to (hw, memo key); dedupe keys into ``pending``
    (each key's memory system on ``device``).

    The memo key splits into the placement-INVARIANT class key
    (classification + stats assembly never read the NUMA axes) plus the
    canonicalized placement axes. Classification runs once per class key;
    DRAM timing once per full key.
    """
    grid = []                        # (combo..., hw, key)
    pending: Dict[tuple, tuple] = {}  # key -> (ms, class_key)
    # Placement-collapse preconditions for this (workload, zipf) slice: a
    # single rank and a single table make the table_rank transform provably
    # equal to plain interleave for EVERY op (PlacementMap.effective_placement
    # — the transform itself dispatches on the same rule, so the collapse is
    # bitwise).
    plc_collapses = (
        base_hw.offchip.banks_per_channel == 1
        and all(et.spec.num_tables == 1 for et in etraces)
    )
    sat_memo: Dict[int, bool] = {}      # capacity -> footprint saturation
    tr_sat_memo: Dict[tuple, bool] = {}  # translation key -> TLB saturation
    line = base_hw.onchip.line_bytes
    for pol, cap, w, nc, topo, aff, plc, trk in combos:
        hw = base_hw.with_policy(
            OnChipPolicy(pol), capacity_bytes=cap, ways=w
        ).with_cluster(nc, topo).with_placement(aff, plc).with_translation(
            _tr_from_key(trk))
        ms = memory_system_for(hw, device)
        class_key = (pol, nc, topo, hw.lookup_sharding.value,
                     hw.onchip.policy_mix)
        # Canonicalize the sensitive parameters: a saturating policy's
        # capacity collapses to one marker once it covers the slice's whole
        # footprint (provably identical classification — test-enforced).
        sens = []
        for p in ms.policy.sensitive_params:
            v = getattr(hw.onchip, p)
            if (
                p == "capacity_bytes"
                and ms.policy.capacity_saturates
                and not hw.onchip.policy_mix
            ):
                sat = sat_memo.get(cap)
                if sat is None:
                    sat = sat_memo[cap] = _capacity_saturated(etraces, hw)
                if sat:
                    v = _CAP_SATURATED
            sens.append(v)
        class_key += tuple(sens)
        if ms.policy.uses_cache_engine:
            # Backends are bit-exact, but memoization must not hand a
            # "pallas" grid point stats computed by "scan" — the knob
            # is part of what the config requests.
            class_key += (hw.cache_backend,)
        if hw.onchip.policy_mix:
            # Mix groups may read parameters the default policy does
            # not (e.g. pinned tables under an SPM default).
            class_key += (cap, w)
        # Canonicalize the placement axes: with one core every affinity
        # collapses to a single channel group, and a degenerate table_rank
        # collapses to interleave — keying such points apart would re-time
        # provably identical DRAM traffic (e.g. the base-grid entry).
        key_aff = "symmetric" if nc == 1 else aff
        key_plc = plc
        if key_plc == "table_rank" and plc_collapses:
            key_plc = "interleave"
        # Canonicalize the translation axis: a TLB whose every set covers
        # the slice's page footprint never takes a non-compulsory miss, so
        # its charge collapses to first-touch-only walks — identical for
        # every saturated geometry sharing (page_bytes,
        # miss_latency_cycles). Checked against the FULL address trace's
        # unique pages, so it holds for any classified miss subsequence
        # (i.e. every policy/capacity of the slice) — see ``memory.tlb.
        # translation_saturated`` (collapse-is-bitwise test-enforced).
        key_tr = trk
        if trk:
            tcfg = hw.translation
            sat = tr_sat_memo.get(trk)
            if sat is None:
                sat = tr_sat_memo[trk] = all(
                    translation_saturated(
                        et.unique_pages(line, tcfg.page_bytes), tcfg)
                    for et in etraces)
            if sat:
                key_tr = (_TLB_SATURATED, tcfg.page_bytes,
                          tcfg.miss_latency_cycles)
        key = class_key + (key_aff, key_plc, key_tr)
        grid.append((pol, cap, w, nc, topo, aff, plc, trk, hw, key))
        if key not in pending:
            pending[key] = (ms, class_key)
    return grid, pending


# --------------------------------------------------------------------------
# Memo-key evaluation (classification + batched DRAM timing)
# --------------------------------------------------------------------------

def _on(items: Dict[tuple, tuple], device: torch.device) -> Dict[tuple, tuple]:
    """``items`` with every memory system on ``device``: a shard evaluates
    on its own device, and ``classify_embedding_many`` takes the systems of
    one device only. Systems already there are kept; one rebuilt system
    serves every key that shared the original."""
    moved: Dict[int, object] = {}
    out = {}
    for key, (ms, ck) in items.items():
        if ms.device != device:
            if id(ms) not in moved:
                moved[id(ms)] = memory_system_for(ms.hw, device)
            ms = moved[id(ms)]
        out[key] = (ms, ck)
    return out


def _evaluate_keys(
    etraces, items: Dict[tuple, tuple], batch_scans: bool, batch_dram: bool,
    device: torch.device,
) -> Dict[tuple, list]:
    """Evaluate a subset of memo keys on ``device``: shared classification
    per class key, placement fan-out per full key, ONE batched DRAM dispatch
    for the lot.

    Self-contained in ``items`` — the sharded sweep calls it once per shard
    and the checkpointed sweep once per cadence round; results are bit-exact
    regardless of how the key space is split or which device evaluates it
    (every batching layer is composition-invariant, test-enforced).
    """
    items = _on(items, device)
    class_systems: Dict[tuple, object] = {}
    for key, (ms, ck) in items.items():
        class_systems.setdefault(ck, ms)

    # Batched classification: distinct single-core cache-engine class keys of
    # ONE policy share a kernel launch per scan shape — and, under the
    # stack backend, one analytic pass per (stream, num_sets)
    # (classify_embedding_many); everything else classifies per class key.
    # DRAM timing is deferred throughout.
    classified: Dict[tuple, list] = {}  # class_key -> per-etrace
    by_policy: Dict[str, list] = {}
    for ck, ms in class_systems.items():
        if (
            batch_scans
            and isinstance(ms, MemorySystem)
            and ms.policy.uses_cache_engine
            and not ms.hw.onchip.policy_mix
        ):
            by_policy.setdefault(ms.policy.name, []).append((ck, ms))
    for batch in by_policy.values():
        if len(batch) < 2:
            continue
        cks = [k for k, _ in batch]
        systems = [m for _, m in batch]
        per_ck = [[] for _ in systems]
        for et in etraces:
            for i, cs in enumerate(classify_embedding_many(systems, et)):
                per_ck[i].append(cs)
        for ck, css in zip(cks, per_ck):
            classified[ck] = css
    for ck, ms in class_systems.items():
        if ck not in classified:
            classified[ck] = [ms.classify_for_pending(et) for et in etraces]

    # Placement fan-out: every full key packages ITS OWN placement transform
    # of the shared classification into a deferred DRAM request — so
    # placement siblings ride the same size-bucketed dram_timing_many
    # dispatch as the base grid.
    prepared: Dict[tuple, list] = {
        key: [
            ms.pending_from(et, cl)
            for et, cl in zip(etraces, classified[ck])
        ]
        for key, (ms, ck) in items.items()
    }

    # Cross-memo-key DRAM batching: every deferred miss-trace dispatch of
    # this key subset — all policies, geometries, and cluster shapes — runs
    # through ONE dram_timing_many call. Per-request results are bitwise
    # identical to unbatched dispatch (batch_dram=False is that reference
    # path; test-enforced).
    key_order = list(prepared)
    all_pending = [p for k in key_order for p in prepared[k]]
    outs = iter(dram_timing_many(
        [p.request for p in all_pending], batch=batch_dram, device=device
    ))
    return {k: [p.finalize(*next(outs)) for p in prepared[k]] for k in key_order}


def _chunks(items: Dict[tuple, tuple], cadence: Optional[int]):
    """Split the todo keys into cadence-sized rounds (insertion order)."""
    keys = list(items)
    if not cadence or cadence <= 0 or cadence >= len(keys):
        if keys:
            yield items
        return
    for i in range(0, len(keys), cadence):
        yield {k: items[k] for k in keys[i:i + cadence]}


def _prewarm_traces(etraces, base_hw: HardwareConfig, combos) -> None:
    """Materialize the lazily cached derived streams BEFORE shard threads
    start, so concurrent workers never duplicate the (deterministic but
    expensive) trace work. Line geometry is grid-invariant (``with_policy``
    never touches ``line_bytes``)."""
    line = base_hw.onchip.line_bytes
    any_hot = any(c[6] == "hot_replicate" for c in combos)
    for et in etraces:
        et.lookup_batch
        et.vec_ids
        et.address_trace(line)
        if any_hot:
            et.hot_vec_ids


def sweep(
    workloads: Union[Workload, Sequence[Workload]],
    base_hw: Optional[HardwareConfig] = None,
    policies: Sequence[Union[str, OnChipPolicy]] = DEFAULT_POLICIES,
    capacities: Optional[Sequence[int]] = None,
    ways: Optional[Sequence[int]] = None,
    zipf_s: Union[float, Sequence[float]] = 0.8,
    seed: int = 0,
    index_trace: Optional[np.ndarray] = None,
    energy_table: EnergyTable = EnergyTable(),
    num_cores: Optional[Sequence[int]] = None,
    topologies: Optional[Sequence[Union[str, Topology]]] = None,
    channel_affinities: Optional[Sequence[str]] = None,
    placements: Optional[Sequence[str]] = None,
    translations: Optional[Sequence[Optional[TranslationConfig]]] = None,
    batch_scans: bool = True,
    batch_dram: bool = True,
    configs: Optional[Sequence[SweepConfig]] = None,
    devices=None,
    checkpoint: Union[SweepCheckpoint, str, None] = None,
    fault_tolerance: Optional[FaultTolerance] = None,
    fault_plan: Optional[FaultPlan] = None,
    fault_telemetry: Optional[FaultTelemetry] = None,
    scenarios: Optional[Sequence] = None,
    *,
    device: DeviceLike = "cuda",
) -> SweepResult:
    """Evaluate the (workload x zipf x policy x capacity x ways x num_cores
    x topology x channel_affinity x placement x translation) grid.

    Every grid point's ``SimResult`` is bit-exact against
    ``simulate(workload, base_hw.with_policy(policy, capacity_bytes=...,
    ways=...).with_cluster(num_cores, topology).with_placement(affinity,
    placement).with_translation(translation), seed=seed, zipf_s=z)`` — the
    sweep only removes redundant work, never changes the model.

    ``translations`` sweeps the address-translation layer
    (``TranslationConfig`` entries; ``None`` = translation off, the exact
    pre-translation engine). Translation is a pure charge on the classified
    miss stream, so translation siblings share one classification, and two
    memo-key collapses apply: ``None`` keys exactly like the base grid, and
    any TLB whose reach saturates the slice's page footprint collapses to a
    first-touch-only marker (bitwise — test-enforced).

    ``configs`` replaces the axis grid with an explicit ``SweepConfig`` list
    (entry order preserved; the search's evaluation path).

    ``device`` is where the kernels run: the CUDA card by default (raises
    when there is none), the CPU only when asked (``device="cpu"``, the
    kernels' plain versions).

    ``devices`` shards the memo-key space: an int takes that many shards over
    the local devices of ``device``'s type (``cuda:0 … cuda:{n-1}``, cycled
    when fewer exist; the CPU for ``cpu``), a device sequence pins one shard
    per device. Shards evaluate concurrently (one thread per shard, each on
    its device with a CUDA stream of its own) and results are bitwise
    identical to the unsharded path.

    ``checkpoint`` (a ``SweepCheckpoint`` or journal path) makes the sweep
    restartable: memo keys journal in ``cadence``-sized rounds, a resumed
    sweep restores finished keys and is bitwise identical to an
    uninterrupted run.

    ``fault_tolerance`` (default ``FaultTolerance()``) sets the recovery
    policy for sharded execution: transient retries with seeded backoff,
    the per-shard heartbeat watchdog (``shard_timeout_s``), and failover of
    crashed/hung shards onto surviving devices — every recovery path
    bitwise identical to the fault-free run (``strict=True`` raises
    instead of degrading). ``fault_plan`` injects a deterministic fault
    schedule (tests / chaos CI only — see ``core.faults``); ``fault_
    telemetry`` supplies the counter sink (pass one in to read telemetry
    even when the sweep raises), otherwise a fresh ``FaultTelemetry`` is
    created. Either way the counters land on ``SweepResult.telemetry``.

    ``scenarios`` (serving-scenario sweeps: traffic pattern x robustness
    policy over the request-level serving simulator) raises
    ``NotImplementedError``: that simulator is not ported yet.
    """
    dev = indexed_device(device)
    base_hw = base_hw or tpuv6e()
    wls = _as_tuple(workloads, ())
    if not wls:
        raise ValueError("need at least one workload")

    if scenarios is not None:
        raise NotImplementedError(
            "serving-scenario sweeps (scenarios=) need the request-level "
            "serving simulator (core/requests.py, serving/scheduler.py), which "
            "is not ported yet (serving slice of the port; see ROADMAP.md)")

    if configs is not None:
        slices = _slices_from_configs(wls, list(configs))
        num_entries = len(configs)
    else:
        axes = _resolve_axes(base_hw, policies, capacities, ways, num_cores,
                             topologies, channel_affinities, placements,
                             translations)
        zipfs = _as_tuple(zipf_s, (0.8,))
        slices = _slices_from_axes(wls, zipfs, axes)
        num_entries = sum(len(s.combos) for s in slices)

    shard_plan = None
    if devices is not None:
        from ..distributed.sweep_shard import resolve_shard_plan
        shard_plan = resolve_shard_plan(devices, dev)

    tol = fault_tolerance if fault_tolerance is not None else FaultTolerance()
    telemetry = (fault_telemetry if fault_telemetry is not None
                 else FaultTelemetry())
    injector: Optional[FaultInjector] = None
    if fault_plan is not None:
        if shard_plan is None and fault_plan.has_shard_events():
            raise ValueError(
                "fault_plan schedules shard events but the sweep is not "
                "sharded — pass devices= so the plan's shard coordinates "
                "mean something")
        if fault_plan.has_kind("hang") and tol.shard_timeout_s is None:
            raise ValueError(
                "fault_plan injects hangs but no watchdog is armed — set "
                "FaultTolerance.shard_timeout_s or the sweep deadlocks")
        injector = FaultInjector(fault_plan, telemetry)

    ckpt: Optional[SweepCheckpoint] = None
    if checkpoint is not None:
        ckpt = (checkpoint if isinstance(checkpoint, SweepCheckpoint)
                else SweepCheckpoint(checkpoint))
        ckpt.open(_fingerprint(wls, base_hw, seed, slices, index_trace,
                               energy_table))
        ckpt.fault_injector = injector

    t0 = time.perf_counter()
    out = SweepResult()
    out.telemetry = telemetry
    if shard_plan is not None:
        out.sharded = True
        out.device_count = shard_plan.distinct_devices
    entries: List[Optional[SweepEntry]] = [None] * num_entries
    matrix_memo: Dict[int, object] = {}
    try:
        for sl in slices:
            wl, z = sl.workload, sl.zipf_s
            # Matrix side ignores the swept on-chip parameters — once per
            # workload.
            matrix = matrix_memo.get(id(wl))
            if matrix is None:
                matrix = matrix_memo[id(wl)] = summarize_matrix_ops(wl, base_hw)
            # Traces depend only on (workload, seed, zipf) — shared across
            # every grid point below.
            etraces = build_embedding_traces(wl, index_trace, seed, z)
            grid, pending = _build_grid(base_hw, sl.combos, etraces, dev)
            out.distinct_memo_keys += len(pending)

            # Restore journaled keys; only the remainder is (re)evaluated.
            stats_memo: Dict[tuple, list] = {}
            if ckpt is not None:
                for key in pending:
                    restored = ckpt.lookup(sl.slice_id, key)
                    if restored is not None:
                        stats_memo[key] = restored
                out.resumed_keys += len(stats_memo)
            todo = {k: v for k, v in pending.items() if k not in stats_memo}

            if shard_plan is not None and todo:
                _prewarm_traces(etraces, base_hw, sl.combos)
            cadence = ckpt.cadence if ckpt is not None else None
            for round_items in _chunks(todo, cadence):
                if injector is not None:
                    injector.begin_round()
                # Single-key rounds normally skip sharding (thread overhead
                # for nothing), but an armed injector forces the supervised
                # path so (shard, round) coordinates stay meaningful.
                if shard_plan is not None and (
                    len(round_items) > 1 or injector is not None
                ):
                    from ..distributed.sweep_shard import evaluate_sharded
                    try:
                        results = evaluate_sharded(
                            round_items, shard_plan,
                            lambda sub, shard_dev: _evaluate_keys(
                                etraces, sub, batch_scans, batch_dram,
                                shard_dev,
                            ),
                            tolerance=tol,
                            injector=injector,
                            telemetry=telemetry,
                        )
                    except ShardEvaluationError as exc:
                        # Completed sibling-shard results are journaled
                        # before the fatal error propagates, so a rerun
                        # resumes past the surviving work.
                        if ckpt is not None and exc.completed:
                            ckpt.record(sl.slice_id, exc.completed)
                        raise
                else:
                    results = _evaluate_keys(
                        etraces, round_items, batch_scans, batch_dram, dev
                    )
                stats_memo.update(results)
                if ckpt is not None:
                    ckpt.record(sl.slice_id, results)

            for idx, (pol, cap, w, nc, topo, aff, plc, trk, hw, key) in zip(
                sl.indices, grid
            ):
                res = assemble_result(
                    wl, hw, matrix, stats_memo[key], energy_table
                )
                entries[idx] = SweepEntry(
                    config=SweepConfig(
                        policy=pol,
                        capacity_bytes=cap,
                        ways=w,
                        workload=wl.name,
                        zipf_s=z,
                        num_cores=nc,
                        topology=topo,
                        channel_affinity=aff,
                        placement=plc,
                        translation=_tr_from_key(trk),
                    ),
                    result=res,
                    memo_key=sl.slice_id + key,
                )
        out.entries = [e for e in entries if e is not None]
        if ckpt is not None:
            ckpt.mark_complete(len(out.entries))
    finally:
        if ckpt is not None and not isinstance(checkpoint, SweepCheckpoint):
            ckpt.close()
    out.wall_seconds = time.perf_counter() - t0
    return out


def _fingerprint(wls, base_hw, seed, slices, index_trace, energy_table) -> Dict:
    """Everything that determines sweep RESULTS (not how they are computed:
    batching, sharding, and cadence are bit-exact and excluded) — a resumed
    checkpoint must match it exactly."""
    import hashlib

    it_digest = None
    if index_trace is not None:
        it_digest = hashlib.sha256(
            np.ascontiguousarray(index_trace).tobytes()
        ).hexdigest()
    return {
        "workloads": sorted(repr(wl) for wl in wls),
        "base_hw": repr(base_hw),
        "seed": int(seed),
        "slices": [
            [sl.slice_id[0], sl.slice_id[1], sorted(map(list, set(sl.combos)))]
            for sl in slices
        ],
        "index_trace": it_digest,
        "energy_table": repr(energy_table),
    }
