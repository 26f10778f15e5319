"""On-chip memory management policies (paper Sec. III/IV) behind a registry.

Four configurations evaluated in the paper's case study (Fig. 4):
  * SPM      — scratchpad staging as on TPUv6e: *every* vector lookup fetches
               from off-chip regardless of hotness; on-chip memory is a
               double-buffered staging area.
  * LRU/SRRIP/FIFO — on-chip memory configured as a set-associative cache
               (MTIA LLC-mode-like); misses go off-chip.
  * PINNING  — "Profiling": track access frequency, pin the hottest vectors
               up to capacity; pinned hits stay on-chip, everything else is
               staged from off-chip like SPM.

Every policy is a ``MemoryPolicy`` subclass registered under its
``OnChipPolicy`` name. Policies only *classify* accesses (hit / miss); the
shared accounting contract lives in ``MemoryPolicy.run``:

  * each line access = 1 on-chip read (the consumer always reads on-chip);
  * each miss       = 1 off-chip read + 1 on-chip fill/stage write;
  * ``setup_writes`` = one-time fills at load time (e.g. pinned-set preload),
    attributed to the first batch by the MemorySystem.

This single contract reproduces the per-policy counts the paper reports
(Fig. 3c/4c). Adding a policy = subclass + ``@register_policy``; the
MemorySystem, sweep engine, and benchmarks pick it up automatically (see
docs/architecture.md).
"""
from __future__ import annotations

import abc
import dataclasses
from dataclasses import dataclass
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple, Type, Union

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from ..hardware import HardwareConfig, OnChipPolicy
from ..profiling import stage
from ..trace import AddressTrace
from .cache import CacheGeometry, classify_streams


@dataclass
class PolicyOutcome:
    hits: np.ndarray              # bool (N,) on-chip hit per line access
    miss_lines: np.ndarray        # int64 (M,) off-chip line trace, trace order
    onchip_reads: int             # on-chip read accesses (line granular)
    onchip_writes: int            # on-chip write accesses (fills/stages)
    offchip_reads: int            # off-chip line fetches
    policy: OnChipPolicy
    setup_writes: int = 0         # one-time load-time fills (subset of writes)

    @property
    def onchip_accesses(self) -> int:
        return self.onchip_reads + self.onchip_writes

    @property
    def onchip_ratio(self) -> float:
        """On-chip share of all memory accesses (paper Fig. 4c metric)."""
        total = self.onchip_accesses + self.offchip_reads
        return self.onchip_accesses / max(total, 1)

    @property
    def hit_rate(self) -> float:
        return float(self.hits.mean()) if self.hits.size else 0.0


@dataclass(frozen=True)
class PolicyContext:
    """Everything a policy may need to classify an access stream.

    ``geometry`` describes the stream's granularity: the full line-granular
    cache geometry normally, or the lane sub-cache geometry when the
    MemorySystem applies the lane-decomposition transform (the policy itself
    is agnostic — that is what makes the transform transparent).
    ``device`` is where the cache engines run.
    """

    geometry: CacheGeometry
    capacity_units: int                       # capacity in stream-granularity units
    pinned_lines: Optional[np.ndarray] = None
    backend: str = "scan"                     # cache-engine backend (hw knob)
    device: torch.device = torch.device("cuda")

    @staticmethod
    def from_hardware(
        hw: HardwareConfig,
        pinned_lines: Optional[np.ndarray] = None,
        device: torch.device = torch.device("cuda"),
    ) -> "PolicyContext":
        geom = CacheGeometry.from_capacity(
            hw.onchip.capacity_bytes, hw.onchip.line_bytes, hw.onchip.ways
        )
        return PolicyContext(
            geometry=geom,
            capacity_units=hw.onchip.num_lines,
            pinned_lines=pinned_lines,
            backend=hw.cache_backend,
            device=device,
        )

    def scaled(self, fraction: float) -> "PolicyContext":
        """Context for a capacity partition (per-table policy mixes).

        The on-chip memory is statically partitioned set-wise: a policy group
        owning ``fraction`` of the tables gets ``fraction`` of the sets (and
        capacity units), associativity unchanged. ``fraction=1`` is exact
        identity, so a degenerate one-group mix classifies bit-exactly like
        the unmixed path.
        """
        if fraction >= 1.0:
            return self
        g = self.geometry
        return dataclasses.replace(
            self,
            geometry=CacheGeometry(
                num_sets=max(1, int(g.num_sets * fraction)),
                ways=g.ways,
                line_bytes=g.line_bytes,
            ),
            capacity_units=max(1, int(self.capacity_units * fraction)),
        )


class MemoryPolicy(abc.ABC):
    """A pluggable on-chip memory management policy."""

    name: ClassVar[str]
    enum: ClassVar[OnChipPolicy]
    uses_cache_engine: ClassVar[bool] = False
    # Swept on-chip parameters classification actually depends on. The DSE
    # sweep engine memoizes embedding stats across grid points that agree on
    # these values (e.g. SPM is invariant to both capacity and ways, PINNING
    # only reads capacity), so declaring a narrower set makes sweeps cheaper
    # — never different.
    sensitive_params: ClassVar[Tuple[str, ...]] = ("capacity_bytes", "ways")
    # Classification saturates once capacity covers the trace's whole line
    # footprint: every capacity at or above it is provably identical (e.g.
    # PINNING pins ALL unique lines — all hits, setup writes equal the
    # footprint). The sweep canonicalizes such capacities onto one memo key.
    capacity_saturates: ClassVar[bool] = False
    # Safe to classify at vector granularity through the lane decomposition
    # (bit-exact only when classification is independent of line/vector
    # granularity tie-breaking — true for stateless staging and for
    # set-associative caches with an exact lane split; NOT for pinning,
    # whose frequency top-K can split a vector at the capacity boundary).
    supports_lane_transform: ClassVar[bool] = False

    def prepare(self, lines: np.ndarray, ctx: PolicyContext) -> PolicyContext:
        """Resolve any trace-derived state (e.g. the profiled pinned set)."""
        return ctx

    @abc.abstractmethod
    def classify(self, lines: np.ndarray, ctx: PolicyContext) -> np.ndarray:
        """Return a bool (N,) array: on-chip hit per access."""

    def classify_many(
        self, streams: Sequence[np.ndarray], ctxs: Sequence[PolicyContext]
    ) -> List[np.ndarray]:
        """Classify several independent (stream, ctx) pairs.

        Default is a plain loop; policies backed by the cache engine
        override this to share launches across pairs. MUST be bit-exact with
        per-pair ``classify``.
        """
        return [self.classify(s, c) for s, c in zip(streams, ctxs)]

    def setup_writes(self, ctx: PolicyContext) -> int:
        """One-time on-chip fills at load time (before the first batch)."""
        return 0

    def classify_device(self, lines: torch.Tensor, ctx: PolicyContext) -> torch.Tensor:
        """Device-resident ``classify`` (the JAX package's ``classify_jnp``):
        takes a line tensor, returns a bool tensor on the same device.

        Policies with a native torch version (SPM, PINNING) override this;
        the numpy ``classify`` stays the golden reference (equality is
        test-enforced). The default round-trips through the host.
        """
        hits = self.classify(lines.cpu().numpy(), ctx)
        return torch.as_tensor(hits, dtype=torch.bool, device=lines.device)

    def _outcome(
        self, lines: np.ndarray, ctx: PolicyContext, hits: np.ndarray
    ) -> PolicyOutcome:
        """The shared accounting contract applied to a classification."""
        misses = int((~hits).sum())
        setup = self.setup_writes(ctx)
        return PolicyOutcome(
            hits=hits,
            miss_lines=lines[~hits],
            onchip_reads=int(lines.size),
            onchip_writes=misses + setup,
            offchip_reads=misses,
            policy=self.enum,
            setup_writes=setup,
        )

    def run(self, lines: np.ndarray, ctx: PolicyContext) -> PolicyOutcome:
        """Classify + apply the shared accounting contract."""
        with stage("classify"):
            lines = np.asarray(lines, dtype=np.int64).reshape(-1)
            ctx = self.prepare(lines, ctx)
            return self._outcome(lines, ctx, self.classify(lines, ctx))

    def run_many(
        self, streams: Sequence[np.ndarray], ctxs: Sequence[PolicyContext]
    ) -> List[PolicyOutcome]:
        """Batched ``run``: same contract, one ``classify_many`` dispatch."""
        with stage("classify"):
            streams = [np.asarray(s, dtype=np.int64).reshape(-1) for s in streams]
            ctxs = [self.prepare(s, c) for s, c in zip(streams, ctxs)]
            hits_list = self.classify_many(streams, ctxs)
            return [
                self._outcome(s, c, h)
                for s, c, h in zip(streams, ctxs, hits_list)
            ]


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, MemoryPolicy] = {}


def register_policy(cls: Type[MemoryPolicy]) -> Type[MemoryPolicy]:
    """Class decorator: register a MemoryPolicy under ``cls.name``."""
    inst = cls()
    _REGISTRY[inst.name] = inst
    return cls


def get_policy(name) -> MemoryPolicy:
    key = name.value if isinstance(name, OnChipPolicy) else str(name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise ValueError(
            f"unknown policy {key!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# Built-in policies
# --------------------------------------------------------------------------

@register_policy
class SpmPolicy(MemoryPolicy):
    """TPUv6e baseline: fetch every vector from off-chip regardless of hotness.

    Each access = 1 off-chip read + 1 staging write + 1 on-chip read (contract
    above) — no on-chip reuse, so classification is all-miss and granularity
    independent (lane transform is trivially exact).
    """

    name = "spm"
    enum = OnChipPolicy.SPM
    supports_lane_transform = True
    sensitive_params = ()

    def classify(self, lines: np.ndarray, ctx: PolicyContext) -> np.ndarray:
        return np.zeros(lines.size, dtype=bool)

    def classify_device(self, lines: torch.Tensor, ctx: PolicyContext) -> torch.Tensor:
        """Device-resident ``classify`` (the JAX package's ``classify_jnp``):
        all-miss, on ``lines``' device."""
        return torch.zeros(lines.shape[0], dtype=torch.bool, device=lines.device)


class _CacheModePolicy(MemoryPolicy):
    """Set-associative cache mode (MTIA LLC-like); replacement = ``name``.

    Classification runs on the cache engine selected by ``ctx.backend``
    on ``ctx.device`` through the hits-only surface
    ``cache.classify_streams`` — the scan state and per-access results stay
    on the device until the one bulk extraction per shape bucket.
    """

    uses_cache_engine = True
    supports_lane_transform = True

    def classify(self, lines: np.ndarray, ctx: PolicyContext) -> np.ndarray:
        return classify_streams(
            [lines], [ctx.geometry], policy=self.name, backend=ctx.backend,
            device=ctx.device,
        )[0]

    def classify_many(
        self, streams: Sequence[np.ndarray], ctxs: Sequence[PolicyContext]
    ) -> List[np.ndarray]:
        """One ``classify_streams`` call per (backend, device) among the
        pairs, so their shape buckets (or analytic passes) are shared."""
        out: List[Optional[np.ndarray]] = [None] * len(ctxs)
        groups: Dict[tuple, List[int]] = {}
        for i, c in enumerate(ctxs):
            groups.setdefault((c.backend, c.device), []).append(i)
        for (backend, device), idxs in groups.items():
            hits = classify_streams(
                [streams[i] for i in idxs],
                [ctxs[i].geometry for i in idxs],
                policy=self.name,
                backend=backend,
                device=device,
            )
            for i, h in zip(idxs, hits):
                out[i] = h
        return out  # type: ignore[return-value]


@register_policy
class LruPolicy(_CacheModePolicy):
    name = "lru"
    enum = OnChipPolicy.LRU


@register_policy
class SrripPolicy(_CacheModePolicy):
    name = "srrip"
    enum = OnChipPolicy.SRRIP


@register_policy
class FifoPolicy(_CacheModePolicy):
    name = "fifo"
    enum = OnChipPolicy.FIFO


def profile_hot_lines(lines: np.ndarray, capacity_lines: int) -> np.ndarray:
    """Pick the most frequently accessed lines, up to on-chip capacity.

    The paper's Profiling policy "tracks vector access frequency and pins the
    most frequently accessed vectors in on-chip memory, up to its capacity".
    """
    uniq, counts = np.unique(lines, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    return np.sort(uniq[order[:capacity_lines]])


@register_policy
class PinningPolicy(MemoryPolicy):
    """Profiling: pin the hottest lines up to capacity; the rest stage as SPM.

    Pinned fill happens once at load time (``setup_writes``). Lane transform
    is disabled: a line-granular frequency top-K can split a vector at the
    capacity boundary, so vector-granular classification would not be
    bit-exact.
    """

    name = "pinning"
    enum = OnChipPolicy.PINNING
    sensitive_params = ("capacity_bytes",)
    # profile_hot_lines(lines, cap) with cap >= the unique-line footprint
    # pins every line regardless of cap — classification is capacity-
    # invariant from the footprint up (collapse-is-bitwise test-enforced).
    capacity_saturates = True

    def prepare(self, lines: np.ndarray, ctx: PolicyContext) -> PolicyContext:
        if ctx.pinned_lines is None:
            ctx = dataclasses.replace(
                ctx, pinned_lines=profile_hot_lines(lines, ctx.capacity_units)
            )
        return dataclasses.replace(
            ctx, pinned_lines=np.sort(np.asarray(ctx.pinned_lines))
        )

    def classify(self, lines: np.ndarray, ctx: PolicyContext) -> np.ndarray:
        pinned = ctx.pinned_lines
        if pinned is None or not len(pinned):
            return np.zeros(lines.size, dtype=bool)
        idx = np.searchsorted(pinned, lines)
        idx = np.clip(idx, 0, len(pinned) - 1)
        return pinned[idx] == lines

    def classify_device(self, lines: torch.Tensor, ctx: PolicyContext) -> torch.Tensor:
        """Device-resident ``classify`` (the JAX package's ``classify_jnp``):
        the same sorted-membership test as the numpy golden, with
        ``torch.searchsorted`` on ``lines``' device, so a device-resident
        caller keeps the lookup stream there."""
        pinned = ctx.pinned_lines
        if pinned is None or not len(pinned):
            return torch.zeros(lines.shape[0], dtype=torch.bool, device=lines.device)
        pinned_d = torch.as_tensor(np.asarray(pinned, dtype=np.int64), device=lines.device)
        lines = lines.to(torch.int64)
        idx = torch.searchsorted(pinned_d, lines).clamp_(0, len(pinned) - 1)
        return pinned_d[idx] == lines

    def setup_writes(self, ctx: PolicyContext) -> int:
        return 0 if ctx.pinned_lines is None else int(len(ctx.pinned_lines))


# --------------------------------------------------------------------------
# Per-table policy mixes
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PolicyGroup:
    """One partition of a per-table policy mix."""

    policy: MemoryPolicy
    table_ids: Tuple[int, ...]       # tables classified by this policy
    fraction: float                  # share of tables -> share of capacity


def resolve_policy_mix(
    mix: Optional[Tuple[Tuple[int, str], ...]],
    default_policy: Union[str, OnChipPolicy],
    num_tables: int,
) -> List[PolicyGroup]:
    """Expand ``hw.onchip.policy_mix`` into policy groups over all tables.

    Tables not named in the mix fall back to ``default_policy``. Capacity is
    statically partitioned set-wise, proportional to each group's table count
    (``PolicyContext.scaled``); a single-group result keeps fraction 1.0 and
    is bit-exact with the unmixed path.
    """
    assign: Dict[int, str] = {}
    default_name = (
        default_policy.value
        if isinstance(default_policy, OnChipPolicy)
        else str(default_policy)
    )
    for t, p in mix or ():
        if not 0 <= t < num_tables:
            raise ValueError(
                f"policy mix table id {t} out of range [0, {num_tables})"
            )
        if int(t) in assign:
            raise ValueError(f"duplicate table id {t} in policy mix")
        assign[int(t)] = p
    by_policy: Dict[str, List[int]] = {}
    for t in range(num_tables):
        by_policy.setdefault(assign.get(t, default_name), []).append(t)
    return [
        PolicyGroup(
            policy=get_policy(name),
            table_ids=tuple(tables),
            fraction=len(tables) / max(num_tables, 1),
        )
        for name, tables in sorted(by_policy.items())
    ]


# --------------------------------------------------------------------------
# Back-compat functional entry point
# --------------------------------------------------------------------------

def run_policy(
    atrace: AddressTrace,
    hw: HardwareConfig,
    pinned_lines: np.ndarray | None = None,
    *,
    device: DeviceLike = "cuda",
) -> PolicyOutcome:
    """Classify each line access of ``atrace`` under ``hw``'s policy."""
    policy = get_policy(hw.onchip.policy)
    return policy.run(
        atrace.lines,
        PolicyContext.from_hardware(hw, pinned_lines, resolve_device(device)),
    )
