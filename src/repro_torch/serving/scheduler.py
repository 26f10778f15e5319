"""Closed-loop continuous-batching scheduler with robustness policies.

This is the serving layer on top of ``MultiCoreMemorySystem``: requests from
``core.requests`` arrive over simulated time, are admitted into fixed batch
slots, and each served batch's *service time* comes from the unmodified
memory system (``simulate_embedding`` over the lowered ``ConcatTrace``, with
on-chip state persisting across batches exactly like the fixed-trace path).
Queueing delay vs. service time, tail latency, and goodput fall out of the
timeline; the robustness policy set decides what happens when the memory
system saturates:

* **Admission control / load shedding** — an arrival finding the queue at or
  above ``admission_watermark`` is shed on the spot (429 semantics).
* **Deadlines / timeout abandonment** — a queued request whose per-attempt
  deadline passes before its batch starts is abandoned (the client hung up).
* **Seeded client retries** — shed or timed-out requests re-submit after
  exponential backoff with seeded jitter (deterministic in
  ``(seed, rid, attempt)`` — the same idiom as ``core.faults.backoff_
  seconds``), so retry storms and metastable overload are *reproducible*.

**Clock monotonicity guarantee.** The simulated clock ``now`` never moves
backwards (regression-tested under deadline+retry storms): every event the
loop schedules — arrivals, batch starts, and in particular *retries of
timed-out requests* — is stamped at or after the clock at the instant it is
scheduled. A timed-out attempt's backoff still counts from its deadline
(the instant the client gave up), but the resubmission is clamped to the
pruning clock: ``max(deadline + backoff, clock)``. Without the clamp a
short backoff could land the retry *before* the batch-formation instant
that pruned it, rewinding ``now`` when the heap entry popped and corrupting
every subsequent ``enqueued``/admission decision. Pass ``event_log=`` to
``simulate_serving`` to capture the clock trace the regression test
asserts over.
* **Graceful degradation** — under queue pressure a batch is served
  degraded: ``hot_rows_only`` truncates pooling to the hottest rows;
  ``cache_bypass`` routes cold tables around the on-chip cache (no
  pollution) at a flat per-line DRAM cost.

**Identity guarantee** (differential-enforced in tests/test_serving_sim.py):
with every policy off, the scheduler's served batches are exactly the
request stream chunked into ``batch_slots`` in arrival order, and its
per-batch stats are the output of ONE ``simulate_embedding`` call over that
lowered ConcatTrace — bit-for-bit the plain fixed-trace path. Policies
"off" means ``RobustnessPolicy()`` defaults; each knob's off spelling
leaves zero trace of that policy's machinery.

**Batching discipline.** The server fills ``batch_slots`` slots from the
FIFO queue and launches when the batch is full — or, when no future arrival
remains, launches the final partial batch. Under load (the regime the
robustness policies exist for) this coincides with "serve whatever is
queued"; in the all-off case it makes batch *composition* independent of
service times, which is what lets the steady-state path run as one batched
``simulate_embedding`` call.

**Closed loop.** With policies armed, composition depends on simulated time
(sheds happen at arrival instants, timeouts at batch formation), so batches
are simulated sequentially: each launch extends the served ConcatTrace and
re-runs ``simulate_embedding`` over the prefix — exact (classification and
DRAM timing are prefix-causal: a batch's stats never depend on later
batches; test-enforced) at O(batches²) trace cost, which is the price of
schedule-dependent traces. A ``ReplayOracle`` substitutes recorded per-batch
stats for the simulation, which is how checkpointed sweeps reconstruct a
``ServingResult`` from journaled stats bitwise.

A copy of the JAX package's ``repro.serving.scheduler``. ``ms`` is any of
this package's memory systems (``MemorySystem``/``MultiCoreMemorySystem``)
on whatever device it was built on: every served batch is priced by its
``simulate_embedding`` there (on the card: K1 or K2 or D2 for the on-chip
classification, D1 for DRAM timing), and the scheduler itself is host
Python over integer cycles.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.memory.system import EmbeddingBatchStats, EmbeddingTrace
from ..core.requests import (
    BatchLowering,
    Request,
    TrafficConfig,
    generate_requests,
    hot_table_set,
    lower_batch,
)
from ..core.results import ServingResult
from ..core.trace import ConcatTrace, FullTrace
from ..core.workload import EmbeddingOpSpec

__all__ = [
    "DEGRADE_MODES",
    "ReplayOracle",
    "RobustnessPolicy",
    "ServingScenario",
    "simulate_serving",
]

DEGRADE_MODES = ("hot_rows_only", "cache_bypass")

_RETRY_TAG = 0x4E7B


@dataclass(frozen=True)
class RobustnessPolicy:
    """The sweepable robustness policy set. Every default is the OFF
    spelling; ``RobustnessPolicy()`` is differential-proven identical to the
    plain fixed-trace path."""

    admission_watermark: Optional[int] = None   # queue depth; None = off
    deadline_cycles: Optional[int] = None       # per-attempt; None = off
    max_retries: int = 0                        # client retries; 0 = off
    retry_backoff_cycles: float = 4_096.0
    retry_backoff_factor: float = 2.0
    retry_jitter_frac: float = 0.5
    retry_seed: int = 0
    degrade_mode: Optional[str] = None          # None = off
    degrade_watermark: int = 1                  # queue depth arming degrade
    hot_fraction: float = 0.1                   # hot_rows_only keep fraction
    bypass_keep_tables: float = 0.5             # cache_bypass hot-table frac
    bypass_line_cycles: float = 40.0            # flat DRAM cost per bypassed line

    def __post_init__(self) -> None:
        if self.degrade_mode is not None and self.degrade_mode not in DEGRADE_MODES:
            raise ValueError(
                f"unknown degrade_mode {self.degrade_mode!r}; "
                f"options: {DEGRADE_MODES} or None")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    @property
    def all_off(self) -> bool:
        return (self.admission_watermark is None
                and self.deadline_cycles is None
                and self.max_retries == 0
                and self.degrade_mode is None)

    @property
    def key(self) -> tuple:
        return (
            "policy", self.admission_watermark, self.deadline_cycles,
            int(self.max_retries), float(self.retry_backoff_cycles),
            float(self.retry_backoff_factor), float(self.retry_jitter_frac),
            int(self.retry_seed), self.degrade_mode,
            int(self.degrade_watermark), float(self.hot_fraction),
            float(self.bypass_keep_tables), float(self.bypass_line_cycles),
        )


@dataclass(frozen=True)
class ServingScenario:
    """One sweepable serving scenario: traffic pattern x robustness policy
    x batch geometry. ``sweep(scenarios=[...])`` puts these next to the
    hardware axes."""

    name: str
    traffic: TrafficConfig
    policy: RobustnessPolicy = RobustnessPolicy()
    batch_slots: int = 8

    def __post_init__(self) -> None:
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")

    @property
    def key(self) -> tuple:
        return ("scenario", self.name, self.traffic.key, self.policy.key,
                int(self.batch_slots))


def _retry_backoff(policy: RobustnessPolicy, rid: int, attempt: int) -> int:
    """Cycles before retry ``attempt`` (1-based) of request ``rid`` —
    exponential with seeded jitter, deterministic in (seed, rid, attempt)
    and PYTHONHASHSEED-proof (integer-tuple rng seed, the ``core.faults``
    backoff idiom lifted to simulated cycles)."""
    base = policy.retry_backoff_cycles * (
        policy.retry_backoff_factor ** (attempt - 1)
    )
    rng = np.random.default_rng(
        (int(policy.retry_seed), _RETRY_TAG, int(rid), int(attempt))
    )
    return max(1, int(math.ceil(
        base * (1.0 + policy.retry_jitter_frac * float(rng.random()))
    )))


# --------------------------------------------------------------------------
# Service oracles
# --------------------------------------------------------------------------

class _SimOracle:
    """Live oracle: each served batch extends the concat and re-simulates the
    prefix with persistent on-chip state — the last batch's stats are exact
    (prefix-causality of classification + segmented DRAM timing)."""

    def __init__(self, ms, spec: EmbeddingOpSpec):
        self.ms = ms
        self.spec = spec
        self._traces: List[FullTrace] = []

    def service(self, full: FullTrace) -> EmbeddingBatchStats:
        self._traces.append(full)
        et = EmbeddingTrace.from_concat(
            self.spec, ConcatTrace.from_traces(self._traces)
        )
        return self.ms.simulate_embedding(et)[-1]


class ReplayOracle:
    """Replay oracle: substitutes recorded per-batch stats for simulation.

    The scheduler is deterministic given its oracle responses, so replaying
    journaled stats reproduces the original compositions — and therefore
    the original ``ServingResult`` — bitwise. ``finish()`` asserts the log
    was consumed exactly (a composition drift would desynchronize it)."""

    def __init__(self, stats: Sequence[EmbeddingBatchStats]):
        self._stats = list(stats)
        self._pos = 0

    def service(self, full: FullTrace) -> EmbeddingBatchStats:
        if self._pos >= len(self._stats):
            raise RuntimeError(
                "replay oracle exhausted: recorded serving log has "
                f"{len(self._stats)} batches but the scheduler composed more "
                "— the scenario/hardware does not match the recording")
        s = self._stats[self._pos]
        self._pos += 1
        return s

    def finish(self) -> None:
        if self._pos != len(self._stats):
            raise RuntimeError(
                f"replay oracle undrained: {len(self._stats) - self._pos} "
                "recorded batches unused — the scenario/hardware does not "
                "match the recording")


# --------------------------------------------------------------------------
# The scheduler
# --------------------------------------------------------------------------

@dataclass
class _QItem:
    req: Request
    attempt: int        # 0 = first submission
    enqueued: int       # this attempt's arrival cycle
    deadline: Optional[int]


def _service_cycles(stats: EmbeddingBatchStats) -> int:
    """Integer service cycles for timeline arithmetic (ceil of the batch's
    simulated cycles; the raw stats keep full precision for the identity
    surface)."""
    return max(1, int(math.ceil(float(stats.cycles))))


def simulate_serving(
    ms,
    spec: EmbeddingOpSpec,
    scenario: ServingScenario,
    requests: Optional[Sequence[Request]] = None,
    oracle=None,
    event_log: Optional[List[int]] = None,
) -> ServingResult:
    """Run one serving scenario against one memory system; returns the
    ``ServingResult`` (deterministic: same arguments => bitwise-identical
    result, including latency arrays and shed/timeout/retry counts).

    ``requests`` overrides stream generation (the sweep pre-generates one
    stream per scenario and shares it across hardware configs).  ``oracle``
    overrides the service-time source (``ReplayOracle`` for checkpoint
    reconstruction); default is live simulation through ``ms``.
    ``event_log``, when given, receives every value the simulated clock
    takes, in order — the monotonicity regression surface (see the module
    docstring's clock guarantee).
    """
    policy = scenario.policy
    traffic = scenario.traffic
    B = scenario.batch_slots
    if requests is None:
        requests = generate_requests(spec, traffic)
    offered = len(requests)

    hot_rank_limit = None
    bypass_tables = None
    bypass_line_cost = 0.0
    if policy.degrade_mode == "hot_rows_only":
        hot_rank_limit = max(
            1, int(spec.rows_per_table * policy.hot_fraction))
    elif policy.degrade_mode == "cache_bypass":
        bypass_tables = ~hot_table_set(requests, spec,
                                       policy.bypass_keep_tables)
        lines_per_vec = -(-spec.vector_bytes // ms.hw.onchip.line_bytes)
        bypass_line_cost = policy.bypass_line_cycles * lines_per_vec

    # -- all-policies-off fast path: composition is timing-free ------------
    if oracle is None and policy.all_off:
        lowered = [
            lower_batch(requests[i:i + B], spec)
            for i in range(0, offered, B)
        ]
        et = EmbeddingTrace.from_concat(
            spec, ConcatTrace.from_traces([bl.full for bl in lowered])
        )
        oracle = ReplayOracle(ms.simulate_embedding(et))

    if oracle is None:
        oracle = _SimOracle(ms, spec)

    # -- event loop ---------------------------------------------------------
    # Arrival heap entries: (time, seq, qitem-fields). seq breaks time ties
    # deterministically (original submissions before retries scheduled for
    # the same instant keep stream order).
    heap: List[Tuple[int, int, Request, int]] = []
    seq = 0
    for r in requests:
        heap.append((r.arrival, seq, r, 0))
        seq += 1
    heapq.heapify(heap)

    queue: List[_QItem] = []
    server_free = 0
    now = 0

    shed = timed_out = retries = abandoned = 0
    degraded_batches = dropped_rows = bypassed_lookups = 0
    batch_stats: List[EmbeddingBatchStats] = []
    batch_service: List[int] = []
    batch_starts: List[int] = []
    # per completed request (completion order): rid, first arrival, queue
    # delay of the served attempt, service cycles, completion cycle
    completions: List[Tuple[int, int, int, int, int]] = []
    first_arrival: Dict[int, int] = {r.rid: r.arrival for r in requests}
    last_finish = 0

    def fail_attempt(
        item_req: Request, attempt: int, at: int, clock: int, kind: str
    ):
        """Shed/timeout bookkeeping + client retry scheduling.

        ``at`` is when the attempt failed (the deadline for timeouts, the
        arrival for sheds); backoff counts from there. ``clock`` is the
        simulated time at which the failure is being processed — a timeout
        is only *observed* at the prune instant, which can be well past the
        deadline, so the resubmission is clamped to ``clock`` to keep the
        event heap (and thus ``now``) monotone.
        """
        nonlocal shed, timed_out, retries, abandoned, seq
        if kind == "shed":
            shed += 1
        else:
            timed_out += 1
        if attempt < policy.max_retries:
            retries += 1
            back = _retry_backoff(policy, item_req.rid, attempt + 1)
            heapq.heappush(
                heap, (max(at + back, clock), seq, item_req, attempt + 1)
            )
            seq += 1
        else:
            abandoned += 1

    def prune_expired(at: int) -> None:
        if policy.deadline_cycles is None:
            return
        kept: List[_QItem] = []
        for it in queue:
            if it.deadline is not None and it.deadline <= at:
                fail_attempt(it.req, it.attempt, it.deadline, at, "timeout")
            else:
                kept.append(it)
        queue[:] = kept

    while heap or queue:
        can_launch = bool(queue) and (len(queue) >= B or not heap)
        start = max(now, server_free) if can_launch else None
        if can_launch and not (heap and heap[0][0] <= start):
            prune_expired(start)
            if not (queue and (len(queue) >= B or not heap)):
                continue          # timeouts shrank the batch; wait for more
            take, queue[:] = queue[:B], queue[B:]
            degrade = (
                policy.degrade_mode is not None
                and len(queue) >= policy.degrade_watermark
            )
            bl: BatchLowering = lower_batch(
                [it.req for it in take], spec,
                hot_rank_limit=hot_rank_limit if degrade else None,
                bypass_tables=bypass_tables if degrade else None,
            )
            stats = oracle.service(bl.full)
            service = _service_cycles(stats)
            if degrade:
                degraded_batches += 1
                dropped_rows += bl.dropped_cold_rows
                bypassed_lookups += bl.bypassed_lookups
                service += int(math.ceil(
                    bl.bypassed_lookups * bypass_line_cost))
            finish = start + service
            batch_stats.append(stats)
            batch_service.append(service)
            batch_starts.append(start)
            for it in take:
                completions.append((
                    it.req.rid, first_arrival[it.req.rid],
                    start - it.enqueued, service, finish,
                ))
            last_finish = max(last_finish, finish)
            server_free = finish
            now = start
            if event_log is not None:
                event_log.append(now)
        else:
            t_a, _, req, attempt = heapq.heappop(heap)
            now = t_a
            if event_log is not None:
                event_log.append(now)
            prune_expired(now)
            if (policy.admission_watermark is not None
                    and len(queue) >= policy.admission_watermark):
                fail_attempt(req, attempt, now, now, "shed")
                continue
            ddl = (now + policy.deadline_cycles
                   if policy.deadline_cycles is not None else None)
            queue.append(_QItem(req=req, attempt=attempt,
                                enqueued=now, deadline=ddl))

    if isinstance(oracle, ReplayOracle):
        oracle.finish()

    # -- result assembly ----------------------------------------------------
    n_done = len(completions)
    lat = np.empty(n_done, dtype=np.int64)
    qd = np.empty(n_done, dtype=np.int64)
    sv = np.empty(n_done, dtype=np.int64)
    in_deadline = 0
    for i, (rid, arr0, qdelay, service, finish) in enumerate(completions):
        lat[i] = finish - arr0
        qd[i] = qdelay
        sv[i] = service
        if (policy.deadline_cycles is None
                or finish - arr0 <= policy.deadline_cycles):
            in_deadline += 1
    t0 = min((r.arrival for r in requests), default=0)
    makespan = max(last_finish - t0, 1)
    return ServingResult(
        scenario=scenario.name,
        hardware=ms.hw.name,
        policy=ms.hw.onchip.policy.value,
        clock_ghz=float(ms.hw.clock_ghz),
        offered=offered,
        completed=n_done,
        shed=shed,
        timed_out=timed_out,
        retries=retries,
        abandoned=abandoned,
        degraded_batches=degraded_batches,
        dropped_cold_rows=dropped_rows,
        bypassed_lookups=bypassed_lookups,
        num_batches=len(batch_stats),
        makespan_cycles=int(makespan),
        goodput=in_deadline / max(offered, 1),
        latency_cycles=lat,
        queue_cycles=qd,
        service_cycles=sv,
        batch_stats=batch_stats,
        batch_service_cycles=np.asarray(batch_service, dtype=np.int64),
        batch_start_cycles=np.asarray(batch_starts, dtype=np.int64),
    )
