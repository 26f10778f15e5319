"""Deterministic fault injection + fault-tolerance policy for the sweep engine.

Long multi-device DSE campaigns fail in infrastructure, not in math: a worker
hangs, a kernel launch throws transiently, a journal append is torn by a kill.
This module owns everything the execution layer needs to survive those faults
*deterministically*:

  * **`FaultPlan`** — a seeded, replayable schedule of injected faults, pure
    data: each `FaultEvent` names a kind (worker crash, transient eval
    exception, hung shard, torn journal write), a (shard, round) coordinate,
    and a fire count. Threaded through ``sweep(fault_plan=...)`` for tests
    and chaos CI only — production sweeps never construct one.
  * **`FaultInjector`** — the runtime for one sweep call: consumes the
    plan's events as (shard, round) coordinates come up, thread-safe, and
    records what actually fired (``.fired``) so a chaos run is auditable.
    Re-running the same plan against the same sweep fires the same events —
    replayable by construction (no wall-clock, no unseeded randomness).
  * **`FaultTolerance`** — the *policy* knobs of the recovery machinery:
    retry budget + exponential backoff with seeded jitter, the per-shard
    heartbeat watchdog timeout, and ``strict`` (raise instead of degrading).
    The default instance is what production sweeps run under.
  * **`FaultTelemetry`** — thread-safe counters for retries, failovers,
    hung/crashed shards, lost devices, torn writes, and per-shard
    wall/retry/key stats; recorded on ``SweepResult`` and in ``to_json``.
  * **`classify_exception`** — the transient / crash / fatal / kill
    taxonomy the supervisor dispatches on (see below).

The invariant all of this preserves: **any fault schedule that leaves at
least one live device yields a bitwise-identical ``SweepResult``** to the
fault-free sweep. Recovery only re-partitions *which worker evaluates which
memo keys* — and every batching layer underneath is bit-exact regardless of
batch composition — so retried, failed-over, and resumed evaluations produce
the same bits (differential-enforced in ``tests/test_faults.py``).

Exception taxonomy (``classify_exception``):

  * ``"transient"`` — worth retrying in place: ``TransientEvalError``
    subclasses (the injector's transient events), ``OSError`` (filesystem /
    RPC blips), and runtime errors whose message carries a transient status
    (RESOURCE_EXHAUSTED, DEADLINE_EXCEEDED, UNAVAILABLE, ABORTED).
  * ``"crash"`` — the worker (or its device) is gone: retrying in place is
    pointless, fail the shard over to the survivors.
  * ``"kill"`` — process-level interruption (``KeyboardInterrupt``,
    ``SystemExit``, the injector's ``InjectedKill``): propagate untouched.
  * ``"fatal"`` — everything else is a *bug*, not an infrastructure fault:
    wrapped with shard context (``ShardEvaluationError``) and raised,
    preserving completed sibling-shard results on the exception.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "FaultInjector",
    "FaultTolerance",
    "FaultTelemetry",
    "TransientEvalError",
    "InjectedTransientError",
    "InjectedWorkerCrash",
    "InjectedFatalError",
    "InjectedHang",
    "InjectedKill",
    "ShardEvaluationError",
    "FaultToleranceExhausted",
    "CheckpointLockedError",
    "classify_exception",
    "backoff_seconds",
]

FAULT_KINDS = ("transient", "crash", "hang", "fatal", "torn_write")

# Status substrings that mark a runtime error as transient (gRPC-style
# status codes in the message text; the same taxonomy as the JAX package's,
# so a fault schedule recovers the same way in both).
_TRANSIENT_PATTERNS = (
    "RESOURCE_EXHAUSTED", "DEADLINE_EXCEEDED", "UNAVAILABLE", "ABORTED",
)
# ... and as a dead worker/device (retry-in-place is pointless; fail over).
_CRASH_PATTERNS = ("DATA_LOSS", "device lost", "worker crashed")


# --------------------------------------------------------------------------
# Exceptions
# --------------------------------------------------------------------------

class TransientEvalError(RuntimeError):
    """Base class for errors the retry loop should absorb."""


class InjectedTransientError(TransientEvalError):
    """Injected transient evaluation failure (retried with backoff)."""


class InjectedWorkerCrash(RuntimeError):
    """Injected worker death (the shard fails over to survivors)."""


class InjectedFatalError(RuntimeError):
    """Injected non-recoverable bug (wrapped + raised, never failed over)."""


class InjectedHang(RuntimeError):
    """Raised by a hung worker AFTER the watchdog abandons it, so the
    injected hang's thread exits instead of leaking."""


class InjectedKill(KeyboardInterrupt):
    """Injected process death (e.g. mid-journal-append). Subclasses
    ``KeyboardInterrupt`` so no ``except Exception`` recovery path can
    swallow it — it behaves like a SIGINT/SIGKILL would."""


class CheckpointLockedError(RuntimeError):
    """A live process holds the checkpoint journal's lockfile."""


class FaultToleranceExhausted(RuntimeError):
    """No surviving shard/device can take the remaining memo keys."""


class ShardEvaluationError(RuntimeError):
    """A shard's evaluation failed in a way fault tolerance does not absorb
    (a fatal error, or any failure under ``strict=True``).

    Carries full context instead of a bare worker re-raise: the shard index,
    its device, the memo keys and class-key groups it owned, the original
    cause, and — crucially — ``completed``: every sibling shard's finished
    results, so callers (and the checkpoint journal) never discard
    surviving work because one shard died.
    """

    def __init__(
        self,
        shard: int,
        device: str,
        keys: Sequence[tuple],
        class_groups: Sequence[str],
        completed: Dict[tuple, list],
        cause: Optional[BaseException],
        prefix: Optional[str] = None,
    ) -> None:
        self.shard = int(shard)
        self.device = str(device)
        self.keys = list(keys)
        self.class_groups = list(class_groups)
        self.completed = dict(completed)
        self.cause = cause
        head = prefix or "shard evaluation failed"
        shown = ", ".join(self.class_groups[:3])
        if len(self.class_groups) > 3:
            shown += ", ..."
        super().__init__(
            f"{head}: shard {self.shard} on {self.device} owned "
            f"{len(self.keys)} memo keys in {len(self.class_groups)} "
            f"class-key groups [{shown}]: {cause!r}; "
            f"{len(self.completed)} completed sibling-shard keys are "
            "preserved on this exception (and journaled when checkpointed)"
        )


def classify_exception(exc: BaseException) -> str:
    """``"transient"`` / ``"crash"`` / ``"kill"`` / ``"fatal"`` — the
    taxonomy the shard supervisor dispatches on (see module docstring)."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return "kill"
    if isinstance(exc, TransientEvalError):
        return "transient"
    if isinstance(exc, (InjectedWorkerCrash, InjectedHang)):
        return "crash"
    if isinstance(exc, OSError):
        return "transient"
    msg = str(exc)
    if any(p in msg for p in _CRASH_PATTERNS):
        return "crash"
    if any(p in msg for p in _TRANSIENT_PATTERNS):
        return "transient"
    return "fatal"


# --------------------------------------------------------------------------
# Fault plans (pure data, seeded, replayable)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire ``count`` times at (shard, round).

    ``round`` counts evaluation rounds globally across the sweep (one per
    cadence chunk per slice, in order). ``shard`` is the shard index in the
    ``ShardPlan`` — stable across failover, so a plan targeting shard 2
    keeps targeting shard 2 even after shard 1 died. ``torn_write`` events
    ignore ``shard`` (the journal append happens on the sweep's own thread)."""

    kind: str
    shard: int = 0
    round: int = 0
    count: int = 1

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.count < 1 or self.shard < 0 or self.round < 0:
            raise ValueError(f"invalid fault event: {self}")


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic, replayable fault schedule — pure data.

    Thread through ``sweep(fault_plan=...)`` (tests / chaos CI only). The
    same plan against the same sweep spec fires the same events in the same
    places; recovery is then exercised end-to-end and the result is asserted
    bitwise identical to the fault-free run."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(self.events))

    def has_kind(self, kind: str) -> bool:
        return any(e.kind == kind for e in self.events)

    def has_shard_events(self) -> bool:
        """True when any event targets a shard worker (everything except
        ``torn_write``, which fires on the sweep's own journal append)."""
        return any(e.kind != "torn_write" for e in self.events)

    @classmethod
    def chaos(
        cls,
        seed: int,
        num_shards: int,
        num_rounds: int = 1,
        events: int = 3,
        kinds: Sequence[str] = ("transient", "crash", "hang"),
    ) -> "FaultPlan":
        """Seeded random schedule for chaos tests. Guarantees the invariant
        precondition — at least one shard survives every round — by capping
        lethal events (crash/hang) at ``num_shards - 1`` per round; an
        over-budget draw degrades to a transient instead."""
        if num_shards < 1 or num_rounds < 1:
            raise ValueError("need >= 1 shard and >= 1 round")
        rng = random.Random(seed)
        lethal_per_round: Dict[int, int] = {}
        out: List[FaultEvent] = []
        for _ in range(events):
            kind = rng.choice(tuple(kinds))
            shard = rng.randrange(num_shards)
            rnd = rng.randrange(num_rounds)
            if kind in ("crash", "hang"):
                if lethal_per_round.get(rnd, 0) >= num_shards - 1:
                    kind = "transient"
                else:
                    lethal_per_round[rnd] = lethal_per_round.get(rnd, 0) + 1
            count = rng.choice((1, 2)) if kind == "transient" else 1
            out.append(FaultEvent(kind=kind, shard=shard, round=rnd,
                                  count=count))
        return cls(events=tuple(out), seed=seed)


class FaultInjector:
    """Runtime state for one sweep call over a ``FaultPlan``.

    ``begin_round()`` advances the global round counter (the sweep calls it
    once per evaluation round); ``fire(shard, cancel)`` raises/blocks when a
    matching event has count left; ``maybe_tear()`` consumes a ``torn_write``
    event for the current round. All methods are thread-safe. ``fired``
    records (kind, shard, round) in fire order for auditing."""

    def __init__(self, plan: FaultPlan, telemetry: "FaultTelemetry" = None):
        self.plan = plan
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._remaining = [e.count for e in plan.events]
        self._round = -1
        self.fired: List[Tuple[str, int, int]] = []

    @property
    def current_round(self) -> int:
        return self._round

    def begin_round(self) -> int:
        with self._lock:
            self._round += 1
            return self._round

    def _take(self, shard: Optional[int], torn: bool) -> Optional[FaultEvent]:
        with self._lock:
            for i, ev in enumerate(self.plan.events):
                if self._remaining[i] <= 0 or ev.round != self._round:
                    continue
                if torn != (ev.kind == "torn_write"):
                    continue
                if not torn and ev.shard != shard:
                    continue
                self._remaining[i] -= 1
                self.fired.append((ev.kind, ev.shard, self._round))
                return ev
        return None

    def fire(self, shard: int, cancel_event=None) -> None:
        """Raise/block per the plan for (shard, current round). Called by
        each shard worker at every evaluation attempt; a no-op when nothing
        is scheduled (or everything scheduled already fired)."""
        ev = self._take(shard, torn=False)
        if ev is None:
            return
        where = f"(shard {shard}, round {self._round})"
        if ev.kind == "transient":
            raise InjectedTransientError(f"injected transient failure {where}")
        if ev.kind == "crash":
            raise InjectedWorkerCrash(f"injected worker crash {where}")
        if ev.kind == "fatal":
            raise InjectedFatalError(f"injected fatal error {where}")
        # hang: stop heartbeating until the watchdog abandons this shard
        # (sets the cancel event), then exit the thread via InjectedHang so
        # the test's hung worker does not leak past the sweep.
        if cancel_event is not None:
            cancel_event.wait()
        raise InjectedHang(f"injected hang abandoned by watchdog {where}")

    def maybe_tear(self) -> bool:
        """Consume a ``torn_write`` event for the current round (the journal
        ``record`` path asks before appending)."""
        ev = self._take(None, torn=True)
        if ev is not None and self.telemetry is not None:
            self.telemetry.note_torn_write()
        return ev is not None


# --------------------------------------------------------------------------
# Fault-tolerance policy (retry / backoff / watchdog / strictness)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultTolerance:
    """Recovery policy for sharded sweep execution.

    * ``max_retries`` transient failures per shard attempt retry in place,
      sleeping ``backoff_base_s * backoff_factor**(attempt-1)`` scaled by a
      seeded jitter in ``[1, 1 + jitter_frac)`` — deterministic in
      ``(seed, shard, attempt)``, so two runs of the same plan back off
      identically (replayability; also decorrelates shards).
    * ``shard_timeout_s`` arms the per-shard heartbeat watchdog: a shard
      whose heartbeat (refreshed at every evaluation attempt) goes stale for
      longer is abandoned and its memo keys fail over to the surviving
      shards. ``None`` (default) disarms it — an unbounded evaluation is
      indistinguishable from a hang, so the bound must be chosen by the
      caller who knows the workload scale.
    * ``strict=True`` turns graceful degradation (shrink the plan, finish
      the sweep) into an immediate ``ShardEvaluationError`` — for callers
      who prefer a loud failure over a slower success.
    * ``max_failover_rounds`` bounds re-partitioning (default: the shard
      count), so a fault that follows the keys cannot livelock the sweep.
    """

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    jitter_frac: float = 0.25
    seed: int = 0
    shard_timeout_s: Optional[float] = None
    watchdog_poll_s: float = 0.02
    strict: bool = False
    max_failover_rounds: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_retries < 0 or self.backoff_base_s < 0:
            raise ValueError(f"invalid retry policy: {self}")
        if self.backoff_factor < 1.0 or self.jitter_frac < 0:
            raise ValueError(f"invalid backoff policy: {self}")
        if self.shard_timeout_s is not None and self.shard_timeout_s <= 0:
            raise ValueError("shard_timeout_s must be positive (or None)")


def backoff_seconds(tol: FaultTolerance, shard: int, attempt: int) -> float:
    """Delay before retry ``attempt`` (1-based) on ``shard``: exponential in
    the attempt, jittered by a PRNG seeded from (policy seed, shard,
    attempt) — fully deterministic, no global random state."""
    base = tol.backoff_base_s * (tol.backoff_factor ** (attempt - 1))
    # Deterministic integer mix (no str hashing: PYTHONHASHSEED-proof).
    mixed = (int(tol.seed) * 1_000_003 + int(shard)) * 1_000_003 + int(attempt)
    rng = random.Random(mixed)
    return base * (1.0 + tol.jitter_frac * rng.random())


# --------------------------------------------------------------------------
# Failure telemetry
# --------------------------------------------------------------------------

class FaultTelemetry:
    """Thread-safe counters describing how a sweep survived its faults.

    Recorded on ``SweepResult.telemetry`` and serialized by
    ``SweepResult.to_json`` (``fault_telemetry``). Fault-free sweeps report
    all-zero counters — CI asserts that, so spurious retries/failovers in
    the production path are themselves a test failure."""

    COUNTER_FIELDS = (
        "retries", "transient_errors", "worker_crashes", "hung_shards",
        "retries_exhausted", "failed_shards", "failovers", "failover_keys",
        "lost_devices", "torn_writes",
    )

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for name in self.COUNTER_FIELDS:
            setattr(self, name, 0)
        # shard index -> {"device", "keys", "wall_s", "retries",
        #                 "failures": [kind, ...]} (accumulated over rounds)
        self.shards: Dict[int, Dict[str, object]] = {}

    def _shard(self, shard: int) -> Dict[str, object]:
        rec = self.shards.get(shard)
        if rec is None:
            rec = self.shards[shard] = {
                "device": None, "keys": 0, "wall_s": 0.0, "retries": 0,
                "failures": [],
            }
        return rec

    def note_retry(self, shard: int) -> None:
        with self._lock:
            self.retries += 1
            self._shard(shard)["retries"] += 1

    def note_transient(self, shard: int) -> None:
        with self._lock:
            self.transient_errors += 1

    def note_shard(self, shard: int, device: str, keys: int,
                   wall_s: float) -> None:
        """One shard completed one supervision wave successfully (per-shard
        retry counts accumulate separately via ``note_retry``)."""
        with self._lock:
            rec = self._shard(shard)
            rec["device"] = device
            rec["keys"] = int(rec["keys"]) + int(keys)
            rec["wall_s"] = round(float(rec["wall_s"]) + float(wall_s), 6)

    def note_shard_failure(self, shard: int, kind: str,
                           device: str = None) -> None:
        with self._lock:
            self.failed_shards += 1
            if kind == "crash":
                self.worker_crashes += 1
            elif kind == "hang":
                self.hung_shards += 1
            elif kind == "transient":
                self.retries_exhausted += 1
            rec = self._shard(shard)
            if device is not None:
                rec["device"] = device
            rec["failures"] = list(rec["failures"]) + [kind]

    def note_failover(self, keys: int, survivors: int) -> None:
        with self._lock:
            self.failovers += 1
            self.failover_keys += int(keys)

    def note_lost_devices(self, n: int) -> None:
        with self._lock:
            self.lost_devices += int(n)

    def note_torn_write(self) -> None:
        with self._lock:
            self.torn_writes += 1

    @property
    def any_faults(self) -> bool:
        return any(getattr(self, f) for f in self.COUNTER_FIELDS)

    def brief(self) -> Dict[str, int]:
        """Counters only (no per-shard detail) — the benchmark perf row."""
        with self._lock:
            return {f: int(getattr(self, f)) for f in self.COUNTER_FIELDS}

    def to_dict(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                f: int(getattr(self, f)) for f in self.COUNTER_FIELDS
            }
            out["shards"] = {
                str(i): dict(rec) for i, rec in sorted(self.shards.items())
            }
            return out
