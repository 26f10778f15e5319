"""Device sharding for the DSE sweep's memo-key space.

The sweep engine reduces a config grid to a set of memo keys (distinct
classification + DRAM-timing evaluations). Those keys are embarrassingly
parallel — every batching layer underneath (`classify_embedding_many`, the
stack/rrip analytic passes, ``dram_timing_many``) is bit-exact regardless of
batch composition — so scaling out is a pure partitioning problem:

  * **Partition by class-key group**, not by key: placement siblings share
    ONE classification with their class key, so splitting a group across
    shards would re-classify it per shard. Whole groups round-robin across
    shards by size (largest first) for balance, deterministically.
  * **One supervised worker thread per shard**, each evaluating its key
    subset through the regular engine on its own device: a CUDA shard makes
    its card the thread's current device (``torch.cuda.device``) and
    launches on a CUDA stream of its own (``torch.cuda.stream``; both are
    thread-local in torch, so shards on one card or on several run their
    launches concurrently), a CPU shard runs the plain versions. The
    evaluation function is handed the shard's device, where it builds the
    shard's memory systems. The per-shard stats dicts merge back into the
    single memo table — bitwise identical to the unsharded pass,
    differential-enforced.
  * **Fault tolerance** (see ``core/faults.py`` for the taxonomy): each
    worker retries transient failures in place with seeded exponential
    backoff; a heartbeat watchdog (armed via
    ``FaultTolerance.shard_timeout_s``) abandons hung shards; crashed or
    hung shards have their memo keys re-partitioned onto the survivors
    (the plan shrinks, the sweep completes — ``strict=True`` raises
    instead). Because the batching layers are composition-invariant, every
    recovery path is bitwise identical to the fault-free run. Fatal errors
    (bugs, not infrastructure) raise ``ShardEvaluationError`` with shard/
    device/key-group context, carrying all completed sibling-shard results
    so surviving work is never discarded.
  * **Cross-device gather check**: each device's shards' key count is a
    tensor on that device; the subtotals are copied to the first device
    and summed there, and the sum must see every key — a cheap end-to-end
    assertion that the devices the plan claims took part. One process, no
    ``torch.distributed``.

``sweep(devices=8)`` is the user surface; this module only plans and
executes the partition.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core import profiling
from ..core.faults import (
    FaultInjector,
    FaultTelemetry,
    FaultTolerance,
    FaultToleranceExhausted,
    ShardEvaluationError,
    backoff_seconds,
    classify_exception,
)
from ..device import DeviceLike, indexed_device

__all__ = [
    "ShardPlan",
    "resolve_shard_plan",
    "partition_by_class_key",
    "evaluate_sharded",
    "shard_key_totals",
]


@dataclass(frozen=True)
class ShardPlan:
    """How to split one evaluation round: ``devices[i]`` hosts shard i."""

    devices: tuple            # one indexed torch.device per shard (may repeat)

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> int:
        return len(set(self.devices))


def resolve_shard_plan(devices, device: DeviceLike = "cuda") -> ShardPlan:
    """``devices`` as an int takes that many shards cycled over the local
    devices of the sweep's ``device`` type — ``cuda:0 … cuda:{n-1}`` for
    CUDA, the CPU for ``cpu`` — oversubscribing when fewer exist (still
    bit-exact, just less parallel); a device sequence pins one shard per
    device. Every device comes back indexed (``cuda`` names the current
    card), and CUDA raises without a card."""
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"need >= 1 shard, got {devices}")
        dev = indexed_device(device)
        local = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                 if dev.type == "cuda" else [dev])
        devs = tuple(itertools.islice(itertools.cycle(local), devices))
    else:
        devs = tuple(indexed_device(d) for d in devices)
        if not devs:
            raise ValueError("empty device sequence")
    return ShardPlan(devices=devs)


def partition_by_class_key(
    items: Dict[tuple, tuple], num_shards: int
) -> List[Dict[tuple, tuple]]:
    """Split ``{key: (ms, class_key)}`` into per-shard dicts, keeping every
    class-key group whole (placement siblings share one classification) and
    balancing by group size, largest first. Deterministic in the input
    order, so resumed/re-run sweeps partition identically."""
    groups: Dict[tuple, List[tuple]] = {}
    for key, (_, ck) in items.items():
        groups.setdefault(ck, []).append(key)
    # Stable balance: largest groups first (ties keep insertion order), each
    # onto the currently lightest shard (ties -> lowest index).
    order = sorted(groups, key=lambda ck: -len(groups[ck]))
    loads = [0] * num_shards
    parts: List[Dict[tuple, tuple]] = [dict() for _ in range(num_shards)]
    for ck in order:
        i = loads.index(min(loads))
        for key in groups[ck]:
            parts[i][key] = items[key]
        loads[i] += len(groups[ck])
    return parts


@contextmanager
def _on_shard_device(device: torch.device):
    """Run the enclosed launches on ``device``: a CUDA card made the
    thread's current device, on a stream of the shard's own (from torch's
    stream pool, so shards of one wave on one card launch concurrently),
    waited for before the worker reports; nothing to set for the CPU."""
    if device.type != "cuda":
        yield
        return
    stream = torch.cuda.Stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield
    stream.synchronize()


class _ShardWorker:
    """Per-shard supervision state for one wave of workers."""

    __slots__ = (
        "index", "device", "part", "thread", "result", "error", "ok",
        "hung", "retries", "wall", "heartbeat", "done", "cancel",
    )

    def __init__(self, index: int, device, part: Dict[tuple, tuple]):
        self.index = index
        self.device = device
        self.part = part
        self.thread: Optional[threading.Thread] = None
        self.result: Dict[tuple, list] = {}
        self.error: Optional[BaseException] = None
        self.ok = False
        self.hung = False
        self.retries = 0
        self.wall = 0.0
        self.heartbeat = time.monotonic()
        self.done = threading.Event()
        self.cancel = threading.Event()


def _shard_worker_main(
    w: _ShardWorker,
    eval_fn: Callable[[Dict[tuple, tuple], torch.device], Dict[tuple, list]],
    tol: FaultTolerance,
    injector: Optional[FaultInjector],
    tele: FaultTelemetry,
) -> None:
    """Worker body: evaluate on the shard's device (a CUDA shard on its
    card, as the thread's current device, on a stream of its own), retry
    transient failures in place with seeded backoff, surface everything
    else to the supervisor via ``w.error``. Never raises — the supervisor
    classifies."""
    t0 = time.monotonic()
    try:
        with _on_shard_device(w.device):
            attempt = 0
            while True:
                w.heartbeat = time.monotonic()
                try:
                    if injector is not None:
                        injector.fire(w.index, w.cancel)
                    w.result = eval_fn(w.part, w.device) if w.part else {}
                    w.ok = True
                    return
                except Exception as exc:  # noqa: BLE001 — classified below
                    if classify_exception(exc) != "transient":
                        raise
                    tele.note_transient(w.index)
                    if attempt >= tol.max_retries or w.cancel.is_set():
                        raise
                    last_exc = exc
                attempt += 1
                w.retries += 1
                tele.note_retry(w.index)
                # Backoff between attempts; a watchdog cancel interrupts the
                # wait (the shard is being abandoned, stop burning time).
                with profiling.stage("fault_wait"):
                    if w.cancel.wait(backoff_seconds(tol, w.index, attempt)):
                        raise last_exc
    except BaseException as exc:  # noqa: BLE001 — handed to the supervisor
        w.error = exc
    finally:
        w.wall = time.monotonic() - t0
        w.done.set()


def _run_wave(
    workers: List[_ShardWorker],
    eval_fn: Callable[[Dict[tuple, tuple], torch.device], Dict[tuple, list]],
    tol: FaultTolerance,
    injector: Optional[FaultInjector],
    tele: FaultTelemetry,
) -> None:
    """Run one wave of shard workers to completion (or abandonment).

    Threads are daemonic because a hung worker cannot be force-killed in
    Python: the watchdog marks it ``hung``, sets its cancel event (so
    cooperative waits — backoff sleeps, injected hangs — exit promptly),
    and stops waiting for it. With no timeout armed the supervisor is a
    plain zero-poll join, so the fault-free path pays no watchdog tax."""
    for w in workers:
        w.thread = threading.Thread(
            target=_shard_worker_main,
            args=(w, eval_fn, tol, injector, tele),
            name=f"sweep-shard-{w.index}",
            daemon=True,
        )
        w.thread.start()
    if tol.shard_timeout_s is None:
        for w in workers:
            w.done.wait()
        return
    pending = list(workers)
    while pending:
        pending[0].done.wait(tol.watchdog_poll_s)
        now = time.monotonic()
        still: List[_ShardWorker] = []
        for w in pending:
            if w.done.is_set():
                continue
            if now - w.heartbeat > tol.shard_timeout_s:
                w.hung = True
                w.cancel.set()  # abandoned; thread may finish later, ignored
                continue
            still.append(w)
        pending = still


def _shard_error(
    w: _ShardWorker,
    merged: Dict[tuple, list],
    prefix: Optional[str] = None,
) -> ShardEvaluationError:
    groups = sorted({str(ck) for (_ms, ck) in w.part.values()})
    return ShardEvaluationError(
        shard=w.index,
        device=str(w.device),
        keys=list(w.part),
        class_groups=groups,
        completed=merged,
        cause=w.error,
        prefix=prefix,
    )


def evaluate_sharded(
    items: Dict[tuple, tuple],
    plan: ShardPlan,
    eval_fn: Callable[[Dict[tuple, tuple], torch.device], Dict[tuple, list]],
    *,
    tolerance: Optional[FaultTolerance] = None,
    injector: Optional[FaultInjector] = None,
    telemetry: Optional[FaultTelemetry] = None,
) -> Dict[tuple, list]:
    """Partition ``items``, evaluate each shard on its device under
    supervision (``eval_fn(part, device)``), and merge the per-key stats
    back (original key order preserved).

    Recovery semantics (``tolerance``, default ``FaultTolerance()``):
    transient worker errors retry in place with seeded backoff; crashed,
    hung (watchdog-abandoned), or retry-exhausted shards are dropped and
    their memo keys re-partitioned onto the surviving shards — the plan
    shrinks, the call completes, and the merged result is bitwise identical
    because every batching layer is composition-invariant. ``strict=True``
    raises ``ShardEvaluationError`` instead of degrading. Fatal errors
    always raise it, carrying every completed sibling shard's results as
    ``.completed``. Kills (``KeyboardInterrupt``/``SystemExit``) propagate
    untouched. ``injector`` threads a test-only fault schedule into the
    workers; ``telemetry`` accumulates retry/failover/degradation counts.
    """
    tol = tolerance if tolerance is not None else FaultTolerance()
    tele = telemetry if telemetry is not None else FaultTelemetry()
    parts = partition_by_class_key(items, plan.num_shards)
    # Shard ids are indices into plan.devices and stay stable across
    # failover waves, so a FaultPlan's (shard, round) coordinates keep
    # meaning the same worker even after other shards died.
    alive: Dict[int, object] = dict(enumerate(plan.devices))
    assignments: List[Tuple[int, Dict[tuple, tuple]]] = [
        (i, parts[i]) for i in range(plan.num_shards) if parts[i]
    ]
    merged: Dict[tuple, list] = {}
    completed_counts = [0] * plan.num_shards
    max_failovers = (
        tol.max_failover_rounds
        if tol.max_failover_rounds is not None
        else plan.num_shards
    )
    failover_round = 0

    while assignments:
        workers = [_ShardWorker(i, alive[i], part) for i, part in assignments]
        _run_wave(workers, eval_fn, tol, injector, tele)

        failed: List[_ShardWorker] = []
        for w in workers:
            # A worker that finished after the watchdog abandoned it stays
            # failed: its keys are already earmarked for failover and the
            # completed-count bookkeeping must see each key exactly once.
            if w.ok and not w.hung:
                merged.update(w.result)
                completed_counts[w.index] += len(w.part)
                tele.note_shard(w.index, device=str(w.device),
                                keys=len(w.part), wall_s=w.wall)
            else:
                failed.append(w)
        if not failed:
            break

        # Process-level kills propagate untouched (Ctrl-C, injected kill).
        for w in failed:
            if w.error is not None and classify_exception(w.error) == "kill":
                raise w.error
        # Fatal = a bug, not infrastructure: never failed over. Wrap with
        # shard context; completed sibling results ride along.
        for w in failed:
            if not w.hung and classify_exception(w.error) == "fatal":
                raise _shard_error(w, merged) from w.error

        for w in failed:
            kind = "hang" if w.hung else classify_exception(w.error)
            tele.note_shard_failure(w.index, kind, device=str(w.device))
        if tol.strict:
            w = failed[0]
            raise _shard_error(
                w, merged,
                prefix="strict fault tolerance (no failover): shard "
                       + ("hung" if w.hung else "failed"),
            ) from w.error

        # Graceful degradation: drop the failed shards, re-partition their
        # keys onto the survivors, and run another wave over the shrunken
        # plan. partition_by_class_key is deterministic, and the batching
        # layers are composition-invariant, so the failover result is
        # bitwise identical to the fault-free evaluation.
        failed_keys: Dict[tuple, tuple] = {}
        for w in failed:
            alive.pop(w.index, None)
            failed_keys.update(w.part)
        live_devs = set(alive.values())
        lost = len({w.device for w in failed} - live_devs)
        if lost:
            tele.note_lost_devices(lost)
        if not alive:
            hung_n = sum(1 for w in failed if w.hung)
            hint = (
                " (all failures are watchdog timeouts: if the shards were "
                "making progress, FaultTolerance.shard_timeout_s is below "
                "the legitimate per-round evaluation time — raise it)"
                if hung_n == len(failed) else ""
            )
            raise FaultToleranceExhausted(
                f"every shard failed; {len(failed_keys)} memo keys have no "
                f"surviving device{hint}"
            ) from failed[0].error
        failover_round += 1
        if failover_round > max_failovers:
            raise FaultToleranceExhausted(
                f"failover depth {failover_round} exceeds "
                f"max_failover_rounds={max_failovers}"
            ) from failed[0].error
        survivors = sorted(alive)
        tele.note_failover(keys=len(failed_keys), survivors=len(survivors))
        sub = partition_by_class_key(failed_keys, len(survivors))
        assignments = [(i, p) for i, p in zip(survivors, sub) if p]

    # Cross-device participation check: every completed shard's key count
    # must arrive in the device-summed total. Cheap, and it moves the counts
    # through the devices themselves rather than trusting the supervisor's
    # bookkeeping.
    total = shard_key_totals(completed_counts, plan)
    if total != len(items) or len(merged) != len(items):
        raise RuntimeError(
            f"sharded gather dropped keys: the device sum saw {total}, merged "
            f"{len(merged)}, expected {len(items)}"
        )
    return {k: merged[k] for k in items}


def shard_key_totals(counts: Sequence[int], plan: ShardPlan) -> int:
    """Sum the per-shard key counts across the plan's devices: shards fold
    onto their distinct devices (oversubscribed plans stack their counts per
    device), each device's subtotal is a tensor on that device, and the
    subtotals are copied to the first device and summed there. Devices that
    contributed zero keys are left out: after a failover their hardware may
    be the thing that died. With fewer than two contributing devices the
    sum stays on the host."""
    per_dev: Dict[torch.device, int] = {}
    for dev, n in zip(plan.devices, counts):
        per_dev[dev] = per_dev.get(dev, 0) + int(n)
    live = [(d, n) for d, n in per_dev.items() if n > 0]
    if len(live) < 2:
        return int(sum(n for _, n in live))
    first = live[0][0]
    parts = [torch.tensor([n], dtype=torch.int64, device=d).to(first) for d, n in live]
    return int(torch.stack(parts).sum())
