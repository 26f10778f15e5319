"""Lightweight per-stage wall-time accounting for the simulation hot path.

The DSE sweep's perf work needs to know where a config's milliseconds go:
trace generation, on-chip classification, the cache scan itself, DRAM
timing, or host<->device synchronization. This module is the single owner
of that attribution: hot-path stages wrap themselves in ``stage(name)`` and
a profiling session (``collect()``) accumulates exclusive wall time per
stage. When no session is active the wrappers cost one global read and a
``None`` check — nothing is timed, so ``simulate()``/``sweep()`` keep their
normal performance.

Stages nest: time spent inside an inner ``stage`` is attributed to the
inner stage only (exclusive accounting), so ``classify`` does not
double-count the ``cache_scan`` dispatch it contains, and ``host_sync``
blocks (device-result extraction) subtract cleanly from whichever stage
they interrupt.

Canonical stage names used by the memory pipeline:

  * ``trace_gen``   — index-trace generation + expansion + translation
  * ``classify``    — policy classification (stream prep, accounting)
  * ``cache_scan``  — set-associative cache engine dispatch (scan or kernel)
  * ``dram``        — DRAM timing (FR-FCFS ordering + event scan)
  * ``source_finish`` — a multi-source DRAM call's per-source finish
                      (host, run-granular, from the scan's chunk results)
  * ``place``       — the NUMA placement transform of a miss stream (host)
  * ``host_sync``   — blocking device->host result extraction (``.cpu()``
                      of device tensors; the cost the device-resident
                      pipeline is designed to keep out of the inner loop)
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

__all__ = ["stage", "collect", "is_active", "StageProfile"]


class StageProfile:
    """Accumulated exclusive seconds per stage for one profiling session.

    Thread-safe: the sharded sweep runs stages on several worker threads at
    once, so nesting state lives per thread (a shared stack would attribute
    one thread's children to another's parent frame) and the accumulator
    takes a lock. Concurrent stages both count their own wall time — the
    breakdown is attribution, not a partition of the session's wall clock.
    """

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._local = threading.local()  # .stack: [name, started, child_s]

    def _stack(self) -> List[list]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def breakdown(self, total_seconds: Optional[float] = None) -> Dict[str, float]:
        """Stage -> seconds, with ``other`` filling up to ``total_seconds``."""
        out = dict(sorted(self.seconds.items(), key=lambda kv: -kv[1]))
        if total_seconds is not None:
            out["other"] = max(0.0, total_seconds - sum(self.seconds.values()))
        return out


_active: Optional[StageProfile] = None


def is_active() -> bool:
    """True while a ``collect()`` session is open.

    Hot-path code uses this to force device computations to complete inside
    their own stage (``torch.cuda.synchronize``) so that asynchronous-launch
    wait time is attributed to the compute stage, not to the ``host_sync``
    extraction that would otherwise absorb it. Never true in production, so
    the extra synchronization only exists while profiling.
    """
    return _active is not None


@contextmanager
def stage(name: str) -> Iterator[None]:
    """Attribute the enclosed wall time to ``name`` (exclusive of children)."""
    prof = _active
    if prof is None:
        yield
        return
    stack = prof._stack()
    stack.append([name, time.perf_counter(), 0.0])
    try:
        yield
    finally:
        frame = stack.pop()
        elapsed = time.perf_counter() - frame[1]
        prof._add(name, elapsed - frame[2])
        if stack:
            stack[-1][2] += elapsed


@contextmanager
def collect() -> Iterator[StageProfile]:
    """Open a profiling session; hot-path ``stage`` blocks report into it."""
    global _active
    prev = _active
    prof = StageProfile()
    _active = prof
    try:
        yield prof
    finally:
        _active = prev
