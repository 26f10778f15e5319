"""Spans over the port's hot paths, with two sinks: exclusive host wall time
per stage, and the device trace.

The DSE sweep's perf work needs to know where a config's milliseconds go:
trace generation, on-chip classification, the cache scan itself, DRAM
timing, or host<->device synchronization; a ranking server's needs to know
where a batch's dispatch goes, beside what the card was doing meanwhile.
This module is the single owner of that attribution: hot-path code wraps
itself in ``stage(name)``, and the span reaches whichever sink is recording:

  * a profiling session (``collect()``) accumulates exclusive wall time per
    stage on the host's clock;
  * while ``torch.profiler`` records, the stage opens a record-function
    range (``_RecordFunctionFast``, the C++ range beneath
    ``record_function``, a fourth of its cost under the profiler): a host
    event on the clock of CUPTI's kernels, copies and fills, nested under
    the enclosing stage on the same thread. Being no user annotation, it
    leaves no annotation on the device's side of the trace.

When neither records, ``stage`` costs one global read and one
profiler-enabled check and returns a shared no-op context manager, so
``simulate()``/``sweep()`` and the DLRM forward keep their normal
performance. No range is entered unless the profiler records.

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

and by the DLRM forward (``models/dlrm.py``), one of each a call:

  * ``dlrm.forward``    — the whole of ``DLRM.forward``; the root of the four
                          below
  * ``dlrm.bottom_mlp`` — the bottom MLP over the dense features
  * ``dlrm.embedding``  — the embedding bags: ``ops.embedding_bag`` (the
                          flat-index arithmetic and K3's launch) or, on the
                          pinned path, ``ops.embedding_bag_pinned``
  * ``dlrm.interact``   — the dot interaction (``cat``, ``bmm``, the
                          strict upper triangle's gather)
  * ``dlrm.top_mlp``    — the concatenation and the top MLP
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

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
    """True while a ``collect()`` session is open (``torch.profiler`` alone
    does not make it true).

    Hot-path code uses this to force device computations to complete inside
    their own stage (``torch.cuda.synchronize``) so that asynchronous-launch
    wait time is attributed to the compute stage, not to the ``host_sync``
    extraction that would otherwise absorb it. Never true in production, so
    the extra synchronization only exists while profiling.
    """
    return _active is not None


class _Off:
    """The span while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    """One span while a sink records: a record-function range under the
    profiler, exclusive wall time into ``prof`` under ``collect()``."""

    __slots__ = ("name", "prof", "range")

    def __init__(self, name: str, prof: Optional[StageProfile], traced: bool) -> None:
        self.name, self.prof = name, prof
        self.range = _RecordFunctionFast(name) if traced else None

    def __enter__(self) -> None:
        if self.range is not None:
            self.range.__enter__()
        if self.prof is not None:
            self.prof._stack().append([self.name, time.perf_counter(), 0.0])

    def __exit__(self, *exc) -> bool:
        if self.prof is not None:
            stack = self.prof._stack()
            frame = stack.pop()
            elapsed = time.perf_counter() - frame[1]
            self.prof._add(self.name, elapsed - frame[2])
            if stack:
                stack[-1][2] += elapsed
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def stage(name: str):
    """A context manager that attributes the enclosed wall time to ``name``
    (exclusive of children) and, under ``torch.profiler``, records it as a
    span of the trace."""
    prof = _active
    if prof is None and not _profiler_enabled():
        return _OFF
    return _Span(name, prof, _profiler_enabled())


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
