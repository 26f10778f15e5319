"""The program's own spans in a traced run.

The port's ``core/profiling.stage`` opens a ``record_function`` range while
``torch.profiler`` records, so each stage is a host event of the device
trace, on the clock of CUPTI's kernels, copies and fills. A program that
has no such stage leaves none, and the readers of these spans find nothing.
"""
from __future__ import annotations

from typing import List, Tuple

FORWARD = "dlrm.forward"       # the root span of ``DLRM.forward``, one a call


def spans(run, name: str = FORWARD) -> List[Tuple[int, int]]:
    """(start ns, end ns) of the traced window's host spans named ``name``,
    in order of their starts; empty in a run without a trace."""
    if run.trace is None:
        return []
    return [(a, b) for n, a, b in run.trace.host if n == name]
