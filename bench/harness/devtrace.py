"""The device trace of a traced run: what ran on the card, when, and what
the host was doing while the card sat idle.

``torch.profiler`` (CUPTI) records every kernel, copy and fill on the
device and every operator and ``record_function`` span on the host, on one
clock. The traced window is the harness's ``bench.window`` span.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

WINDOW_SPAN = "bench.window"

Event = Tuple[str, int, int]          # name, start ns, end ns


def profiler_events(prof):
    """(device events, host events) of a ``torch.profiler`` run as (name,
    start ns, end ns), sorted."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        item = (e.name(), start, start + e.duration_ns())
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    # A host span (``record_function``) also shows on the device's side as
    # an annotation over the kernels it launched: not device work.
    spans = {h[0] for h in host}
    device = [d for d in device if d[0] not in spans]
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return device, host


class DeviceTrace:
    """Device events clipped to the traced window, their busy union and
    idle gaps."""

    def __init__(self, device: List[Event], host: List[Event]):
        spans = [h for h in host if h[0] == WINDOW_SPAN]
        if not spans:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        _, self.t0, self.t1 = spans[0]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.device: List[Event] = [(n, max(a, self.t0), min(b, self.t1)) for n, a, b in device
                                    if b > self.t0 and a < self.t1]
        self.host: List[Event] = [h for h in host if h[0] != WINDOW_SPAN and h[2] > self.t0
                                  and h[1] < self.t1]
        self._host_starts = [h[1] for h in self.host]
        busy, gaps, end = 0, [], self.t0
        for _, a, b in self.device:
            if a > end:
                gaps.append((end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        if end < self.t1:
            gaps.append((end, self.t1))
        self.busy_s = busy / 1e9
        self.gaps = gaps

    @classmethod
    def from_profiler(cls, prof) -> "DeviceTrace":
        return cls(*profiler_events(prof))

    def seconds(self, match: Callable[[str], bool] = lambda name: True) -> float:
        """Summed device time of the events whose names ``match`` (events
        that overlap each other count each)."""
        return sum(b - a for n, a, b in self.device if match(n)) / 1e9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            out[n] += (b - a) / 1e9
        return dict(out)

    def host_doing(self, t: int) -> str:
        """The innermost host operator or span running at ``t``."""
        i = bisect.bisect_right(self._host_starts, t)
        for j in range(i - 1, max(i - 400, -1), -1):
            name, a, b = self.host[j]
            if b >= t:
                return name
        return "python, no op recorded"

    def idle_by_host(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps:
            out[self.host_doing((a + b) // 2)] += (b - a) / 1e9
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in idle]}
