"""Small pieces the harness shares: seeds, percentiles, the process's start."""
from __future__ import annotations

import hashlib
import math
import os
import time
from typing import Sequence


def subseed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (weights, traffic, the check's sample),
    drawn from ``--seed``: any whole number, negative or past 64 bits too."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of ``values`` at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def process_start_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (``/proc/self/stat``, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])          # field 22 of the whole line
    hz = os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / hz


class Phases:
    """Seconds of each named phase of a set-up, the device synchronised at
    each mark; the first, ``device``, makes the CUDA context."""

    def __init__(self, device):
        import torch
        self._sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
        self._last = time.perf_counter()
        self.seconds = {}
        self.mark("device")

    def mark(self, name: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now
