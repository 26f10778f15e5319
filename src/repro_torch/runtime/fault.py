"""Failure detection — heartbeat table + injected-failure harness (a copy of
``repro/runtime/fault.py``).

On a real cluster each host heartbeats a coordination service; here the
detector is the same state machine driven by test-injected clocks, so the
train loop's react-path (checkpoint -> replan mesh -> restore) is exercised
end-to-end on CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set


@dataclass(frozen=True)
class FaultConfig:
    heartbeat_timeout_s: float = 30.0
    min_healthy_fraction: float = 0.75   # below this: halt instead of shrink


class FailureDetector:
    def __init__(self, hosts: List[str], cfg: FaultConfig, clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.last_seen: Dict[str, float] = {h: clock() for h in hosts}
        self.failed: Set[str] = set()

    def heartbeat(self, host: str):
        if host in self.failed:
            return  # rejoin handled by elastic replan, not silent resurrection
        self.last_seen[host] = self.clock()

    def inject_failure(self, host: str):
        """Test hook: drop a host immediately."""
        self.last_seen[host] = -float("inf")

    def poll(self) -> Set[str]:
        """Returns newly-failed hosts since last poll."""
        now = self.clock()
        newly = {
            h for h, t in self.last_seen.items()
            if h not in self.failed and now - t > self.cfg.heartbeat_timeout_s
        }
        self.failed |= newly
        return newly

    @property
    def healthy(self) -> List[str]:
        return [h for h in self.last_seen if h not in self.failed]

    def should_halt(self) -> bool:
        total = len(self.last_seen)
        return len(self.healthy) < self.cfg.min_healthy_fraction * total
