"""Straggler mitigation for synchronous data parallelism (a copy of
``repro/runtime/straggler.py``).

Policy engine (hardware-agnostic, driven by observed per-host step times):

  * detect: host slower than ``threshold x median`` over a sliding window;
  * mitigate:
      - "rebalance": shrink the straggler's microbatch share (returned as a
        per-host microbatch allocation the launcher applies);
      - "drop": exclude the straggler's gradient contribution this step
        (gradient scale adjusts — bounded staleness, like backup workers);
  * escalate: persistent stragglers are reported for eviction (feeds the
    FailureDetector -> elastic replan path).
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclass
class StragglerReport:
    stragglers: List[str]
    persistent: List[str]
    microbatch_shares: Dict[str, float]
    grad_scale: float                 # 1 / participating fraction


@dataclass
class StragglerPolicy:
    threshold: float = 1.5
    window: int = 8
    persistent_after: int = 3         # windows flagged before eviction advice
    mode: str = "rebalance"           # rebalance | drop

    _history: Dict[str, Deque[float]] = field(default_factory=dict)
    _flags: Dict[str, int] = field(default_factory=dict)

    def observe(self, step_times: Dict[str, float]) -> StragglerReport:
        for h, t in step_times.items():
            self._history.setdefault(h, collections.deque(maxlen=self.window)).append(t)

        med = {h: float(np.median(d)) for h, d in self._history.items()}
        global_med = float(np.median(list(med.values())))
        stragglers = [h for h, m in med.items() if m > self.threshold * global_med]

        for h in list(self._flags):
            if h not in stragglers:
                self._flags[h] = 0
        for h in stragglers:
            self._flags[h] = self._flags.get(h, 0) + 1
        persistent = [h for h, c in self._flags.items() if c >= self.persistent_after]

        hosts = list(self._history)
        shares = {h: 1.0 for h in hosts}
        grad_scale = 1.0
        if stragglers:
            if self.mode == "rebalance":
                # give the straggler work proportional to its relative speed
                for h in stragglers:
                    shares[h] = max(0.25, global_med / med[h])
                total = sum(shares.values())
                shares = {h: s * len(hosts) / total for h, s in shares.items()}
            else:  # drop
                for h in stragglers:
                    shares[h] = 0.0
                live = sum(1 for s in shares.values() if s > 0)
                grad_scale = len(hosts) / max(live, 1)
        return StragglerReport(
            stragglers=stragglers,
            persistent=persistent,
            microbatch_shares=shares,
            grad_scale=grad_scale,
        )
