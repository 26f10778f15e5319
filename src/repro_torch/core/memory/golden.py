"""Sequential golden cache model with ChampSim replacement semantics.

This is the validation oracle for ``cache.py`` (paper Fig. 4a compares EONSim
against ChampSim and reports identical hit/miss counts; every cache engine —
the plain scan, the analytic stack/rrip engines and the CUDA kernels — must be
bit-exact against this model). Deliberately written as a straightforward
per-access loop — a different *shape* of implementation from the vectorised
engines, so agreement is meaningful. A copy of the JAX package's
``repro.core.memory.golden``.

ChampSim semantics implemented (champsim/replacement/{lru,srrip}):
  * victim search prefers the first invalid way;
  * lru:   hit -> promote to MRU; victim = LRU way.
  * srrip: rrpv init maxRRPV (3); hit -> rrpv=0; victim = first way with
           rrpv==maxRRPV, incrementing all ways' rrpv until one qualifies
           (increments persist); fill -> rrpv=maxRRPV-1.
  * fifo:  victim = oldest fill; hits don't update state.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .cache import MAX_RRPV, CacheGeometry


class GoldenCache:
    def __init__(self, geometry: CacheGeometry, policy: str = "lru"):
        self.g = geometry
        self.policy = policy
        S, W = geometry.num_sets, geometry.ways
        self.tags = [[-1] * W for _ in range(S)]
        if policy == "srrip":
            self.meta = [[MAX_RRPV] * W for _ in range(S)]
        else:
            self.meta = [[-1] * W for _ in range(S)]
        self.t = 0
        self.num_hits = 0
        self.num_misses = 0
        self.num_evictions = 0

    def _find_victim(self, s: int) -> int:
        tags, meta = self.tags[s], self.meta[s]
        for w, tag in enumerate(tags):
            if tag < 0 and self.policy != "srrip":
                return w
        if self.policy == "srrip":
            # invalid lines sit at maxRRPV already (init value)
            while True:
                for w in range(self.g.ways):
                    if meta[w] == MAX_RRPV:
                        return w
                for w in range(self.g.ways):
                    meta[w] += 1
        # lru / fifo: min timestamp (invalid handled above)
        best_w, best_t = 0, None
        for w in range(self.g.ways):
            if best_t is None or meta[w] < best_t:
                best_w, best_t = w, meta[w]
        return best_w

    def access(self, line: int) -> bool:
        s = int(line % self.g.num_sets)
        tags, meta = self.tags[s], self.meta[s]
        hit_way = -1
        for w in range(self.g.ways):
            if tags[w] == line:
                hit_way = w
                break
        if hit_way >= 0:
            self.num_hits += 1
            if self.policy == "lru":
                meta[hit_way] = self.t
            elif self.policy == "srrip":
                meta[hit_way] = 0
            self.t += 1
            return True

        self.num_misses += 1
        victim = self._find_victim(s)
        if tags[victim] >= 0:
            self.num_evictions += 1
        tags[victim] = line
        if self.policy == "srrip":
            meta[victim] = MAX_RRPV - 1
        else:
            meta[victim] = self.t
        self.t += 1
        return False

    def run(self, lines: np.ndarray) -> np.ndarray:
        return np.array([self.access(int(l)) for l in lines], dtype=bool)
