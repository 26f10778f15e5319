"""Sequential golden DRAM model — the TPUv6e-proxy reference for Fig. 3.

The paper validates EONSim's timing against real TPUv6e runs. Offline, the
strongest available analogue is an independently-written reference
implementation of the same documented service discipline:

  * block-granular channel interleave (decompose as in DramModel),
  * FR-FCFS-like scheduling: banks served round-robin at block granularity,
    per-bank request order preserved, a block's lines streamed consecutively,
  * bank occupancy = tRP+tRCD per activate (row miss), bursts at bus rate,
  * channel bus serializes bursts; CAS latency pipelines onto completion.

This module is a deliberate straight-line Python transcription of that spec
(dict/list bookkeeping, explicit queues) — structurally unlike the chunked
scan engine (D1, ``kernels/dram_scan.py``) — so agreement between the two is
meaningful. The Fig. 3 benchmarks report the EONSim-vs-reference
execution-time error, mirroring the paper's sim-vs-hardware metric. A copy of the JAX package's
``repro.core.memory.golden_dram``, on this package's ``DramModel``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .dram import DramModel, DramResult


def golden_dram(lines: np.ndarray, model: DramModel) -> DramResult:
    lines = np.asarray(lines, dtype=np.int64).reshape(-1)
    n = lines.size
    if n == 0:
        return DramResult(0.0, 0.0, 0, 0, 0)

    ch_a, bk_a, row_a = model.decompose(lines)
    blk_a = lines // model.lines_per_block

    bus_cyc = model.line_bytes / model.chan_bytes_per_cycle
    act = model.t_rp + model.t_rcd

    finish = 0.0
    total_lat = 0.0
    row_hits = 0

    for c in range(model.channels):
        idx = np.nonzero(ch_a == c)[0]
        if idx.size == 0:
            continue
        # build per-bank queues of blocks; each block is a list of accesses
        bank_blocks: List[List[List[int]]] = [[] for _ in range(model.banks_per_channel)]
        for i in idx:
            b = int(bk_a[i])
            q = bank_blocks[b]
            if q and blk_a[q[-1][-1]] == blk_a[i]:
                q[-1].append(int(i))
            else:
                q.append([int(i)])

        open_row = [-1] * model.banks_per_channel
        bank_free = [0.0] * model.banks_per_channel
        bus_free = 0.0
        ptr = [0] * model.banks_per_channel
        remaining = sum(len(q) for q in bank_blocks)
        b = 0
        while remaining:
            # round-robin: next bank with a pending block
            while ptr[b] >= len(bank_blocks[b]):
                b = (b + 1) % model.banks_per_channel
            block = bank_blocks[b][ptr[b]]
            ptr[b] += 1
            remaining -= 1
            for i in block:
                r = int(row_a[i])
                hit = open_row[b] == r
                occ = 0.0 if hit else act
                bank_avail = bank_free[b] + occ
                start_xfer = max(bank_avail, bus_free)
                done = start_xfer + bus_cyc
                open_row[b] = r
                bank_free[b] = done
                bus_free = done
                total_lat += done + model.t_cas
                row_hits += int(hit)
                finish = max(finish, done + model.t_cas)
            b = (b + 1) % model.banks_per_channel

    return DramResult(
        finish_cycle=finish + model.base_latency,
        total_latency_cycles=total_lat + model.base_latency * n,
        row_hits=row_hits,
        row_misses=n - row_hits,
        accesses=n,
    )
