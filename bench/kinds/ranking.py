"""The ``ranking`` kind: a ranking server scores batches.

A mix gives ``batch`` samples a batch, each with the configuration's dense
features N(0, 1) and, per table, the configuration's lookups: row ids drawn
Zipf(``zipf_s``) over the table's rows. Each table keeps one rank-to-row
permutation for the whole run, so a popular item stays popular.
``pool_batches`` distinct batches are drawn at set-up and cycled through.

A step is one batch: the family's program on it, then the scores copied to
the host. The mix's ``in_flight`` batches run at once: the host enqueues the
next batch before it waits for the oldest, as a server keeps its card fed.
A batch's latency is taken on the device's clock, from an event recorded on
an idle stream when the host starts the batch to one after its scores'
copy; its dispatch is the host's time to enqueue it, on the host's clock.
"""
from __future__ import annotations

import collections
import time
from typing import Dict

import numpy as np
import torch

from bench.harness.traffic import zipf_cdf, zipf_ranks
from bench.harness.util import Phases, subseed
from bench.reference.precision import PRODUCTS


def generate(mix: dict, config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``dense`` (P, B, F) f32 and ``sparse`` (P, B, T, L) int32 per-table
    row ids, and ``perm`` (T, R) int32, each table's rank-to-row map."""
    T, R = config["num_tables"], config["rows_per_table"]
    L, F = config["lookups_per_table"], config["dense_features"]
    P, B = mix["pool_batches"], mix["batch"]
    g = torch.Generator(device=device).manual_seed(subseed(seed, "traffic"))
    perm = torch.rand((T, R), generator=g, device=device).argsort(dim=1).to(torch.int32)
    cdf = zipf_cdf(R, mix["zipf_s"], device)
    sparse = torch.empty((P, B, T, L), dtype=torch.int32, device=device)
    for p in range(P):
        ranks = zipf_ranks(B * T * L, cdf, g).view(B, T, L)
        rows = torch.gather(perm, 1, ranks.permute(1, 0, 2).reshape(T, B * L))
        sparse[p] = rows.view(T, B, L).permute(1, 0, 2)
        del ranks, rows
    dense = torch.randn((P, B, F), generator=g, device=device)
    return {"dense": dense, "sparse": sparse, "perm": perm}


class Session:
    """One ranking cell's program, inputs and outputs on one device."""

    def __init__(self, family, config: dict, mix: dict, check: dict, seed: int, device):
        config = family.prepare(config)
        self.family, self.config = family, config
        self.device = torch.device(device)
        clock = Phases(self.device)
        self.weights = family.make_weights(config, seed, self.device)
        self.model = family.build(config, self.weights)
        clock.mark("weights")
        self.inputs = generate(mix, config, seed, self.device)
        clock.mark("traffic")
        self.pool = self.cover_steps = self.inputs["sparse"].shape[0]
        self.batch = mix["batch"]
        cuda = self.device.type == "cuda"
        # ``in_flight`` batches at once: a ring of pinned score buffers and
        # event pairs; starts are recorded on an idle stream of their own, so
        # a start event reads the time the host began the batch
        self.ring = [(torch.empty(self.batch, dtype=torch.float32, pin_memory=cuda),
                      torch.cuda.Event(enable_timing=True) if cuda else None,
                      torch.cuda.Event(enable_timing=True) if cuda else None)
                     for _ in range(mix.get("in_flight", 1))]
        self.clock_stream = torch.cuda.Stream(self.device) if cuda else None
        self.pending = collections.deque()
        self.outputs = []
        with torch.inference_mode():
            for i in range(2 * len(self.ring)):
                self.step(i)
            self.drain()
        clock.mark("warm-up")
        self.outputs.clear()
        self.setup_phases = clock.seconds

    def _launch(self, i: int) -> None:
        """Enqueue batch ``i``: the forward of pool batch ``i % pool``, its
        scores copied into a pinned buffer of the ring."""
        b, (host, start, end) = i % self.pool, self.ring[i % len(self.ring)]
        t0 = time.perf_counter()
        if start is not None:
            start.record(self.clock_stream)
        out = self.model(self.inputs["dense"][b], self.inputs["sparse"][b])
        host.copy_(out, non_blocking=True)
        if end is not None:
            end.record()
        self.pending.append((b, host, start, end, t0, time.perf_counter() - t0))

    def _finish(self) -> dict:
        """Wait for the oldest batch in flight; keep its scores. Its latency
        runs from its start to its scores in host memory, on the device's
        clock on the card."""
        b, host, start, end, t0, dispatch_s = self.pending.popleft()
        if end is not None:
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        self.outputs.append((b, host.numpy().copy()))
        return {"items": self.batch, "latency_ms": ms, "pool": b, "dispatch_s": dispatch_s}

    def step(self, i: int):
        """Enqueue batch ``i``, then, with the ring full, finish the oldest:
        its record, or None."""
        with torch.inference_mode():
            self._launch(i)
            return self._finish() if len(self.pending) >= len(self.ring) else None

    def drain(self) -> list:
        """Finish every batch still in flight."""
        with torch.inference_mode():
            return [self._finish() for _ in range(len(self.pending))]

    def window_done(self, steps: int, elapsed: float, seconds: float) -> bool:
        return elapsed >= seconds

    def free_program(self) -> None:
        self.model = None

    def compared(self, products: str = "float32") -> Dict[str, float]:
        """The numbers compared: ``score_err``, the largest |program -
        reference| over every score the window produced, over the rms of
        that batch's reference scores. ``products`` other than float32
        puts the reference at that precision in the program's place (the
        control)."""
        mm = PRODUCTS[products]
        ref_scores = self.family.reference_scores
        used = sorted({b for b, _ in self.outputs})
        ref, ctl = {}, {}
        with torch.inference_mode():
            for b in used:
                args = (self.weights, self.inputs["dense"][b], self.inputs["sparse"][b], self.config)
                ref[b] = ref_scores(*args).cpu().numpy().astype(np.float64)
                if products != "float32":
                    ctl[b] = ref_scores(*args, mm=mm).cpu().numpy()
        worst = 0.0
        for b, s in (self.outputs if products == "float32" else ctl.items()):
            r = ref[b]
            worst = max(worst, float(np.max(np.abs(s - r)) / np.sqrt(np.mean(r * r))))
        return {"score_err": worst}
