#!/usr/bin/env python3
"""The host cost of one span of ``repro_torch.core.profiling.stage``.

    PYTHONPATH=src python3 scripts/stage_cost.py [--entries 100000]

Enters ``with stage("x"): pass`` ``--entries`` times in each state of the
span system and prints one JSON line of microseconds an entry (the loop's
own cost included): ``off`` (neither ``collect()`` nor ``torch.profiler``
records), ``collect`` (a session open), ``profiler`` (``torch.profiler``
recording the CPU, and the card where there is one), ``both``; and, beside
them, ``torch.profiler.record_function`` with the profiler off and on
(``record_function_off``, ``record_function_on``), which ``stage`` never
enters. Every state is timed three times in turn; the line holds each
state's least time and all three.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import platform
import time

import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import profiling

STATES = ("off", "collect", "profiler", "both", "record_function_off", "record_function_on")


def per_entry_us(enter, n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        with enter("x"):
            pass
    return 1e6 * (time.perf_counter() - t0) / n


def measure(state: str, n: int) -> float:
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    traced = state in ("profiler", "both", "record_function_on")
    with contextlib.ExitStack() as on:
        if traced:
            on.enter_context(profile(activities=acts))
        if state in ("collect", "both"):
            on.enter_context(profiling.collect())
        return per_entry_us(record_function if state.startswith("record_function")
                            else profiling.stage, n)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entries", type=int, default=100_000)
    n = ap.parse_args().entries
    runs = {s: [] for s in STATES}
    measure("off", n)                                    # warm-up
    for _ in range(3):
        for s in STATES:
            runs[s].append(measure(s, n))
    print(json.dumps({"entries": n, "host": platform.machine(), "torch": torch.__version__,
                      "card": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
                      "us_per_entry": {s: min(v) for s, v in runs.items()}, "runs": runs}))


if __name__ == "__main__":
    main()
