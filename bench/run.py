"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the machine it is started on: set-up
(the port's kernels built on the first run in a checkout, weights and
inputs drawn on the device from the seed, every shape the traffic uses
warmed up), a closed loop of the cell's traffic for ``--seconds`` seconds,
then the check of what the timed path produced against the plain
reference. With ``--trace 0`` the result holds the cell's end-to-end
metrics; with ``--trace 1`` the window runs under ``torch.profiler`` and
the result holds the cell's per-layer metrics, the device's busy seconds
and a breakdown. The last line of standard output is the result, one JSON
object; the numbers compared are also the last lines of standard error.

Exits non-zero, printing no result, without enough CUDA cards, when the
port cannot be imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_environment() -> None:
    """Every cache of the build and the compilers inside the checkout, at
    fixed paths; no library loads JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


@dataclass
class Run:
    """What the metric readers read."""
    workload: dict
    config: dict
    mix: dict
    session: object
    records: List[dict]
    window_s: float
    setup_s: float
    trace: object = None
    peaks: Optional[dict] = None


def window(session, seconds: float, profiler=None):
    """The closed loop: steps until ``seconds`` have passed and the session
    says the window may close, then what is still in flight finishes.
    Returns (records, seconds on the host).

    The set-up's objects are frozen out of the garbage collector first
    (``gc.freeze``, as a server that loads its model before it serves), so
    that no collection in the window walks them: at a few milliseconds a
    step the host's dispatch is part of every step's time, and collections
    over the set-up's objects made runs of one seed differ by 7%."""
    import torch
    from torch.profiler import record_function
    from bench.harness.devtrace import WINDOW_SPAN
    records = []
    span = record_function(WINDOW_SPAN) if profiler is not None else contextlib.nullcontext()
    gc.collect()
    gc.freeze()
    with span:
        t0 = time.perf_counter()
        steps = 0
        while True:
            record = session.step(steps)
            steps += 1
            if record is not None:
                records.append(record)
            if session.window_done(steps, time.perf_counter() - t0, seconds):
                break
        records += session.drain()
        if session.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    gc.unfreeze()
    return records, elapsed


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[dict] = None) -> dict:
    """Everything of a run but the look for a card: returns the result.

    ``overrides`` replaces the cell's ``config``, ``mix`` or ``check`` (the
    tests run small ones on the CPU)."""
    import torch
    from bench.harness import manifest as mf
    from bench.harness.devtrace import DeviceTrace
    from bench.harness.peaks import peaks
    from bench.harness.util import process_start_age_s
    from bench.reference.precision import no_tf32

    overrides = overrides or {}
    bench = mf.load()
    cell = mf.workload(bench, workload)
    config = overrides.get("config") or mf.load_config(bench, cell["config"])
    mix = overrides.get("mix") or mf.load_traffic(cell["traffic"])
    check = overrides.get("check") or mf.load_check(workload)
    no_tf32()
    cuda = torch.device(device).type == "cuda"

    session = mf.kind(mix).Session(mf.family(config), config, mix, check, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_start_age_s()

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            records, window_s = window(session, seconds, prof)
    else:
        records, window_s = window(session, seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    name = torch.cuda.get_device_name(device) if cuda else "cpu"

    run = Run(workload=cell, config=config, mix=mix, session=session, records=records,
              window_s=window_s, setup_s=setup_s, peaks=peaks(name))
    if prof is not None:
        run.trace = DeviceTrace.from_profiler(prof)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in mf.metrics_for(bench, workload, kind):
        value = mf.metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    breakdown = run.trace.breakdown() if run.trace is not None else None
    run.trace = prof = None

    session.free_program()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = session.compared()
    lat = [r["latency_ms"] for r in records]
    print(f"setup phases (s): {json.dumps(session.setup_phases)}; window {window_s!r} s, "
          f"{len(records)} steps, {1e3 * window_s / len(records)!r} ms a step, latency mean "
          f"{sum(lat) / len(lat)!r} ms; check {time.perf_counter() - t_check!r} s", file=sys.stderr)
    compared = {k: {"value": v, "limit": check["limits"][k]} for k, v in numbers.items()}
    correct = bool(numbers) and all(v <= check["limits"][k] for k, v in numbers.items())
    items = sum(r["items"] for r in records)
    result = {"correct": correct, "attempted": items, "failed": 0, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def loaded_forbidden() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_environment()
    try:
        import torch
        import repro_torch  # noqa: F401  the program under test
        from bench.harness import manifest as mf
        cell = mf.workload(mf.load(), args.workload)
    except (ImportError, OSError, ValueError) as e:
        print(f"bench: cannot start: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: the cell needs {cell['chips']} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} card(s)",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"bench: the process loaded {bad}; no result", file=sys.stderr)
        return 4
    print(f"correct {result['correct']}; the numbers compared and their limits:", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
