#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero; nothing is caught and
passed over):

  1. device and versions, with the card's name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
     all at once), timed;
  3. the latency of one dependent step, timed by the probes of
     ``csrc/latency_probe.cu``; then each kernel against its plain torch
     version on the card: K1 cache scan and K2 stack distance on the
     full-size set-group buckets that ``simulate`` produces and on edge
     geometries, D1 DRAM scan on the full-size chunk rows, bitwise; kernel
     and plain times;
  4. ``simulate`` on the full DLRM-RMC2 workload (60 tables x 1M rows x dim
     128, 120 lookups, batch 32, 2 batches) x ``tpuv6e()`` for every
     policy/backend pair of the slice, with launch counts reset just before
     and read just after each run; results bitwise equal across backends of
     one policy; one more K1 run under ``torch.profiler`` for the device's
     busy share; small runs on the card equal to the same runs on the CPU;
  5. each kernel's bound: the largest of its bytes over the HBM rate, its
     operations over the peak scalar rate, and its longest chain of
     dependent steps times the probed step latency.

Then it prints the ``nvidia-smi`` name/power line, one ``{"kernels": ...}``
JSON line and, last, ``{"ok": true, "device": {...}}``. Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet), used for the bounds below.
HBM_BYTES_PER_S = 3.35e12
# Scalar (non-tensor-core) rate; the kernels' integer and f32 work is
# counted against it.
SCALAR_OPS_PER_S = 67e12
# The kernels are chains of dependent steps, so their operations also bound
# them through latency: longest chain x one step's latency, measured in this
# run by the probes of csrc/latency_probe.cu. ``bound_ms`` is the largest of
# bytes / HBM rate, operations / peak rate and that chain; ``bound_by`` says
# "operations" when either of the last two wins.
PROBE_STEPS = (1 << 16, 1 << 20)

RUNS = [
    ("spm", "stack"),
    ("lru", "stack"),
    ("lru", "pallas"),
    ("lru", "stack_pallas"),
    ("lru", "scan"),
    ("srrip", "pallas"),
    ("srrip", "scan"),
    ("fifo", "pallas"),
    ("fifo", "scan"),
]
EDGE_GEOMETRIES = [(1, 1), (1, 4), (3, 2), (7, 5), (16, 7), (16, 16), (4, 32), (2, 33), (2, 64)]
KERNEL_SOURCES = {
    "cache_scan": ("src/repro_torch/csrc/cache_scan.cu", "src/repro/kernels/cache_scan.py:44"),
    "stack_distance": ("src/repro_torch/csrc/stack_distance.cu", "src/repro/kernels/stack_distance.py:31"),
    "dram_scan": ("src/repro_torch/csrc/dram_scan.cu", "src/repro/core/memory/dram.py:315"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def probe_step_ms(launch, inp, out, want) -> float:
    """Device ms per step of a latency probe: two chain lengths, timed with
    CUDA events, differenced (launch overhead cancels)."""
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    times = []
    for n in PROBE_STEPS:
        def run():
            err = launch(inp.data_ptr(), n, out.data_ptr(), stream)
            if err != 0:
                fail(f"latency probe launch failed with CUDA error {err}")
        times.append(time_ms(run, 5))
        if not torch.equal(out, torch.full_like(out, want(n))):
            fail(f"latency probe gave {out.tolist()} after {n} steps")
    return (times[1] - times[0]) / (PROBE_STEPS[1] - PROBE_STEPS[0])


def max_abs_err(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def bitwise_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.core import dlrm_rmc2_small, simulate, tpuv6e
    from repro_torch.core import profiling
    from repro_torch.core.engine import build_embedding_traces
    from repro_torch.core.memory.cache import bucket_rows
    from repro_torch.core.memory.dram import chunk_rows
    from repro_torch.core.memory.system import MemorySystem, lane_geometry
    from repro_torch.kernels import _build
    from repro_torch.kernels.cache_scan import cache_scan_groups, cache_scan_plain
    from repro_torch.kernels.dram_scan import dram_scan_chunked, dram_scan_plain
    from repro_torch.kernels.stack_distance import stack_distance_groups, stack_distance_plain

    if any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro" for m in sys.modules):
        fail("the port imported JAX or the JAX package")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_script = time.perf_counter()

    # ---- 1. device and versions ------------------------------------------
    name_power = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
          f"{name_power}; max SM clock {clock_mhz} MHz", flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    regs = []
    for name, path in libs.items():
        log = path.with_suffix(".log")
        used = [ln.split("Used")[1].strip() for ln in log.read_text().splitlines()
                if "Used" in ln] if log.exists() else []
        regs.append(f"{name}: {'; '.join(used) or 'cached'}")
    print(f"[2] built {sorted(p.name for p in libs.values())} in {build_s:.3f} s "
          f"({' | '.join(regs)})", flush=True)

    # ---- 3. latency probes, then kernels against their plain versions -----
    probe = _build.load_library("latency_probe")
    for fn in (probe.vote_chain_launch, probe.f32_chain_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # vote: tag = lane, x = 0; the first match walks lanes 0, 1, 3, 7, 15, 31
    # and x settles at 63. f32: x = max(x, 0) + 0.5, exact in f32 here.
    vote_in = torch.cat([torch.arange(32), torch.zeros(32)]).to(torch.int32).to(dev)
    f32_in = torch.cat([torch.zeros(32), torch.full((32,), 0.5), torch.zeros(32)]).to(dev)
    vote_step_ms = probe_step_ms(probe.vote_chain_launch, vote_in,
                                 torch.empty(32, dtype=torch.int32, device=dev), lambda n: 63)
    f32_op_ms = probe_step_ms(probe.f32_chain_launch, f32_in,
                              torch.empty(32, device=dev), lambda n: 0.5 * n) / 2
    print(f"[3] latency probes: compare-vote-ffs step {vote_step_ms * 1e6:.4f} ns, "
          f"dependent f32 op {f32_op_ms * 1e6:.4f} ns", flush=True)

    wl = dlrm_rmc2_small(num_batches=2)
    hw = tpuv6e()
    t0 = time.perf_counter()
    etrace = build_embedding_traces(wl)[0]
    print(f"[3] full-size trace: {len(etrace.concat)} lookups in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    lane = lane_geometry(hw, etrace.spec)
    buckets = [
        tuple(torch.from_numpy(a).to(dev) for a in (s_b, t_b, v_b)) + (S, W)
        for _, s_b, t_b, v_b, S, W in bucket_rows([etrace.vec_ids], [lane])
    ]
    print(f"[3] full-size buckets (B, L), sets, ways: "
          f"{[(tuple(b[0].shape), b[3], b[4]) for b in buckets]}", flush=True)
    # Sets (and rows) are independent state machines, so the longest chain
    # of dependent steps is the most valid accesses any one (row, set) sees.
    # (A design with one warp per row, as K1's and K2's, walks the row's
    # whole valid length in sequence; printed for comparison.)
    chain, row_chain = 0, 0
    for s_d, _, v_d, S, _ in buckets:
        rows = torch.arange(s_d.shape[0], device=dev)[:, None] * S
        chain = max(chain, int(torch.bincount((rows + s_d)[v_d]).max()))
        row_chain = max(row_chain, int(v_d.sum(dim=1).max()))
    print(f"[3] longest dependent chain: {chain} accesses to one set "
          f"(longest row: {row_chain} valid accesses)", flush=True)
    entries = {}

    def bucket_bound(kind):
        nbytes = sum(b[0].numel() * (4 + 4 + 1) + b[0].numel() * (2 if kind == "cache_scan" else 5)
                     for b in buckets)
        ops = sum(int(b[2].sum()) * b[4] * 3 for b in buckets)
        return nbytes, ops, chain * vote_step_ms

    for policy in ("lru", "srrip", "fifo"):
        err, k_ms, p_ms = 0.0, 0.0, 0.0
        for s_d, t_d, v_d, S, W in buckets:
            h, e = cache_scan_groups(s_d, t_d, v_d, S, W, policy)
            t1 = time.perf_counter()
            hp, ep = cache_scan_plain(s_d, t_d, v_d, S, W, policy)
            torch.cuda.synchronize()
            p_ms += (time.perf_counter() - t1) * 1e3
            if not (torch.equal(h, hp) and torch.equal(e, ep)):
                fail(f"cache_scan[{policy}] differs from its plain version at {tuple(s_d.shape)}")
            err = max(err, max_abs_err(h, hp), max_abs_err(e, ep))
            k_ms += time_ms(lambda: cache_scan_groups(s_d, t_d, v_d, S, W, policy), 20)
        nbytes, ops, lat_ms = bucket_bound("cache_scan")
        entries[f"cache_scan[{policy}]"] = dict(
            kind="cache_scan", err=err, ms=k_ms, plain_ms=p_ms, nbytes=nbytes, ops=ops,
            lat_ms=lat_ms, shapes=[tuple(b[0].shape) for b in buckets])
        print(f"[3] cache_scan[{policy}]: equal to plain; kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.2f} ms per classification", flush=True)

    err, k_ms, p_ms = 0.0, 0.0, 0.0
    for s_d, t_d, v_d, S, W in buckets:
        d, e = stack_distance_groups(s_d, t_d, v_d, S, W)
        t1 = time.perf_counter()
        dp, ep = stack_distance_plain(s_d, t_d, v_d, S, W)
        torch.cuda.synchronize()
        p_ms += (time.perf_counter() - t1) * 1e3
        if not (torch.equal(d, dp) and torch.equal(e, ep)):
            fail(f"stack_distance differs from its plain version at {tuple(s_d.shape)}")
        err = max(err, max_abs_err(d, dp), max_abs_err(e, ep))
        k_ms += time_ms(lambda: stack_distance_groups(s_d, t_d, v_d, S, W), 20)
    nbytes, ops, lat_ms = bucket_bound("stack_distance")
    entries["stack_distance[lru]"] = dict(
        kind="stack_distance", err=err, ms=k_ms, plain_ms=p_ms, nbytes=nbytes, ops=ops,
        lat_ms=lat_ms, shapes=[tuple(b[0].shape) for b in buckets])
    print(f"[3] stack_distance[lru]: equal to plain; kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.2f} ms per classification", flush=True)

    rng = np.random.default_rng(0)
    for S, W in EDGE_GEOMETRIES:
        B, L = 3, 160
        s_d = torch.from_numpy(rng.integers(0, S, size=(B, L)).astype(np.int32)).to(dev)
        t_d = torch.from_numpy(rng.integers(0, S * W * 2 + 1, size=(B, L)).astype(np.int32)).to(dev)
        v_np = rng.random((B, L)) < 0.9
        v_np[:, 130:] = False
        v_d = torch.from_numpy(v_np).to(dev)
        for policy in ("lru", "srrip", "fifo"):
            got = cache_scan_groups(s_d, t_d, v_d, S, W, policy)
            want = cache_scan_plain(s_d, t_d, v_d, S, W, policy)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"cache_scan[{policy}] differs from its plain version at (sets, ways)={(S, W)}")
        got = stack_distance_groups(s_d, t_d, v_d, S, W)
        want = stack_distance_plain(s_d, t_d, v_d, S, W)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"stack_distance differs from its plain version at (sets, ways)={(S, W)}")
    print(f"[3] edge geometries {EDGE_GEOMETRIES}: kernels equal plain versions", flush=True)

    # D1 on the full-size SPM miss stream (every lookup misses: the largest
    # DRAM scan of the slice), then on a small ragged input.
    spm = MemorySystem.from_hardware(hw.with_policy("spm"), "cuda")
    req = spm.prepare_embedding(etrace).request
    st = chunk_rows(req.lines, req.seg, req.src, req.num_segments, req.num_sources, req.model)
    args = [torch.from_numpy(st[k]).to(dev) for k in ("bk_m", "row_m", "k_m", "va_m")]
    scal = (req.model.banks_per_channel, st["k_max"], float(req.model.t_rp + req.model.t_rcd),
            float(req.model.t_cas), st["bus_cyc"])
    (lat, hit, dmax), (done0, rh) = dram_scan_chunked(*args, *scal)
    t1 = time.perf_counter()
    (lat_p, hit_p, dmax_p), (done0_p, rh_p) = dram_scan_plain(*args, *scal)
    torch.cuda.synchronize()
    d1_plain_ms = (time.perf_counter() - t1) * 1e3
    pairs = [(lat, lat_p), (hit, hit_p), (dmax, dmax_p), (done0, done0_p), (rh, rh_p)]
    if not all(bitwise_equal(a, b) for a, b in pairs):
        fail("dram_scan differs bitwise from its plain version at full size")
    d1_err = max(max_abs_err(a, b) for a, b in pairs)
    d1_ms = time_ms(lambda: dram_scan_chunked(*args, *scal), 20)
    R, Lc = args[0].shape
    kv = st["k_m"][st["va_m"]].astype(np.int64)
    # A row's bus chain per valid chunk: one f32 max, then k dependent adds.
    d1_chain = int(((st["k_m"].astype(np.int64) + 1) * st["va_m"]).sum(axis=1).max())
    entries["dram_scan[spm]"] = dict(
        kind="dram_scan", err=d1_err, ms=d1_ms, plain_ms=d1_plain_ms,
        nbytes=R * Lc * (4 * 3 + 1) + R * Lc * (4 + 1) + R * 12,
        ops=int((2 * (kv - 1) + 6).sum()),
        lat_ms=d1_chain * f32_op_ms, shapes=[(R, Lc)])
    print(f"[3] dram_scan: bitwise equal to plain at (R, Lc)={(R, Lc)}, "
          f"{int(st['va_m'].sum())} chunks, longest bus chain {d1_chain} dependent f32 ops; "
          f"kernel {d1_ms:.4f} ms, plain {d1_plain_ms:.2f} ms",
          flush=True)
    Rs, Ls = 5, 96
    small = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 8, size=(Rs, Ls)).astype(np.int32),
        rng.integers(0, 3, size=(Rs, Ls)).astype(np.int32),
        rng.integers(1, 9, size=(Rs, Ls)).astype(np.int32),
        rng.random((Rs, Ls)) < 0.8)]
    got = dram_scan_chunked(*small, 8, 8, 44.0, 22.0, 0.6016)
    want = dram_scan_plain(*small, 8, 8, 44.0, 22.0, 0.6016)
    if not all(bitwise_equal(a, b) for a, b in zip(got[0] + got[1], want[0] + want[1])):
        fail("dram_scan differs bitwise from its plain version on the ragged input")
    print("[3] dram_scan: bitwise equal to plain on a ragged (5, 96) input", flush=True)

    # ---- 4. simulate on every policy/backend pair ------------------------
    results, launches = {}, {}
    expect = {"pallas": "cache_scan", "stack_pallas": "stack_distance"}
    for policy, backend in RUNS:
        hw_run = tpuv6e().with_policy(policy).with_cache_backend(backend)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with profiling.collect() as prof:
            res = simulate(wl, hw_run)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        summ = res.summary()
        if len(res.batches) != 2 or not all(
                math.isfinite(v) for v in summ.values() if isinstance(v, float)):
            fail(f"{policy}/{backend}: malformed result {summ}")
        if not res.total_cycles > 0:
            fail(f"{policy}/{backend}: total_cycles {res.total_cycles}")
        for kname, n in counts.items():
            should = kname in ("dram_scan", expect.get(backend))
            if should and n == 0:
                fail(f"{policy}/{backend}: kernel {kname} was not launched on the main path")
            if not should and n != 0:
                fail(f"{policy}/{backend}: kernel {kname} launched {n} times off its path")
        if counts["dram_scan"] != 1:
            fail(f"{policy}/{backend}: {counts['dram_scan']} DRAM scan launches, expected 1")
        results[(policy, backend)] = dataclasses.asdict(res)
        launches[(policy, backend)] = counts
        acc = res.cache_hits + res.cache_misses
        stages = {k: round(v, 4) for k, v in prof.breakdown(wall).items()}
        print(f"[4] {policy}/{backend}: wall {wall:.3f} s, total_cycles {res.total_cycles!r}, "
              f"hit_rate {res.cache_hits / max(acc, 1)!r}, launches {counts}, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, stages {json.dumps(stages)}",
              flush=True)
    for policy in sorted({p for p, _ in RUNS}):
        same = [results[k] for k in results if k[0] == policy]
        if any(r != same[0] for r in same[1:]):
            fail(f"{policy}: results differ across backends")
    print("[4] results bitwise equal across backends for every policy", flush=True)

    # Device busy share of one run of the K1 path: the profiler's device
    # events (kernels, copies, fills) merged into busy intervals.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    hw_run = tpuv6e().with_policy("lru").with_cache_backend("pallas")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        t0 = time.perf_counter()
        simulate(wl, hw_run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in tprof.events()
                   if e.device_type == DeviceType.CUDA)
    if spans:
        busy_us, end, by_name = 0.0, -math.inf, {}
        for a, b, name in spans:
            if b > end:
                busy_us += b - max(a, end)
                end = b
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"[4] profiled lru/pallas: wall {wall!r} s, device busy {busy_us / 1e6!r} s "
              f"({100 * busy_us / 1e6 / wall!r}% busy) over {len(spans)} device events; "
              f"top device time (us): {json.dumps({n[:60]: round(t, 3) for n, t in top})}",
              flush=True)
    else:
        print(f"[4] profiled lru/pallas: wall {wall!r} s, device busy not measured "
              "(the profiler recorded no device events)", flush=True)

    small_wl = dlrm_rmc2_small(num_tables=2, rows_per_table=300, batch_size=2, num_batches=2)
    for policy, backend in RUNS:
        hw_small = tpuv6e().with_policy(policy, capacity_bytes=1 << 14).with_cache_backend(backend)
        on_card = dataclasses.asdict(simulate(small_wl, hw_small))
        on_cpu = dataclasses.asdict(simulate(small_wl, hw_small, device="cpu"))
        if on_card != on_cpu:
            fail(f"{policy}/{backend}: small run on the card differs from the CPU")
    print("[4] small runs on the card equal the same runs on the CPU", flush=True)

    # ---- report ----------------------------------------------------------
    main_run = {"cache_scan[lru]": ("lru", "pallas"), "cache_scan[srrip]": ("srrip", "pallas"),
                "cache_scan[fifo]": ("fifo", "pallas"), "stack_distance[lru]": ("lru", "stack_pallas"),
                "dram_scan[spm]": ("spm", "stack")}
    out = []
    for name, e in entries.items():
        bytes_ms = e["nbytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = e["ops"] / SCALAR_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms, e["lat_ms"])
        print(f"[5] bound {name}: bytes {bytes_ms!r} ms, operations at peak rate "
              f"{ops_ms!r} ms, dependent chain {e['lat_ms']!r} ms -> {bound_ms!r} ms",
              flush=True)
        src, replaces = KERNEL_SOURCES[e["kind"]]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[main_run[name]][e["kind"]],
            "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= bound_ms else "operations",
            "library_ms": None, "shapes": e["shapes"],
        })
    print(f"[5] script wall {time.perf_counter() - t_script:.1f} s", flush=True)
    print(name_power, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
