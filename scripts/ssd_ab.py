#!/usr/bin/env python3
"""K8's bf16 route timed in two checkouts of the repo, in turn, on one NVIDIA GPU.

    python3 scripts/ssd_ab.py OTHER [ROUNDS]

OTHER is the root of another checkout (for example the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each of ROUNDS rounds (default 3) runs OTHER, this checkout, this checkout,
OTHER, each in a process of its own that imports ``repro_torch`` from its
checkout and builds its kernels there. Each process times
``mamba2_ssd_kernel`` at Zamba2-2.7B's prefill shape in bf16 (the inputs of
``scripts/ssd_ablation.py bf16``, chunk 128) three ways: with the L2 cache
flushed before each launch (CUDA events around the wrapper, as
``chip_smoke.py`` phase 3 times it, so the host's share shows), warm
back to back, and the device time of its kernels under ``torch.profiler``
(pre-pass plus scan, per call). It checks the output against
``mamba2_ssd_plain`` first (atol 2e-4, rtol 2^-7) and prints one JSON line.
Last come the medians of each checkout and the card's name and power limit.

    python3 scripts/ssd_ab.py --time TREE

is one such process. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, H, S, P, N, CHUNK = 8, 80, 1024, 64, 64, 128
REPS = 50


def time_tree(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_kernel, mamba2_ssd_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev)).transpose(1, 2)
    adt = -torch.linspace(1.0, 16.0, H, device=dev)[None, :, None] * dt
    args = (x, adt, dt, xbc[..., H * P:H * P + N], xbc[..., H * P + N:])

    def run():
        return mamba2_ssd_kernel(*args, chunk=CHUNK)

    got = run()
    torch.cuda.synchronize()
    want = mamba2_ssd_plain(*args, CHUNK)
    if not torch.allclose(got.float(), want.float(), atol=2e-4, rtol=2.0 ** -7):
        raise SystemExit(f"{tree}: K8 bf16 differs from plain "
                         f"({float((got.float() - want.float()).abs().max())!r})")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    total = 0.0
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        run()
    end.record()
    torch.cuda.synchronize()
    warm = start.elapsed_time(end) / REPS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            run()
        torch.cuda.synchronize()
    device_us = sum(ev.device_time_total for ev in prof.key_averages() if "ssd" in ev.key)
    return {"tree": str(tree), "flushed_ms": total / REPS, "warm_ms": warm,
            "device_ms": device_us / 1e3 / REPS}


def main(argv) -> None:
    if argv[:1] == ["--time"]:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("needs an NVIDIA GPU")
        print(json.dumps(time_tree(Path(argv[1]).resolve())), flush=True)
        return
    other = Path(argv[0]).resolve()
    rounds = int(argv[1]) if len(argv) > 1 else 3
    runs = {str(other): [], str(ROOT): []}
    for r in range(rounds):
        for tree in (other, ROOT, ROOT, other):
            proc = subprocess.run([sys.executable, __file__, "--time", str(tree)],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
            line = proc.stdout.strip().splitlines()[-1]
            print(f"round {r}: {line}", flush=True)
            runs[str(tree)].append(json.loads(line))
    for tree, rs in runs.items():
        med = {k: statistics.median(x[k] for x in rs) for k in ("flushed_ms", "warm_ms",
                                                                  "device_ms")}
        print(f"median of {len(rs)} runs, {tree}: {json.dumps(med)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
