#!/usr/bin/env python3
"""Ablation of the port's K8 Mamba2 SSD kernel (bf16 route) on one NVIDIA GPU.

    python3 scripts/ssd_ablation.py

K8 (``src/repro_torch/csrc/mamba2_ssd.cu``, ``ssd_mma_kernel``) at
Zamba2-2.7B's prefill shape: x (8, 80, 1024, 64) bf16 as the Mamba2 block
hands it (a transpose of a slice of one projection), B and C (8, 1024, 64)
column slices of it, adt and dt (8, 80, 1024) f32, chunk 128. For each
P-slice width (16, 32, 64: 2,560, 1,280 and 640 blocks; the wrapper runs
``P_SLICE``, 64, which the script sets to each width in turn), it checks the
output against ``mamba2_ssd_plain`` at the kernel's tolerance (atol 2e-4,
rtol 2^-7) and prints the time with the L2 cache flushed before every
launch, the achieved TB/s, the share of the byte bound and the blocks
resident on one SM. Then variants built from the source by text
substitution, each timed at P-slice 64 and 32 with its max abs error
against the plain version (the variants that skip work give wrong output;
they show what a part costs):

  no-state   the state update skipped;
  no-intra   the intra-chunk scores and scores.x skipped;
  no-inter   the C.state^T term skipped;
  no-exp     every exponential replaced by its argument;
  balanced   warps w and w + 4 (one warp scheduler) take row tiles w and
             7 - w, so every scheduler holds 9 of the chunk's 36 score
             tiles, not 6 to 12 (output right);
  state-on-8 the state tiles spread over all 8 warps, not the 4 with the
             light rows (output right);
  bf16-only  the lo halves dropped: scores, w x and the state rounded once
             to bf16 (what the hi/lo split costs, and whether plain bf16
             rounding would hold the tolerance).

Then one launch under ``torch.profiler`` splits the time between the cumsum
pre-pass and the scan. Builds into ``build/ablation/``. Last, the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.kernels.mamba2_ssd import (  # noqa: E402
    P_SLICE, mamba2_ssd_kernel, mamba2_ssd_plain, mma_blocks_per_sm)

OUT = ROOT / "build" / "ablation"
K8_SOURCE = _build.CSRC / "mamba2_ssd.cu"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x * 1.4426950408889634f));'
LO = ["          mma16816(y[2 * np], al, xb[0], xb[1]);\n",
      "          mma16816(y[2 * np + 1], al, xb[2], xb[3]);\n",
      "          mma16816(y[2 * np], ca[ks], bl[0], bl[1]);\n",
      "          mma16816(y[2 * np + 1], ca[ks], bl[2], bl[3]);\n",
      "          ldsm_x4(bl, stl + (np * 16 + hi8 + r8) * LN + ks * 16 + lo8);\n",
      "          mma16816(st[k], al, bb[0], bb[1]);\n"]
VARIANTS = {
    "no-state": [("    if (warp < kStateWarps) {", "    if (warp < 0) {")],
    "no-intra": [("for (int jt = 0; jt <= rt && jt * 16 < len; ++jt) {",
                  "for (int jt = 0; jt < 0; ++jt) {")],
    "no-inter": [("          uint32_t bh[4], bl[4];\n",
                  "          if (ks >= 0) continue;\n          uint32_t bh[4], bl[4];\n")],
    "no-exp": [(EX2, "y = x;")],
    "balanced": [("const int rt = warp;",
                  "const int rt = warp < 4 ? warp : kMmaWarps + 3 - warp;")],
    "state-on-8": [("constexpr int kStateWarps = 4;", "constexpr int kStateWarps = 8;")],
    "bf16-only": [(line, "") for line in LO],
}

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
B, H, S, P, N, CHUNK = 8, 80, 1024, 64, 64, 128
TOL = dict(atol=2e-4, rtol=2.0 ** -7)


def time_cold_ms(fn, reps: int, flush) -> float:
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def build(name: str) -> Path:
    src = K8_SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is no longer in {K8_SOURCE.name}")
        src = src.replace(old, new)
    cu, lib = OUT / f"ssd_{name}.cu", OUT / f"libssd_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.nvcc_flags("mamba2_ssd"), "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    return lib


@contextlib.contextmanager
def kernel_as(ps: int, lib: Path | None = None):
    """Runs the wrapper at P-slice ``ps`` and, with ``lib``, on that build's
    functions (typed as the package types its own)."""
    saved = ssd.P_SLICE, ssd._fn
    ssd.P_SLICE = ps
    if lib is not None:
        dll = ctypes.CDLL(str(lib))

        def fn(name):
            f = getattr(dll, name)
            f.argtypes = ssd._ARGTYPES[name]
            f.restype = ctypes.c_int
            return f
        ssd._fn = fn
    try:
        yield
    finally:
        ssd.P_SLICE, ssd._fn = saved


def inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device=dev).to(torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev)).transpose(1, 2)
    adt = -torch.linspace(1.0, 16.0, H, device=dev)[None, :, None] * dt
    return x, adt, dt, xbc[..., H * P:H * P + N], xbc[..., H * P + N:]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    args = inputs(dev)
    want = mamba2_ssd_plain(*args, CHUNK)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    nbytes = (2 * B * H * S * P + 2 * B * S * N) * 2 + 2 * B * H * S * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"K8 bf16 at x {(B, H, S, P)}, B/C {(B, S, N)}, chunk {CHUNK}: byte bound "
          f"{bound_ms!r} ms ({nbytes} B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)
    def run():
        return mamba2_ssd_kernel(*args, chunk=CHUNK)
    for ps in (16, 32, 64):
        with kernel_as(ps):
            got = run()
            torch.cuda.synchronize()
            if not torch.allclose(got.float(), want.float(), **TOL):
                err = float((got.float() - want.float()).abs().max())
                raise SystemExit(f"P-slice {ps}: differs from plain ({err!r})")
            ms = time_cold_ms(run, 20, flush)
            default = " (the wrapper's)" if ps == P_SLICE else ""
            print(f"K8 P-slice {ps} ({B * H * (P // ps)} blocks){default}: {ms!r} ms, "
                  f"{nbytes / ms / 1e9!r} TB/s, {ms / bound_ms!r} x the byte bound, "
                  f"{mma_blocks_per_sm(CHUNK, P, N)} blocks per SM", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    for name, lib in libs.items():
        for ps in (64, 32):
            with kernel_as(ps, lib):
                got = run()
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                ok = torch.allclose(got.float(), want.float(), **TOL)
                ms = time_cold_ms(run, 20, flush)
            print(f"K8 variant {name}, P-slice {ps}: {ms!r} ms, max abs err {err!r} (within "
                  f"the tolerance: {ok})", flush=True)
    from torch.profiler import ProfilerActivity, profile
    mamba2_ssd_kernel(*args, chunk=CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mamba2_ssd_kernel(*args, chunk=CHUNK)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "ssd" in ev.key:
            print(f"K8 profiled: {ev.key[:60]} {ev.device_time_total!r} us over {ev.count} "
                  f"launch(es)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
