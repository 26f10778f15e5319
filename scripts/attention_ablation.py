#!/usr/bin/env python3
"""Ablations of the port's attention kernels K6 and K7 on one NVIDIA GPU.

    python3 scripts/attention_ablation.py

K6 (``src/repro_torch/csrc/flash_attention.cu``), both routes (bf16 wgmma,
f32 3xTF32), at Zamba2-2.7B's prefill shape (8, 32, 32, 1024, 80) and at
(2, 32, 32, 4096, 80), causal: the source as it is and variants built from
it by text substitution,

  exp2f     the library's exp2f in place of ``ex2.approx.ftz``;
  no-exp    every exponential of the softmax removed (p = the scaled score,
            so the output is meaningless): what the MUFU work costs;
  3-stage   a third K/V stage in the TMA ring (bf16);
  1xTF32    one TF32 product (hi.hi) where the f32 route runs three (the
            error grows to TF32's): what the two others cost;
  no-split  the f32 route's split of each K/V tile into hi and lo left out
            (wrong output): what the split pass costs;
  no-v-loads the f32 route's V fragments read from one place a tile, not
            per k-step and column block (wrong output): what those shared
            loads cost;
  bk-32     the f32 route's K/V tiles of 32 positions, not 64, at d <= 80;
  bk-32x2   that, with two blocks resident on an SM (128 registers a
            thread);

each timed with the L2 cache flushed before every launch, beside
``F.scaled_dot_product_attention`` in the same dtype. K7 (``csrc/decode_attention.cu``) at
Zamba2's last decode step (q (8, 32, 80), cache (8, 32, 1064, 80), valid
1056, bf16) for chunks of 32 to 256 positions, beside SDPA over the valid
prefix, and the device times of its split and combine kernels by
``torch.profiler``. Prints one line per measurement, then the card's name and
power limit. Builds into ``build/ablation/``; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels.flash_attention import _launch, flash_attention_plain  # noqa: E402

OUT = ROOT / "build" / "ablation"
K6_SOURCE = _build.CSRC / "flash_attention.cu"
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
VARIANTS = {
    "as-is": [],
    "exp2f": [(EX2, "y = exp2f(x);")],
    "no-exp": [(EX2, "y = x;")],
    "3-stage": [("static constexpr int kStages = 2;", "static constexpr int kStages = 3;")],
    "1xTF32": [("  mma_tf32(d, al, bh0, bh1);\n  mma_tf32(d, ah, bl0, bl1);\n", "")],
    "no-split": [("    tf_split<DP, BK, NT>(kt, klo, tid);\n    tf_split<DP, BK, NT>(vt, vlo, tid);\n",
                  "")],
    "no-v-loads": [("        mma_3xtf32(o[i], ph, pl, __float_as_uint(vh[off]), __float_as_uint(vh[off + kS]),\n"
                    "                   __float_as_uint(vl[off]), __float_as_uint(vl[off + kS]));",
                    "        mma_3xtf32(o[i], ph, pl, __float_as_uint(vh[0]), __float_as_uint(vh[kS]),\n"
                    "                   __float_as_uint(vl[0]), __float_as_uint(vl[kS]));")],
    "bk-32": [("launch_tf32<80, 128, 64>", "launch_tf32<80, 128, 32>")],
    "bk-32x2": [("launch_tf32<80, 128, 64>", "launch_tf32<80, 128, 32>"),
                ("__launch_bounds__(TfLayout<DP, BQ, BK>::kThreads, 1)",
                 "__launch_bounds__(TfLayout<DP, BQ, BK>::kThreads, 2)")],
}
# The variants that change one route only.
ONLY = {"3-stage": torch.bfloat16, "1xTF32": torch.float32, "no-split": torch.float32,
        "no-v-loads": torch.float32, "bk-32": torch.float32, "bk-32x2": torch.float32}


def build(name: str) -> Path:
    src = _build.source_text("flash_attention")  # its csrc/ headers inlined
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is no longer in {K6_SOURCE.name}")
        src = src.replace(old, new)
    cu, lib = OUT / f"flash_{name}.cu", OUT / f"libflash_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.nvcc_flags("flash_attention"), "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def time_cold_ms(fn, reps: int, flush) -> float:
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def time_k6(libs, flush, gen) -> None:
    fns = {}
    for name, lib in libs.items():
        for dtype, entry in ((torch.bfloat16, "flash_attention_bf16_launch"),
                             (torch.float32, "flash_attention_f32_launch")):
            if ONLY.get(name, dtype) != dtype:
                continue
            fn = getattr(ctypes.CDLL(str(lib)), entry)
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[(name, dtype)] = fn
    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in ((8, 1024), (2, 4096)):
            q, k, v = (torch.randn(B, S, 32, 80, generator=gen, device="cuda").to(dtype)
                       .transpose(1, 2) for _ in range(3))
            out = torch.empty(q.shape, dtype=dtype, device="cuda")
            want = flash_attention_plain(q, k, v, causal=True).float() if S <= 1024 else None
            flops = 4 * B * 32 * (S * (S + 1) // 2) * 80

            def run(fn):
                err = _launch(fn, q, k, v, out, True, 1.0 / math.sqrt(80), stream)
                if err:
                    raise SystemExit(f"K6 launch failed with CUDA error {err}")

            sdpa = time_cold_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                                10, flush)
            for (name, dt), fn in fns.items():
                if dt != dtype:
                    continue
                run(fn)
                torch.cuda.synchronize()
                err = float((out.float() - want).abs().max()) if want is not None else None
                ms = time_cold_ms(lambda: run(fn), 10, flush)
                print(f"K6 {name} (B, H, S, d)=({B}, 32, {S}, 80) causal {dtype}: {ms!r} ms "
                      f"({flops / ms / 1e9!r} TFLOP/s of products), max abs err vs plain "
                      f"{err!r}; SDPA {sdpa!r} ms", flush=True)


def time_k7(flush, gen) -> None:
    q = torch.randn(8, 32, 80, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(8, 32, 1064, 80, generator=gen, device="cuda").bfloat16() for _ in range(2))
    want = dec.decode_attention_plain(q, k, v, 1056).float()
    sdpa = time_cold_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k[:, :, :1056], v[:, :, :1056]), 20, flush)
    chosen = dec.CHUNK
    try:
        for chunk in (32, 64, 128, 256):
            dec.CHUNK = chunk
            err = float((dec.decode_attention_kernel(q, k, v, 1056).float() - want).abs().max())
            ms = time_cold_ms(lambda: dec.decode_attention_kernel(q, k, v, 1056), 20, flush)
            print(f"K7 chunk {chunk} (q (8, 32, 80), cache (8, 32, 1064, 80), valid 1056, bf16): "
                  f"{ms!r} ms, max abs err vs plain {err!r}; SDPA {sdpa!r} ms", flush=True)
    finally:
        dec.CHUNK = chosen
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            flush.zero_()
            dec.decode_attention_kernel(q, k, v, 1056)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "split_kernel" in e.key or "combine_kernel" in e.key:
            print(f"K7 chunk {chosen}: {e.key[:60]} {e.device_time_total / e.count!r} us a launch "
                  f"({e.count} launches, torch.profiler)", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    time_k6(libs, flush, gen)
    time_k7(flush, gen)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
