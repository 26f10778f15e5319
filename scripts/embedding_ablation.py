#!/usr/bin/env python3
"""Ablation of the port's embedding-bag kernel K3 on one NVIDIA GPU.

    python3 scripts/embedding_ablation.py

K3 (``bag_kernel`` of ``src/repro_torch/csrc/embedding_bag.cu``) runs on the
inputs the DLRM-RMC2 forward gives it at its first request: the full-width
table (60 x 1M rows x dim 128, f32, 30.72 GB, filled on the card from seed
0 as ``chip_smoke.py`` fills it) and request 0's lookups
(``dlrm_batch(batch_size=32, zipf_s=1.10)``, 1,920 bags of 120). Each
variant is built from the source by text substitution, checked bitwise
against the kernel as it is, and timed three ways: the mean of 20
back-to-back launches, the mean of 20 with the L2 cache flushed before
each, and the mean device time of 20 launches under ``torch.profiler``
(the kernel's own span, without the gaps between launches). The kernel as
it is runs first and last, so the spread of the card shows;
``F.embedding_bag`` on the same inputs is timed beside them.

Variants:
  column-per-thread  the design it replaced: a thread per output column (a
                     bag = 128 threads at D = 128, four bags a 512-thread
                     block), 4-byte loads, the indices staged in shared
                     memory behind two __syncthreads per 128;
  4-byte-loads       the warp-per-bag design with the scalar columns (c0 +
                     lane + 32 e) of a table it cannot read 16 bytes at a
                     time, not 4 consecutive columns a lane;
  rows-4, -8, -32    groups of 4, 8 or 32 rows loaded before their adds
                     (the kernel loads 16);
  smem-indices       each block of 32 indices stored to shared memory and
                     read from there (a __syncwarp before and after), not
                     handed between lanes by shuffle;
  block-per-sm       a grid of one 4-warp block per SM, each warp taking
                     several bags in turn, not a bag a warp.

Builds into ``build/ablation/``. Last, the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.trace import REUSE_LEVELS  # noqa: E402
from repro_torch.data import DLRMDataConfig, dlrm_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import embedding_bag as emb  # noqa: E402
from repro_torch.models import DLRM, DLRMConfig  # noqa: E402

OUT = ROOT / "build" / "ablation"
LAUNCH_HEAD = """template <typename T>
int launch_bag(const void* table, const int* idx, int64_t rows, int64_t bags, int L, int D,
               int sms, void* out, cudaStream_t st) {
"""
COLUMN_BAG = """constexpr int kColumnBlock = 512;
constexpr int kColumnChunk = 128;
template <typename T>
__global__ void __launch_bounds__(kColumnBlock)
column_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx, int64_t rows,
                  int64_t bags, int L, int D, int col_threads, T* __restrict__ out) {
  __shared__ int idx_s[kColumnBlock / 32][kColumnChunk];
  const int groups = blockDim.x / col_threads;
  const int g = threadIdx.x / col_threads;
  const int c = threadIdx.x % col_threads;
  const int64_t bag = (int64_t)blockIdx.x * groups + g;
  const bool live_bag = bag < bags;
  for (int c0 = 0; c0 < D; c0 += col_threads) {
    const int col = c0 + c;
    const bool live = live_bag && col < D;
    const T* column = table + col;
    float acc = 0.0f;
    for (int l0 = 0; l0 < L; l0 += kColumnChunk) {
      const int n = min(kColumnChunk, L - l0);
      __syncthreads();
      if (live_bag) {
        for (int i = c; i < n; i += col_threads) idx_s[g][i] = idx[bag * L + l0 + i];
      }
      __syncthreads();
      if (live) {
#pragma unroll 8
        for (int i = 0; i < n; ++i) {
          const int64_t r = clamp_row(idx_s[g][i], rows);
          acc = __fadd_rn(acc, to_f32(column[r * D]));
        }
      }
    }
    if (live) out[bag * D + col] = from_f32<T>(acc);
  }
}

template <typename T>
int launch_bag(const void* table, const int* idx, int64_t rows, int64_t bags, int L, int D,
               int sms, void* out, cudaStream_t st) {
  const int col_threads = (D + 31) / 32 * 32 < 256 ? (D + 31) / 32 * 32 : 256;
  const int groups = kColumnBlock / col_threads;
  const int64_t grid = (bags + groups - 1) / groups;
  column_bag_kernel<T><<<(unsigned)grid, col_threads * groups, 0, st>>>(
      (const T*)table, idx, rows, bags, L, D, col_threads, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bag_unused(const void* table, const int* idx, int64_t rows, int64_t bags, int L,
                      int D, int sms, void* out, cudaStream_t st) {
"""
ROWS = "constexpr int kBagRows = 16;"
VARIANTS = {
    "column-per-thread": [(LAUNCH_HEAD, COLUMN_BAG)],
    "4-byte-loads": [("  if (D % 4 == 0 && (uintptr_t)table % (4 * sizeof(T)) == 0) {",
                      "  if (false) {")],
    "rows-4": [(ROWS, "constexpr int kBagRows = 4;")],
    "rows-8": [(ROWS, "constexpr int kBagRows = 8;")],
    "rows-32": [(ROWS, "constexpr int kBagRows = 32;")],
    "smem-indices": [
        ('  static_assert(32 % U == 0, "a group of rows stays inside a block of 32 indices");\n',
         '  static_assert(32 % U == 0, "a group of rows stays inside a block of 32 indices");\n'
         "  __shared__ int s_idx[kBagWarps][32];\n"),
        ("        const int cur = next;\n",
         "        __syncwarp();\n        s_idx[threadIdx.x / 32][lane] = next;\n"
         "        __syncwarp();\n"),
        ("            const int q = __shfl_sync(kFull, cur, g + u);",
         "            const int q = s_idx[threadIdx.x / 32][g + u];")],
    "block-per-sm": [("  const int64_t cap = (int64_t)sms * bag_blocks_per_sm<T, VEC>();",
                      "  const int64_t cap = (int64_t)sms;")],
}


def build(name: str) -> Path:
    src = _build.source_text("embedding_bag")
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is no longer in embedding_bag.cu")
        src = src.replace(old, new)
    cu, lib = OUT / f"embedding_bag_{name}.cu", OUT / f"libembedding_bag_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.nvcc_flags("embedding_bag"), "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def time_ms(fn, reps: int) -> float:
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


def device_ms(fn, reps: int, word: str) -> float:
    """Mean device time of the events whose names hold ``word`` over
    ``reps`` runs under torch.profiler (-1.0 if it recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and word in e.name]
    return sum(spans) / reps / 1e3 if spans else -1.0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))

    cfg = DLRMConfig()
    R, D, L = cfg.rows_per_table, cfg.dim, cfg.lookups_per_table
    table = DLRM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)).tables
    batch = dlrm_batch(DLRMDataConfig(cfg.num_tables, R, L, batch_size=32,
                                      zipf_s=REUSE_LEVELS["reuse_high"]), 0)
    B, T = batch["sparse"].shape[:2]
    idx = (torch.from_numpy(batch["sparse"]).to(dev)
           + torch.arange(T, dtype=torch.int32, device=dev)[None, :, None] * R).contiguous()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)     # > the 50 MB L2
    stream = torch.cuda.current_stream(dev).cuda_stream
    want = emb.embedding_bag_kernel(table, idx)
    out = torch.empty_like(want)
    print(f"K3 at (B, T, L, D)=({B}, {T}, {L}, {D}) f32, {B * T} bags, "
          f"{int(torch.unique(idx).numel())} distinct rows", flush=True)

    def launcher(lib):
        if lib is None:
            return emb._fn("embedding_bag_launch")
        fn = ctypes.CDLL(str(lib)).embedding_bag_launch
        fn.argtypes, fn.restype = emb._ARGTYPES["embedding_bag_launch"], ctypes.c_int
        return fn

    for name in ["as is", *VARIANTS, "as is"]:
        fn = launcher(libs.get(name))

        def run(fn=fn):
            err = fn(table.data_ptr(), idx.data_ptr(), table.shape[0], B * T, L, D,
                     emb.DTYPE_IDS[table.dtype], emb._sm_count(), out.data_ptr(), stream)
            if err:
                raise SystemExit(f"{name}: launch failed with CUDA error {err}")
        run()
        torch.cuda.synchronize()
        same = torch.equal(out.view(torch.int32), want.view(torch.int32))
        ms, cold = time_ms(run, 20), time_cold_ms(run, 20, flush)
        word = "column_bag_kernel" if name == "column-per-thread" else "bag_kernel"
        print(f"K3 {name}: {ms!r} ms ({cold!r} L2 flushed, device time {device_ms(run, 20, word)!r}"
              f" ms), bitwise equal to the kernel as it is: {same}", flush=True)
    flat = idx.reshape(-1).long()
    offs = torch.arange(0, flat.numel(), L, device=dev)

    def lib_run():
        return F.embedding_bag(flat, table, offs, mode="sum")
    print(f"F.embedding_bag: {time_ms(lib_run, 20)!r} ms ({time_cold_ms(lib_run, 20, flush)!r} "
          f"L2 flushed)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
