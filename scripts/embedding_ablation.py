#!/usr/bin/env python3
"""Ablation of the port's embedding-bag kernel K3 on one NVIDIA GPU.

    python3 scripts/embedding_ablation.py

K3 (``bag_kernel`` of ``src/repro_torch/csrc/embedding_bag.cu``) runs on the
full-width DLRM-RMC2 table (60 x 1M rows x dim 128, f32, 30.72 GB, filled on
the card from seed 0 as ``chip_smoke.py`` fills it) with three inputs:

  request 0        the DLRM forward's first request
                   (``dlrm_batch(batch_size=32, zipf_s=1.10)``, 1,920 bags of
                   120), every bag resident at once;
  bench s=1.10     batches of the benchmark's cells: 4,096 samples x 60
  bench s=0.81     tables x 120 lookups, row ids Zipf(s) over each table's
                   rows through one rank-to-row permutation a table, drawn as
                   ``bench/harness/traffic.py`` and ``bench/kinds/ranking.py``
                   draw them (245,760 bags, far more than the card holds
                   warps at once, so the order of the walk decides what L2
                   holds).

Each variant is built from the source by text substitution, checked bitwise
against the kernel as it is (which is checked against
``embedding_bag_plain`` at the benchmark's shape), and timed three ways: the
mean of 20 back-to-back launches, each on the next of ``BATCHES`` distinct
batches (so one launch does not leave the next one's rows in L2 beyond what
a batch of the same traffic would), the mean of 20 with the L2 cache
flushed before each, and the mean device time of 20 launches under
``torch.profiler`` (the kernel's own span, without the gaps between
launches). The kernel as it is runs first and last, so the spread of the
card shows; ``F.embedding_bag`` on the same inputs is timed beside them. At
the benchmark's shape each line also gives K3's share of its byte roofline
as ``bag_roofline`` counts it (distinct rows, indices and bags at 3.35 TB/s).

Variants:
  bag-major          the walk before tables came first: bag k is (b, t) =
                     (k / T, k % T), so the resident warps gather from
                     every table at once;
  tables-2, -4       the walk 2 or 4 tables at a time, bag-major inside the
                     group (the kernel walks one table at a time);
  column-per-thread  the design warp-per-bag replaced: a thread per output
                     column (a bag = 128 threads at D = 128, four bags a
                     512-thread block), 4-byte loads, the indices staged in
                     shared memory behind two __syncthreads per 128;
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

Last, where Nsight Compute (``ncu``) is on the machine and the card lets it
read its counters, K3's DRAM bytes read and L2 and L1 hit rates at both
benchmark inputs, for the kernel as it is and for ``bag-major``, each on a
batch launched right after another batch of the same traffic
(``--ncu-child`` is that run); then the card's name and power limit.

Builds into ``build/ablation/``. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import re
import shutil
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
HBM_BYTES_PER_S = 3.35e12
BENCH_BATCH = 4096
BATCHES = 4          # distinct benchmark batches a level, launched in turn
NCU_METRICS = "dram__bytes_read.sum,lts__t_sector_hit_rate.pct,l1tex__t_sector_hit_rate.pct"
LAUNCH_HEAD = """template <typename T>
int launch_bag(const void* table, const int* idx, int64_t rows, int64_t bags, int tables, int L,
               int D, int sms, void* out, cudaStream_t st) {
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
int launch_bag(const void* table, const int* idx, int64_t rows, int64_t bags, int tables, int L,
               int D, int sms, void* out, cudaStream_t st) {
  const int col_threads = (D + 31) / 32 * 32 < 256 ? (D + 31) / 32 * 32 : 256;
  const int groups = kColumnBlock / col_threads;
  const int64_t grid = (bags + groups - 1) / groups;
  column_bag_kernel<T><<<(unsigned)grid, col_threads * groups, 0, st>>>(
      (const T*)table, idx, rows, bags, L, D, col_threads, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bag_unused(const void* table, const int* idx, int64_t rows, int64_t bags, int tables,
                      int L, int D, int sms, void* out, cudaStream_t st) {
"""
ROWS = "constexpr int kBagRows = 16;"
TABLES = "constexpr int kBagTables = 1;"
VARIANTS = {
    "as is": [],
    "bag-major": [(TABLES, "constexpr int kBagTables = 1 << 30;")],
    "tables-2": [(TABLES, "constexpr int kBagTables = 2;")],
    "tables-4": [(TABLES, "constexpr int kBagTables = 4;")],
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


def lib_path(name: str) -> Path:
    return OUT / f"libembedding_bag_{name.replace(' ', '-')}.so"


def build(name: str) -> str:
    """Builds variant ``name``; returns ptxas's line on the registers of its
    f32, 16-byte K3 instance."""
    src = _build.source_text("embedding_bag")
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} is no longer in embedding_bag.cu")
        src = src.replace(old, new)
    lib = lib_path(name)
    cu = lib.with_suffix(".cu")
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.nvcc_flags("embedding_bag"), "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stdout}{proc.stderr}")
    said, entry = [], ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif ("spill" in line or "Used" in line) and re.search(
                r"bag_kernelIfLb1E|column_bag_kernelIfE", entry):
            said.append(line.split(":", 1)[-1].strip())
    return "; ".join(said)


def launcher(name: str):
    fn = ctypes.CDLL(str(lib_path(name))).embedding_bag_launch
    fn.argtypes, fn.restype = emb._ARGTYPES["embedding_bag_launch"], ctypes.c_int
    return fn


def zipf_batches(cfg: DLRMConfig, s: float, n: int, seed: int, dev) -> list:
    """``n`` batches of the benchmark's ranking traffic at Zipf ``s``, their
    row ids offset into the stacked table ``(B, T, L)`` int32: one rank-to-row
    permutation a table, ranks by inverse CDF over p(r) ~ (r + 1)^-s."""
    T, R, L, B = cfg.num_tables, cfg.rows_per_table, cfg.lookups_per_table, BENCH_BATCH
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.rand((T, R), generator=g, device=dev).argsort(dim=1).to(torch.int32)
    cdf = torch.cumsum(torch.arange(1, R + 1, dtype=torch.float64, device=dev).pow_(-s), 0)
    cdf = cdf.div_(cdf[-1].clone())
    offsets = torch.arange(T, dtype=torch.int32, device=dev)[None, :, None] * R
    batches = []
    for _ in range(n):
        u = torch.rand(B * T * L, dtype=torch.float64, device=dev, generator=g)
        ranks = torch.searchsorted(cdf, u, right=True).clamp_(max=R - 1).view(B, T, L)
        rows = torch.gather(perm, 1, ranks.permute(1, 0, 2).reshape(T, B * L))
        batches.append((rows.view(T, B, L).permute(1, 0, 2) + offsets).contiguous())
    return batches


def inputs(cfg: DLRMConfig, dev) -> dict:
    """The three inputs: name -> list of index batches ``(B, T, L)``."""
    R, L = cfg.rows_per_table, cfg.lookups_per_table
    batch = dlrm_batch(DLRMDataConfig(cfg.num_tables, R, L, batch_size=32,
                                      zipf_s=REUSE_LEVELS["reuse_high"]), 0)
    T = batch["sparse"].shape[1]
    req0 = (torch.from_numpy(batch["sparse"]).to(dev)
            + torch.arange(T, dtype=torch.int32, device=dev)[None, :, None] * R).contiguous()
    return {"request 0": [req0],
            **{f"bench s={REUSE_LEVELS[k]:.2f}": zipf_batches(cfg, REUSE_LEVELS[k], BATCHES,
                                                              seed, dev)
               for seed, k in enumerate(("reuse_high", "reuse_low"), 1)}}


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


def roofline_bytes(idx: torch.Tensor, D: int, elem: int) -> int:
    """What ``bag_roofline`` counts for a batch: each distinct row once, the
    indices once, the bags once."""
    B, T, L = idx.shape
    return int(torch.unique(idx).numel()) * D * elem + B * T * L * 4 + B * T * D * elem


def ncu_readings() -> None:
    """K3's DRAM bytes and hit rates under Nsight Compute, where it runs."""
    ncu = shutil.which("ncu") or shutil.which("ncu", path="/usr/local/cuda/bin")
    if ncu is None:
        print("ncu: not on this machine; no counter readings", flush=True)
        return
    cmd = [ncu, "--metrics", NCU_METRICS, "--kernel-name", "regex:bag_kernel", "--cache-control",
           "none", "--clock-control", "none", "--replay-mode", "application", "--csv",
           sys.executable, str(Path(__file__).resolve()), "--ncu-child"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
    except subprocess.TimeoutExpired:
        print("ncu: no result within 1,200 s", flush=True)
        return
    print(f"ncu exited {proc.returncode}", flush=True)
    keep = [ln for ln in proc.stdout.splitlines() if "bag_kernel" in ln or ln.startswith(
        ('"ID"', "launch ", "==ERROR==", "==WARNING=="))]
    print("\n".join(keep[-200:] or proc.stdout.splitlines()[-40:]), flush=True)
    if proc.returncode:
        print(proc.stderr[-3000:], flush=True)


def ncu_child(table, batches: dict, stream) -> None:
    """The launches ``ncu`` reads: at each benchmark input, the kernel as it
    is and ``bag-major``, each on batch 0 and then on batch 1 (read that
    one: it finds L2 as a batch of the same traffic left it)."""
    B, T, L = next(iter(batches.values()))[0].shape
    out = torch.empty((B, T, table.shape[1]), dtype=table.dtype, device=table.device)
    n = 0
    for name in ("as is", "bag-major"):
        fn = launcher(name)
        for level, idxs in batches.items():
            for i in (0, 1):
                fn(table.data_ptr(), idxs[i].data_ptr(), table.shape[0], B * T, T, L,
                   table.shape[1], emb.DTYPE_IDS[table.dtype], emb._sm_count(),
                   out.data_ptr(), stream)
                torch.cuda.synchronize()
                print(f"launch {n}: {name}, {level}, batch {i}", flush=True)
                n += 1


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    child = "--ncu-child" in sys.argv[1:]
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    names = ["as is", "bag-major"] if child else list(VARIANTS)
    if not child or not all(lib_path(n).exists() for n in names):
        with ThreadPoolExecutor(len(names)) as pool:
            regs = dict(zip(names, pool.map(build, names)))
        for name in names:
            print(f"K3 {name}: {regs[name]}", flush=True)

    cfg = DLRMConfig()
    D = cfg.dim
    table = DLRM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)).tables
    stream = torch.cuda.current_stream(dev).cuda_stream
    data = inputs(cfg, dev)
    if child:
        ncu_child(table, {k: v for k, v in data.items() if k != "request 0"}, stream)
        return
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)     # > the 50 MB L2
    elem = table.element_size()

    for label, idxs in data.items():
        B, T, L = idxs[0].shape
        want = emb.embedding_bag_kernel(table, idxs[0])
        out = torch.empty_like(want)
        need = [roofline_bytes(i, D, elem) for i in idxs]
        plain = ""
        if B == BENCH_BATCH:
            same = torch.equal(want.view(torch.int32),
                               emb.embedding_bag_plain(table, idxs[0]).view(torch.int32))
            plain = f", bitwise equal to embedding_bag_plain: {same}"
        distinct = sum(n - B * T * (L * 4 + D * elem) for n in need) / (D * elem) / len(idxs)
        print(f"{label}: K3 at (B, T, L, D)=({B}, {T}, {L}, {D}) f32, {B * T} bags, "
              f"{distinct:.0f} distinct rows a batch ({100 * distinct / (B * T * L):.2f}% of "
              f"lookups), {len(idxs)} distinct batches{plain}", flush=True)

        for name in [*VARIANTS, "as is"]:
            fn = launcher(name)
            turn = [0]

            def run(fn=fn, name=name, turn=turn):
                idx = idxs[turn[0] % len(idxs)]
                turn[0] += 1
                err = fn(table.data_ptr(), idx.data_ptr(), table.shape[0], B * T, T, L, D,
                         emb.DTYPE_IDS[table.dtype], emb._sm_count(), out.data_ptr(), stream)
                if err:
                    raise SystemExit(f"{name}: launch failed with CUDA error {err}")
            run()        # batch 0
            torch.cuda.synchronize()
            same = torch.equal(out.view(torch.int32), want.view(torch.int32))
            ms, cold = time_ms(run, 20), time_cold_ms(run, 20, flush)
            word = "column_bag_kernel" if name == "column-per-thread" else "bag_kernel"
            dev_ms = device_ms(run, 20, word)
            roof = (f", bag_roofline {100 * sum(need) / len(need) / HBM_BYTES_PER_S / dev_ms * 1e3!r}%"
                    if B == BENCH_BATCH and dev_ms > 0 else "")
            print(f"{label}: K3 {name}: {ms!r} ms ({cold!r} L2 flushed, device time {dev_ms!r}"
                  f" ms{roof}), bitwise equal to the kernel as it is: {same}", flush=True)
        flat = idxs[0].reshape(-1).long()
        offs = torch.arange(0, flat.numel(), L, device=dev)

        def lib_run():
            return F.embedding_bag(flat, table, offs, mode="sum")
        print(f"{label}: F.embedding_bag: {time_ms(lib_run, 20)!r} ms "
              f"({time_cold_ms(lib_run, 20, flush)!r} L2 flushed)", flush=True)
        del want, out, flat, offs
    del flush, table, data
    torch.cuda.empty_cache()
    ncu_readings()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
