#!/usr/bin/env python3
"""Ablation of the port's simulator scan kernels, D1, K1, K2 and D2, on one NVIDIA GPU.

    python3 scripts/scan_ablation.py [KERNEL ...]

KERNEL is any of dram_scan, cache_scan, stack_distance and rrip_scan; with
none given, all four run.

All run on the full-size inputs of ``simulate`` on DLRM-RMC2 x ``tpuv6e()``
(``dlrm_rmc2_small(num_batches=2)``): D1 (``src/repro_torch/csrc/dram_scan.cu``)
on the (32, 16384) chunk rows of the SPM miss stream, K1
(``src/repro_torch/csrc/cache_scan.cu``) and K2
(``src/repro_torch/csrc/stack_distance.cu``) on the two set-group buckets,
(967, 512) and (57, 1024), 16 sets x 16 ways, K1 for each policy, and D2
(``src/repro_torch/csrc/rrip_scan.cu``) on the buckets of the on-chip
cache's lane stream under srrip and fifo (16 ways) and of a FIFO TLB
(64 entries of 4 ways, an L2 of 1,024 entries of 8 ways) behind spm. Each
variant is built from the kernel's source, its ``csrc/`` headers inlined
(``_build.source_text``), by text substitution, checked bitwise against
the kernel as it is, and timed as ``chip_smoke.py`` times the kernels: the
mean of 20 back-to-back launches, and the mean of 20 with the L2 cache
flushed before each. The kernel as it is runs first and last, so the
spread of the card shows.

D1 variants:
  registers      the bank state of a row in registers (8 banks, as tpuv6e
                 has), a read a select per bank, not in shared memory;
  no-read-ahead  each chunk's bank entry read after the previous chunk's
                 write, not before it (a shared-memory round trip on the
                 chain);
  branch-a-step  the state update under `if (valid)` as the reference
                 writes it, not as selects and a store to a spare row;
  prefetch       a group's 16 chunks read into a second set of registers
                 when the group before it starts, not at its end;
  group-at-top   a group's 16 chunks read at the top of its own loop
                 iteration, not at the end of the one before;
  one-stage      one stage of tiles: the loaders refill it only when the
                 compute warp is done with it;
  tile-64        tiles of 64 chunks, not 128.
K1 and K2 variants (of the walk both share, csrc/set_team_scan.cuh):
  team-32        every set's team a whole warp (32 lanes, 16 of them idle at
                 16 ways), so each warp walks one set;
  scan-only      no access walked: staging the row, sorting its positions
                 into the teams' lists and writing the outputs back (wrong
                 output: what the rest costs);
  stage-only     staging the row (and counting its sets) and writing the
                 outputs back, nothing else (wrong output);
  no-read-ahead  each access's position and tag read from shared memory when
                 its step starts, not during the step before;
K1 only:
  no-min         the victim's min-reduction left out (wrong output: what the
                 reductions cost).
K2 only:
  no-sum         the team sum of matching ranks left out (wrong output).
D2 variants:
  walk-padding   every group of 16 steps walked, also those past the block's
                 longest row;
  keyed-min      SRRIP's key held as (key << 6) | way, so one min tree gives
                 the minimum and its first way (no find-first-set);
  int-chain      FIFO's step in integer operations only: equality as the
                 unsigned minimum of tag XORs, the head a one-hot mask, each
                 update a masked XOR (no predicates on the chain);
  branch-a-step  FIFO's state update under `if (miss)`, not as selects;
  one-stage      one stage of tiles;
  tile-64        tiles of 64 steps, not 256;
  masked-only    every ways count run by the instance that masks the ways
                 past it, also where the ways fill the instance (no
                 instance without the mask);
  no-walk        no step walked: staging the rows and writing the outputs
                 back (wrong output: what the rest costs).

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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import dlrm_rmc2_small, tpuv6e  # noqa: E402
from repro_torch.core.engine import build_embedding_traces  # noqa: E402
from repro_torch.core.memory.cache import bucket_rows  # noqa: E402
from repro_torch.core.memory.dram import chunk_rows  # noqa: E402
from repro_torch.core.memory.system import MemorySystem, lane_geometry  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cache_scan as k1  # noqa: E402
from repro_torch.kernels import dram_scan as d1  # noqa: E402
from repro_torch.kernels import rrip_scan as d2  # noqa: E402
from repro_torch.core.memory.rrip import row_buckets  # noqa: E402
from repro_torch.core.memory.tlb import classify_tlb, tlb_pages  # noqa: E402
from repro_torch.kernels import stack_distance as k2  # noqa: E402

OUT = ROOT / "build" / "ablation"
REGISTER_STATE = """struct BankState {
  int open[9];
  float free_[9];
  __device__ BankState(uint8_t*, int, int) {
#pragma unroll
    for (int b = 0; b < 9; ++b) {
      open[b] = -1;
      free_[b] = 0.0f;
    }
  }
  __device__ __forceinline__ void read(int b, float& f, int& o) const {
    f = free_[0];
    o = open[0];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      if (b == j) {
        f = free_[j];
        o = open[j];
      }
    }
  }
  __device__ __forceinline__ void write(int b, int o, float f) {
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      if (b == j) {
        open[j] = o;
        free_[j] = f;
      }
    }
  }
};
"""
UPDATE = """        const bool upd = v && in;
        state.write(upd ? slot : banks, g.rw[j], dlast);
        bus_free = v ? dlast : bus_free;
        lat = v ? __fadd_rn(lat, lc) : lat;
        hits += v ? g.k[j] - 1 + (row_hit ? 1 : 0) : 0;
        dmax = v ? fmaxf(dmax, dlast) : dmax;
"""
BRANCH = """        const bool upd = v && in;
        if (v) {
          if (in) state.write(slot, g.rw[j], dlast);
          bus_free = dlast;
          lat = __fadd_rn(lat, lc);
          hits += g.k[j] - 1 + (row_hit ? 1 : 0);
          dmax = fmaxf(dmax, dlast);
        }
"""
VARIANTS = {
    "dram_scan": {
        "registers": [("struct BankState {", REGISTER_STATE + "struct SharedBankState {"),
                      ("  __device__ BankState(uint8_t* smem,", "  __device__ SharedBankState(uint8_t* smem,")],
        "no-read-ahead": [
            ("          state.read(slot_n, pf_n, po_n);\n", ""),
            ("          const bool same = upd && slot_n == slot;",
             "          state.read(slot_n, pf_n, po_n);\n          const bool same = false;")],
        "branch-a-step": [(UPDATE, BRANCH)],
        "prefetch": [
            ("    for (int g0 = 0; g0 < n; g0 += kGroup) {\n      float d0[kGroup];",
             "    for (int g0 = 0; g0 < n; g0 += kGroup) {\n      Group next;\n"
             "      if (g0 + kGroup < n) load_group(next, st, lane, g0 + kGroup);\n"
             "      float d0[kGroup];"),
            ("      if (g0 + kGroup < n) load_group(g, st, lane, g0 + kGroup);\n", "      g = next;\n")],
        "group-at-top": [
            ("    Group g;\n    load_group(g, st, lane, 0);\n"
             "    for (int g0 = 0; g0 < n; g0 += kGroup) {\n",
             "    for (int g0 = 0; g0 < n; g0 += kGroup) {\n      Group g;\n"
             "      load_group(g, st, lane, g0);\n"),
            ("      if (g0 + kGroup < n) load_group(g, st, lane, g0 + kGroup);\n", "")],
        "one-stage": [("constexpr int kStages = 2;", "constexpr int kStages = 1;")],
        "tile-64": [("constexpr int kTile = 128;", "constexpr int kTile = 64;")],
    },
}
# The shared walk's variants, for K1 and K2 alike.
WALK = {
    "team-32": [("while ((1 << *team_log2) < (ways < 32 ? ways : 32)) ++*team_log2;",
                 "*team_log2 = 5;")],
    "scan-only": [("    const int steps = (int)__reduce_max_sync(kFull, (unsigned)count);",
                   "    const int steps = 0 * (int)__reduce_max_sync(kFull, (unsigned)count);")],
    "stage-only": [("    const int steps = (int)__reduce_max_sync(kFull, (unsigned)count);",
                    "    const int steps = 0 * (int)__reduce_max_sync(kFull, (unsigned)count);"),
                   ("    for (int c = 0, k = 0; c < n; c += ln.team) {",
                    "    for (int c = 0, k = 0; c < 0 * n; c += ln.team) {")],
    "no-read-ahead": [
        ("    int p_next = count > 0 ? list[0] : 0;\n    int tag_next = s_tag[p_next];\n", ""),
        ("      const int p = p_next, tag = tag_next;\n"
         "      if (i + 1 < count) {\n        p_next = list[i + 1];\n"
         "        tag_next = s_tag[p_next];\n      }\n",
         "      const int p = act ? list[i] : 0, tag = s_tag[p];\n")],
}
KEYED_MIN = """template <int W, bool FULL>
struct SrripRow {
  int t[W], kj[W];
  int A, nf, ways;
  __device__ __forceinline__ void init(int ways_) {
    ways = ways_;
    A = 0;
    nf = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      t[j] = -1;
      kj[j] = (FULL || j < ways) ? j : INT_MAX;  // a way past `ways` is never the minimum
    }
  }
  __device__ __forceinline__ bool step(int tag, bool v) {
    bool e[W], any[W];
    int km[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      e[j] = (FULL || j < ways) && t[j] == tag;
      any[j] = e[j];
      km[j] = kj[j];
    }
    const bool hit = tree(any, Or());
    const int mk = tree(km, Min());
    const int m = mk >> 6;  // an arithmetic shift: keys may be negative
    const bool warm = nf >= ways;
    const int vic = warm ? (mk & 63) : nf;
    const int fill = warm ? m + 1 : A - 2;
    const bool hitb = v && hit, missb = v && !hit;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const bool put = missb && vic == j;
      t[j] = put ? tag : t[j];
      kj[j] = (hitb && e[j]) ? A * 64 + j : (put ? fill * 64 + j : kj[j]);
    }
    A = (missb && warm) ? m + 3 : A;
    nf = (missb && !warm) ? nf + 1 : nf;
    return hitb;
  }
};
"""
INT_CHAIN = """struct UMin {
  __device__ __forceinline__ unsigned operator()(unsigned x, unsigned y) const { return x < y ? x : y; }
};
template <int W, bool FULL>
struct FifoRow {
  using Mask = typename std::conditional<(W > 32), unsigned long long, unsigned>::type;
  int t[W];
  Mask head, low;
  int ways;
  __device__ __forceinline__ void init(int ways_) {
    ways = ways_;
    head = 1;
    low = ways >= (int)(8 * sizeof(Mask)) ? ~(Mask)0 : (((Mask)1 << ways) - 1);
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = -1;
  }
  __device__ __forceinline__ bool step(int tag, bool v) {
    unsigned z[W], zm[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      z[j] = (unsigned)(t[j] ^ tag);
      zm[j] = (FULL || j < ways) ? z[j] : 0xffffffffu;
    }
    const unsigned mz = tree(zm, UMin());
    const int mm = ((int)(mz | (0u - mz)) >> 31) & -(int)v;
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] ^= (int)z[j] & mm & -(int)((head >> j) & 1u);
    const Mask rot = ((head << 1) | (head >> (ways - 1))) & low;
    head ^= (head ^ rot) & (Mask)(long long)mm;
    return v && mz == 0u;
  }
};
"""
VARIANTS["rrip_scan"] = {
    "walk-padding": [("__any_sync(0xffffffffu, live)", "(live || true)")],
    "keyed-min": [("template <int W, bool FULL>\nstruct SrripRow {",
                   KEYED_MIN + "template <int W, bool FULL>\nstruct SrripRowTwoTrees {")],
    "int-chain": [("template <int W, bool FULL>\nstruct FifoRow {",
                   INT_CHAIN + "template <int W, bool FULL>\nstruct FifoRowPredicates {")],
    "branch-a-step": [
        ("    for (int j = 0; j < W; ++j) t[j] = (miss && head == j) ? tag : t[j];\n"
         "    const int nxt = head + 1;\n"
         "    head = miss ? (nxt == ways ? 0 : nxt) : head;\n",
         "    if (miss) {\n      for (int j = 0; j < W; ++j) {\n        if (head == j) t[j] = tag;\n"
         "      }\n      head = head + 1 == ways ? 0 : head + 1;\n    }\n")],
    "one-stage": [("constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "tile-64": [("constexpr int kMaxTile = 256;", "constexpr int kMaxTile = 64;")],
    "masked-only": [("    return a.ways == W ? run<W, true, SRRIP>(a, stream, occ)\n"
                     "                       : run<W, false, SRRIP>(a, stream, occ);",
                     "    return run<W, false, SRRIP>(a, stream, occ);")],
    "no-walk": [("hw[j / 4] |= (unsigned)row.step(tag[j], v) << (8 * (j % 4));",
                 "hw[j / 4] |= (unsigned)(v && tag[j] == 0) << (8 * (j % 4));")],
}
VARIANTS["cache_scan"] = dict(WALK, **{
    "no-min": [("  if (ln.team_log2 == 5) return __reduce_min_sync(kFull, key);",
                "  if (ln.team_log2 >= 4) return key;")]})
VARIANTS["stack_distance"] = dict(WALK, **{
    "no-sum": [("  if (ln.team_log2 == 5) return __reduce_add_sync(kFull, x);",
                "  if (ln.team_log2 >= 4) return x;")]})


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


def build(job) -> Path:
    kernel, name = job
    src = _build.source_text(kernel)
    for old, new in VARIANTS[kernel][name]:
        if old not in src:
            raise SystemExit(f"{kernel} {name}: {old!r} is no longer in {kernel}.cu or its headers")
        src = src.replace(old, new)
    cu, lib = OUT / f"{kernel}_{name}.cu", OUT / f"lib{kernel}_{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.nvcc_flags(kernel), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {kernel} {name}:\n{proc.stdout}{proc.stderr}")
    return lib


def launcher(module, lib: Path | None):
    """The module's C launch function: the package's build, or a variant's."""
    if lib is None:
        return module._launcher()
    fn = getattr(ctypes.CDLL(str(lib)), f"{module.__name__.rsplit('.', 1)[1]}_launch")
    ref = module._launcher()
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return fn


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)     # > the 50 MB L2
    OUT.mkdir(parents=True, exist_ok=True)
    wanted = sys.argv[1:] or list(VARIANTS)
    if set(wanted) - set(VARIANTS):
        raise SystemExit(f"unknown kernels {sorted(set(wanted) - set(VARIANTS))}; "
                         f"choose from {list(VARIANTS)}")
    jobs = [(k, n) for k in wanted for n in VARIANTS[k]]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip(jobs, pool.map(build, jobs)))

    wl, hw = dlrm_rmc2_small(num_batches=2), tpuv6e()
    etrace = build_embedding_traces(wl)[0]

    if "dram_scan" in wanted:
        # D1 on the SPM miss stream.
        req = MemorySystem.from_hardware(hw.with_policy("spm"), "cuda").prepare_embedding(etrace).request
        st = chunk_rows(req.lines, req.seg, req.src, req.num_segments, req.num_sources, req.model)
        args = [torch.from_numpy(st[k]).to(dev) for k in ("bk_m", "row_m", "k_m", "va_m")]
        banks, k_max = req.model.banks_per_channel, st["k_max"]
        scal = [d1._f32(x) for x in (req.model.t_rp + req.model.t_rcd, req.model.t_cas, st["bus_cyc"])]
        R, Lc = args[0].shape
        outs = [torch.empty(R, device=dev), torch.empty(R, dtype=torch.int32, device=dev),
                torch.empty(R, device=dev), torch.empty((R, Lc), device=dev),
                torch.empty((R, Lc), dtype=torch.bool, device=dev)]
        want = [o.clone() for o in outs]
        print(f"D1 at (R, Lc)=({R}, {Lc}), {banks} banks, k_max {k_max}, "
              f"{int(st['va_m'].sum())} valid chunks", flush=True)

        def d1_run(fn, into):
            def run():
                err = fn(*(a.data_ptr() for a in args), R, Lc, banks, k_max, *scal,
                         *(o.data_ptr() for o in into), stream)
                if err:
                    raise SystemExit(f"dram_scan launch failed with CUDA error {err}")
            return run

        d1_run(launcher(d1, None), want)()
        for name in ["as is", *VARIANTS["dram_scan"], "as is"]:
            run = d1_run(launcher(d1, libs.get(("dram_scan", name))), outs)
            run()
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                   b.view(torch.int32) if b.dtype == torch.float32 else b)
                       for a, b in zip(outs, want))
            ms, cold = time_ms(run, 20), time_cold_ms(run, 20, flush)
            print(f"D1 {name}: {ms!r} ms ({cold!r} L2 flushed), {ms * 1e6 / Lc!r} ns per chunk, "
                  f"bitwise equal to the kernel as it is: {same}", flush=True)

    lane = lane_geometry(hw, etrace.spec)
    buckets = [tuple(torch.from_numpy(a).to(dev) for a in (s, t, v)) + (S, W)
               for _, s, t, v, S, W in bucket_rows([etrace.vec_ids], [lane])]
    if "cache_scan" in wanted:
        # K1 on the set-group buckets.
        for policy in ("lru", "srrip", "fifo"):
            pid = k1.POLICY_IDS[policy]
            refs = [k1.cache_scan_groups(s, t, v, S, W, policy) for s, t, v, S, W in buckets]
            for name in ["as is", *VARIANTS["cache_scan"], "as is"]:
                fn = launcher(k1, libs.get(("cache_scan", name)))
                total, total_cold, same, per_bucket = 0.0, 0.0, True, []
                for (s, t, v, S, W), ref in zip(buckets, refs):
                    hit, ev = torch.empty_like(ref[0]), torch.empty_like(ref[1])

                    def run(s=s, t=t, v=v, S=S, W=W, hit=hit, ev=ev):
                        err = fn(s.data_ptr(), t.data_ptr(), v.data_ptr(), hit.data_ptr(),
                                 ev.data_ptr(), s.shape[0], s.shape[1], S, W, pid, stream)
                        if err:
                            raise SystemExit(f"cache_scan launch failed with CUDA error {err}")
                    run()
                    torch.cuda.synchronize()
                    same &= torch.equal(hit, ref[0]) and torch.equal(ev, ref[1])
                    ms = time_ms(run, 20)
                    per_bucket.append(f"{tuple(s.shape)} {ms!r}")
                    total += ms
                    total_cold += time_cold_ms(run, 20, flush)
                print(f"K1 {policy} {name}: {total!r} ms per classification ({total_cold!r} L2 "
                      f"flushed; per bucket {', '.join(per_bucket)}), equal to the kernel as it is: "
                      f"{same}", flush=True)
    if "stack_distance" in wanted:
        # K2 on the same buckets.
        refs = [k2.stack_distance_groups(s, t, v, S, W) for s, t, v, S, W in buckets]
        for name in ["as is", *VARIANTS["stack_distance"], "as is"]:
            fn = launcher(k2, libs.get(("stack_distance", name)))
            total, total_cold, same, per_bucket = 0.0, 0.0, True, []
            for (s, t, v, S, W), ref in zip(buckets, refs):
                dist, ev = torch.empty_like(ref[0]), torch.empty_like(ref[1])

                def run(s=s, t=t, v=v, S=S, W=W, dist=dist, ev=ev):
                    err = fn(s.data_ptr(), t.data_ptr(), v.data_ptr(), dist.data_ptr(),
                             ev.data_ptr(), s.shape[0], s.shape[1], S, W, stream)
                    if err:
                        raise SystemExit(f"stack_distance launch failed with CUDA error {err}")
                run()
                torch.cuda.synchronize()
                same &= torch.equal(dist, ref[0]) and torch.equal(ev, ref[1])
                ms = time_ms(run, 20)
                per_bucket.append(f"{tuple(s.shape)} {ms!r}")
                total += ms
                total_cold += time_cold_ms(run, 20, flush)
            print(f"K2 {name}: {total!r} ms per classification ({total_cold!r} L2 flushed; per "
                  f"bucket {', '.join(per_bucket)}), equal to the kernel as it is: {same}", flush=True)
    if "rrip_scan" in wanted:
        # D2 on the buckets simulate and a FIFO TLB give it.
        hw_tr = hw.with_policy("spm").with_translation(
            entries=64, ways=4, l2_entries=1024, replacement="fifo")
        tr = hw_tr.translation
        cs = MemorySystem.from_hardware(hw_tr, "cuda").classify_embedding(etrace)
        pages = tlb_pages(cs.miss_lines, hw.onchip.line_bytes, tr.page_bytes)
        l1 = classify_tlb(pages, tr.num_sets, tr.ways, "fifo", device="cuda")
        sets = {
            "srrip on-chip": ("srrip", row_buckets(etrace.vec_ids, lane.num_sets, lane.ways, "srrip")),
            "fifo on-chip": ("fifo", row_buckets(etrace.vec_ids, lane.num_sets, lane.ways, "fifo")),
            "fifo TLB": ("fifo", row_buckets(pages, tr.num_sets, tr.ways, "fifo")
                         + row_buckets(pages[~l1], tr.l2_num_sets, tr.l2_ways, "fifo")),
        }
        for label, (policy, bk) in sets.items():
            pid = d2.POLICY_IDS[policy]
            rows = [(torch.from_numpy(t).to(dev), torch.from_numpy(v).to(dev), w)
                    for _, _, t, v, w in bk]
            refs = [d2.rrip_scan_rows(t, v, w, policy) for t, v, w in rows]
            for name in ["as is", *VARIANTS["rrip_scan"], "as is"]:
                fn = launcher(d2, libs.get(("rrip_scan", name)))
                total, total_cold, same, per_bucket = 0.0, 0.0, True, []
                for (t, v, w), ref in zip(rows, refs):
                    hits = torch.empty_like(ref)

                    def run(t=t, v=v, w=w, hits=hits):
                        err = fn(t.data_ptr(), v.data_ptr(), hits.data_ptr(), t.shape[0],
                                 t.shape[1], w, pid, stream)
                        if err:
                            raise SystemExit(f"rrip_scan launch failed with CUDA error {err}")
                    run()
                    torch.cuda.synchronize()
                    same &= torch.equal(hits, ref)
                    ms = time_ms(run, 20)
                    per_bucket.append(f"{tuple(t.shape)} {ms!r}")
                    total += ms
                    total_cold += time_cold_ms(run, 20, flush)
                print(f"D2 {label} {name}: {total!r} ms ({total_cold!r} L2 flushed; per bucket "
                      f"{', '.join(per_bucket)}), equal to the kernel as it is: {same}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
