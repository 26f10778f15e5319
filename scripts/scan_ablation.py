#!/usr/bin/env python3
"""Ablation of the port's simulator scan kernels, D1, K1, K2, D2 and D3, on one NVIDIA GPU.

    python3 scripts/scan_ablation.py [KERNEL ...]

KERNEL is any of dram_scan, cache_scan, stack_distance, rrip_scan and
dram_scan_full; with none given, all five run.

All run on the full-size inputs of ``simulate`` on DLRM-RMC2 x ``tpuv6e()``
(``dlrm_rmc2_small(num_batches=2)``): D1 (``src/repro_torch/csrc/dram_scan.cu``)
on the (32, 16384) chunk rows of the SPM miss stream, K1
(``src/repro_torch/csrc/cache_scan.cu``) and K2
(``src/repro_torch/csrc/stack_distance.cu``) on the two set-group buckets,
(967, 512) and (57, 1024), 16 sets x 16 ways, K1 for each policy, and D2
(``src/repro_torch/csrc/rrip_scan.cu``) on the buckets of the on-chip
cache's lane stream under srrip and fifo (16 ways) and of a FIFO TLB
(64 entries of 4 ways, an L2 of 1,024 entries of 8 ways) behind spm, as
``core/memory/rrip.py`` ``row_plan`` lays them out. Each
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
D2 variants (of the walk both routes run, and of the fix-up):
  walk-padding   every group of 16 steps walked, also those in which no
                 row of the block has a valid step;
  branch-a-step  FIFO's state update under `if (miss)`, not as selects;
  one-stage      one stage of tiles;
  tile-256       tiles of 256 steps, not 64;
  masked-only    every ways count run by the instance that masks the ways
                 past it, also where the ways fill the instance (no
                 instance without the mask);
  rerun-lockstep the fix-up's re-run of a chunk walked by every lane alike,
                 each loading every step's tag from global memory, lane 0
                 writing the hits a byte at a time (not a step a lane
                 staged in shared memory, hits stored coalesced);
  no-walk        no step walked: staging the rows, writing the outputs
                 back and, on the chunked route, storing the states and
                 comparing them in the fix-up (every comparison ignored;
                 wrong output: what the rest costs).
Then D2's own parameters, as ``RowTable``'s chunk, warmup and long_row
(``kernels/rrip_scan.py``): the FIFO TLB's L1 and L2 for chunk C in {64,
128, 256, 512, 1024} x warm-up K in {0, 8, 16, 32, 64}, with the chunks
the fix-up ran again, and LONG_ROW T in {1024, 2048, 4096} (the L2's
rows, up to 3,690 steps, take the chunked route below 4096) and past
the longest row (a lane per row); on two FIFO TLB geometries whose sets
hit more often (4 sets and 1 set of 16 ways, on the same page stream;
every variant above runs on them too), K in {0, 16, 32, 64, 256}, the
module's warm-up for 16 ways and a lane per row. Where chunks re-run, the
rerun-lockstep variant is timed beside the kernel. And the
short route's one launch per call against one launch per bucket of rows
of one power-of-two length (the buckets of a launch per bucket) and
against every row on the chunked route, the launches alone and the whole
call with its copies (``core/memory/rrip.py`` ``scan_rows``, host clock).

D3 (``src/repro_torch/csrc/dram_scan_full.cu``) on the lru/stack miss trace
of the same workload (both batches, 3,254,576 lines) laid out by
``arrival_rows`` at interval 0.5, 16 channels x 207,184 slots, 8 banks, as
``chip_smoke.py`` phase 13 runs it. Its shared route (the bank state in
shared memory, the route of 17 to 160 banks) forced at 8 banks, and
  no-state       its bank state's shared-memory loads and stores left out
                 (wrong output: what the state traffic costs);
then the registers route's pre-pass alone, its scan alone and the wrapper
(both), and
  depth-N        the lanes' bank state read N steps behind the chain (the
                 kernel's kDepth; 3, 5, 6), the nearer updates forwarded
                 from registers;
  role-by-thread the warp's role chosen by threadIdx.x, not by a
                 warp-uniform value (every shfl then a collective sequence);
  no-bank-read   no bank-free cycle read (wrong output: the chain and the
                 staging alone).
Each D3 line gives the SASS instructions of the kernel's largest innermost
loop (``cuobjdump``), per step of 16, and writes that kernel's SASS to
``build/ablation/sass_d3_<variant>.txt``.

Builds into ``build/ablation/``. Last, the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import dlrm_rmc2_small, tpuv6e  # noqa: E402
from repro_torch.core.engine import build_embedding_traces  # noqa: E402
from repro_torch.core.memory.cache import bucket_rows  # noqa: E402
from repro_torch.core.memory.dram import DramModel, arrival_rows, chunk_rows  # noqa: E402
from repro_torch.core.memory.system import MemorySystem, lane_geometry  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cache_scan as k1  # noqa: E402
from repro_torch.kernels import dram_scan as d1  # noqa: E402
from repro_torch.kernels import rrip_scan as d2  # noqa: E402
from repro_torch.core.memory.rrip import row_plan, scan_rows  # noqa: E402
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
VARIANTS["rrip_scan"] = {
    "walk-padding": [("__any_sync(kFull, live)", "(live || true)")],
    "branch-a-step": [
        ("    for (int j = 0; j < W; ++j) t[j] = (miss && head == j) ? tag : t[j];\n"
         "    const int nxt = head + 1;\n"
         "    head = miss ? (nxt == ways ? 0 : nxt) : head;\n",
         "    if (miss) {\n      for (int j = 0; j < W; ++j) {\n        if (head == j) t[j] = tag;\n"
         "      }\n      head = head + 1 == ways ? 0 : head + 1;\n    }\n")],
    "one-stage": [("constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "tile-256": [("constexpr int kMaxTile = 64;", "constexpr int kMaxTile = 256;")],
    "masked-only": [("    return a.ways == W ? run<W, true, SRRIP>(a, stream, occ)\n"
                     "                       : run<W, false, SRRIP>(a, stream, occ);",
                     "    return run<W, false, SRRIP>(a, stream, occ);")],
    "rerun-lockstep": [(
        '  int tag = s + lane < e ? a.tags[off + s + lane] : 0;\n'
        '  uint8_t v = s + lane < e ? a.valid[off + s + lane] : 0;\n'
        '  for (int q = s; q < e; q += 32) {\n'
        '    st_tag[lane] = tag;\n'
        "    st_v[lane] = v;  // 0 past the chunk's end: a step that changes nothing\n"
        '    __syncwarp();\n'
        '    const int pn = q + 32 + lane;\n'
        '    tag = pn < e ? a.tags[off + pn] : 0;\n'
        '    v = pn < e ? a.valid[off + pn] : 0;\n'
        '    unsigned hm = 0u;\n'
        '#pragma unroll\n'
        '    for (int g = 0; g < 32; g += kGroup) {\n'
        '      int t[kGroup];\n'
        '#pragma unroll\n'
        '      for (int j = 0; j < kGroup; j += 4) {\n'
        '        const int4 x = *(const int4*)(st_tag + g + j);\n'
        '        t[j] = x.x;\n'
        '        t[j + 1] = x.y;\n'
        '        t[j + 2] = x.z;\n'
        '        t[j + 3] = x.w;\n'
        '      }\n'
        '      const uint4 vq = *(const uint4*)(st_v + g);\n'
        '      const unsigned vw[4] = {vq.x, vq.y, vq.z, vq.w};\n'
        '#pragma unroll\n'
        '      for (int j = 0; j < kGroup; ++j) {\n'
        '        const bool vj = ((vw[j / 4] >> (8 * (j % 4))) & 0xffu) != 0u;\n'
        '        hm |= (unsigned)row.step(t[j], vj) << (g + j);\n'
        '      }\n'
        '    }\n'
        '    if (q + lane < e) a.hits[off + q + lane] = (uint8_t)((hm >> lane) & 1u);\n'
        '    __syncwarp();  // the piece is read by every lane before the next overwrites it\n'
        '  }\n',
        '  for (int p = s; p < e; p += kGroup) {\n'
        '    int tag[kGroup];\n'
        '    bool v[kGroup];\n'
        '#pragma unroll\n'
        '    for (int j = 0; j < kGroup; ++j) {\n'
        '      const bool in = p + j < e;\n'
        '      tag[j] = in ? a.tags[off + p + j] : 0;\n'
        '      v[j] = in && a.valid[off + p + j] != 0;\n'
        '    }\n'
        '#pragma unroll\n'
        '    for (int j = 0; j < kGroup; ++j) {\n'
        '      const bool hit = row.step(tag[j], v[j]);\n'
        '      if (lane == 0 && p + j < e) a.hits[off + p + j] = hit;\n'
        '    }\n'
        '  }\n')],
    "no-walk": [("hw[j / 4] |= (unsigned)row.step(tag[j], v) << (8 * (j % 4));",
                 "hw[j / 4] |= (unsigned)(v && tag[j] == 0) << (8 * (j % 4));"),
                ("!Row::same(end + (c - 1) * S, start + c * S, a.ways);",
                 "!Row::same(end + (c - 1) * S, start + c * S, a.ways) && a.ways < 0;")],
}
# D3's variants: of the shared-state walk (the route of more than 16 banks)
# and of the registers route.
VARIANTS["dram_scan_full"] = {
    "no-state": [
        ("    f = free_[b * kRows + lane];\n    o = open[b * kRows + lane];\n",
         "    f = __int_as_float(b);\n    o = b;\n"),
        ("    open[b * kRows + lane] = o;\n    free_[b * kRows + lane] = f;\n", "")],
    **{f"depth-{d}": [("constexpr int kDepth = 4;", f"constexpr int kDepth = {d};")]
       for d in (3, 5, 6)},
    "role-by-thread": [("  if (warp == 1) {\n", "  if (threadIdx.x >= 32) {\n")],
    "no-bank-read": [("        const float bp = (c & kNear) ? near : far;\n",
                      "        const float bp = -INFINITY;\n")],
}
# Which of D3's variants change the shared route (the rest, the registers one).
D3_SHARED = ("no-state",)
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


def sass_loop(lib: Path, kernel: str, label: str):
    """The SASS of ``kernel`` (a substring of its symbol) in ``lib``: the
    instructions of its largest innermost loop (the region between a
    backward branch and its target that holds no other such region), and
    their opcodes. The function's SASS is written to
    ``build/ablation/sass_<label>.txt``."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        if kernel not in func.split("\n", 1)[0]:
            continue
        (OUT / f"sass_{label}.txt").write_text(func)
        ins = [(int(m.group(1), 16), m.group(2).strip())
               for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        loops = []
        for addr, t in ins:
            b = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\(?)?(0x[0-9a-f]+)", t)
            if b and int(b.group(1), 16) <= addr:
                loops.append((int(b.group(1), 16), addr))
        inner = [lp for lp in loops
                 if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        if not inner:
            return len(ins), Counter()
        lo, hi = max(inner, key=lambda lp: lp[1] - lp[0])
        body = [t for a, t in ins if lo <= a <= hi]
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for t in body)
        return len(body), ops
    raise SystemExit(f"no kernel {kernel!r} in {lib}")


def d3_ablation(etrace, hw, dev, stream, flush, libs) -> None:
    """D3 at full width: the lru/stack miss trace of ``simulate`` (both
    batches, 3,254,576 lines) laid out by ``arrival_rows`` at interval 0.5,
    as phase 13 of ``chip_smoke.py`` runs it (16 x 207,184, 8 banks)."""
    lines = MemorySystem.from_hardware(hw.with_policy("lru"), "cuda").prepare_embedding(
        etrace).request.lines
    dm = DramModel.from_hardware(hw)
    st = arrival_rows(lines, dm, 0.5, 0.0)
    args = [torch.from_numpy(st[k]).to(dev) for k in ("bk_m", "row_m", "ar_m", "va_m")]
    R, L = args[0].shape
    banks = dm.banks_per_channel
    scal = [d1._f32(x) for x in (dm.t_cas, dm.t_rp + dm.t_rcd,
                                 dm.line_bytes / dm.chan_bytes_per_cycle)]
    outs = [torch.empty((R, L), device=dev), torch.empty((R, L), device=dev),
            torch.empty((R, L), dtype=torch.bool, device=dev)]
    want = [o.clone() for o in outs]
    print(f"D3 at (R, L)=({R}, {L}), {banks} banks, {int(st['va_m'].sum())} accesses",
          flush=True)

    def shared_run(fn, into):
        def run():
            err = fn(*(a.data_ptr() for a in args), R, L, banks, *scal,
                     *(o.data_ptr() for o in into), stream)
            if err:
                raise SystemExit(f"dram_scan_full launch failed with CUDA error {err}")
        return run

    ref_fn = d1._full_launcher()
    shared_run(ref_fn, want)()
    package = _build.build_all()["dram_scan_full"]

    def report(name, run, into, lib, kernel, extra=""):
        run()
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)
                   for a, b in zip(into, want))
        ms, cold = time_ms(run, 20), time_cold_ms(run, 20, flush)
        n, ops = sass_loop(lib or package, kernel, f"d3_{name}")
        print(f"D3 {name}: {ms!r} ms ({cold!r} L2 flushed), {ms * 1e6 / L!r} ns per access, "
              f"bitwise equal to the shared route: {same}{extra}; compute loop {n} SASS "
              f"instructions, {n / 16!r} a step of 16 ({dict(ops.most_common(12))})",
              flush=True)

    # The shared route (the bank state in shared memory) at 8 banks
    for name in ["shared", *D3_SHARED, "shared"]:
        lib = libs.get(("dram_scan_full", name))
        fn = ref_fn
        if lib is not None:
            fn = getattr(ctypes.CDLL(str(lib)), "dram_scan_full_launch")
            fn.argtypes, fn.restype = ref_fn.argtypes, ref_fn.restype
        report(name, shared_run(fn, outs), outs, lib, "dram_scan_full_kernel")

    # The registers route: the pre-pass, then the scan
    bk, row, ar, va = args
    code, hit = d1.dram_prepass(bk, row, va, banks)
    torch.cuda.synchronize()
    pcode, phit = d1.dram_prepass_plain(bk, row, va, banks)
    pre_ms = time_ms(lambda: d1.dram_prepass(bk, row, va, banks), 20)
    pre_cold = time_cold_ms(lambda: d1.dram_prepass(bk, row, va, banks), 20, flush)
    print(f"D3 pre-pass: {pre_ms!r} ms ({pre_cold!r} L2 flushed); codes and hits bitwise the "
          f"plain pre-pass's: {torch.equal(code, pcode) and torch.equal(hit, phit)}", flush=True)
    regs_ref = d1._regs_launcher()
    reg_outs = [torch.empty((R, L), device=dev), torch.empty((R, L), device=dev), hit]
    for name in ["registers", *(v for v in VARIANTS["dram_scan_full"] if v not in D3_SHARED),
                 "registers"]:
        lib = libs.get(("dram_scan_full", name))
        fn = regs_ref
        if lib is not None:
            fn = getattr(ctypes.CDLL(str(lib)), "dram_scan_regs_launch")
            fn.argtypes, fn.restype = regs_ref.argtypes, regs_ref.restype

        def run(fn=fn):
            err = fn(code.data_ptr(), ar.data_ptr(), R, L, *scal,
                     reg_outs[0].data_ptr(), reg_outs[1].data_ptr(), stream)
            if err:
                raise SystemExit(f"dram_scan_regs launch failed with CUDA error {err}")
        report(name, run, reg_outs, lib, "dram_scan_regs_kernel")
    whole = d1.dram_scan_full(*args, banks, *scal)
    same = all(torch.equal(a, b) for a, b in zip(whole, want))
    report("registers, the wrapper (pre-pass + scan)",
           lambda: d1.dram_scan_full(*args, banks, *scal), reg_outs, None,
           "dram_scan_regs_kernel", f" (the wrapper's own outputs: {same})")


def launcher(module, lib: Path | None):
    """The module's C launch function: the package's build, or a variant's."""
    if lib is None:
        return module._launcher()
    fn = getattr(ctypes.CDLL(str(lib)), f"{module.__name__.rsplit('.', 1)[1]}_launch")
    ref = module._launcher()
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return fn


def rrip_plans(etrace, hw, lane):
    """D2's calls: ``{label: (policy, [(tags, valid, table)])}`` for the
    on-chip cache under srrip and fifo and the FIFO TLB (L1, L2)."""
    hw_tr = hw.with_policy("spm").with_translation(
        entries=64, ways=4, l2_entries=1024, replacement="fifo")
    tr = hw_tr.translation
    cs = MemorySystem.from_hardware(hw_tr, "cuda").classify_embedding(etrace)
    pages = tlb_pages(cs.miss_lines, hw.onchip.line_bytes, tr.page_bytes)
    l1 = classify_tlb(pages, tr.num_sets, tr.ways, "fifo", device="cuda")
    calls = {"srrip on-chip": ("srrip", [(etrace.vec_ids, lane.num_sets, lane.ways)]),
             "fifo on-chip": ("fifo", [(etrace.vec_ids, lane.num_sets, lane.ways)]),
             "fifo TLB L1": ("fifo", [(pages, tr.num_sets, tr.ways)]),
             "fifo TLB L2": ("fifo", [(pages[~l1], tr.l2_num_sets, tr.l2_ways)]),
             # Geometries whose sets hit more often, where a short warm-up
             # rebuilds fewer start states: 64 entries of 16 ways, and one
             # set of 16 (the whole stream one row).
             "fifo TLB 4x16 L1": ("fifo", [(pages, 4, 16)]),
             "fifo TLB 1x16 L1": ("fifo", [(pages, 1, 16)])}
    out = {}
    for label, (policy, streams) in calls.items():
        plan = []
        for lines, S, W in streams:
            tags, valid, groups = row_plan(lines, S, W, policy)
            (base, table), = groups
            plan.append((tags, valid, table))
        out[label] = (policy, plan)
    return out


def rrip_launch(fn, t, v, table, policy, out, stream, scratch):
    """One call of D2 through the C launcher ``fn`` (the package's or a
    variant's), as ``rrip_scan_flat`` makes it on the card."""
    states, count = scratch
    err = fn(t.data_ptr(), v.data_ptr(), out.data_ptr(), table.on(t.device).data_ptr(),
             table.rows, table.virtual_rows, table.max_steps, table.ways, d2.POLICY_IDS[policy],
             table.chunk if table.chunked else 0, table.warmup,
             states.data_ptr() if table.chunked else 0, count.data_ptr() if table.chunked else 0,
             stream)
    if err:
        raise SystemExit(f"rrip_scan launch failed with CUDA error {err}")


def rrip_ablation(etrace, hw, lane, dev, stream, flush, libs) -> None:
    plans = rrip_plans(etrace, hw, lane)
    inputs = {}
    for label, (policy, plan) in plans.items():
        calls = []
        for tags, valid, table in plan:
            t, v = torch.from_numpy(tags).to(dev), torch.from_numpy(valid).to(dev)
            ref = d2.rrip_scan_flat(t, v, table, policy)
            scratch = (torch.empty(2 * max(table.virtual_rows, 1)
                                   * d2.state_ints(table.ways, policy), dtype=torch.int32,
                                   device=dev), torch.zeros(1, dtype=torch.int32, device=dev))
            calls.append((t, v, table, ref, scratch))
        inputs[label] = (policy, calls)
        print(f"D2 {label}: {[(tb.rows, tb.max_len, tb.virtual_rows, tb.blocks, tb.chunked) for _, _, tb, _, _ in calls]} "
              f"(rows, longest, virtual rows, blocks, chunked)", flush=True)
    for label, (policy, calls) in inputs.items():
        for name in ["as is", *VARIANTS["rrip_scan"], "as is"]:
            fn = launcher(d2, libs.get(("rrip_scan", name)))
            total, total_cold, same, reruns = 0.0, 0.0, True, []
            for t, v, table, ref, scratch in calls:
                hits = torch.empty_like(ref)

                def run(t=t, v=v, table=table, hits=hits, scratch=scratch):
                    rrip_launch(fn, t, v, table, policy, hits, stream, scratch)
                run()
                torch.cuda.synchronize()
                same &= torch.equal(hits, ref)
                reruns.append(int(scratch[1]) if table.chunked else 0)
                total += time_ms(run, 20)
                total_cold += time_cold_ms(run, 20, flush)
            print(f"D2 {label} {name}: {total!r} ms ({total_cold!r} L2 flushed), re-runs "
                  f"{reruns}, equal to the kernel as it is: {same}", flush=True)

    # The chunked route's parameters on the TLB's two levels; on the
    # geometries that hit more, the warm-up; on all, a lane per row (T past
    # the longest row: one lane walks a whole row). K None: the module's
    # warm-up for the ways. Where chunks re-run, the rerun-lockstep variant
    # too.
    fn = launcher(d2, None)
    lockstep = libs.get(("rrip_scan", "rerun-lockstep"))
    sweep = [(c, k, 2048) for c in (64, 128, 256, 512, 1024) for k in (0, 8, 16, 32, 64)]
    sweep += [(d2.CHUNK, None, T) for T in (1024, 2048, 4096, 1 << 30)]
    hot = [(d2.CHUNK, k, d2.LONG_ROW) for k in (0, 16, 32, 64, 256, None)]
    hot += [(d2.CHUNK, None, 1 << 30)]
    for label, params in (("fifo TLB L1", sweep), ("fifo TLB L2", sweep),
                          ("fifo TLB 4x16 L1", hot), ("fifo TLB 1x16 L1", hot)):
        policy, calls = inputs[label]
        t, v, table0, ref, _ = calls[0]
        for chunk, warmup, long_row in params:
            table = d2.RowTable(table0.off, table0.length, table0.ways, chunk=chunk,
                                warmup=warmup, long_row=long_row)
            scratch = (torch.empty(2 * table.virtual_rows * d2.state_ints(table.ways, policy),
                                   dtype=torch.int32, device=dev),
                       torch.zeros(1, dtype=torch.int32, device=dev))
            hits = torch.empty_like(ref)

            def run(table=table, hits=hits, scratch=scratch):
                rrip_launch(fn, t, v, table, policy, hits, stream, scratch)
            run()
            torch.cuda.synchronize()
            ms = time_ms(run, 20)
            redo = int(scratch[1]) if table.chunked else 0
            old = ""
            if redo and lockstep is not None:
                fn_old = launcher(d2, lockstep)

                def run_old(table=table, hits=hits, scratch=scratch):
                    rrip_launch(fn_old, t, v, table, policy, hits, stream, scratch)
                old = f", rerun-lockstep {time_ms(run_old, 20)!r} ms"
            print(f"D2 {label} C={chunk} K={table.warmup} T={long_row}: {ms!r} ms, chunked "
                  f"{table.chunked}, virtual rows {table.virtual_rows}, blocks {table.blocks}, "
                  f"re-runs {redo}, equal: {torch.equal(hits, ref)}{old}", flush=True)

    # The short route: one launch per call against one per power-of-two
    # length bucket and against the chunked route (what a call whose longest
    # row is long makes of its short rows); launches alone, then the whole
    # call with its copies.
    for label in ("srrip on-chip", "fifo on-chip"):
        policy, plan = plans[label]
        tags, valid, table = plan[0]
        t, v, _, ref, scratch = inputs[label][1][0]
        lb = np.array([1 << (int(n) - 1).bit_length() for n in table.length])
        cuts = np.flatnonzero(np.concatenate(([True], lb[1:] != lb[:-1], [True])))
        buckets = []
        for i0, i1 in zip(cuts[:-1], cuts[1:]):
            base = int(table.off[i0])
            sub = d2.RowTable(table.off[i0:i1] - base, table.length[i0:i1], table.ways)
            buckets.append((slice(base, base + sub.total), sub))
        hits = torch.empty_like(ref)

        def one():
            rrip_launch(fn, t, v, table, policy, hits, stream, scratch)

        def per_bucket():
            for sl, sub in buckets:
                rrip_launch(fn, t[sl], v[sl], sub, policy, hits[sl], stream, scratch)
        per_bucket()
        torch.cuda.synchronize()
        same = torch.equal(hits, ref)
        chunked = d2.RowTable(table.off, table.length, table.ways, long_row=1)
        c_hits = torch.empty_like(ref)
        c_scratch = (torch.empty(2 * chunked.virtual_rows * d2.state_ints(table.ways, policy),
                                 dtype=torch.int32, device=dev),
                     torch.zeros(1, dtype=torch.int32, device=dev))

        def as_chunked():
            rrip_launch(fn, t, v, chunked, policy, c_hits, stream, c_scratch)
        as_chunked()
        torch.cuda.synchronize()
        c_same = torch.equal(c_hits, ref)
        groups = [(0, table)]

        def call_one():
            scan_rows(tags, valid, groups, policy, dev)

        def call_per_bucket():
            out = np.empty(tags.size, bool)
            for sl, sub in buckets:
                td = torch.from_numpy(tags[sl]).to(dev)
                vd = torch.from_numpy(valid[sl]).to(dev)
                hd = torch.empty(sub.total, dtype=torch.bool, device=dev)
                rrip_launch(fn, td, vd, sub, policy, hd, stream, scratch)
                out[sl] = hd.cpu().numpy()
        walls = {}
        for name, f in (("one", call_one), ("per-bucket", call_per_bucket),
                        ("per-bucket", call_per_bucket), ("one", call_one)):
            f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                f()
            torch.cuda.synchronize()
            walls.setdefault(name, []).append((time.perf_counter() - t0) / 20 * 1e3)
        print(f"D2 {label} short route: one launch {time_ms(one, 20)!r} ms against "
              f"{len(buckets)} per-bucket launches {time_ms(per_bucket, 20)!r} ms (equal: {same}; "
              f"buckets {[sub.rows for _, sub in buckets]} rows), every row chunked "
              f"{time_ms(as_chunked, 20)!r} ms ({chunked.virtual_rows} virtual rows, re-runs "
              f"{int(c_scratch[1])}, equal: {c_same}); the whole call with its copies "
              f"(host clock) one {walls['one']!r} ms, per bucket {walls['per-bucket']!r} ms",
              flush=True)


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
        rrip_ablation(etrace, hw, lane, dev, stream, flush, libs)
    if "dram_scan_full" in wanted:
        d3_ablation(etrace, hw, dev, stream, flush, libs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
