// D3: per-access FR-FCFS DRAM event scan with arrival times, for Hopper
// (sm_90a).
//
// Replaces the `lax.scan` of `_scan_channel_full` in
// src/repro/core/memory/dram.py (reached through `_scan_channel`, vmapped
// over channels; a scan, not a Pallas kernel). `simulate_dram` takes it
// when the issue interval or the start cycle is non-zero. A row is one
// channel's L service-ordered slots; the reference walks it carrying the
// per-bank open row and bank-free cycle and the bus-free cycle, and writes
// per slot the completion (done + t_cas), the latency (that minus the
// arrival) and whether the access hit the open row; an invalid slot writes
// 0 / 0 / 0 and leaves the state as it is.
//
// What bounds it: latency. A row is L dependent steps, one f32 chain
//     done = max(max(a, bank_free[b]) + occ, bus_free) + bus,
// and there are as many rows as channels (16 on `simulate_dram`'s path), so
// the card's bandwidth and FLOP rate do not enter. Two routes, chosen by
// `banks` alone; each launches or fails.
//
// Registers (banks <= 16; tpuv6e() has 8): two kernels.
//   * The pre-pass (`dram_prepass_kernel`) takes everything that does not
//     depend on time off the chain. Which row a bank has open depends only
//     on the order of the valid in-range accesses to it, so the row hit,
//     and with it occ (0 or t_row_act), is known before the scan. It also
//     finds each access's previous update of its bank (j) and the previous
//     valid access (pv), and packs per slot one int32 code: the bank's lane
//     (31 for a bank out of range), valid, hit, same (j == pv: the bank's
//     free cycle is the bus-free cycle), a one-hot distance i - j of 2..5,
//     and the bank as a one-hot write mask in bits 16..31. A block of 32
//     warps per row: each warp a segment, first the last update of each
//     bank and the last valid slot per segment, then each warp's start
//     state from the segments before it, then a walk of 32 slots at a time
//     (`__match_any_sync` finds the previous lane of the same bank). It
//     writes the hit output and the codes.
//   * The scan (`dram_scan_regs_kernel`), a block per row: a loader warp
//     stages each tile of codes and arrivals with cp.async and turns them
//     into four f32 terms a slot (ao = a + occ, or -inf if invalid; occ;
//     cc = occ where `same`, else 0; bus, or 0 if invalid), and turns the
//     raw completions back into the outputs; the compute warp walks the row
//     on the staged terms. Every lane runs the same chain; lane k holds bank
//     k's free cycle (lane 31 holds -inf). Because fl(max(x, y) + z) =
//     max(fl(x + z), fl(y + z)) (rounding is monotone) and bank_free <=
//     bus_free, a step is
//         done = max(max(ao, bp + occ), bus_free + cc) + bus,
//     three dependent f32 ops on the chain (the add of cc, the max, the
//     add of bus); where `same`, any bp <= bus_free gives the same bits,
//     and an invalid slot gives done = bus_free. bp, the bank's free cycle,
//     comes off the chain: a `shfl` of the lanes' state as it was kDepth
//     steps back, or the completion of step i - 2 .. i - kDepth + 1 held in
//     registers where the code's distance names it. No memory operation
//     sits between two dependent steps.
// Shared (16 < banks <= 160): one kernel (`dram_scan_full_kernel`), the
// route of every width before the registers route. D1's layout
// (csrc/dram_scan.cu):
//   * a block is one compute warp (lane = row) and three loader warps. The
//     loaders bring tiles of kTile slots of all 32 rows (bank, row,
//     arrival, valid) into shared memory with 16-byte cp.async, kStages
//     tiles ahead, and write the tile's outputs (done, lat, hit), which the
//     compute warp leaves in shared memory, back with 16-byte stores. Named
//     barriers hand each stage from loaders to compute (FULL) and back
//     (EMPTY);
//   * the compute warp reads 16 slots of its row at a time with 16-byte
//     shared loads (row strides of an odd number of 16-byte units: no bank
//     conflicts) and writes 16 outputs the same way;
//   * the bank state (open row, bank-free cycle) stays [bank][lane] in
//     shared memory; each step reads the next slot's bank entry before it
//     writes its own and forwards its own result when the two slots share
//     the bank. That shared-memory round trip and the state's selects and
//     stores make a step several times its chain: what the register route
//     takes off (scripts/scan_ablation.py times both; PERF.md has it);
//   * a step is straight-line code: selects, and a store to a spare bank
//     row where the reference changes nothing.
// Either route copies a tile whose rows are not 16-byte aligned element by
// element, and marks the slots past L in its last group of 16 invalid.
//
// The f32 chain is bitwise equal to the reference's: every add is
// __fadd_rn and the latency __fsub_rn (out = done + t_cas; lat = out - a),
// and the library is built with -fmad=false. The scalar timings arrive
// already rounded to f32 by the caller, as JAX rounds them; the register
// route's algebra needs t_row_act >= 0 and bus >= 0, which the wrapper
// checks. A bank outside [0, banks) never hits, sees no bank-free cycle and
// changes no bank (the plain version does the same; simulate_dram never
// sends one).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                  // rows a block walks: one per compute lane
constexpr int kLoaders = 96;               // three loader warps
constexpr int kThreads = 32 + kLoaders;
constexpr int kTile = 128;                 // slots of a row per stage
constexpr int kStages = 2;
constexpr int kGroup = 16;                 // slots a compute lane reads at once
constexpr int kMaxBanks = 160;
constexpr int kWordStride = kTile + 4;     // words: an odd number of 16-byte units
constexpr int kByteStride = kTile + 16;    // bytes: an odd number of 16-byte units

struct Stage {
  int bk[kRows * kWordStride];
  int row[kRows * kWordStride];
  float arrive[kRows * kWordStride];
  float done[kRows * kWordStride];
  float lat[kRows * kWordStride];
  uint8_t valid[kRows * kByteStride];
  uint8_t hit[kRows * kByteStride];
};

constexpr size_t kStateOffset = kStages * sizeof(Stage);

// Barrier ids: FULL(s) = 1 + s (loaders arrive, compute waits),
// EMPTY(s) = 1 + kStages + s (compute arrives, loaders wait).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

struct Args {
  const int* bk;
  const int* row;
  const float* arrive;
  const uint8_t* valid;
  float* done;
  float* lat;
  uint8_t* hit;
  int R, L;
  bool vec;   // 16-byte copies: L % 16 == 0 and every pointer 16-byte aligned
  int row0, rows;  // the block's rows, set by the kernel
};

// Loader: the inputs of slots [i0, i0 + n) of the block's rows into st.
__device__ void load_tile(Stage& st, const Args& a, int i0, int n, int lt) {
  if (a.vec) {  // n is a multiple of 16
    const int q4 = n / 4;
    for (int e = lt; e < a.rows * q4; e += kLoaders) {
      const int r = e / q4, q = (e - r * q4) * 4;
      const size_t g = (size_t)(a.row0 + r) * a.L + i0 + q;
      const int s = r * kWordStride + q;
      cp_async16(st.bk + s, a.bk + g);
      cp_async16(st.row + s, a.row + g);
      cp_async16(st.arrive + s, a.arrive + g);
    }
    const int q16 = n / 16;
    for (int e = lt; e < a.rows * q16; e += kLoaders) {
      const int r = e / q16, q = (e - r * q16) * 16;
      cp_async16(st.valid + r * kByteStride + q, a.valid + (size_t)(a.row0 + r) * a.L + i0 + q);
    }
    cp_async_wait_all();
  } else {
    const int n16 = (n + kGroup - 1) / kGroup * kGroup;
    for (int e = lt; e < a.rows * n16; e += kLoaders) {
      const int r = e / n16, q = e - r * n16;
      if (q < n) {
        const size_t g = (size_t)(a.row0 + r) * a.L + i0 + q;
        const int s = r * kWordStride + q;
        st.bk[s] = a.bk[g];
        st.row[s] = a.row[g];
        st.arrive[s] = a.arrive[g];
        st.valid[r * kByteStride + q] = a.valid[g];
      } else {
        st.valid[r * kByteStride + q] = 0;  // past L: a step that changes nothing
      }
    }
  }
}

// Loader: the outputs of slots [i0, i0 + n) from st to device memory.
__device__ void store_tile(const Stage& st, const Args& a, int i0, int n, int lt) {
  if (a.vec) {
    const int q4 = n / 4;
    for (int e = lt; e < a.rows * q4; e += kLoaders) {
      const int r = e / q4, q = (e - r * q4) * 4;
      const size_t g = (size_t)(a.row0 + r) * a.L + i0 + q;
      const int s = r * kWordStride + q;
      *(float4*)(a.done + g) = *(const float4*)(st.done + s);
      *(float4*)(a.lat + g) = *(const float4*)(st.lat + s);
    }
    const int q16 = n / 16;
    for (int e = lt; e < a.rows * q16; e += kLoaders) {
      const int r = e / q16, q = (e - r * q16) * 16;
      *(uint4*)(a.hit + (size_t)(a.row0 + r) * a.L + i0 + q) =
          *(const uint4*)(st.hit + r * kByteStride + q);
    }
  } else {
    for (int e = lt; e < a.rows * n; e += kLoaders) {
      const int r = e / n, q = e - r * n;
      const size_t g = (size_t)(a.row0 + r) * a.L + i0 + q;
      a.done[g] = st.done[r * kWordStride + q];
      a.lat[g] = st.lat[r * kWordStride + q];
      a.hit[g] = st.hit[r * kByteStride + q];
    }
  }
}

// A row's bank state (open row, bank-free cycle per bank) in shared memory
// [bank][lane]: each lane touches its own column only. Row `banks` is a
// spare that takes the writes of steps that change nothing.
struct BankState {
  int* open;
  float* free_;
  int lane;
  __device__ BankState(uint8_t* smem, int banks, int lane_) : lane(lane_) {
    open = (int*)(smem + kStateOffset);
    free_ = (float*)(open + (banks + 1) * kRows);
    for (int b = 0; b <= banks; ++b) {
      open[b * kRows + lane] = -1;
      free_[b * kRows + lane] = 0.0f;
    }
  }
  __device__ __forceinline__ void read(int b, float& f, int& o) const {
    f = free_[b * kRows + lane];
    o = open[b * kRows + lane];
  }
  __device__ __forceinline__ void write(int b, int o, float f) {
    open[b * kRows + lane] = o;
    free_[b * kRows + lane] = f;
  }
};

size_t shared_bytes(int banks) { return kStateOffset + (size_t)2 * (banks + 1) * kRows * 4; }

// The inputs of 16 slots of a compute lane's row.
struct Group {
  int bk[kGroup], rw[kGroup];
  float ar[kGroup];
  unsigned valid[kGroup / 4];  // one byte a slot
};

__device__ __forceinline__ void load_group(Group& g, const Stage& st, int lane, int g0) {
  const int o = lane * kWordStride + g0;
#pragma unroll
  for (int j = 0; j < kGroup; j += 4) {
    const int4 b = *(const int4*)(st.bk + o + j);
    const int4 r = *(const int4*)(st.row + o + j);
    const float4 a = *(const float4*)(st.arrive + o + j);
    g.bk[j] = b.x, g.bk[j + 1] = b.y, g.bk[j + 2] = b.z, g.bk[j + 3] = b.w;
    g.rw[j] = r.x, g.rw[j + 1] = r.y, g.rw[j + 2] = r.z, g.rw[j + 3] = r.w;
    g.ar[j] = a.x, g.ar[j + 1] = a.y, g.ar[j + 2] = a.z, g.ar[j + 3] = a.w;
  }
  const uint4 v = *(const uint4*)(st.valid + lane * kByteStride + g0);
  g.valid[0] = v.x;
  g.valid[1] = v.y;
  g.valid[2] = v.z;
  g.valid[3] = v.w;
}

__global__ void __launch_bounds__(kThreads, 1)
dram_scan_full_kernel(Args a, int banks, float t_cas, float t_row_act, float bus) {
  extern __shared__ __align__(16) uint8_t smem[];
  Stage* stages = (Stage*)smem;
  a.row0 = blockIdx.x * kRows;
  a.rows = min(kRows, a.R - a.row0);
  const int ntiles = (a.L + kTile - 1) / kTile;

  if (threadIdx.x >= 32) {  // loader warps
    const int lt = threadIdx.x - 32;
    for (int it = 0; it < ntiles + kStages; ++it) {
      const int s = it % kStages;
      if (it >= kStages) {
        bar_sync(1 + kStages + s);
        const int i0 = (it - kStages) * kTile;
        store_tile(stages[s], a, i0, min(kTile, a.L - i0), lt);
      }
      if (it < ntiles) {
        const int i0 = it * kTile;
        load_tile(stages[s], a, i0, min(kTile, a.L - i0), lt);
        bar_arrive(1 + s);
      }
    }
    return;
  }

  // The compute warp: straight-line steps (selects, a store to the spare
  // bank row where the reference changes nothing), so the compiler can
  // overlap one step's independent work with the last one's chain.
  const int lane = threadIdx.x;
  BankState state(smem, banks, lane);
  const unsigned ubanks = (unsigned)banks;
  float bus_free = 0.0f;
  for (int it = 0; it < ntiles; ++it) {
    Stage& st = stages[it % kStages];
    const int n = min(kTile, a.L - it * kTile);
    bar_sync(1 + it % kStages);
    Group g;
    load_group(g, st, lane, 0);
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      float dn[kGroup], lt[kGroup];
      unsigned hw[4] = {0u, 0u, 0u, 0u};
      // The bank entry of the group's first slot; later slots' entries are
      // read one step ahead, before this step's write.
      int slot = (unsigned)g.bk[0] < ubanks ? g.bk[0] : 0;
      float pf;
      int po;
      state.read(slot, pf, po);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const bool in = (unsigned)g.bk[j] < ubanks;
        const bool v = ((g.valid[j / 4] >> (8 * (j % 4))) & 0xffu) != 0u;
        int slot_n = 0;
        float pf_n = 0.0f;
        int po_n = 0;
        if (j + 1 < kGroup) {
          slot_n = (unsigned)g.bk[j + 1] < ubanks ? g.bk[j + 1] : 0;
          state.read(slot_n, pf_n, po_n);
        }
        const float arr = g.ar[j];
        const bool row_hit = in && po == g.rw[j];
        const float occ = row_hit ? 0.0f : t_row_act;
        const float bank_prev = in ? pf : -INFINITY;
        const float bank_avail = __fadd_rn(fmaxf(arr, bank_prev), occ);
        const float done = __fadd_rn(fmaxf(bank_avail, bus_free), bus);
        const float out = __fadd_rn(done, t_cas);
        const bool upd = v && in;
        state.write(upd ? slot : banks, g.rw[j], done);
        bus_free = v ? done : bus_free;
        dn[j] = v ? out : 0.0f;
        lt[j] = v ? __fsub_rn(out, arr) : 0.0f;
        hw[j / 4] |= (unsigned)(row_hit && v) << (8 * (j % 4));
        if (j + 1 < kGroup) {  // the next slot on this bank sees this step's write
          const bool same = upd && slot_n == slot;
          pf = same ? done : pf_n;
          po = same ? g.rw[j] : po_n;
          slot = slot_n;
        }
      }
      const int o = lane * kWordStride + g0;
#pragma unroll
      for (int j = 0; j < kGroup; j += 4) {
        *(float4*)(st.done + o + j) = make_float4(dn[j], dn[j + 1], dn[j + 2], dn[j + 3]);
        *(float4*)(st.lat + o + j) = make_float4(lt[j], lt[j + 1], lt[j + 2], lt[j + 3]);
      }
      *(uint4*)(st.hit + lane * kByteStride + g0) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
      if (g0 + kGroup < n) load_group(g, st, lane, g0 + kGroup);
    }
    bar_arrive(1 + kStages + it % kStages);
  }
}

cudaError_t opt_in(int banks) {
  return cudaFuncSetAttribute(dram_scan_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shared_bytes(banks));
}

// ---------------------------------------------------------------------------
// Registers route (banks <= 16): the pre-pass, then the scan
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegMaxBanks = 16;
constexpr int kLaneOut = 31;           // the lane that holds -inf: a bank out of range
// A slot's code: bits 0-4 the lane to read (the bank, or kLaneOut), then
// these flags, the one-hot distance to the bank's previous update (2..5
// steps back) and the one-hot bank it updates (bits 16 + b).
constexpr unsigned kValid = 1u << 5, kHit = 1u << 6, kSame = 1u << 7;
constexpr int kDistShift = 8, kMaxDist = 5, kWriteShift = 16;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}
__device__ __forceinline__ unsigned lanemask_gt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_gt;" : "=r"(m));
  return m;
}

constexpr int kPreWarps = 32;          // segments of a row, one a warp
constexpr int kPreThreads = 32 * kPreWarps;
constexpr int kPreUnroll = 4;          // 32-slot chunks whose inputs are loaded at once

struct PrepassArgs {
  const int* bk;
  const int* row;
  const uint8_t* valid;
  int* code;
  uint8_t* hit;
  int L, banks;
};

// One block per row. Each warp owns a segment of seg slots: (1) its last
// update of each bank and its last valid slot; (2) from the segments before
// it, the bank's last update (and the row it opened) and the last valid slot
// as its walk starts; (3) the walk, 32 slots at a time.
__global__ void __launch_bounds__(kPreThreads) dram_prepass_kernel(PrepassArgs a) {
  __shared__ int last_upd[kPreWarps][kRegMaxBanks];
  __shared__ int last_valid[kPreWarps];
  __shared__ int carry_idx[kPreWarps][kRegMaxBanks];
  __shared__ int carry_row[kPreWarps][kRegMaxBanks];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t off = (size_t)blockIdx.x * a.L;
  const int* bk = a.bk + off;
  const int* row = a.row + off;
  const uint8_t* valid = a.valid + off;
  constexpr int kSpan = 32 * kPreUnroll;
  const int seg = (a.L + kPreWarps * kSpan - 1) / (kPreWarps * kSpan) * kSpan;
  const int s0 = min(w * seg, a.L), s1 = min(s0 + seg, a.L);
  const unsigned banks = (unsigned)a.banks;
  if (lane < kRegMaxBanks) last_upd[w][lane] = -1;
  __syncwarp();

  // Each span's inputs are loaded while the span before is processed.
  const auto fetch = [&](int c, int (&b)[kPreUnroll], int (&rw)[kPreUnroll],
                         bool (&v)[kPreUnroll], bool rows) {
#pragma unroll
    for (int k = 0; k < kPreUnroll; ++k) {
      const int i = c + 32 * k + lane;
      b[k] = i < s1 ? bk[i] : -1;
      rw[k] = rows && i < s1 ? row[i] : 0;
      v[k] = i < s1 && valid[i] != 0;
    }
  };
  int b[kPreUnroll], rw[kPreUnroll];
  bool v[kPreUnroll];
  int lastv = -1;
  fetch(s0, b, rw, v, false);
  for (int c = s0; c < s1; c += kSpan) {
    int nb[kPreUnroll], nrw[kPreUnroll];
    bool nv[kPreUnroll];
    fetch(c + kSpan, nb, nrw, nv, false);
#pragma unroll
    for (int k = 0; k < kPreUnroll; ++k) {
      if (v[k] && (unsigned)b[k] < banks) atomicMax(&last_upd[w][b[k]], c + 32 * k + lane);
      const unsigned vb = __ballot_sync(kFull, v[k]);
      if (vb) lastv = c + 32 * k + 31 - __clz(vb);
    }
#pragma unroll
    for (int k = 0; k < kPreUnroll; ++k) b[k] = nb[k], v[k] = nv[k];
  }
  if (lane == 0) last_valid[w] = lastv;
  __syncthreads();

  if (lane < kRegMaxBanks) {
    int j = -1;
    for (int u = 0; u < w; ++u) j = max(j, last_upd[u][lane]);
    carry_idx[w][lane] = j;
    carry_row[w][lane] = j >= 0 ? row[j] : -1;
  }
  int pv = -1;
  for (int u = 0; u < w; ++u) pv = max(pv, last_valid[u]);
  __syncwarp();

  const unsigned lt = lanemask_lt(), gt = lanemask_gt();
  fetch(s0, b, rw, v, true);
  for (int c = s0; c < s1; c += kSpan) {
    int nb[kPreUnroll], nrw[kPreUnroll];
    bool nv[kPreUnroll];
    fetch(c + kSpan, nb, nrw, nv, true);
#pragma unroll
    for (int k = 0; k < kPreUnroll; ++k) {
      const int i = c + 32 * k + lane;
      const bool inb = (unsigned)b[k] < banks;
      const bool upd = v[k] && inb;
      // the lanes before this one that update its bank; the last of them
      // opened the row this access finds
      const unsigned grp = __match_any_sync(kFull, upd ? b[k] : 32 + lane);
      const unsigned before = grp & lt;
      const int jl = before ? 31 - __clz(before) : lane;
      const int open_here = __shfl_sync(kFull, rw[k], jl);
      const int slot = inb ? b[k] : 0;
      const int j = before ? c + 32 * k + jl : carry_idx[w][slot];
      const int open = before ? open_here : carry_row[w][slot];
      const bool hit = upd && open == rw[k];
      const unsigned vb = __ballot_sync(kFull, v[k]);
      const unsigned vbefore = vb & lt;
      const int pvi = vbefore ? c + 32 * k + 31 - __clz(vbefore) : pv;
      const bool has = upd && j >= 0;
      const int dist = i - j;
      unsigned code = (inb ? (unsigned)b[k] : (unsigned)kLaneOut) | (v[k] ? kValid : 0u) |
                      (hit ? kHit : 0u) | (has && j == pvi ? kSame : 0u);
      if (has && dist >= 2 && dist <= kMaxDist) code |= 1u << (kDistShift + dist - 2);
      if (upd) code |= 1u << (kWriteShift + b[k]);
      if (i < s1) {
        a.code[off + i] = (int)code;
        a.hit[off + i] = hit ? 1 : 0;
      }
      __syncwarp();  // every lane has read the carry before its last writers change it
      if (upd && !(grp & gt)) {
        carry_idx[w][b[k]] = i;
        carry_row[w][b[k]] = rw[k];
      }
      if (vb) pv = c + 32 * k + 31 - __clz(vb);
      __syncwarp();
    }
#pragma unroll
    for (int k = 0; k < kPreUnroll; ++k) b[k] = nb[k], rw[k] = nrw[k], v[k] = nv[k];
  }
}

constexpr int kRegTile = 512;          // slots of the row per stage
constexpr int kRegStages = 2;
constexpr int kRegThreads = 64;        // the compute warp and a loader warp
// The lanes' bank state is read kDepth steps behind the chain; the banks
// updated in between come from the completions held in registers.
constexpr int kDepth = 4;
static_assert(kDepth >= 3 && kDepth - 1 <= kMaxDist, "forwarded distances are 2..kMaxDist");
// The code's distance bits the registers forward: 2 .. kDepth - 1.
constexpr unsigned kNear = ((1u << (kDepth - 2)) - 1u) << kDistShift;

struct RegStage {
  int code[kRegTile];
  float arrive[kRegTile];
  float ao[kRegTile];    // a + occ, -inf for an invalid slot
  float occ[kRegTile];   // 0 or t_row_act (0 for an invalid slot)
  float cc[kRegTile];    // occ where the bank's free cycle is the bus-free cycle, else 0
  float bus[kRegTile];   // bus, 0 for an invalid slot
  float done[kRegTile];  // the compute warp's raw completions
};

struct RegArgs {
  const int* code;
  const float* arrive;
  float* done;
  float* lat;
  int L;
  bool vec;  // 16-byte copies: L % 4 == 0 and code, arrive 16-byte aligned
  float t_cas, t_row, bus;
};

__device__ __forceinline__ void reg_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kRegThreads) : "memory");
}
__device__ __forceinline__ void reg_bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kRegThreads) : "memory");
}

// Loader: codes and arrivals of n slots at `g` into st, then each slot's
// terms; the slots from n to the next multiple of 16 are invalid.
__device__ void reg_load_tile(RegStage& st, const RegArgs& a, size_t g, int n, int lane) {
  if (a.vec) {  // n is a multiple of 4
    for (int q = 4 * lane; q < n; q += 128) {
      cp_async16(st.code + q, a.code + g + q);
      cp_async16(st.arrive + q, a.arrive + g + q);
    }
    cp_async_wait_all();
  } else {
    for (int q = lane; q < n; q += 32) {
      st.code[q] = a.code[g + q];
      st.arrive[q] = a.arrive[g + q];
    }
  }
  __syncwarp();
  const int n16 = (n + kGroup - 1) / kGroup * kGroup;
  for (int q = lane; q < n16; q += 32) {
    const unsigned c = q < n ? (unsigned)st.code[q] : 0u;
    const bool v = (c & kValid) != 0u;
    const float occ = v && !(c & kHit) ? a.t_row : 0.0f;
    st.code[q] = (int)c;
    st.ao[q] = v ? __fadd_rn(st.arrive[q], occ) : -INFINITY;
    st.occ[q] = occ;
    st.cc[q] = (c & kSame) ? occ : 0.0f;
    st.bus[q] = v ? a.bus : 0.0f;
  }
}

// Loader: the outputs of n slots from st to device memory at `g`.
__device__ void reg_store_tile(const RegStage& st, const RegArgs& a, size_t g, int n, int lane) {
  for (int q = lane; q < n; q += 32) {
    const bool v = ((unsigned)st.code[q] & kValid) != 0u;
    const float out = __fadd_rn(st.done[q], a.t_cas);
    a.done[g + q] = v ? out : 0.0f;
    a.lat[g + q] = v ? __fsub_rn(out, st.arrive[q]) : 0.0f;
  }
}

// The terms of 16 slots.
struct RegGroup {
  unsigned code[kGroup];
  float ao[kGroup], occ[kGroup], cc[kGroup], bus[kGroup];
};

__device__ __forceinline__ void reg_load_group(RegGroup& g, const RegStage& st, int g0) {
#pragma unroll
  for (int j = 0; j < kGroup; j += 4) {
    const uint4 c = *(const uint4*)(st.code + g0 + j);
    const float4 x = *(const float4*)(st.ao + g0 + j);
    const float4 o = *(const float4*)(st.occ + g0 + j);
    const float4 y = *(const float4*)(st.cc + g0 + j);
    const float4 u = *(const float4*)(st.bus + g0 + j);
    g.code[j] = c.x, g.code[j + 1] = c.y, g.code[j + 2] = c.z, g.code[j + 3] = c.w;
    g.ao[j] = x.x, g.ao[j + 1] = x.y, g.ao[j + 2] = x.z, g.ao[j + 3] = x.w;
    g.occ[j] = o.x, g.occ[j + 1] = o.y, g.occ[j + 2] = o.z, g.occ[j + 3] = o.w;
    g.cc[j] = y.x, g.cc[j + 1] = y.y, g.cc[j + 2] = y.z, g.cc[j + 3] = y.w;
    g.bus[j] = u.x, g.bus[j + 1] = u.y, g.bus[j + 2] = u.z, g.bus[j + 3] = u.w;
  }
}

// One block per row: warp 0 walks the chain, warp 1 stages the tiles and
// writes the outputs.
__global__ void __launch_bounds__(kRegThreads, 1) dram_scan_regs_kernel(RegArgs a) {
  __shared__ __align__(16) RegStage stages[kRegStages];
  const int lane = threadIdx.x % 32;
  // The role by a warp-uniform value (lane 0's warp index), so that the
  // compiler knows the compute warp converged: a branch on threadIdx.x
  // alone leaves it unproven, and every shfl then compiles to a collective
  // sequence of six instructions.
  const int warp = __shfl_sync(kFull, (int)threadIdx.x / 32, 0);
  const size_t off = (size_t)blockIdx.x * a.L;
  const int ntiles = (a.L + kRegTile - 1) / kRegTile;

  if (warp == 1) {
    for (int it = 0; it < ntiles + kRegStages; ++it) {
      const int s = it % kRegStages;
      if (it >= kRegStages) {
        reg_bar_sync(1 + kRegStages + s);
        const int i0 = (it - kRegStages) * kRegTile;
        reg_store_tile(stages[s], a, off + i0, min(kRegTile, a.L - i0), lane);
        __syncwarp();
      }
      if (it < ntiles) {
        const int i0 = it * kRegTile;
        reg_load_tile(stages[s], a, off + i0, min(kRegTile, a.L - i0), lane);
        __syncwarp();
        reg_bar_arrive(1 + s);
      }
    }
    return;
  }

  // The compute warp. Every lane runs the chain; lane k < 16 holds bank k's
  // free cycle as it was kDepth steps back, lane kLaneOut -inf.
  const unsigned lanebit = lane < kRegMaxBanks ? 1u << (kWriteShift + lane) : 0u;
  float lag = lane == kLaneOut ? -INFINITY : 0.0f;
  float f[kDepth - 1];      // f[k]: the bus-free cycle after step i - 1 - k
  unsigned wc[kDepth - 1];  // wc[k]: the code of step i - 1 - k
#pragma unroll
  for (int k = 0; k < kDepth - 1; ++k) {
    f[k] = 0.0f;
    wc[k] = 0u;
  }
  for (int it = 0; it < ntiles; ++it) {
    RegStage& st = stages[it % kRegStages];
    const int n16 = (min(kRegTile, a.L - it * kRegTile) + kGroup - 1) / kGroup * kGroup;
    reg_bar_sync(1 + it % kRegStages);
    RegGroup g;
    reg_load_group(g, st, 0);
    for (int g0 = 0; g0 < n16; g0 += kGroup) {
      float dn[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const unsigned c = g.code[j];
        // the bank's free cycle: the lanes' state (shfl reads the lane in
        // the code's low 5 bits), or a completion still in registers (the
        // code's distance); where `same`, any value <= f[0]. The
        // completions are selected first, so the shfl's result passes one
        // select only; every lane runs the shfl on every step (a shfl
        // under a condition is a branch a step).
        const float far = __shfl_sync(kFull, lag, (int)c);
        float near = f[kDepth - 2];
#pragma unroll
        for (int d = kDepth - 2; d >= 2; --d)
          near = (c & (1u << (kDistShift + d - 2))) ? f[d - 1] : near;
        const float bp = (c & kNear) ? near : far;
        const float y = fmaxf(g.ao[j], __fadd_rn(bp, g.occ[j]));
        const float done = __fadd_rn(fmaxf(y, __fadd_rn(f[0], g.cc[j])), g.bus[j]);
        // the state catches up with step i - kDepth + 1
        lag = (wc[kDepth - 2] & lanebit) ? f[kDepth - 2] : lag;
#pragma unroll
        for (int k = kDepth - 2; k > 0; --k) {
          f[k] = f[k - 1];
          wc[k] = wc[k - 1];
        }
        f[0] = done;
        wc[0] = c;
        dn[j] = done;
      }
#pragma unroll
      for (int j = 0; j < kGroup; j += 4)
        *(float4*)(st.done + g0 + j) = make_float4(dn[j], dn[j + 1], dn[j + 2], dn[j + 3]);
      if (g0 + kGroup < n16) reg_load_group(g, st, g0 + kGroup);
    }
    reg_bar_arrive(1 + kRegStages + it % kRegStages);
  }
}

}  // namespace

extern "C" int dram_scan_full_launch(const int* bk, const int* row, const float* arrive,
                                     const uint8_t* valid, int R, int L, int banks, float t_cas,
                                     float t_row_act, float bus, float* done, float* lat,
                                     uint8_t* hit, void* stream) {
  if (banks < 1 || banks > kMaxBanks) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15u) == 0; };
  const bool vec = L % 16 == 0 && aligned(bk) && aligned(row) && aligned(arrive) &&
                   aligned(valid) && aligned(done) && aligned(lat) && aligned(hit);
  const int grid = (R + kRows - 1) / kRows;
  const Args a{bk, row, arrive, valid, done, lat, hit, R, L, vec, 0, 0};
  const cudaError_t err = opt_in(banks);
  if (err != cudaSuccess) return (int)err;
  dram_scan_full_kernel<<<grid, kThreads, shared_bytes(banks), (cudaStream_t)stream>>>(
      a, banks, t_cas, t_row_act, bus);
  return (int)cudaGetLastError();
}

// The registers route's pre-pass: (R, L) bank, row and valid in, each
// slot's code (int32) and hit (uint8) out. 1 <= banks <= 16.
extern "C" int dram_prepass_launch(const int* bk, const int* row, const uint8_t* valid, int R,
                                   int L, int banks, int* code, uint8_t* hit, void* stream) {
  if (banks < 1 || banks > kRegMaxBanks || R < 1 || L < 1) return (int)cudaErrorInvalidValue;
  dram_prepass_kernel<<<R, kPreThreads, 0, (cudaStream_t)stream>>>(
      PrepassArgs{bk, row, valid, code, hit, L, banks});
  return (int)cudaGetLastError();
}

// The registers route's scan: (R, L) codes of the pre-pass and arrivals in,
// done and lat (f32) out. t_row_act >= 0 and bus >= 0.
extern "C" int dram_scan_regs_launch(const int* code, const float* arrive, int R, int L,
                                     float t_cas, float t_row_act, float bus, float* done,
                                     float* lat, void* stream) {
  if (R < 1 || L < 1 || !(t_row_act >= 0.0f) || !(bus >= 0.0f)) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15u) == 0; };
  const RegArgs a{code, arrive, done, lat, L, L % 4 == 0 && aligned(code) && aligned(arrive),
                  t_cas, t_row_act, bus};
  dram_scan_regs_kernel<<<R, kRegThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
