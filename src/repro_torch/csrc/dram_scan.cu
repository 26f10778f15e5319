// D1: chunked DRAM event scan for Hopper (sm_90a).
//
// Replaces the `lax.scan` of `_scan_channel_chunked` in
// src/repro/core/memory/dram.py (a scan, not a Pallas kernel; run as a
// Python loop of torch ops it cost one launch per op per step). One lane
// walks one (segment, channel) row over its Lc chunks, carrying the
// per-bank open row and bank-free cycle, the bus-free cycle and the row's
// aggregates (latency sum, row-hit count, latest completion). Per chunk it
// writes the first completion and whether the chunk's first access hit the
// open row.
//
// What bounds it: latency. A row is Lc dependent steps, each a chain of
// up to k_max + 1 dependent f32 operations on the bus-free cycle, on as many
// lanes as there are rows (32 for 16 channels x 2 segments), so the card's
// bandwidth and FLOP rate do not enter. The first design read each step's
// inputs from device memory, 32 rows Lc apart: ~400 ns a chunk against
// ~21 ns of adds. This one takes device memory off the chain:
//   * a block is one compute warp (lane = row) and three loader warps.
//     The loaders bring tiles of kTile chunks of all 32 rows into shared
//     memory with 16-byte cp.async (rows are contiguous, so the copies are
//     coalesced), kStages tiles ahead, and write the tile's outputs (done0,
//     row_hit), which the compute warp leaves in shared memory, back to
//     device memory with 16-byte stores. Named barriers hand each stage
//     from loaders to compute (FULL) and back (EMPTY);
//   * the compute warp reads 16 chunks of its row at a time with 16-byte
//     shared loads (row strides of an odd number of 16-byte units: no bank
//     conflicts), the next 16 at the end of a group's steps, and writes 16
//     outputs the same way;
//   * the bank state stays [bank][lane] in shared memory, but each step
//     loads the next chunk's bank entry before it writes its own and
//     forwards its own result when the two chunks share the bank, so no
//     shared-memory round trip sits on the chain either;
//   * a step is straight-line code: selects, and a store to a spare bank
//     row where the reference changes nothing, so the compiler can overlap
//     one step's independent work with the last one's chain.
// scripts/scan_ablation.py times the alternatives at the full-size input
// on an H100: a branch per step (`if (valid)`) takes ~127 ns a chunk
// against ~59, the bank state in registers (8 banks: a select per bank a
// read) ~161, the read-ahead left out ~66.
// A tile whose rows are not 16-byte aligned (Lc not a multiple of 16, or a
// pointer off 16 bytes; never on simulate's path, whose Lc are multiples of
// 32) is copied element by element, and the chunks past Lc in its last
// group of 16 are marked invalid, which leaves the state as it is.
//
// The f32 chain is bitwise equal to the reference's: every add is
// __fadd_rn, in the reference's order (lc = done0 + t_cas, then
// lc + (dlast + t_cas) for each further access of the chunk), and the
// library is built with -fmad=false. The scalar timings arrive already
// rounded to f32 by the caller, as JAX rounds them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                  // rows a block walks: one per compute lane
constexpr int kLoaders = 96;               // three loader warps
constexpr int kThreads = 32 + kLoaders;
constexpr int kTile = 128;                 // chunks of a row per stage
constexpr int kStages = 2;
constexpr int kGroup = 16;                 // chunks a compute lane reads at once
constexpr int kMaxK = 8;                   // k_max the unrolled access loop covers
constexpr int kMaxBanks = 192;
constexpr int kIntStride = kTile + 4;      // words: an odd number of 16-byte units
constexpr int kByteStride = kTile + 16;    // bytes: an odd number of 16-byte units

struct Stage {
  int bk[kRows * kIntStride];
  int row[kRows * kIntStride];
  int k[kRows * kIntStride];
  float done0[kRows * kIntStride];
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
  const int* bkc;
  const int* rowc;
  const int* kc;
  const uint8_t* valid;
  float* done0;
  uint8_t* row_hit;
  int R, Lc;
  bool vec;   // 16-byte copies: Lc % 16 == 0 and every pointer 16-byte aligned
  int row0, rows;  // the block's rows, set by the kernel
};

// Loader: the inputs of chunks [i0, i0 + n) of the block's rows into st.
__device__ void load_tile(Stage& st, const Args& a, int i0, int n, int lt) {
  if (a.vec) {  // n is a multiple of 16
    const int q4 = n / 4;
    for (int e = lt; e < a.rows * q4; e += kLoaders) {
      const int r = e / q4, q = (e - r * q4) * 4;
      const size_t g = (size_t)(a.row0 + r) * a.Lc + i0 + q;
      const int s = r * kIntStride + q;
      cp_async16(st.bk + s, a.bkc + g);
      cp_async16(st.row + s, a.rowc + g);
      cp_async16(st.k + s, a.kc + g);
    }
    const int q16 = n / 16;
    for (int e = lt; e < a.rows * q16; e += kLoaders) {
      const int r = e / q16, q = (e - r * q16) * 16;
      cp_async16(st.valid + r * kByteStride + q, a.valid + (size_t)(a.row0 + r) * a.Lc + i0 + q);
    }
    cp_async_wait_all();
  } else {
    const int n16 = (n + kGroup - 1) / kGroup * kGroup;
    for (int e = lt; e < a.rows * n16; e += kLoaders) {
      const int r = e / n16, q = e - r * n16;
      if (q < n) {
        const size_t g = (size_t)(a.row0 + r) * a.Lc + i0 + q;
        const int s = r * kIntStride + q;
        st.bk[s] = a.bkc[g];
        st.row[s] = a.rowc[g];
        st.k[s] = a.kc[g];
        st.valid[r * kByteStride + q] = a.valid[g];
      } else {
        st.valid[r * kByteStride + q] = 0;  // past Lc: a step that changes nothing
      }
    }
  }
}

// Loader: the outputs of chunks [i0, i0 + n) from st to device memory.
__device__ void store_tile(const Stage& st, const Args& a, int i0, int n, int lt) {
  if (a.vec) {
    const int q4 = n / 4;
    for (int e = lt; e < a.rows * q4; e += kLoaders) {
      const int r = e / q4, q = (e - r * q4) * 4;
      *(float4*)(a.done0 + (size_t)(a.row0 + r) * a.Lc + i0 + q) =
          *(const float4*)(st.done0 + r * kIntStride + q);
    }
    const int q16 = n / 16;
    for (int e = lt; e < a.rows * q16; e += kLoaders) {
      const int r = e / q16, q = (e - r * q16) * 16;
      *(uint4*)(a.row_hit + (size_t)(a.row0 + r) * a.Lc + i0 + q) =
          *(const uint4*)(st.hit + r * kByteStride + q);
    }
  } else {
    for (int e = lt; e < a.rows * n; e += kLoaders) {
      const int r = e / n, q = e - r * n;
      const size_t g = (size_t)(a.row0 + r) * a.Lc + i0 + q;
      a.done0[g] = st.done0[r * kIntStride + q];
      a.row_hit[g] = st.hit[r * kByteStride + q];
    }
  }
}

// A row's bank state (open row, bank-free cycle per bank) in shared memory
// [bank][lane]: each lane touches its own column only, so the warp never
// synchronises on it. Row `banks` is a spare that takes the writes of steps
// that change nothing, so every step stores without a branch.
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

// The inputs of 16 chunks of a compute lane's row.
struct Group {
  int bk[kGroup], rw[kGroup], k[kGroup];
  unsigned valid[kGroup / 4];  // one byte a chunk
};

__device__ __forceinline__ void load_group(Group& g, const Stage& st, int lane, int g0) {
  const int* src[3] = {st.bk + lane * kIntStride + g0, st.row + lane * kIntStride + g0,
                       st.k + lane * kIntStride + g0};
  int* dst[3] = {g.bk, g.rw, g.k};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int j = 0; j < kGroup; j += 4) {
      const int4 v = *(const int4*)(src[a] + j);
      dst[a][j] = v.x;
      dst[a][j + 1] = v.y;
      dst[a][j + 2] = v.z;
      dst[a][j + 3] = v.w;
    }
  }
  const uint4 v = *(const uint4*)(st.valid + lane * kByteStride + g0);
  g.valid[0] = v.x;
  g.valid[1] = v.y;
  g.valid[2] = v.z;
  g.valid[3] = v.w;
}

__global__ void __launch_bounds__(kThreads, 1)
dram_scan_kernel(Args a, int banks, int k_max, float t_row_act, float t_cas, float bus,
                 float* __restrict__ lat_out, int* __restrict__ hit_out,
                 float* __restrict__ dmax_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  Stage* stages = (Stage*)smem;
  a.row0 = blockIdx.x * kRows;
  a.rows = min(kRows, a.R - a.row0);
  const int ntiles = (a.Lc + kTile - 1) / kTile;

  if (threadIdx.x >= 32) {  // loader warps
    const int lt = threadIdx.x - 32;
    for (int it = 0; it < ntiles + kStages; ++it) {
      const int s = it % kStages;
      if (it >= kStages) {
        bar_sync(1 + kStages + s);
        const int i0 = (it - kStages) * kTile;
        store_tile(stages[s], a, i0, min(kTile, a.Lc - i0), lt);
      }
      if (it < ntiles) {
        const int i0 = it * kTile;
        load_tile(stages[s], a, i0, min(kTile, a.Lc - i0), lt);
        bar_arrive(1 + s);
      }
    }
    return;
  }

  // The compute warp. Each step is straight-line code (selects, and a
  // store to the spare bank row where the reference changes nothing): a
  // branch per step would end the block of instructions the compiler can
  // schedule, and the next step's independent work could not overlap this
  // step's chain.
  const int lane = threadIdx.x;
  BankState state(smem, banks, lane);
  const unsigned ubanks = (unsigned)banks;
  float bus_free = 0.0f, lat = 0.0f, dmax = 0.0f;
  int hits = 0;
  for (int it = 0; it < ntiles; ++it) {
    Stage& st = stages[it % kStages];
    const int n = min(kTile, a.Lc - it * kTile);
    bar_sync(1 + it % kStages);
    Group g;
    load_group(g, st, lane, 0);
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      float d0[kGroup];
      unsigned hw[4] = {0u, 0u, 0u, 0u};
      // The bank entry of the group's first chunk; later chunks' entries
      // are read one step ahead, before this step's write.
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
        const bool row_hit = in && po == g.rw[j];
        const float occ = row_hit ? 0.0f : t_row_act;
        const float bank_prev = in ? pf : -INFINITY;
        const float bank_avail = __fadd_rn(fmaxf(0.0f, bank_prev), occ);
        const float done0 = __fadd_rn(fmaxf(bank_avail, bus_free), bus);
        const int kj = min(g.k[j], k_max);
        float dlast = done0;
        float lc = __fadd_rn(done0, t_cas);
#pragma unroll
        for (int q = 1; q < kMaxK; ++q) {
          if (q < kj) {
            dlast = __fadd_rn(dlast, bus);
            lc = __fadd_rn(lc, __fadd_rn(dlast, t_cas));
          }
        }
        const bool upd = v && in;
        state.write(upd ? slot : banks, g.rw[j], dlast);
        bus_free = v ? dlast : bus_free;
        lat = v ? __fadd_rn(lat, lc) : lat;
        hits += v ? g.k[j] - 1 + (row_hit ? 1 : 0) : 0;
        dmax = v ? fmaxf(dmax, dlast) : dmax;
        d0[j] = v ? done0 : 0.0f;
        hw[j / 4] |= (unsigned)(row_hit && v) << (8 * (j % 4));
        if (j + 1 < kGroup) {  // the next chunk on this bank sees this step's write
          const bool same = upd && slot_n == slot;
          pf = same ? dlast : pf_n;
          po = same ? g.rw[j] : po_n;
          slot = slot_n;
        }
      }
      float* od = st.done0 + lane * kIntStride + g0;
#pragma unroll
      for (int j = 0; j < kGroup; j += 4) {
        *(float4*)(od + j) = make_float4(d0[j], d0[j + 1], d0[j + 2], d0[j + 3]);
      }
      *(uint4*)(st.hit + lane * kByteStride + g0) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
      if (g0 + kGroup < n) load_group(g, st, lane, g0 + kGroup);
    }
    bar_arrive(1 + kStages + it % kStages);
  }
  const int r = a.row0 + lane;
  if (lane < a.rows) {
    lat_out[r] = lat;
    hit_out[r] = hits;
    dmax_out[r] = dmax;
  }
}

cudaError_t opt_in(int banks) {
  return cudaFuncSetAttribute(dram_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shared_bytes(banks));
}

}  // namespace

// Blocks resident on one SM of the current card.
extern "C" int dram_scan_occupancy(int banks, int* blocks) {
  if (banks < 1 || banks > kMaxBanks) return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in(banks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, dram_scan_kernel, kThreads,
                                                             shared_bytes(banks));
}

extern "C" int dram_scan_launch(const int* bkc, const int* rowc, const int* kc,
                                const uint8_t* valid, int R, int Lc, int banks,
                                int k_max, float t_row_act, float t_cas,
                                float bus, float* lat, int* hit, float* dmax,
                                float* done0, uint8_t* row_hit, void* stream) {
  if (banks < 1 || banks > kMaxBanks || k_max < 1 || k_max > kMaxK) {
    return (int)cudaErrorInvalidValue;
  }
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15u) == 0; };
  const bool vec = Lc % 16 == 0 && aligned(bkc) && aligned(rowc) && aligned(kc) &&
                   aligned(valid) && aligned(done0) && aligned(row_hit);
  const int grid = (R + kRows - 1) / kRows;
  const Args a{bkc, rowc, kc, valid, done0, row_hit, R, Lc, vec, 0, 0};
  const cudaError_t err = opt_in(banks);
  if (err != cudaSuccess) return (int)err;
  dram_scan_kernel<<<grid, kThreads, shared_bytes(banks), (cudaStream_t)stream>>>(
      a, banks, k_max, t_row_act, t_cas, bus, lat, hit, dmax);
  return (int)cudaGetLastError();
}
