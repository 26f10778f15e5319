// D3: per-access FR-FCFS DRAM event scan with arrival times, for Hopper
// (sm_90a).
//
// Replaces the `lax.scan` of `_scan_channel_full` in
// src/repro/core/memory/dram.py (reached through `_scan_channel`, vmapped
// over channels; a scan, not a Pallas kernel). `simulate_dram` takes it
// when the issue interval or the start cycle is non-zero. One lane walks
// one channel row over its L service-ordered slots, carrying the per-bank
// open row and bank-free cycle and the bus-free cycle. Per slot it writes
// the completion (done + t_cas), the latency (that minus the arrival) and
// whether the access hit the open row; an invalid slot writes 0 / 0 / 0
// and leaves the state as it is.
//
// What bounds it: latency. A row is L dependent steps; consecutive slots
// of one block share a bank, so a step's chain is the bank-free cycle
// forwarded from the step before, a max with the arrival, the row
// activation add, a max with the bus-free cycle and the bus add: four
// dependent f32 operations as written, three at least (after a valid
// access to the same bank the bus-free cycle is that access's done, which
// the first max already bounds, so the second max is exact and could be
// left out; a select in its place would cost as much on the chain). Where
// the bank differs, two (the max with the bus-free cycle and the bus add).
// There are as many lanes as channels (16 on
// `simulate_dram`'s path), so the card's bandwidth and FLOP rate do not
// enter. The layout is D1's (csrc/dram_scan.cu), which keeps device
// memory off the chain:
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
//   * the bank state stays [bank][lane] in shared memory; each step reads
//     the next slot's bank entry before it writes its own and forwards its
//     own result when the two slots share the bank, so no shared-memory
//     round trip sits on the chain;
//   * a step is straight-line code: selects, and a store to a spare bank
//     row where the reference changes nothing.
// The differences from D1: one access a step (no run of k accesses), an
// arrival per slot, and max(arrival, bank-free) where D1 has max(0, ·).
// A tile whose rows are not 16-byte aligned (L not a multiple of 16, or a
// pointer off 16 bytes) is copied element by element, and the slots past L
// in its last group of 16 are marked invalid.
//
// The f32 chain is bitwise equal to the reference's: every add is
// __fadd_rn and the latency __fsub_rn, in the reference's order (done =
// max(max(a, bank_free) + occ, bus_free) + bus; out = done + t_cas;
// lat = out - a), and the library is built with -fmad=false. The scalar
// timings arrive already rounded to f32 by the caller, as JAX rounds them.
// A bank outside [0, banks) never hits, sees no bank-free cycle and
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
