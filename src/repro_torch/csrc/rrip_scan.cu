// D2: FIFO / SRRIP per-set row scans for Hopper (sm_90a).
//
// Replaces the two `lax.scan`s of src/repro/core/memory/rrip.py,
// `_fifo_scan_rows` and `_srrip_scan_rows` (scans, not Pallas kernels; run
// as a Python loop of torch ops they cost one launch per op per step). A
// row is one cache set's compressed access sequence; a lane walks it with
// the set's state in registers and writes one hit flag per position.
//   FIFO:  a ring of `ways` tags (init -1) and a head. A hit changes
//          nothing; a valid miss writes the tag at the head and advances it
//          mod `ways`.
//   SRRIP: `ways` (tag, key) pairs (init -1, 0), an age A and a fill count
//          nf. A hit sets the matching ways' key to A; a valid miss with
//          nf < ways fills way nf with key A - 2 (nf += 1); a warm miss
//          takes m = min(keys), fills the FIRST way holding m with key m + 1
//          and sets A = m + 3.
// An invalid position (padding) changes nothing and reports no hit. All
// arithmetic is int32, signed (A - 2 is negative at the start), as the
// reference's.
//
// What bounds it: latency. A row is L dependent steps, and rows are few
// where they are long: the on-chip cache gives tens of thousands of rows of
// at most 128 steps, but a TLB gives 16 rows of up to 32,768 steps, on 16
// lanes of one warp. So the design keeps everything but the state update
// off a step's chain, as D1 (csrc/dram_scan.cu) does:
//   * a block is one compute warp (lane = row) and two loader warps. The
//     loaders bring tiles of up to kMaxTile steps of all 32 rows into
//     shared memory with 16-byte cp.async, kStages tiles ahead; named
//     barriers hand each stage from loaders to compute (FULL) and back
//     (EMPTY);
//   * the compute lane reads 16 steps of its row at a time with 16-byte
//     shared loads (row strides of an odd number of 16-byte units: no bank
//     conflicts) and writes their 16 hit flags with one 16-byte store;
//   * the ways are a compile-time power of two W >= ways, held in
//     registers. Ways past the real count (W > ways) never match and are
//     never a victim (their key is INT_MAX); an instance with W == ways
//     drops those checks (12-27% faster at 4, 8 and 16 ways than the
//     masked instance: scripts/scan_ablation.py, variant masked-only);
//   * a step is straight-line code: the "any way matches" and "min key"
//     are trees of depth log2(W), the first way holding the minimum is a
//     find-first-set of a bit mask, and every state update is a select, so
//     one step's independent work overlaps the last one's chain;
//   * groups of 16 steps past the longest row of the block (a bucket's
//     rows are padded to its power-of-two length) are skipped, on one
//     warp-uniform branch a group.
// A row set whose length is not a multiple of 16, or a pointer off 16
// bytes, is copied element by element, the steps past L marked invalid.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 32;               // rows a block walks: one per compute lane
constexpr int kLoaders = 64;            // two loader warps
constexpr int kThreads = 32 + kLoaders;
constexpr int kMaxTile = 256;           // steps of a row per stage
constexpr int kStages = 2;
constexpr int kGroup = 16;              // steps a compute lane reads at once
constexpr int kMaxWays = 64;

// A stage holds `tile` steps of each row: L rounded up to 16, at most
// kMaxTile. Row strides are an odd number of 16-byte units.
int tile_of(int L) {
  const int t = (L + kGroup - 1) / kGroup * kGroup;
  return t < kMaxTile ? t : kMaxTile;
}
__host__ __device__ __forceinline__ int tag_stride(int tile) { return tile + 4; }  // ints
__host__ __device__ __forceinline__ int byte_stride(int tile) {                     // bytes
  return tile + ((tile / 16) % 2 ? 0 : 16);
}
__host__ __device__ __forceinline__ size_t stage_bytes(int tile) {
  return (size_t)kRows * tag_stride(tile) * 4 + (size_t)kRows * byte_stride(tile);
}
size_t shared_bytes(int tile) { return kStages * stage_bytes(tile); }

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
  const int* tags;
  const uint8_t* valid;
  uint8_t* hits;
  int B, L, ways, tile;
  bool vec;   // 16-byte copies: L % 16 == 0 and every pointer 16-byte aligned
};

// Loader: steps [i0, i0 + n) of the block's rows into stage st.
__device__ void load_tile(uint8_t* st, const Args& a, int row0, int rows, int i0, int n,
                          int lt) {
  const int ts = tag_stride(a.tile), bs = byte_stride(a.tile);
  int* tg = (int*)st;
  uint8_t* vd = st + (size_t)kRows * ts * 4;
  if (a.vec) {  // n is a multiple of 16
    const int q4 = n / 4;
    for (int e = lt; e < rows * q4; e += kLoaders) {
      const int r = e / q4, q = (e - r * q4) * 4;
      cp_async16(tg + r * ts + q, a.tags + (size_t)(row0 + r) * a.L + i0 + q);
    }
    const int q16 = n / 16;
    for (int e = lt; e < rows * q16; e += kLoaders) {
      const int r = e / q16, q = (e - r * q16) * 16;
      cp_async16(vd + r * bs + q, a.valid + (size_t)(row0 + r) * a.L + i0 + q);
    }
    cp_async_wait_all();
  } else {
    const int n16 = (n + kGroup - 1) / kGroup * kGroup;
    for (int e = lt; e < rows * n16; e += kLoaders) {
      const int r = e / n16, q = e - r * n16;
      if (q < n) {
        const size_t g = (size_t)(row0 + r) * a.L + i0 + q;
        tg[r * ts + q] = a.tags[g];
        vd[r * bs + q] = a.valid[g];
      } else {
        vd[r * bs + q] = 0;  // past L: a step that changes nothing
      }
    }
  }
}

struct Or {
  template <typename T>
  __device__ __forceinline__ T operator()(T x, T y) const { return x | y; }
};
struct Min {
  __device__ __forceinline__ int operator()(int x, int y) const { return x < y ? x : y; }
};

// x[0] op x[1] op ... op x[W-1] as a tree of depth log2(W); overwrites x.
template <int W, typename T, typename Op>
__device__ __forceinline__ T tree(T (&x)[W], Op op) {
#pragma unroll
  for (int s = 1; s < W; s *= 2) {
#pragma unroll
    for (int j = 0; j + s < W; j += 2 * s) x[j] = op(x[j], x[j + s]);
  }
  return x[0];
}

// FIFO state of one row. W: ways held (a power of two); FULL: W == ways.
template <int W, bool FULL>
struct FifoRow {
  int t[W];
  int head, ways;
  __device__ __forceinline__ void init(int ways_) {
    ways = ways_;
    head = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = -1;
  }
  __device__ __forceinline__ bool step(int tag, bool v) {
    bool e[W];
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = (FULL || j < ways) && t[j] == tag;
    const bool hit = tree(e, Or());
    const bool miss = v && !hit;
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = (miss && head == j) ? tag : t[j];
    const int nxt = head + 1;
    head = miss ? (nxt == ways ? 0 : nxt) : head;
    return v && hit;
  }
};

// SRRIP state of one row: (tag, key) per way, the age A, the fill count nf.
template <int W, bool FULL>
struct SrripRow {
  using Mask = typename std::conditional<(W > 32), unsigned long long, unsigned>::type;
  int t[W], k[W];
  int A, nf, ways;
  __device__ __forceinline__ void init(int ways_) {
    ways = ways_;
    A = 0;
    nf = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      t[j] = -1;
      k[j] = (FULL || j < ways) ? 0 : INT_MAX;  // a way past `ways` is never the minimum
    }
  }
  __device__ __forceinline__ bool step(int tag, bool v) {
    bool e[W], any[W];
    int km[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      e[j] = (FULL || j < ways) && t[j] == tag;
      any[j] = e[j];
      km[j] = k[j];
    }
    const bool hit = tree(any, Or());
    const int m = tree(km, Min());
    Mask bits[W];
#pragma unroll
    for (int j = 0; j < W; ++j) bits[j] = (Mask)(k[j] == m) << j;
    const Mask at_min = tree(bits, Or());
    int first;
    if constexpr (W > 32) {
      first = __ffsll((long long)at_min) - 1;
    } else {
      first = __ffs((int)at_min) - 1;
    }
    const bool warm = nf >= ways;
    const int vic = warm ? first : nf;
    const int fill = warm ? m + 1 : A - 2;
    const bool hitb = v && hit, missb = v && !hit;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const bool put = missb && vic == j;
      t[j] = put ? tag : t[j];
      k[j] = (hitb && e[j]) ? A : (put ? fill : k[j]);
    }
    A = (missb && warm) ? m + 3 : A;
    nf = (missb && !warm) ? nf + 1 : nf;
    return hitb;
  }
};

template <int W, bool FULL, bool SRRIP>
__global__ void __launch_bounds__(kThreads)
rrip_scan_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.B - row0);
  const size_t sb = stage_bytes(a.tile);
  const int ntiles = (a.L + a.tile - 1) / a.tile;

  if (threadIdx.x >= 32) {  // loader warps
    const int lt = threadIdx.x - 32;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kStages;
      if (it >= kStages) bar_sync(1 + kStages + s);
      const int i0 = it * a.tile;
      load_tile(smem + s * sb, a, row0, rows, i0, min(a.tile, a.L - i0), lt);
      bar_arrive(1 + s);
    }
    return;
  }

  // The compute warp: lane = row. A lane past the block's rows walks
  // whatever its stage holds and stores nothing.
  const int lane = threadIdx.x;
  typename std::conditional<SRRIP, SrripRow<W, FULL>, FifoRow<W, FULL>>::type row;
  row.init(a.ways);
  const int ts = tag_stride(a.tile), bs = byte_stride(a.tile);
  uint8_t* out = a.hits + (size_t)(row0 + lane) * a.L;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const uint8_t* st = smem + s * sb;
    const int i0 = it * a.tile;
    const int n = min(a.tile, a.L - i0);
    const int* tg = (const int*)st + lane * ts;
    const uint8_t* vd = st + (size_t)kRows * ts * 4 + lane * bs;
    bar_sync(1 + s);
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      const uint4 vq = *(const uint4*)(vd + g0);
      const unsigned vw[4] = {vq.x, vq.y, vq.z, vq.w};
      unsigned hw[4] = {0u, 0u, 0u, 0u};
      // A group in which no row of the block has a valid step (the padding
      // past the block's longest row) changes no state: its steps are
      // skipped, one warp-uniform branch a group.
      const bool live = lane < rows && (vq.x | vq.y | vq.z | vq.w) != 0u;
      if (__any_sync(0xffffffffu, live)) {
        int tag[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; j += 4) {
          const int4 q = *(const int4*)(tg + g0 + j);
          tag[j] = q.x;
          tag[j + 1] = q.y;
          tag[j + 2] = q.z;
          tag[j + 3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const bool v = ((vw[j / 4] >> (8 * (j % 4))) & 0xffu) != 0u;
          hw[j / 4] |= (unsigned)row.step(tag[j], v) << (8 * (j % 4));
        }
      }
      if (lane < rows) {
        if (a.vec) {
          *(uint4*)(out + i0 + g0) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            if (i0 + g0 + j < a.L) out[i0 + g0 + j] = (uint8_t)(hw[j / 4] >> (8 * (j % 4)));
          }
        }
      }
    }
    if (it + kStages < ntiles) bar_arrive(1 + kStages + s);  // the loaders refill it
  }
}

// One instance: set its shared-memory limit, then report its occupancy
// (occ != nullptr) or launch it.
template <int W, bool FULL, bool SRRIP>
cudaError_t run(const Args& a, cudaStream_t stream, int* occ) {
  const auto kernel = rrip_scan_kernel<W, FULL, SRRIP>;
  const size_t smem = shared_bytes(a.tile);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (occ != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kernel, kThreads, smem);
  }
  kernel<<<(a.B + kRows - 1) / kRows, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int W, bool SRRIP>
cudaError_t by_full(const Args& a, cudaStream_t stream, int* occ) {
  if constexpr (W == 1) {
    return run<1, true, SRRIP>(a, stream, occ);
  } else {
    return a.ways == W ? run<W, true, SRRIP>(a, stream, occ)
                       : run<W, false, SRRIP>(a, stream, occ);
  }
}

template <bool SRRIP>
cudaError_t by_ways(const Args& a, cudaStream_t stream, int* occ) {
  if (a.ways <= 1) return by_full<1, SRRIP>(a, stream, occ);
  if (a.ways <= 2) return by_full<2, SRRIP>(a, stream, occ);
  if (a.ways <= 4) return by_full<4, SRRIP>(a, stream, occ);
  if (a.ways <= 8) return by_full<8, SRRIP>(a, stream, occ);
  if (a.ways <= 16) return by_full<16, SRRIP>(a, stream, occ);
  if (a.ways <= 32) return by_full<32, SRRIP>(a, stream, occ);
  return by_full<64, SRRIP>(a, stream, occ);
}

cudaError_t dispatch(const Args& a, int policy, cudaStream_t stream, int* occ) {
  if (a.ways < 1 || a.ways > kMaxWays || (policy != 0 && policy != 1) || a.L < 1) {
    return cudaErrorInvalidValue;
  }
  return policy == 1 ? by_ways<true>(a, stream, occ) : by_ways<false>(a, stream, occ);
}

}  // namespace

// Blocks of 32 rows resident on one SM of the current card, for rows of L
// steps. policy: 0 = FIFO, 1 = SRRIP.
extern "C" int rrip_scan_occupancy(int L, int ways, int policy, int* blocks) {
  const Args a{nullptr, nullptr, nullptr, kRows, L, ways, tile_of(L), false};
  return (int)dispatch(a, policy, nullptr, blocks);
}

extern "C" int rrip_scan_launch(const int* tags, const uint8_t* valid, uint8_t* hits, int B,
                                int L, int ways, int policy, void* stream) {
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15u) == 0; };
  const bool vec = L % 16 == 0 && aligned(tags) && aligned(valid) && aligned(hits);
  const Args a{tags, valid, hits, B, L, ways, tile_of(L), vec};
  return (int)dispatch(a, policy, (cudaStream_t)stream, nullptr);
}
