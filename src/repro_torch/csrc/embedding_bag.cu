// K3, K4, K5: the embedding kernels for Hopper (sm_90a).
//
// Replace the three Pallas kernels of src/repro/kernels/embedding_bag.py:
//   * K3 `_bag_kernel` (embedding bag): per (b, t) bag, gather L rows of the
//     stacked (T*R, D) table by pre-offset int32 indices and sum them in f32,
//     in l order; cast once to the table dtype -> (B, T, D);
//   * K4 `_gather_kernel` (row gather): (N,) int32 -> (N, D), a copy;
//   * K5 `_vmem_pool_kernel` (hot-pinned pool, the paper's Profiling policy):
//     the hot table (H, D) is held on chip (VMEM on the TPU, shared memory
//     here) and each bag sums mask * hot[pos] over l in f32, in l order.
//
// What bounds them: bytes. Each is a gather whose row addresses come from
// data; the arithmetic is one f32 add (K5: a multiply and an add) per
// element gathered, far below the card's rate. The designs keep the loads
// coalesced (a bag's columns go across consecutive threads, so a warp reads
// 32 consecutive elements of one row) and keep many rows in flight (the
// loads of a bag do not depend on its running sum, so the unrolled loop
// issues them ahead of the adds). K5 reads its table from device memory
// once per resident block instead of once per lookup.
//
// Summation order is the reference's: one thread owns one output column and
// adds rows in l = 0..L-1 order with __fadd_rn (K5: __fmul_rn then
// __fadd_rn; the library is built with -fmad=false), so a kernel equals its
// plain torch version bit for bit. The one exception is a K5 hot table that
// does not fit one block's shared memory: the kernel then stages it in
// tiles of rows, one after the other, and each lookup adds in the tile that
// holds its position, so the sum is taken tile by tile.
//
// Indices are int32, as in the reference; element offsets are 64-bit (the
// full DLRM table has 7.68e9 elements). An index outside the table reads
// the row the reference's gathers read (see clamp_row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;
// Threads of one block. A bag's columns take col_threads = min(D rounded up
// to a warp, 256) of them; the block handles 512 / col_threads bags at once.
constexpr int kBlockThreads = 512;
constexpr int kMaxColThreads = 256;
constexpr int kMaxGroups = kBlockThreads / 32;
// K3 stages this many indices of each bag in shared memory at a time.
constexpr int kChunk = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The reference's row of index r (its gathers index as numpy does, then
// clamp): a negative r counts from the end, and a row still outside the
// table is clamped to the nearest one.
__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t rows) {
  if (r < 0) r += rows;
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

int col_threads_for(int D) {
  const int c = (D + 31) / 32 * 32;
  return c < kMaxColThreads ? c : kMaxColThreads;
}

// K3. Group g of the block owns bag blockIdx.x * groups + g; its threads
// stride over the D columns. Every thread reaches every __syncthreads (the
// loops around them have the same trip counts in the whole block).
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
bag_kernel(const T* __restrict__ table, const int* __restrict__ idx, int64_t rows,
           int64_t bags, int L, int D, int col_threads, T* __restrict__ out) {
  __shared__ int idx_s[kMaxGroups][kChunk];
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
    for (int l0 = 0; l0 < L; l0 += kChunk) {
      const int n = min(kChunk, L - l0);
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

// K4. One warp per output row, grid-stride; a row is copied in units of U
// (16 bytes where the row size and both pointers allow it).
template <typename U>
__global__ void gather_kernel(const U* __restrict__ table, const int* __restrict__ idx,
                              int64_t rows, int64_t n, int units, U* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps_per_block = blockDim.x / 32;
  const int64_t stride = (int64_t)gridDim.x * warps_per_block;
  for (int64_t i = (int64_t)blockIdx.x * warps_per_block + threadIdx.x / 32; i < n; i += stride) {
    const U* src = table + clamp_row(idx[i], rows) * units;
    U* dst = out + i * units;
    for (int u = lane; u < units; u += 32) dst[u] = src[u];
  }
}

// K5. Persistent blocks; each stages the hot table tile by tile in shared
// memory and, per tile, walks its bags (group g: bags blockIdx.x * groups +
// g, then + gridDim.x * groups, ...). A bag's running sums live in
// registers within a tile and in `scratch` (f32, (bags, D)) between tiles;
// with one tile, scratch is not touched.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
pool_kernel(const T* __restrict__ hot, const int* __restrict__ pos,
            const int* __restrict__ mask, int H, int64_t bags, int L, int D,
            int tile_rows, int col_threads, float* __restrict__ scratch,
            T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int groups = blockDim.x / col_threads;
  const int g = threadIdx.x / col_threads;
  const int c = threadIdx.x % col_threads;
  const int ntiles = (H + tile_rows - 1) / tile_rows;
  for (int k = 0; k < ntiles; ++k) {
    const int h0 = k * tile_rows;
    const int nh = min(tile_rows, H - h0);
    const bool first = k == 0;
    const bool last = k == ntiles - 1;
    __syncthreads();
    const int64_t n_el = (int64_t)nh * D;
    const T* src = hot + (int64_t)h0 * D;
    for (int64_t e = threadIdx.x; e < n_el; e += blockDim.x) tile[e] = src[e];
    __syncthreads();
    for (int64_t bag = (int64_t)blockIdx.x * groups + g; bag < bags;
         bag += (int64_t)gridDim.x * groups) {
      const int* p = pos + bag * L;
      const int* m = mask + bag * L;
      for (int col = c; col < D; col += col_threads) {
        float acc = first ? 0.0f : scratch[bag * D + col];
#pragma unroll 4
        for (int l = 0; l < L; ++l) {
          const int q = (int)clamp_row(p[l], H) - h0;
          if (q >= 0 && q < nh) {
            acc = __fadd_rn(acc, __fmul_rn((float)m[l], to_f32(tile[(int64_t)q * D + col])));
          }
        }
        if (last) {
          out[bag * D + col] = from_f32<T>(acc);
        } else {
          scratch[bag * D + col] = acc;
        }
      }
    }
  }
}

template <typename T>
int launch_bag(const void* table, const int* idx, int64_t rows, int64_t bags, int L,
               int D, void* out, cudaStream_t st) {
  const int col_threads = col_threads_for(D);
  const int groups = kBlockThreads / col_threads;
  const int64_t grid = (bags + groups - 1) / groups;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  bag_kernel<T><<<(unsigned)grid, col_threads * groups, 0, st>>>(
      (const T*)table, idx, rows, bags, L, D, col_threads, (T*)out);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_gather(const void* table, const int* idx, int64_t rows, int64_t n,
                  int row_bytes, int sms, void* out, cudaStream_t st) {
  const int threads = 256;
  const int64_t want = (n + threads / 32 - 1) / (threads / 32);
  const int64_t cap = (int64_t)sms * 8;
  const int grid = (int)(want < cap ? want : cap);
  gather_kernel<U><<<grid, threads, 0, st>>>((const U*)table, idx, rows, n,
                                             row_bytes / (int)sizeof(U), (U*)out);
  return (int)cudaGetLastError();
}

int pool_threads(int D) {
  const int col_threads = col_threads_for(D);
  return col_threads * (kBlockThreads / col_threads);
}

// Opts pool_kernel<T> in to the device's largest dynamic shared memory (one
// value for every table, so a later call never lowers it under an earlier
// one's tile) and returns how many blocks with a tile of tile_rows x D stay
// resident on the whole card.
template <typename T>
int prepare_pool(int D, int tile_rows, int* blocks) {
  const size_t smem = (size_t)tile_rows * D * sizeof(T);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pool_kernel<T>, pool_threads(D),
                                                      smem);
  }
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

template <typename T>
int launch_pool(const void* hot, const int* pos, const int* mask, int H, int64_t bags,
                int L, int D, int tile_rows, int max_blocks, float* scratch, void* out,
                cudaStream_t st) {
  const int col_threads = col_threads_for(D);
  const int groups = kBlockThreads / col_threads;
  const size_t smem = (size_t)tile_rows * D * sizeof(T);
  const int64_t want = (bags + groups - 1) / groups;
  const int grid = (int)(want < max_blocks ? want : max_blocks);
  pool_kernel<T><<<grid, pool_threads(D), smem, st>>>((const T*)hot, pos, mask, H, bags, L, D,
                                                       tile_rows, col_threads, scratch, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// All return a cudaError_t code (0 = launched). `dtype`: 0 = f32, 1 = bf16.

extern "C" int embedding_bag_launch(const void* table, const int* idx, int64_t rows,
                                    int64_t bags, int L, int D, int dtype, void* out,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kDtypeF32) return launch_bag<float>(table, idx, rows, bags, L, D, out, st);
  if (dtype == kDtypeBf16) return launch_bag<__nv_bfloat16>(table, idx, rows, bags, L, D, out, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int embedding_gather_launch(const void* table, const int* idx, int64_t rows,
                                       int64_t n, int row_bytes, int sms, void* out,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (sms < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0) return launch_gather<uint4>(table, idx, rows, n, row_bytes, sms, out, st);
  if (align % 8 == 0) return launch_gather<uint2>(table, idx, rows, n, row_bytes, sms, out, st);
  if (align % 4 == 0) {
    return launch_gather<uint32_t>(table, idx, rows, n, row_bytes, sms, out, st);
  }
  if (align % 2 == 0) {
    return launch_gather<uint16_t>(table, idx, rows, n, row_bytes, sms, out, st);
  }
  return launch_gather<uint8_t>(table, idx, rows, n, row_bytes, sms, out, st);
}

// Rows of a hot table with rows of `row_bytes` that one block's shared
// memory holds on the current device (0 if not even one row fits).
extern "C" int vmem_pool_tile_rows(int row_bytes, int* tile_rows) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  *tile_rows = row_bytes > 0 ? optin / row_bytes : 0;
  return 0;
}

// Once per (dtype, D, tile_rows), before the first launch with them: the
// shared-memory opt-in, and the resident blocks that cap the launch's grid.
extern "C" int vmem_pool_prepare(int dtype, int D, int tile_rows, int* max_blocks) {
  if (D < 1 || tile_rows < 1) return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeF32) return prepare_pool<float>(D, tile_rows, max_blocks);
  if (dtype == kDtypeBf16) return prepare_pool<__nv_bfloat16>(D, tile_rows, max_blocks);
  return (int)cudaErrorInvalidValue;
}

extern "C" int vmem_gather_pool_launch(const void* hot, const int* pos, const int* mask,
                                       int H, int64_t bags, int L, int D, int tile_rows,
                                       int max_blocks, int dtype, float* scratch, void* out,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (H < 1 || tile_rows < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  if (tile_rows < H && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeF32) {
    return launch_pool<float>(hot, pos, mask, H, bags, L, D, tile_rows, max_blocks, scratch,
                              out, st);
  }
  if (dtype == kDtypeBf16) {
    return launch_pool<__nv_bfloat16>(hot, pos, mask, H, bags, L, D, tile_rows, max_blocks,
                                      scratch, out, st);
  }
  return (int)cudaErrorInvalidValue;
}
