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
// element gathered, far below the card's rate. K3 and K5 run one warp per
// bag, a lane holding 4 columns of a 128-column pass over the row (one
// 16-byte f32 or 8-byte bf16 load a row where D and the table's alignment
// allow it, else 4 scalar loads), and keep the indices out of the chain:
// loaded 32 at a time, coalesced, a block ahead, and handed between lanes
// by shuffle. K3 reads its rows through L2, and what sets its pace is the
// bytes that miss there and come from HBM: a table's popular rows are
// looked up by many bags, and a row read again while it is still in L2
// costs no HBM bytes. So the resident warps walk the bags table by table
// (kBagTables tables at a time, every sample of a table before the next
// table), and the L2 holds one table's re-read rows, not a share of every
// table's (on an H100, at the DLRM-RMC2 batches of 4,096 samples, this cut
// K3's time by 17-24% against a walk sample by sample across all tables).
// Where most lookups hit, what is left is the L2's delivery of the hits:
// each lane issues the loads of a group of kBagRows rows before it adds
// any of them. K4 copies rows a warp each, 16 bytes a lane where it can.
// K5 reads its table from device memory once per resident block instead
// of once per lookup; its lookups then read shared memory, so what bounds
// it on the card is the chain of L dependent adds of each bag: it spreads
// the bags over every SM.
//
// Summation order is the reference's: each output column adds its rows in
// l = 0..L-1 order with __fadd_rn (K5: __fmul_rn then __fadd_rn; the
// library is built with -fmad=false), so a kernel equals its plain torch
// version bit for bit. The one exception is a K5 hot table that does not
// fit one block's shared memory: the kernel then stages it in tiles of
// rows, one after the other, and each lookup adds in the tile that holds
// its position, so the sum is taken tile by tile.
//
// Indices are int32, as in the reference; element offsets are 64-bit (the
// full DLRM table has 7.68e9 elements). An index outside the table reads
// the row the reference's gathers read (see clamp_row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;
constexpr unsigned kFull = 0xffffffffu;
// K3: warps of a block, one bag each; rows a lane loads before adding them;
// tables walked at a time (a group as wide as T walks bag-major, sample by
// sample across every table).
constexpr int kBagWarps = 4;
constexpr int kBagRows = 16;
constexpr int kBagTables = 1;
// K5: warps of a block, one bag each.
constexpr int kPoolMaxWarps = 32;

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

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// K3's walk: the k-th bag a warp of the launch takes is bag (b, t), row b *
// T + t of `out` and of the indices, with the tables kBagTables at a time
// and, inside a group of tables, sample by sample. With one table at a
// time the resident warps gather from one table (or the seam of two) at
// once, so the rows that table's bags read again are still in L2 (and
// often in the SM's L1) when they come back.
__device__ __forceinline__ int64_t walk_bag(int64_t k, int64_t B, int T) {
  const int64_t t0 = k / (B * kBagTables) * kBagTables;  // the group's first table
  const int64_t w = T - t0 < kBagTables ? T - t0 : kBagTables;  // its tables
  const int64_t r = k - t0 * B;
  return r / w * T + t0 + r % w;
}

// K3. One warp per bag, grid-stride over the walk (warp w of the launch
// takes walk positions w, w + the launch's warps, ...). A lane owns 4
// columns of each pass of 128 over D: 4 consecutive ones (c0 + 4 lane +
// e), read as one 16-byte (f32) or 8-byte (bf16) load, when VEC (D % 4 ==
// 0 and the table aligned for it); else every 32nd (c0 + lane + 32 e),
// scalar loads. The warp loads its bag's indices 32 at a time, coalesced,
// one block ahead of the block it sums (the next pass's or the next bag's
// first block after the last), and hands each row's index from lane to
// lane by shuffle. A group of U rows is loaded before any of it is added,
// straight-line: a position past L (the last group's tail) loads row 0
// and adds +0, which leaves every sum as skipping it would (sums never
// hold -0); columns past D load column 0 and are not stored. Each column
// adds in l order, whatever the walk. Its pace is set by the HBM bytes of
// its L2 misses, which the walk keeps down (walk_bag).
template <typename T, bool VEC, int U>
__global__ void __launch_bounds__(32 * kBagWarps)
bag_kernel(const T* __restrict__ table, const int* __restrict__ idx, int64_t rows,
           int64_t bags, int tables, int L, int D, T* __restrict__ out) {
  static_assert(32 % U == 0, "a group of rows stays inside a block of 32 indices");
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kBagWarps;
  const int64_t B = bags / tables;
  int64_t k = (int64_t)blockIdx.x * kBagWarps + threadIdx.x / 32;
  int64_t bag = k < bags ? walk_bag(k, B, tables) : 0;
  int next = k < bags && lane < L ? idx[bag * L + lane] : 0;
  for (; k < bags; k += warps) {
    const int64_t after = k + warps < bags ? walk_bag(k + warps, B, tables) : -1;
    for (int c0 = 0; c0 < D; c0 += 128) {
      int col[4], ld[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        col[e] = VEC ? c0 + 4 * lane + e : c0 + lane + 32 * e;
        ld[e] = col[e] < D ? col[e] : 0;
      }
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int l0 = 0; l0 < L; l0 += 32) {
        const int cur = next;
        // the block after this one, in flight while this one is summed
        const int64_t nb = l0 + 32 < L || c0 + 128 < D ? bag : after;
        const int nl = (l0 + 32 < L ? l0 + 32 : 0) + lane;
        next = nb >= 0 && nl < L ? idx[nb * L + nl] : 0;
        const int n = min(32, L - l0);
        for (int g = 0; g < n; g += U) {
          float r[U][4];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int q = __shfl_sync(kFull, cur, g + u);
            const T* row = table + clamp_row(q, rows) * D;
            if (VEC) {
              load4<T>(row + ld[0], r[u]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) r[u][e] = to_f32(row[ld[e]]);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], g + u < n ? r[u][e] : 0.0f);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col[e] < D) out[bag * D + col[e]] = from_f32<T>(acc[e]);
      }
    }
    bag = after;
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

// K5. One warp per bag, columns across lanes; blocks of up to 32 warps,
// each staging the hot table tile by tile in shared memory (cp.async, 16
// bytes a thread, while the warps load their first bag's indices) and, per
// tile, walking its bags (warp w: bags blockIdx.x * warps + w, then +
// gridDim.x * warps, ...). A lane owns a few columns of a pass over D: 4
// consecutive ones per group of 32 lanes (one 16-byte f32 or 8-byte bf16
// shared load) when D % 4 == 0, else every 32nd (scalar loads). The warp
// loads 32 positions and masks at a time, coalesced, one block of 32 ahead
// of the one it sums, and hands each step's position and mask from lane to
// lane by shuffle, so no step of the chain waits on device memory. A bag's
// running sums live in registers within a tile and in `scratch` (f32,
// (bags, D)) between tiles; with one tile, scratch is not touched.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

// VEC: a lane's columns are VPL groups of 4 consecutive ones (c0 + 4 (lane
// + 32 v) + e), read as one 16-byte (f32) or 8-byte (bf16) shared load;
// else VPL single columns (c0 + lane + 32 u). A pass covers 32 * KC columns.
template <typename T, bool VEC, int VPL>
__global__ void __launch_bounds__(32 * kPoolMaxWarps)
pool_kernel(const T* __restrict__ hot, const int* __restrict__ pos,
            const int* __restrict__ mask, int H, int64_t bags, int L, int D,
            int tile_rows, float* __restrict__ scratch, T* __restrict__ out) {
  constexpr int KC = VEC ? 4 * VPL : VPL;  // columns a lane sums per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int64_t first_bag = (int64_t)blockIdx.x * warps + threadIdx.x / 32;
  const int64_t bag_step = (int64_t)gridDim.x * warps;
  const int ntiles = (H + tile_rows - 1) / tile_rows;
  for (int k = 0; k < ntiles; ++k) {
    const int h0 = k * tile_rows;
    const int nh = min(tile_rows, H - h0);
    const bool first = k == 0;
    const bool last = k == ntiles - 1;
    __syncthreads();  // every warp is done with the previous tile
    const T* src = hot + (int64_t)h0 * D;
    const int64_t nbytes = (int64_t)nh * D * sizeof(T);
    if ((uintptr_t)src % 16 == 0 && nbytes % 16 == 0) {
      for (int64_t e = threadIdx.x; e < nbytes / 16; e += blockDim.x) {
        cp_async16(smem_raw + 16 * e, reinterpret_cast<const unsigned char*>(src) + 16 * e);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      for (int64_t e = threadIdx.x; e < (int64_t)nh * D; e += blockDim.x) tile[e] = src[e];
    }
    // the first bag's first block of indices, loaded while the tile lands
    int pn = 0, mn = 0;
    if (first_bag < bags && lane < L) {
      pn = pos[first_bag * L + lane];
      mn = mask[first_bag * L + lane];
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int64_t bag = first_bag; bag < bags; bag += bag_step) {
      const int* p = pos + bag * L;
      const int* m = mask + bag * L;
      for (int c0 = 0; c0 < D; c0 += 32 * KC) {
        if (bag != first_bag || c0 != 0) {
          pn = lane < L ? p[lane] : 0;
          mn = lane < L ? m[lane] : 0;
        }
        // this lane's columns; loads of columns past D read column 0 and
        // their sums are never stored, so the loop below has no branch
        int col[KC], ld[VPL];
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          col[u] = VEC ? c0 + 4 * (lane + 32 * (u / 4)) + u % 4 : c0 + lane + 32 * u;
        }
#pragma unroll
        for (int v = 0; v < VPL; ++v) ld[v] = col[VEC ? 4 * v : v] < D ? col[VEC ? 4 * v : v] : 0;
        float acc[KC];
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          acc[u] = (first || col[u] >= D) ? 0.0f : scratch[bag * D + col[u]];
        }
        for (int l0 = 0; l0 < L; l0 += 32) {
          const int q = (int)clamp_row(pn, H) - h0;
          const float mf = (float)mn;
          // the next block of 32, in flight while this one is summed
          const int ln = l0 + 32 + lane;
          pn = ln < L ? p[ln] : 0;
          mn = ln < L ? m[ln] : 0;
          const int n = min(32, L - l0);
          // straight-line and unrolled, so that the shuffles and shared
          // loads of later steps issue ahead of this step's adds (which
          // stay in l order). A position outside this tile adds +0, which
          // leaves every sum as skipping it would (sums never hold -0).
#pragma unroll 8
          for (int i = 0; i < n; ++i) {
            const int qi = __shfl_sync(0xffffffffu, q, i);
            const float mi = __shfl_sync(0xffffffffu, mf, i);
            const bool in = qi >= 0 && qi < nh;
            const T* row = tile + (int64_t)(in ? qi : 0) * D;
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
              float r[4];
              if (VEC) {
                load4<T>(row + ld[v], r);
              } else {
                r[0] = to_f32(row[ld[v]]);
              }
#pragma unroll
              for (int e = 0; e < (VEC ? 4 : 1); ++e) {
                const int u = VEC ? 4 * v + e : v;
                acc[u] = __fadd_rn(acc[u], in ? __fmul_rn(mi, r[e]) : 0.0f);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          if (col[u] >= D) continue;
          if (last) {
            out[bag * D + col[u]] = from_f32<T>(acc[u]);
          } else {
            scratch[bag * D + col[u]] = acc[u];
          }
        }
      }
    }
  }
}

// Blocks of K3's kernel resident on one SM of the current card.
template <typename T, bool VEC>
int bag_blocks_per_sm() {
  static PerDevice<int> n;
  return n.get([] {
    int b = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, bag_kernel<T, VEC, kBagRows>, 32 * kBagWarps, 0);
    return e == cudaSuccess ? b : 0;
  });
}

// A bag a warp while the card holds them all at once; past that, the grid
// is what the card holds (one wave) and each warp takes several bags.
template <typename T, bool VEC>
int launch_bag_as(const void* table, const int* idx, int64_t rows, int64_t bags, int tables,
                  int L, int D, int sms, void* out, cudaStream_t st) {
  const int64_t cap = (int64_t)sms * bag_blocks_per_sm<T, VEC>();
  if (cap < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t want = (bags + kBagWarps - 1) / kBagWarps;
  bag_kernel<T, VEC, kBagRows><<<(unsigned)(want < cap ? want : cap), 32 * kBagWarps, 0, st>>>(
      (const T*)table, idx, rows, bags, tables, L, D, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bag(const void* table, const int* idx, int64_t rows, int64_t bags, int tables, int L,
               int D, int sms, void* out, cudaStream_t st) {
  if (D % 4 == 0 && (uintptr_t)table % (4 * sizeof(T)) == 0) {
    return launch_bag_as<T, true>(table, idx, rows, bags, tables, L, D, sms, out, st);
  }
  return launch_bag_as<T, false>(table, idx, rows, bags, tables, L, D, sms, out, st);
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

// Opts every pool_kernel<T, ...> in to the device's largest dynamic shared
// memory: one value for every table, so a later call never lowers it under
// an earlier one's tile.
template <typename T>
cudaError_t pool_optin(int optin) {
  cudaError_t e = cudaFuncSetAttribute(pool_kernel<T, true, 1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(pool_kernel<T, true, 2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(pool_kernel<T, false, 8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  return e;
}

// The opt-in, and how many blocks of 32 warps with a tile of tile_rows x D
// stay resident on the whole card.
template <typename T>
int prepare_pool(int D, int tile_rows, int* blocks) {
  const size_t smem = (size_t)tile_rows * D * sizeof(T);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess && smem > 48 * 1024) e = pool_optin<T>(optin);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pool_kernel<T, false, 8>,
                                                      32 * kPoolMaxWarps, smem);
  }
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  return 0;
}

// Warps per block: the bags spread over every resident block, at most 32
// warps a block.
int pool_warps(int64_t bags, int max_blocks) {
  const int64_t w = (bags + max_blocks - 1) / max_blocks;
  return (int)(w < 1 ? 1 : (w > kPoolMaxWarps ? kPoolMaxWarps : w));
}

template <typename T>
int launch_pool(const void* hot, const int* pos, const int* mask, int H, int64_t bags,
                int L, int D, int tile_rows, int max_blocks, float* scratch, void* out,
                cudaStream_t st) {
  const int warps = pool_warps(bags, max_blocks);
  const size_t smem = (size_t)tile_rows * D * sizeof(T);
  const int64_t want = (bags + warps - 1) / warps;
  const int grid = (int)(want < max_blocks ? want : max_blocks);
  const T* h = (const T*)hot;
  T* o = (T*)out;
  if (D % 4) {
    pool_kernel<T, false, 8><<<grid, 32 * warps, smem, st>>>(h, pos, mask, H, bags, L, D,
                                                            tile_rows, scratch, o);
  } else if (D <= 128) {
    pool_kernel<T, true, 1><<<grid, 32 * warps, smem, st>>>(h, pos, mask, H, bags, L, D,
                                                           tile_rows, scratch, o);
  } else {
    pool_kernel<T, true, 2><<<grid, 32 * warps, smem, st>>>(h, pos, mask, H, bags, L, D,
                                                           tile_rows, scratch, o);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// All return a cudaError_t code (0 = launched). `dtype`: 0 = f32, 1 = bf16.

// `bags` = B * T, each table's B bags: bag (b, t) is row b * T + t of `idx`
// (L indices) and of `out`.
extern "C" int embedding_bag_launch(const void* table, const int* idx, int64_t rows,
                                    int64_t bags, int T, int L, int D, int dtype, int sms,
                                    void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (sms < 1 || L < 0 || T < 1 || bags % T) return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeF32) {
    return launch_bag<float>(table, idx, rows, bags, T, L, D, sms, out, st);
  }
  if (dtype == kDtypeBf16) {
    return launch_bag<__nv_bfloat16>(table, idx, rows, bags, T, L, D, sms, out, st);
  }
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
