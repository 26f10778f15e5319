// K7: one-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces `_decode_kernel` of src/repro/kernels/decode_attention.py. For q
// (B, Hq, d), one new token per sequence, and a cache k, v (B, Hkv, S_max,
// d) whose first `valid` positions are filled, query head h = kvh * G + g
// (G = Hq / Hkv) attends over kv head kvh:
//     out = softmax(q k^T / sqrt(d), positions < valid) v
// with f32 scores and sums and out = acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it: bytes. The cache is read once (86.5 MB at Zamba2's last
// decode step: 8 x 32 kv heads x 1,056 positions x 80 x bf16, twice), and
// each element feeds one multiply-add per query head of its group (G = 1 at
// Zamba2), far below the tensor cores' rate. So the design is about loads
// in flight, in the flash-decoding shape: two kernels on the caller's
// stream.
//
// split_kernel: one block per (chunk of C positions, b, kv head). The
// number of chunks is ceil(S_max / C), fixed by the cache and not by
// `valid`, so the grid is the same at every step (a CUDA graph of the step
// can hold it); a block whose chunk starts at or past `valid` writes an
// empty partial (m = -1e30, l = 0, acc = 0) and exits. Each thread issues
// all of its cp.async copies of the chunk's K rows and then of its V rows
// at once (16-byte copies where the row and strides allow), raw into
// shared memory in the cache's own dtype, never widened there; the copies
// stop at `valid` (predicated, never masked after loading, so stale or NaN
// entries past it cannot matter). The block computes the chunk's scores
// while its V rows are still landing: one thread per (query head, row), a
// dot product over the row's 16-byte units. A warp per query head then
// takes the chunk's max m and p = exp(s - m) and sum l, and the block forms
// acc = sum_j p_j v_j, a thread per (16-byte column unit, group of rows),
// the row groups summed in a fixed order. The G query heads of a group
// share every loaded row, so grouped heads never re-read the cache. Each
// block writes (acc[d], m, l) per query head to an f32 workspace.
//
// combine_kernel: one block per (b, query head) merges the partials of its
// chunks in chunk order by the log-sum-exp rule, M = max m_c,
// L = sum exp(m_c - M) l_c, out = sum exp(m_c - M) acc_c / max(L, 1e-30).
// No float atomics anywhere, so two calls give the same bits.
//
// C is the caller's. The wrapper's is 128 positions: of 32, 64, 128 and 256
// it is the fastest at Zamba2's decode shape on an H100
// (scripts/attention_ablation.py times them; PERF.md has the readings).
// Shorter chunks add blocks, partials and combine work; at 256 only 1,280
// blocks of ~90 KB of shared memory remain, two per SM, too few to keep the
// loads in flight while each block computes. Any d up to 256, any S_max, f32 or bf16. q
// must be contiguous (B, Hq, d); k and v may be strided (innermost stride
// 1), as views of a larger cache are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowPad = 16;  // bytes after each staged row: conflict-free 16-byte reads
constexpr float kNegInf = -1e30f;

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

// A VB-byte unit of a row, moved as one load.
template <int VB>
struct Unit;
template <>
struct Unit<16> { using type = uint4; };
template <>
struct Unit<8> { using type = uint2; };
template <>
struct Unit<4> { using type = uint32_t; };
template <>
struct Unit<2> { using type = uint16_t; };

// Copy one VB-byte unit global -> shared, asynchronously where cp.async
// takes the size (4, 8, 16 bytes).
template <int VB>
__device__ __forceinline__ void copy_unit(void* dst, const void* src) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
  } else if constexpr (VB >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src), "n"(VB)
                 : "memory");
  } else {
    *reinterpret_cast<typename Unit<VB>::type*>(dst) =
        *reinterpret_cast<const typename Unit<VB>::type*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  float* part;  // [B * Hq][nchunks][d + 2]: acc[d], m, l
  int64_t ks_b, ks_h, ks_s, vs_b, vs_h, vs_s;  // element strides of k and v
  int Hkv, G, d, valid, chunk, nchunks;
  float scale;
};

// Row groups of the p.v pass for rows of `nu` units.
__host__ __device__ inline int row_groups(int nu) { return nu >= kThreads ? 1 : kThreads / nu; }

// Shared bytes of a split block: K and V rows (C x (d*es + pad) each), then
// f32 q (G, d), scores (G, C) and the p.v row-group sums (J, G, d).
__host__ __device__ inline int64_t split_smem(int G, int d, int es, int chunk, int VB) {
  const int64_t rowp = (int64_t)d * es + kRowPad;
  const int J = row_groups(d * es >= VB ? d * es / VB : 1);
  return 2 * chunk * rowp + ((int64_t)G * d + (int64_t)G * chunk + (int64_t)J * G * d) * 4;
}

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads) split_kernel(SplitArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int W = VB / (int)sizeof(T);  // elements in a unit
  const int G = a.G, d = a.d, C = a.chunk;
  const int nu = d / W;                   // units in a row
  const int rowp = d * (int)sizeof(T) + kRowPad;
  unsigned char* kbuf = smem;
  unsigned char* vbuf = kbuf + (int64_t)C * rowp;
  float* qs = reinterpret_cast<float*>(vbuf + (int64_t)C * rowp);  // [G][d]
  float* sc = qs + G * d;                                           // [G][C]
  float* red = sc + G * C;                                          // [J][G][d]

  const int c = blockIdx.x, bk = blockIdx.y;
  const int b = bk / a.Hkv, kvh = bk % a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = c * C;
  const int n = min(C, a.valid - p0);  // rows of this chunk below `valid`
  const int64_t qrow = (int64_t)b * a.Hkv * G + (int64_t)kvh * G;  // first query head's row
  float* part = a.part + (qrow * a.nchunks + c) * (d + 2);
  const int64_t pstride = (int64_t)a.nchunks * (d + 2);              // next query head

  if (n <= 0) {  // an empty chunk
    for (int e = tid; e < G * (d + 2); e += kThreads) {
      const int g = e / (d + 2), col = e % (d + 2);
      part[g * pstride + col] = col == d ? kNegInf : 0.f;
    }
    return;
  }

  const unsigned char* kb = reinterpret_cast<const unsigned char*>(a.k) +
                            (b * a.ks_b + kvh * a.ks_h + (int64_t)p0 * a.ks_s) * sizeof(T);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(a.v) +
                            (b * a.vs_b + kvh * a.vs_h + (int64_t)p0 * a.vs_s) * sizeof(T);
  const int64_t ks_row = a.ks_s * sizeof(T), vs_row = a.vs_s * sizeof(T);
  for (int e = tid; e < n * nu; e += kThreads) {
    const int j = e / nu, u = e % nu;
    copy_unit<VB>(kbuf + j * rowp + u * VB, kb + j * ks_row + u * VB);
  }
  cp_async_commit();
  for (int e = tid; e < n * nu; e += kThreads) {
    const int j = e / nu, u = e % nu;
    copy_unit<VB>(vbuf + j * rowp + u * VB, vb + j * vs_row + u * VB);
  }
  cp_async_commit();

  const T* qb = reinterpret_cast<const T*>(a.q) + qrow * d;
  for (int e = tid; e < G * d; e += kThreads) qs[e] = to_f32(qb[e]);
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();

  // Scores: one thread per (query head, row).
  for (int e = tid; e < G * n; e += kThreads) {
    const int g = e / n, j = e % n;
    const unsigned char* row = kbuf + j * rowp;
    const float* qg = qs + g * d;
    float s = 0.f;
    for (int u = 0; u < nu; ++u) {
      const typename Unit<VB>::type raw =
          *reinterpret_cast<const typename Unit<VB>::type*>(row + u * VB);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < W; ++i) s += qg[u * W + i] * to_f32(x[i]);
    }
    sc[g * C + j] = s * a.scale;
  }
  __syncthreads();

  // The chunk's max and sum per query head, one warp each; p replaces s.
  for (int g = warp; g < G; g += kWarps) {
    float* sg = sc + g * C;
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sg[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sg[j] - mx);
      sg[j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      part[g * pstride + d] = mx;
      part[g * pstride + d + 1] = sum;
    }
  }
  cp_async_wait<0>();  // V
  __syncthreads();

  // acc = sum_j p_j v_j: thread (row group jg, unit u) sums rows jg, jg+J, ...
  const int J = row_groups(nu);
  for (int w = tid; w < J * nu; w += kThreads) {
    const int u = w % nu, jg = w / nu;
    for (int g = 0; g < G; ++g) {
      const float* pg = sc + g * C;
      float acc[W];
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = 0.f;
      for (int j = jg; j < n; j += J) {
        const typename Unit<VB>::type raw =
            *reinterpret_cast<const typename Unit<VB>::type*>(vbuf + j * rowp + u * VB);
        const T* x = reinterpret_cast<const T*>(&raw);
        const float p = pg[j];
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] += p * to_f32(x[i]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) red[(jg * G + g) * d + u * W + i] = acc[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * d; e += kThreads) {
    float x = 0.f;
    for (int jg = 0; jg < J; ++jg) x += red[jg * G * d + e];
    part[(e / d) * pstride + e % d] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(const float* part, T* out, int d,
                                                           int nchunks) {
  const int64_t row = blockIdx.x;  // b * Hq + h
  const float* pr = part + row * nchunks * (d + 2);
  float M = kNegInf;
  for (int c = 0; c < nchunks; ++c) M = fmaxf(M, pr[c * (d + 2) + d]);
  float L = 0.f;
  for (int c = 0; c < nchunks; ++c) L += expf(pr[c * (d + 2) + d] - M) * pr[c * (d + 2) + d + 1];
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float acc = 0.f;
    for (int c = 0; c < nchunks; ++c) acc += expf(pr[c * (d + 2) + d] - M) * pr[c * (d + 2) + col];
    out[row * d + col] = from_f32<T>(acc * inv);
  }
}

template <typename T, int VB>
int launch_split(const SplitArgs& a, int B, void* out, cudaStream_t st) {
  const int64_t bytes = split_smem(a.G, a.d, (int)sizeof(T), a.chunk, VB);
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in.ensure((const void*)split_kernel<T, VB>, (size_t)bytes);
  if (opted != cudaSuccess) return (int)opted;
  split_kernel<T, VB><<<dim3(a.nchunks, B * a.Hkv), kThreads, bytes, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<T><<<B * a.Hkv * a.G, kThreads, 0, st>>>(a.part, (T*)out, a.d, a.nchunks);
  return (int)cudaGetLastError();
}

// The widest unit (16, 8, 4 or 2 bytes) that divides the row, every stride
// and both cache pointers.
template <typename T>
int launch_by_unit(const SplitArgs& a, int B, void* out, cudaStream_t st) {
  uint64_t bits = (uint64_t)a.d * sizeof(T) | (uint64_t)(uintptr_t)a.k | (uint64_t)(uintptr_t)a.v;
  const int64_t strides[6] = {a.ks_b, a.ks_h, a.ks_s, a.vs_b, a.vs_h, a.vs_s};
  for (int i = 0; i < 6; ++i) bits |= (uint64_t)strides[i] * sizeof(T);
  if (bits % 16 == 0) return launch_split<T, 16>(a, B, out, st);
  if (bits % 8 == 0) return launch_split<T, 8>(a, B, out, st);
  if (bits % 4 == 0) return launch_split<T, 4>(a, B, out, st);
  if constexpr (sizeof(T) == 2) return launch_split<T, 2>(a, B, out, st);
  return (int)cudaErrorMisalignedAddress;
}

}  // namespace

// Upper bound of the shared bytes a split block needs for G heads of width
// d in `dtype` (0 f32, 1 bf16) at `chunk` positions (at the widest unit).
extern "C" int64_t decode_attention_smem_bytes(int G, int d, int dtype, int chunk) {
  return split_smem(G, d, dtype == kDtypeF32 ? 4 : 2, chunk, 16);
}

// q (B, Hkv*G, d) contiguous, k and v (B, Hkv, S_max, d) with element
// strides (b, h, s) in `strides` (k's three, then v's), in `dtype` (0 f32,
// 1 bf16); valid in [1, S_max]; `part` an f32 workspace of
// B * Hkv * G * ceil(S_max / chunk) * (d + 2) floats; out contiguous
// (B, Hkv*G, d).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       float* part, const int64_t* strides, int B, int Hkv,
                                       int G, int S_max, int d, int valid, int chunk, float scale,
                                       int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || d < 1 || d > 256 || valid < 1 || valid > S_max ||
      chunk < 1 || (int64_t)B * Hkv > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int nchunks = (S_max + chunk - 1) / chunk;
  SplitArgs a{q, k, v, part, strides[0], strides[1], strides[2], strides[3], strides[4],
              strides[5], Hkv, G, d, valid, chunk, nchunks, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kDtypeF32) return launch_by_unit<float>(a, B, out, st);
  if (dtype == kDtypeBf16) return launch_by_unit<__nv_bfloat16>(a, B, out, st);
  return (int)cudaErrorInvalidValue;
}
