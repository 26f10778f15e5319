// K7: one-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces `_decode_kernel` of src/repro/kernels/decode_attention.py. For q
// (B, Hq, d), one new token per sequence, and a cache k, v (B, Hkv, S_max,
// d) whose first `valid` positions are filled, query head h = kvh * G + g
// (G = Hq / Hkv) attends over kv head kvh:
//     out = softmax(q k^T / sqrt(d), positions < valid) v
// with the reference's arithmetic: f32 scores, online softmax (running max
// and sum per head), masked scores -1e30, out = acc / max(l, 1e-30) cast to
// q's dtype.
//
// What bounds it: bytes (the cache is read once; each element feeds one or
// G multiply-adds). One block per (b, kv head): the G query heads of the
// group share each 64-position K/V tile staged in shared memory, so grouped
// heads never re-read the cache. The block stops at `valid`: positions at
// or past it are never read, which computes the reference's masked function
// with fewer bytes (stale entries there cannot matter). `valid` is a host
// int, so no device scalar is read per step. The tile's scores (one
// thread per (head, position) pair), each head's running max and sum (one
// warp per head, shuffles) and the accumulator (one thread per (head,
// column), kept in shared memory) follow in turn. Splitting S_max over
// several blocks per head, for more blocks in flight, is later work.
//
// Any d up to 256 and any S_max. q must be contiguous (B, Hq, d); k and v
// may be strided (innermost stride 1), as views of a larger cache are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;  // cache positions per tile: two per lane in the softmax
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

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t ks_b, ks_h, ks_s, vs_b, vs_h, vs_s;  // element strides of k and v
  int B, Hkv, G, d, valid;
  float scale;
};

// Shared floats: q and acc (G, d), K (BK, d+1), V (BK, d), p (G, BK), and
// m, l, alpha (G each).
__host__ __device__ inline int smem_floats(int G, int d) {
  return 2 * G * d + kBK * (d + 1) + kBK * d + G * kBK + 3 * G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  extern __shared__ float smem[];
  const int G = a.G, d = a.d, L = a.valid;
  float* qs = smem;                  // [G][d]
  float* acc = qs + G * d;           // [G][d]
  float* ks = acc + G * d;           // [BK][d+1]
  float* vs = ks + kBK * (d + 1);    // [BK][d]
  float* ps = vs + kBK * d;          // [G][BK]
  float* ms = ps + G * kBK;          // [G]
  float* ls = ms + G;                // [G]
  float* al = ls + G;                // [G]

  const int b = blockIdx.x / a.Hkv, kvh = blockIdx.x % a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t qoff = ((int64_t)b * a.Hkv + kvh) * G * d;
  const T* qb = (const T*)a.q + qoff;
  const T* kb = (const T*)a.k + b * a.ks_b + kvh * a.ks_h;
  const T* vb = (const T*)a.v + b * a.vs_b + kvh * a.vs_h;

  for (int e = tid; e < G * d; e += kThreads) {
    qs[e] = to_f32(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and p are no longer read
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const bool in = k0 + r < L;
      ks[r * (d + 1) + c] = in ? to_f32(kb[(k0 + r) * a.ks_s + c]) : 0.f;
      vs[e] = in ? to_f32(vb[(k0 + r) * a.vs_s + c]) : 0.f;
    }
    __syncthreads();

    for (int e = tid; e < G * kBK; e += kThreads) {
      const int g = e / kBK, j = e % kBK;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s += qs[g * d + c] * ks[j * (d + 1) + c];
      ps[e] = k0 + j < L ? s * a.scale : kNegInf;
    }
    __syncthreads();

    // One warp per head: the tile's max, p = exp(s - m_new), the new sum.
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = ps[g * kBK + lane], s1 = ps[g * kBK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(ms[g], mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ps[g * kBK + lane] = p0;
      ps[g * kBK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(ms[g] - m_new);
        al[g] = alpha;
        ls[g] = alpha * ls[g] + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * d; e += kThreads) {
      const int g = e / d, c = e % d;
      float x = acc[e] * al[g];
      for (int j = 0; j < kBK; ++j) x += ps[g * kBK + j] * vs[j * d + c];
      acc[e] = x;
    }
  }
  __syncthreads();

  T* ob = (T*)a.o + qoff;
  for (int e = tid; e < G * d; e += kThreads) {
    ob[e] = from_f32<T>(acc[e] / fmaxf(ls[e / d], 1e-30f));
  }
}

template <typename T>
int launch_decode(const DecodeArgs& a, cudaStream_t st) {
  const size_t bytes = (size_t)smem_floats(a.G, a.d) * sizeof(float);
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  decode_kernel<T><<<a.B * a.Hkv, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block needs for G heads of width d.
extern "C" int64_t decode_attention_smem_bytes(int G, int d) {
  return (int64_t)smem_floats(G, d) * (int64_t)sizeof(float);
}

// q (B, Hkv*G, d) contiguous, k and v (B, Hkv, S_max, d) with element
// strides (b, h, s) in `strides` (k's three, then v's), in `dtype` (0 f32,
// 1 bf16); valid in [1, S_max]; out contiguous (B, Hkv*G, d).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       const int64_t* strides, int B, int Hkv, int G, int d,
                                       int valid, float scale, int dtype, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || d < 1 || d > 256 || valid < 1 ||
      (int64_t)B * Hkv > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  DecodeArgs a{q, k, v, out, strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], B, Hkv, G, d, valid, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kDtypeF32) return launch_decode<float>(a, st);
  if (dtype == kDtypeBf16) return launch_decode<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
