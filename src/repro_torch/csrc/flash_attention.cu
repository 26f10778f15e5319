// K6: tiled online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces `_flash_kernel` of src/repro/kernels/flash_attention.py. For q
// (B,Hq,S,d) and k, v (B,Hkv,S,d), query head h reads kv head
// h / (Hq / Hkv) (GQA, MQA), and
//     out = softmax(q k^T * sm_scale [+ causal mask]) v
// with the reference's arithmetic: f32 scores and accumulator, masked
// scores set to -1e30, running max m and sum l per query row, and
// out = acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it: operations. One block per (b, h, 64-row q tile) keeps its
// q tile and, for each query row, the online-softmax state (m, l and the
// d-wide accumulator) on chip, so the (S, S) scores never exist in device
// memory. It walks the 64-row k/v tiles in order, staging each in shared
// memory (K transposed), and computes the 64 x 64 scores and the p.v
// update with scalar f32 FMAs, each thread holding a 4 x 4 tile of scores
// and a 4 x (16-column stride) tile of the accumulator in registers; a row's
// max and sum are reduced across the 16 threads that share it with warp
// shuffles. In causal mode it stops at the tile that holds the q tile's
// last row (the reference's skip of blocks with ik*bk > (iq+1)*bq - 1) and
// masks the columns past each row. Tensor cores (wgmma) are later work.
//
// Any d up to 256 (a template on the accumulator's column tiles), any S:
// rows and columns past S are zero-padded in shared memory, masked, and
// never written. q, k and v may be strided views (the innermost dimension
// has stride 1); the output is contiguous (B,Hq,S,d) in q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;
constexpr int kThreads = 256;  // 16 (rows) x 16 (columns)
constexpr int kBQ = 64;        // q rows of a block: 16 x kRows
constexpr int kBK = 64;        // k/v rows of a tile: 16 x kCols
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
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

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides (b, h, s) of q, k, v
  int64_t qs_b, qs_h, qs_s, ks_b, ks_h, ks_s, vs_b, vs_h, vs_s;
  int B, Hq, Hkv, S, d, causal;
  float scale;
};

// Shared floats: q (BQ, d+1), K^T (d, BK+1), V (BK, d), p (BQ, BK+1).
__host__ __device__ inline int smem_floats(int d) {
  return kBQ * (d + 1) + d * (kBK + 1) + kBK * d + kBQ * (kBK + 1);
}

// Max and sum over the 16 threads (one half-warp) that share a query row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// CC = column tiles of the accumulator: thread column tx covers d columns
// tx + 16 * cc for cc < CC, so d <= 16 * CC.
template <typename T, int CC>
__global__ void __launch_bounds__(kThreads) flash_kernel(FlashArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, S = a.S;
  float* qs = smem;                    // [BQ][d+1]
  float* kT = qs + kBQ * (d + 1);      // [d][BK+1]
  float* vs = kT + d * (kBK + 1);      // [BK][d]
  float* ps = vs + kBK * d;            // [BQ][BK+1]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = (const T*)a.q + b * a.qs_b + h * a.qs_h;
  const T* kb = (const T*)a.k + b * a.ks_b + kvh * a.ks_h;
  const T* vb = (const T*)a.v + b * a.vs_b + kvh * a.vs_h;

  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e % d;
    qs[r * (d + 1) + c] = q0 + r < S ? to_f32(qb[(q0 + r) * a.qs_s + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][CC];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) acc[ii][cc] = 0.f;
  }

  // Causal: tiles past the q tile's last row are fully masked; skip them.
  const int k_end = a.causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and p are no longer read
    for (int e = tid; e < kBK * d; e += kThreads) {
      const int r = e / d, c = e % d;
      const bool in = k0 + r < S;
      kT[c * (kBK + 1) + r] = in ? to_f32(kb[(k0 + r) * a.ks_s + c]) : 0.f;
      vs[e] = in ? to_f32(vb[(k0 + r) * a.vs_s + c]) : 0.f;
    }
    __syncthreads();

    // Scores of rows ty*kRows + ii, columns tx + 16*jj.
    float s[kRows][kCols];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) s[ii][jj] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) qv[ii] = qs[(ty * kRows + ii) * (d + 1) + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) kv[jj] = kT[c * (kBK + 1) + tx + 16 * jj];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) s[ii][jj] += qv[ii] * kv[jj];
    }

#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
      const int row = q0 + ty * kRows + ii;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int col = k0 + tx + 16 * jj;
        float x = s[ii][jj] * a.scale;
        if (col >= S || (a.causal && col > row)) x = kNegInf;
        s[ii][jj] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[ii], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float p = expf(s[ii][jj] - m_new);
        ps[(ty * kRows + ii) * (kBK + 1) + tx + 16 * jj] = p;
        sum += p;
      }
      const float alpha = expf(m[ii] - m_new);
      l[ii] = alpha * l[ii] + row_sum(sum);
      m[ii] = m_new;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) acc[ii][cc] *= alpha;
    }
    __syncthreads();

    // acc[i][c] += sum_j p[i][j] v[j][c], columns c = tx + 16*cc.
    for (int j = 0; j < kBK; ++j) {
      float vv[CC], pv[kRows];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int c = tx + 16 * cc;
        vv[cc] = c < d ? vs[j * d + c] : 0.f;
      }
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) pv[ii] = ps[(ty * kRows + ii) * (kBK + 1) + j];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) acc[ii][cc] += pv[ii] * vv[cc];
    }
  }

  T* ob = (T*)a.o + ((int64_t)b * a.Hq + h) * S * d;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int row = q0 + ty * kRows + ii;
    if (row < S) {
      const float inv_l = 1.f / fmaxf(l[ii], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int c = tx + 16 * cc;
        if (c < d) ob[(int64_t)row * d + c] = from_f32<T>(acc[ii][cc] * inv_l);
      }
    }
  }
}

template <typename T, int CC>
int launch_flash(const FlashArgs& a, cudaStream_t st) {
  const size_t bytes = (size_t)smem_floats(a.d) * sizeof(float);
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, CC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  dim3 grid((a.S + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_kernel<T, CC><<<grid, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_by_width(const FlashArgs& a, cudaStream_t st) {
  if (a.d <= 16) return launch_flash<T, 1>(a, st);
  if (a.d <= 32) return launch_flash<T, 2>(a, st);
  if (a.d <= 64) return launch_flash<T, 4>(a, st);
  if (a.d <= 80) return launch_flash<T, 5>(a, st);
  if (a.d <= 128) return launch_flash<T, 8>(a, st);
  return launch_flash<T, 16>(a, st);
}

}  // namespace

// q (B,Hq,S,d), k and v (B,Hkv,S,d) in `dtype` (0 f32, 1 bf16), each with
// the element strides (b, h, s) in `strides` (q's three, then k's, then
// v's); out contiguous (B,Hq,S,d) in `dtype`.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const int64_t* strides, int B, int Hq, int Hkv, int S,
                                      int d, int causal, float scale, int dtype, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 || Hq % Hkv != 0 || S < 1 ||
      d < 1 || d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  FlashArgs a{q, k, v, out,
              strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
              strides[6], strides[7], strides[8], B, Hq, Hkv, S, d, causal ? 1 : 0, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kDtypeF32) return launch_by_width<float>(a, st);
  if (dtype == kDtypeBf16) return launch_by_width<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
