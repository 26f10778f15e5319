// K8: the chunked Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces `_ssd_kernel` of src/repro/kernels/mamba2_ssd.py. Per batch b and
// head h (ngroups = 1), with x (B,H,S,P), adt = A*dt and dt (B,H,S) in f32,
// B and C (B,S,N):
//     state_t = exp(adt_t) * state_{t-1} + dt_t * x_t (x) B_t      (P, N)
//     y_t     = state_t @ C_t                                      (P,)
// computed chunk by chunk as the reference does. Inside a chunk of Q steps,
// with cum the inclusive cumsum of adt over the chunk:
//     y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//          + exp(cum_i) C_i . state                                  (inter)
//     state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
//
// What bounds it: operations. One block per (b, h) walks its S / Q chunks in
// order, the (P, N) f32 state kept in shared memory the whole way: that
// carried state is the TPU kernel's VMEM scratch, and the chunk walk is the
// sequential grid axis the TPU ran in order. Per chunk the block stages x,
// B and C (converted to f32) and the chunk's adt and dt in shared memory,
// then runs four small products with scalar f32 FMAs, each thread holding a
// register tile of outputs: C.state^T, the (Q, Q) decayed scores (only the
// column blocks on or below the diagonal of its warp's rows), scores.x, and
// the state update. The tiles are laid out so that a warp's threads read
// consecutive words or one broadcast word (B and C transposed, rows padded
// to Q + 1). Tensor cores (wgmma) are later work.
//
// A ragged last chunk is padded with x = B = C = adt = dt = 0: adt = 0 keeps
// the cumsum flat and dt = 0 adds nothing to the state or to any output, so
// the padded rows are computed and never written. The inputs may be strided
// views (x is a transpose of a reshape, B and C column slices of one
// projection in the Mamba2 block): every element offset comes from the
// strides the wrapper passes; the innermost dimension has stride 1. y is
// written contiguous (B,H,S,P) in x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxQ = 128;     // rows of a chunk: 16 thread rows x kRowsPerThread
constexpr int kRowsPerThread = kMaxQ / 16;
constexpr int kMaxP = 64;      // y and state columns: 16 threads x kColTiles
constexpr int kColTiles = kMaxP / 16;
constexpr int kMaxN = 128;     // state rows: 16 threads x kStateTiles
constexpr int kStateTiles = kMaxN / 16;

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

struct SsdArgs {
  const void* x;
  const float* adt;
  const float* dt;
  const void* bm;
  const void* cm;
  void* y;
  // element strides: x (b, h, s), adt (b, h, s), dt (b, h, s), B (b, s), C (b, s)
  int64_t xs_b, xs_h, xs_s, as_b, as_h, as_s, ds_b, ds_h, ds_s, bs_b, bs_s, cs_b, cs_s;
  int B, H, S, P, N, Q;
};

// Shared floats of one block: x (Q,P), C^T and B^T (N, Q+1), state^T (N,P),
// scores (Q, Q+1), and the chunk's cumsum, dt and state weights (Q each).
__host__ __device__ inline int64_t smem_floats(int Q, int P, int N) {
  const int64_t lq = Q + 1;
  return (int64_t)Q * P + 2 * (int64_t)N * lq + (int64_t)N * P + (int64_t)Q * lq + 3 * (int64_t)Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  const int Q = a.Q, P = a.P, N = a.N, S = a.S;
  const int LQ = Q + 1;
  float* xs = smem;             // [Q][P]
  float* cT = xs + Q * P;       // [N][LQ]
  float* bT = cT + N * LQ;      // [N][LQ]
  float* stT = bT + N * LQ;     // [N][P], the carried state, transposed
  float* sc = stT + N * P;      // [Q][LQ]
  float* cum = sc + Q * LQ;     // [Q]
  float* dts = cum + Q;         // [Q]
  float* wv = dts + Q;          // [Q]

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // This thread's chunk rows are ty * rpt + ii; its warp's rows end at wlast.
  const int rpt = (Q + 15) / 16;
  const int wlast = min(Q - 1, ((ty | 1) + 1) * rpt - 1);

  const T* xb = (const T*)a.x + b * a.xs_b + h * a.xs_h;
  const T* bb = (const T*)a.bm + b * a.bs_b;
  const T* cb = (const T*)a.cm + b * a.cs_b;
  const float* ab = a.adt + b * a.as_b + h * a.as_h;
  const float* db = a.dt + b * a.ds_b + h * a.ds_h;
  T* yb = (T*)a.y + ((int64_t)b * a.H + h) * S * P;

  for (int e = tid; e < N * P; e += kThreads) stT[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int len = min(Q, S - c0);
    // ---- stage the chunk (zero past its end) ----
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, p = e % P;
      xs[e] = i < len ? to_f32(xb[(c0 + i) * a.xs_s + p]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const bool in = i < len;
      bT[n * LQ + i] = in ? to_f32(bb[(c0 + i) * a.bs_s + n]) : 0.f;
      cT[n * LQ + i] = in ? to_f32(cb[(c0 + i) * a.cs_s + n]) : 0.f;
    }
    for (int i = tid; i < Q; i += kThreads) {
      cum[i] = i < len ? ab[(c0 + i) * a.as_s] : 0.f;
      dts[i] = i < len ? db[(c0 + i) * a.ds_s] : 0.f;
    }
    __syncthreads();
    // Inclusive cumsum of adt over the chunk, in order, as the reference.
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += cum[i];
        cum[i] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    // ---- inter-chunk term: y_i = exp(cum_i) C_i . state ----
    float yacc[kRowsPerThread][kColTiles];
#pragma unroll
    for (int ii = 0; ii < kRowsPerThread; ++ii)
#pragma unroll
      for (int pp = 0; pp < kColTiles; ++pp) yacc[ii][pp] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[kRowsPerThread], sv[kColTiles];
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii) {
        const int i = ty * rpt + ii;
        cv[ii] = (ii < rpt && i < Q) ? cT[n * LQ + i] : 0.f;
      }
#pragma unroll
      for (int pp = 0; pp < kColTiles; ++pp) {
        const int p = tx + 16 * pp;
        sv[pp] = p < P ? stT[n * P + p] : 0.f;
      }
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii)
#pragma unroll
        for (int pp = 0; pp < kColTiles; ++pp) yacc[ii][pp] += cv[ii] * sv[pp];
    }
#pragma unroll
    for (int ii = 0; ii < kRowsPerThread; ++ii) {
      const int i = ty * rpt + ii;
      const float g = (ii < rpt && i < Q) ? expf(cum[i]) : 0.f;
#pragma unroll
      for (int pp = 0; pp < kColTiles; ++pp) yacc[ii][pp] *= g;
    }

    // ---- decayed scores: sc[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i ----
    // Column blocks past the last row of this warp are all zero and never read.
    {
      float s[kRowsPerThread][kRowsPerThread];  // [jj][ii]
#pragma unroll
      for (int jj = 0; jj < kRowsPerThread; ++jj)
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii) s[jj][ii] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kRowsPerThread];
#pragma unroll
        for (int ii = 0; ii < kRowsPerThread; ++ii) {
          const int i = ty * rpt + ii;
          cv[ii] = (ii < rpt && i < Q) ? cT[n * LQ + i] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kRowsPerThread; ++jj) {
          const int j = tx + 16 * jj;
          if (16 * jj <= wlast) {
            const float bv = j < Q ? bT[n * LQ + j] : 0.f;
#pragma unroll
            for (int ii = 0; ii < kRowsPerThread; ++ii) s[jj][ii] += cv[ii] * bv;
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kRowsPerThread; ++jj) {
        const int j = tx + 16 * jj;
        if (16 * jj <= wlast && j < Q) {
#pragma unroll
          for (int ii = 0; ii < kRowsPerThread; ++ii) {
            const int i = ty * rpt + ii;
            if (ii < rpt && i < Q) {
              sc[i * LQ + j] = j <= i ? s[jj][ii] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
            }
          }
        }
      }
    }
    for (int j = tid; j < Q; j += kThreads) wv[j] = expf(cum_last - cum[j]) * dts[j];
    __syncthreads();

    // ---- intra-chunk term: y_i += sum_{j <= wlast} sc[i][j] x_j; write y ----
    for (int j = 0; j <= wlast; ++j) {
      float xv[kColTiles];
#pragma unroll
      for (int pp = 0; pp < kColTiles; ++pp) {
        const int p = tx + 16 * pp;
        xv[pp] = p < P ? xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int ii = 0; ii < kRowsPerThread; ++ii) {
        const int i = ty * rpt + ii;
        const float sv = (ii < rpt && i < Q) ? sc[i * LQ + j] : 0.f;
#pragma unroll
        for (int pp = 0; pp < kColTiles; ++pp) yacc[ii][pp] += sv * xv[pp];
      }
    }
#pragma unroll
    for (int ii = 0; ii < kRowsPerThread; ++ii) {
      const int i = ty * rpt + ii;
      if (ii < rpt && i < len) {
#pragma unroll
        for (int pp = 0; pp < kColTiles; ++pp) {
          const int p = tx + 16 * pp;
          if (p < P) yb[(int64_t)(c0 + i) * P + p] = from_f32<T>(yacc[ii][pp]);
        }
      }
    }

    // ---- state update: state^T[n][p] = exp(cum_last) state^T[n][p]
    //                                    + sum_j B_j[n] w_j x_j[p] ----
    {
      const float decay = expf(cum_last);
      float acc[kStateTiles][kColTiles];
#pragma unroll
      for (int nn = 0; nn < kStateTiles; ++nn) {
        const int n = ty + 16 * nn;
#pragma unroll
        for (int pp = 0; pp < kColTiles; ++pp) {
          const int p = tx + 16 * pp;
          acc[nn][pp] = (n < N && p < P) ? stT[n * P + p] * decay : 0.f;
        }
      }
      for (int j = 0; j < Q; ++j) {
        const float w = wv[j];
        float xv[kColTiles];
#pragma unroll
        for (int pp = 0; pp < kColTiles; ++pp) {
          const int p = tx + 16 * pp;
          xv[pp] = p < P ? xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int nn = 0; nn < kStateTiles; ++nn) {
          const int n = ty + 16 * nn;
          const float bw = n < N ? bT[n * LQ + j] * w : 0.f;
#pragma unroll
          for (int pp = 0; pp < kColTiles; ++pp) acc[nn][pp] += bw * xv[pp];
        }
      }
#pragma unroll
      for (int nn = 0; nn < kStateTiles; ++nn) {
        const int n = ty + 16 * nn;
#pragma unroll
        for (int pp = 0; pp < kColTiles; ++pp) {
          const int p = tx + 16 * pp;
          if (n < N && p < P) stT[n * P + p] = acc[nn][pp];
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_ssd(const SsdArgs& a, cudaStream_t st) {
  const size_t bytes = (size_t)smem_floats(a.Q, a.P, a.N) * sizeof(float);
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  ssd_kernel<T><<<a.B * a.H, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block needs for a chunk of Q steps.
extern "C" int64_t mamba2_ssd_smem_bytes(int Q, int P, int N) {
  return smem_floats(Q, P, N) * (int64_t)sizeof(float);
}

// x, B, C in `dtype` (0 f32, 1 bf16); adt, dt f32; y contiguous (B,H,S,P)
// in `dtype`. `strides` holds the 13 element strides of SsdArgs, in order.
extern "C" int mamba2_ssd_launch(const void* x, const float* adt, const float* dt,
                                 const void* bm, const void* cm, void* y,
                                 const int64_t* strides, int B, int H, int S, int P, int N,
                                 int Q, int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || (int64_t)B * H > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  SsdArgs a{x, adt, dt, bm, cm, y,
            strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
            strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
            strides[12], B, H, S, P, N, Q};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kDtypeF32) return launch_ssd<float>(a, st);
  if (dtype == kDtypeBf16) return launch_ssd<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
