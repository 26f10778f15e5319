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
// What bounds it: bytes. x, B and C are read once and y written once; the
// (P, N) state is carried across chunks on chip and never written out, as
// the TPU kernel carries it in VMEM scratch along its sequential grid axis.
// The products (~21 GFLOP at Zamba2's prefill) would take 6x the byte bound
// on the scalar units, so the bf16 route runs them on the tensor cores. On
// an H100 it still runs at ~6x the byte bound: the chunk walk's mma.sync,
// exponential and split instructions set its pace, no one part dominating
// (scripts/ssd_ablation.py, PERF.md).
//
// bf16 route (ssd_mma_kernel, every launch of the bf16 model):
//   * The grid is split over the state's rows as well: state[p, :] evolves
//     on its own for each p, so a block per (b, h, slice of PS of the P
//     columns) carries only its rows, with no exchange between blocks. With
//     PS < P each block re-reads its chunk's B, C, cum and dt (from the L2)
//     and recomputes C.B^T; the default PS = P (64 at Zamba2) does not.
//   * 8 warps; tiles stay bf16 in shared memory, rows padded by 16 bytes so
//     that ldmatrix reads them without bank conflicts, and are copied with
//     cp.async, zero-filled past the sequence. One copy of the tiles: chunk
//     c+1's x, B, C, cum and dt are issued once every warp is done with
//     chunk c, and the SM's other resident block (two fit at PS = 64, N <=
//     64) computes while this one waits for them.
//   * mma.sync m16n8k16, bf16 in, f32 accumulate. Each warp owns 16 rows of
//     the chunk: y = exp(cum_i) C.state^T, then for each column tile on or
//     below the diagonal G = C.B^T, the scores G exp(cum_i - cum_j) dt_j
//     (masked to j <= i on the diagonal tile) formed in registers and fed
//     straight back as the A fragment of scores.x (as FlashAttention feeds P
//     to P.V).
//   * The four warps with the light rows (0..63) also carry the state, f32
//     in registers across the whole walk (the block's PS x N tiles spread
//     over them): state = exp(cum_last) state + (w x)^T.B, w_j =
//     exp(cum_last - cum_j) dt_j, while the other warps finish their rows;
//     each chunk writes it to the other of two copies in shared memory,
//     which the next chunk's C.state^T reads, so one barrier a chunk
//     suffices.
//   * f32 operands (the scores, w x, the state) are split into bf16 hi + lo
//     (lo = bf16(v - f32(hi))) and both halves go through the product into
//     one f32 accumulator; the bf16 inputs x, B, C are exact. Rounded once
//     to bf16 instead, the output parts from the plain version by up to 1.0
//     at Zamba2's shape (scripts/ssd_ablation.py), far outside the
//     tolerance. Exponentials are ex2.approx (relative error ~2^-22).
//   * The cumsum of adt over a chunk is added in order, one f32 add at a
//     time, as the reference and the plain version add it (a tree order
//     parts from it by a few bf16 steps where cum runs near -1,000): a
//     pre-pass (ssd_cumsum_kernel, a block per (b, chunk, 32 heads), one
//     thread per head adding out of shared memory) writes the chunk-local
//     cumsums and a contiguous copy of dt before the main kernel runs, so no
//     thread of it waits on a serial sum. Both kernels count as one launch.
//   P must be a multiple of PS (16, 32 or 64) and N one of 16, 32, 64, 128;
//   every row of x, B and C must start on 16 bytes. The wrapper pads or
//   copies what does not fit that.
//
// f32 route (ssd_kernel, scalar; it runs only in the f32 checks): one block
// per (b, h) walks its chunks in order with the (P, N) f32 state in shared
// memory, x, B and C widened to f32 there, and four small products on
// scalar f32 FMAs, each thread holding a register tile of outputs (B and C
// transposed, rows padded to Q + 1). Its cumsum runs on thread 0. TF32 or
// the bf16 split would not keep the f32 tolerance, so it stays scalar.
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

#include "per_device.cuh"

namespace {

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
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in.ensure((const void*)ssd_kernel<T>, bytes);
  if (opted != cudaSuccess) return (int)opted;
  ssd_kernel<T><<<a.B * a.H, kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: the cumsum pre-pass and the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
// Warps 0..3 own the chunk's rows 0..63, the light half of the triangle of
// scores, and carry the state as well.
constexpr int kStateWarps = 4;

typedef __nv_bfloat16 bf16;

// Chunk-local inclusive cumsums of adt, added in order, and dt, both written
// contiguous (B, H, S). A block per (b, chunk, group of 32 heads): its
// threads load the chunk's adt and dt into shared memory (h fastest: in the
// Mamba2 block adt and dt are (B, S, H) in memory), one thread per head then
// adds its column in order out of shared memory, and all threads write both
// out with s fastest.
constexpr int kCumsumHeads = 32;
constexpr int kCumsumThreads = 256;

__global__ void __launch_bounds__(kCumsumThreads)
ssd_cumsum_kernel(const float* __restrict__ adt, const float* __restrict__ dt, int64_t as_b,
                  int64_t as_h, int64_t as_s, int64_t ds_b, int64_t ds_h, int64_t ds_s, int B,
                  int H, int S, int Q, float* __restrict__ cum, float* __restrict__ dto) {
  __shared__ float as[kMaxQ][kCumsumHeads + 1], dsm[kMaxQ][kCumsumHeads + 1];
  const int groups = (H + kCumsumHeads - 1) / kCumsumHeads;
  const int nch = (S + Q - 1) / Q;
  const int g = blockIdx.x % groups;
  const int c = (blockIdx.x / groups) % nch;
  const int b = blockIdx.x / (groups * nch);
  const int h0 = g * kCumsumHeads, nh = min(kCumsumHeads, H - h0);
  const int c0 = c * Q, len = min(Q, S - c0);
  for (int e = threadIdx.x; e < len * kCumsumHeads; e += kCumsumThreads) {
    const int i = e / kCumsumHeads, hh = e % kCumsumHeads;
    if (hh < nh) {
      as[i][hh] = adt[b * as_b + (h0 + hh) * as_h + (c0 + i) * as_s];
      dsm[i][hh] = dt[b * ds_b + (h0 + hh) * ds_h + (c0 + i) * ds_s];
    }
  }
  __syncthreads();
  if (threadIdx.x < nh) {
    float run = 0.f;
    for (int i = 0; i < len; ++i) {
      run = __fadd_rn(run, as[i][threadIdx.x]);
      as[i][threadIdx.x] = run;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nh * len; e += kCumsumThreads) {
    const int hh = e / len, i = e % len;
    const int64_t o = ((int64_t)b * H + h0 + hh) * S + c0 + i;
    cum[o] = as[i][hh];
    dto[o] = dsm[i][hh];
  }
}

struct MmaArgs {
  const bf16* x;
  const bf16* bm;
  const bf16* cm;
  const float* cum;  // (B, H, S) from ssd_cumsum_kernel
  const float* dt;   // (B, H, S)
  bf16* y;           // (B, H, S, P)
  int64_t xs_b, xs_h, xs_s, bs_b, bs_s, cs_b, cs_s;
  int B, H, S, P, Q, QP;
};

// Shared memory of one block, in bytes: x (QP, PS), B and C (QP, N), each
// row padded by 8 bf16; two copies (one read, one written per chunk) of the
// state's hi and lo halves (PS, N); cum and dt (QP,) in f32.
__host__ __device__ inline int64_t mma_smem_bytes(int QP, int PS, int N) {
  return 2 * ((int64_t)QP * (PS + 8) + 2LL * QP * (N + 8) + 4LL * PS * (N + 8)) +
         4 * (2LL * QP);
}

// e^x as ex2.approx of x log2(e): relative error ~2^-22, 0 below about -87.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, zero-filled when !full (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) -> bf16 pairs hi = bf16(u, v), lo = bf16(u - hi, v - hi); u is the
// lower half of each word.
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// Copy chunk rows [c0, c0 + len) of this block's tiles (zero rows up to QP).
template <int PS, int N>
__device__ __forceinline__ void issue_chunk(const MmaArgs& a, int b, int h, int p0, int c0,
                                            int len, bf16* xs, bf16* bs, bf16* cs,
                                            float* cum, float* dts) {
  constexpr int XV = PS / 8, NV = N / 8, LX = PS + 8, LN = N + 8;
  const int QP = a.QP;
  const bf16* xg = a.x + b * a.xs_b + h * a.xs_h + p0;
  for (int e = threadIdx.x; e < QP * XV; e += kMmaThreads) {
    const int i = e / XV, v = e % XV;
    const bool in = i < len;
    cp_async16(xs + i * LX + v * 8, in ? xg + (int64_t)(c0 + i) * a.xs_s + v * 8 : a.x, in);
  }
  const bf16* bg = a.bm + b * a.bs_b;
  const bf16* cg = a.cm + b * a.cs_b;
  for (int e = threadIdx.x; e < QP * NV; e += kMmaThreads) {
    const int i = e / NV, v = e % NV;
    const bool in = i < len;
    cp_async16(bs + i * LN + v * 8, in ? bg + (int64_t)(c0 + i) * a.bs_s + v * 8 : a.bm, in);
    cp_async16(cs + i * LN + v * 8, in ? cg + (int64_t)(c0 + i) * a.cs_s + v * 8 : a.cm, in);
  }
  const int64_t row = ((int64_t)b * a.H + h) * a.S + c0;
  for (int e = threadIdx.x; e < 2 * QP; e += kMmaThreads) {
    const int i = e % QP;
    const bool in = i < len;
    if (e < QP) {
      cp_async4(cum + i, in ? a.cum + row + i : a.cum, in);
    } else {
      cp_async4(dts + i, in ? a.dt + row + i : a.dt, in);
    }
  }
}

template <int PS, int N>
__global__ void __launch_bounds__(kMmaThreads, (N <= 64 ? 2 : 1)) ssd_mma_kernel(MmaArgs a) {
  constexpr int LX = PS + 8, LN = N + 8, KN = N / 16, NT = PS / 8, NN = N / 8;
  constexpr int ST_TILES = (PS / 16) * NN;
  constexpr int ST_PER_WARP = (ST_TILES + kStateWarps - 1) / kStateWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QP = a.QP, S = a.S, Q = a.Q;
  bf16* X = reinterpret_cast<bf16*>(smem_raw);  // [QP][LX]
  bf16* Bt = X + QP * LX;                        // [QP][LN]
  bf16* Ct = Bt + QP * LN;                       // [QP][LN]
  bf16* sts = Ct + QP * LN;                      // [2][hi, lo][PS][LN]
  float* cum = reinterpret_cast<float*>(sts + 4 * PS * LN);  // [QP]
  float* dtv = cum + QP;                                     // [QP]

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, p0 = blockIdx.y * PS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // ldmatrix: this lane gives the address of row r8 of 8x8 matrix lane / 8;
  // lo8 / hi8 place that matrix in a 16x16 tile (bit 3 / bit 4 of the lane).
  const int r8 = lane & 7, lo8 = ((lane >> 3) & 1) * 8, hi8 = (lane >> 4) * 8;
  // This warp's row tile of the chunk (scripts/ssd_ablation.py measures
  // the layout that gives warps w and w + 4, which share a scheduler, row
  // tiles w and 7 - w: it ran slower).
  const int rt = warp;
  const int nch = (S + Q - 1) / Q;
  bf16* yb = a.y + (int64_t)blockIdx.x * S * a.P + p0;

  for (int e = tid; e < 4 * PS * LN; e += kMmaThreads) sts[e] = __float2bfloat16_rn(0.f);
  // Warps 0..kStateWarps-1 carry state tiles t0 .. t0 + ST_PER_WARP - 1 in
  // f32 registers (16 x 8 each, tile t at row tile t / NN, column tile
  // t % NN): one row tile st_pm per warp (NN is a multiple of ST_PER_WARP).
  // Where the block has fewer tiles than 4 warps hold (PS = 16, N = 16), the
  // spare warps compute a copy of tile 0 and never write it (st_live).
  static_assert(NN % ST_PER_WARP == 0, "a state warp's tiles share one row tile");
  const int t0 = warp * ST_PER_WARP;
  const bool st_live = t0 < ST_TILES;
  const int st_pm = st_live ? t0 / NN : 0, st_nn = st_live ? t0 % NN : 0;
  float st[ST_PER_WARP][4];
#pragma unroll
  for (int k = 0; k < ST_PER_WARP; ++k) st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0.f;

  issue_chunk<PS, N>(a, b, h, p0, 0, min(Q, S), X, Bt, Ct, cum, dtv);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * Q, len = min(Q, S - c0);
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed
    const float cum_last = cum[len - 1];
    const bf16* sth = sts + (c & 1) * 2 * PS * LN;  // the state before this chunk
    const bf16* stl = sth + PS * LN;

    // ---- y for this warp's 16 rows ----
    const int i0 = rt * 16;
    if (i0 < len) {
      uint32_t ca[KN][4];
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) ldsm_x4(ca[ks], Ct + (i0 + lo8 + r8) * LN + ks * 16 + hi8);
      float y[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) y[nt][0] = y[nt][1] = y[nt][2] = y[nt][3] = 0.f;
      // inter-chunk term: exp(cum_i) C_i . state
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, sth + (np * 16 + hi8 + r8) * LN + ks * 16 + lo8);
          ldsm_x4(bl, stl + (np * 16 + hi8 + r8) * LN + ks * 16 + lo8);
          mma16816(y[2 * np], ca[ks], bh[0], bh[1]);
          mma16816(y[2 * np], ca[ks], bl[0], bl[1]);
          mma16816(y[2 * np + 1], ca[ks], bh[2], bh[3]);
          mma16816(y[2 * np + 1], ca[ks], bl[2], bl[3]);
        }
      }
      const int ia = i0 + g, ib = ia + 8;
      const float cia = cum[ia], cib = cum[ib];
      const float ea = fast_exp(cia), eb = fast_exp(cib);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        y[nt][0] *= ea;
        y[nt][1] *= ea;
        y[nt][2] *= eb;
        y[nt][3] *= eb;
      }
      // intra-chunk term, one 16-column tile of the scores at a time; only
      // the diagonal tile is masked (j <= i). Rows past len are computed and
      // never written.
      for (int jt = 0; jt <= rt && jt * 16 < len; ++jt) {
        const int j0 = jt * 16;
        float g0[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t bb[4];
          ldsm_x4(bb, Bt + (j0 + hi8 + r8) * LN + ks * 16 + lo8);
          mma16816(g0, ca[ks], bb[0], bb[1]);
          mma16816(g1, ca[ks], bb[2], bb[3]);
        }
        const bool diag = jt == rt;
        float s[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = j0 + half * 8 + 2 * t4 + (e & 1);
            const float v = (half ? g1[e] : g0[e]) * fast_exp((e < 2 ? cia : cib) - cum[j]) *
                            dtv[j];
            s[half][e] = (!diag || j <= i) ? v : 0.f;
          }
        }
        uint32_t ah[4], al[4];
        split2(s[0][0], s[0][1], ah[0], al[0]);
        split2(s[0][2], s[0][3], ah[1], al[1]);
        split2(s[1][0], s[1][1], ah[2], al[2]);
        split2(s[1][2], s[1][3], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t xb[4];
          ldsm_x4_t(xb, X + (j0 + lo8 + r8) * LX + np * 16 + hi8);
          mma16816(y[2 * np], ah, xb[0], xb[1]);
          mma16816(y[2 * np], al, xb[0], xb[1]);
          mma16816(y[2 * np + 1], ah, xb[2], xb[3]);
          mma16816(y[2 * np + 1], al, xb[2], xb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t4;
        if (ia < len) {
          *reinterpret_cast<__nv_bfloat162*>(yb + (int64_t)(c0 + ia) * a.P + col) =
              __floats2bfloat162_rn(y[nt][0], y[nt][1]);
        }
        if (ib < len) {
          *reinterpret_cast<__nv_bfloat162*>(yb + (int64_t)(c0 + ib) * a.P + col) =
              __floats2bfloat162_rn(y[nt][2], y[nt][3]);
        }
      }
    }

    // ---- state update on the light warps (rows 0..63 of the triangle):
    //      state = exp(cum_last) state + (w x)^T . B, w_j = exp(cum_last -
    //      cum_j) dt_j; written to the other copy for the next chunk ----
    if (warp < kStateWarps) {
      const float decay = fast_exp(cum_last);
#pragma unroll
      for (int k = 0; k < ST_PER_WARP; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][e] *= decay;
      }
      for (int j0 = 0; j0 < len; j0 += 16) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + (q >> 1) * 8 + 2 * t4 + (q & 1);
          w[q] = j < len ? fast_exp(cum_last - cum[j]) * dtv[j] : 0.f;
        }
        // A = (w x)^T, this warp's 16 state rows, from x stored (j, p):
        // transposed loads, one fragment for all of the warp's tiles
        uint32_t xa[4], ah[4], al[4];
        ldsm_x4_t(xa, X + (j0 + hi8 + r8) * LX + st_pm * 16 + lo8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 xv = unpack2(xa[r]);
          split2(xv.x * w[(r >> 1) * 2], xv.y * w[(r >> 1) * 2 + 1], ah[r], al[r]);
        }
        // no branch between the tiles: their loads and products interleave
#pragma unroll
        for (int k = 0; k < ST_PER_WARP; ++k) {
          uint32_t bb[2];
          ldsm_x2_t(bb, Bt + (j0 + lo8 + r8) * LN + (st_nn + k) * 8);
          mma16816(st[k], ah, bb[0], bb[1]);
          mma16816(st[k], al, bb[0], bb[1]);
        }
      }
      if (st_live) {
        bf16* nh = sts + ((c + 1) & 1) * 2 * PS * LN;
        bf16* nl = nh + PS * LN;
        const int pr = st_pm * 16 + g;
#pragma unroll
        for (int k = 0; k < ST_PER_WARP; ++k) {
          const int nc = (st_nn + k) * 8 + 2 * t4;
          uint32_t h0, l0, h1, l1;
          split2(st[k][0], st[k][1], h0, l0);
          split2(st[k][2], st[k][3], h1, l1);
          *reinterpret_cast<uint32_t*>(nh + pr * LN + nc) = h0;
          *reinterpret_cast<uint32_t*>(nl + pr * LN + nc) = l0;
          *reinterpret_cast<uint32_t*>(nh + (pr + 8) * LN + nc) = h1;
          *reinterpret_cast<uint32_t*>(nl + (pr + 8) * LN + nc) = l1;
        }
      }
    }
    if (c + 1 < nch) {
      __syncthreads();  // every warp is done with this chunk's tiles
      issue_chunk<PS, N>(a, b, h, p0, c0 + Q, min(Q, S - c0 - Q), X, Bt, Ct, cum, dtv);
      cp_async_commit();
    }
  }
}

template <int PS, int N>
cudaError_t mma_prepare(int QP) {
  const size_t bytes = (size_t)mma_smem_bytes(QP, PS, N);
  static SmemOptIn opt_in;
  return opt_in.ensure((const void*)ssd_mma_kernel<PS, N>, bytes);
}

template <int PS, int N>
int launch_mma(const MmaArgs& a, cudaStream_t st) {
  cudaError_t e = mma_prepare<PS, N>(a.QP);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.B * a.H, a.P / PS);
  ssd_mma_kernel<PS, N><<<grid, kMmaThreads, mma_smem_bytes(a.QP, PS, N), st>>>(a);
  return (int)cudaGetLastError();
}

template <int PS, int N>
int occupancy_mma(int QP, int* blocks) {
  cudaError_t e = mma_prepare<PS, N>(QP);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ssd_mma_kernel<PS, N>, kMmaThreads, mma_smem_bytes(QP, PS, N));
  }
  return (int)e;
}

// Calls F<PS, N>(args...) for the supported widths; -1 for any other.
#define SSD_DISPATCH(F, PS, N, ...)                                          \
  do {                                                                       \
    switch (PS * 1000 + N) {                                                 \
      case 16016: return F<16, 16>(__VA_ARGS__);                             \
      case 16032: return F<16, 32>(__VA_ARGS__);                             \
      case 16064: return F<16, 64>(__VA_ARGS__);                             \
      case 16128: return F<16, 128>(__VA_ARGS__);                            \
      case 32016: return F<32, 16>(__VA_ARGS__);                             \
      case 32032: return F<32, 32>(__VA_ARGS__);                             \
      case 32064: return F<32, 64>(__VA_ARGS__);                             \
      case 32128: return F<32, 128>(__VA_ARGS__);                            \
      case 64016: return F<64, 16>(__VA_ARGS__);                             \
      case 64032: return F<64, 32>(__VA_ARGS__);                             \
      case 64064: return F<64, 64>(__VA_ARGS__);                             \
      case 64128: return F<64, 128>(__VA_ARGS__);                            \
      default: return -1;                                                    \
    }                                                                        \
  } while (0)

bool mma_widths_ok(int ps, int N) {
  return (ps == 16 || ps == 32 || ps == 64) && (N == 16 || N == 32 || N == 64 || N == 128);
}

int launch_cumsum(const float* adt, const float* dt, const int64_t* s6, int B, int H, int S,
                  int Q, float* cum, float* dto, cudaStream_t st) {
  const int64_t grid =
      (int64_t)B * ((S + Q - 1) / Q) * ((H + kCumsumHeads - 1) / kCumsumHeads);
  if (grid > 0x7fffffff || Q > kMaxQ) return (int)cudaErrorInvalidValue;
  ssd_cumsum_kernel<<<(unsigned)grid, kCumsumThreads, 0, st>>>(
      adt, dt, s6[0], s6[1], s6[2], s6[3], s6[4], s6[5], B, H, S, Q, cum, dto);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block of the f32 route needs for a chunk of Q steps.
extern "C" int64_t mamba2_ssd_smem_bytes(int Q, int P, int N) {
  return smem_floats(Q, P, N) * (int64_t)sizeof(float);
}

// Bytes of shared memory a block of the bf16 route needs: chunk rows QP (Q
// rounded up to 16), P-slice ps, state dim N.
extern "C" int64_t mamba2_ssd_mma_smem_bytes(int QP, int ps, int N) {
  return mma_smem_bytes(QP, ps, N);
}

// Blocks of the bf16 route that stay resident on one SM (sets the kernel's
// shared-memory opt-in first).
extern "C" int mamba2_ssd_mma_occupancy(int QP, int ps, int N, int* blocks) {
  if (!mma_widths_ok(ps, N) || QP < 16 || QP > kMaxQ || QP % 16) {
    return (int)cudaErrorInvalidValue;
  }
  SSD_DISPATCH(occupancy_mma, ps, N, QP, blocks);
}

// The bf16 route's pre-pass alone: chunk-local in-order cumsums of adt and a
// contiguous copy of dt, both (B, H, S) f32. `strides` holds adt's and dt's
// (b, h, s) element strides.
extern "C" int mamba2_ssd_cumsum_launch(const float* adt, const float* dt,
                                        const int64_t* strides, int B, int H, int S, int Q,
                                        float* cum, float* dto, void* stream) {
  if (B < 1 || H < 1 || S < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  return launch_cumsum(adt, dt, strides, B, H, S, Q, cum, dto, (cudaStream_t)stream);
}

// f32 route: x, B, C, y f32 (the scalar kernel). `strides` holds the 13
// element strides of SsdArgs, in order.
extern "C" int mamba2_ssd_launch(const void* x, const float* adt, const float* dt,
                                 const void* bm, const void* cm, void* y,
                                 const int64_t* strides, int B, int H, int S, int P, int N,
                                 int Q, void* stream) {
  if (B < 1 || H < 1 || S < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || (int64_t)B * H > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  SsdArgs a{x, adt, dt, bm, cm, y,
            strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
            strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
            strides[12], B, H, S, P, N, Q};
  return launch_ssd<float>(a, (cudaStream_t)stream);
}

// bf16 route: x, B, C, y bf16; adt, dt f32; strides as mamba2_ssd_launch.
// P a multiple of ps (16, 32 or 64), N in {16, 32, 64, 128}, every row of
// x, B and C on 16 bytes. cum and dto are (B, H, S) f32 scratch. Launches
// the cumsum pre-pass, then the tensor-core kernel.
extern "C" int mamba2_ssd_mma_launch(const void* x, const float* adt, const float* dt,
                                     const void* bm, const void* cm, void* y,
                                     const int64_t* strides, int B, int H, int S, int P,
                                     int N, int Q, int ps, float* cum,
                                     float* dto, void* stream) {
  if (B < 1 || H < 1 || S < 1 || Q < 1 || Q > kMaxQ || !mma_widths_ok(ps, N) || P < ps ||
      P % ps || (int64_t)B * H > 0x7fffffff ||
      (int64_t)P / ps > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t xs_b = strides[0], xs_h = strides[1], xs_s = strides[2];
  const int64_t bs_b = strides[9], bs_s = strides[10], cs_b = strides[11], cs_s = strides[12];
  const uint64_t align = (uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm | (uint64_t)(xs_b * 2) |
                         (uint64_t)(xs_h * 2) | (uint64_t)(xs_s * 2) | (uint64_t)(bs_b * 2) |
                         (uint64_t)(bs_s * 2) | (uint64_t)(cs_b * 2) | (uint64_t)(cs_s * 2);
  if (align % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_cumsum(adt, dt, strides + 3, B, H, S, Q, cum, dto, st);
  if (err) return err;
  MmaArgs a{(const bf16*)x, (const bf16*)bm, (const bf16*)cm, cum, dto, (bf16*)y,
            xs_b, xs_h, xs_s, bs_b, bs_s, cs_b, cs_s,
            B, H, S, P, Q, (Q + 15) / 16 * 16};
  SSD_DISPATCH(launch_mma, ps, N, a, st);
}
