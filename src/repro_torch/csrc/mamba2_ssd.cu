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
// The products (~16 GFLOP at Zamba2's prefill) would take several times the
// byte bound on the scalar units, so both routes run them on the tensor
// cores, `mma.sync` with f32 accumulation, and both still run at several
// times the byte bound: the chunk walk's mma.sync, exponential and split
// instructions set their pace, no one part dominating
// (scripts/ssd_ablation.py, PERF.md). The dtype picks the route; each
// launches or fails.
//
// Common to both routes:
//   * The cumsum of adt over a chunk is added in order, one f32 add at a
//     time, as the reference and the plain version add it (a tree order
//     parts from it by a few bf16 steps where cum runs near -1,000): a
//     pre-pass (ssd_cumsum_kernel, a block per (b, chunk, 32 heads), one
//     thread per head adding out of shared memory) writes the chunk-local
//     cumsums and a contiguous copy of dt before the main kernel runs, so no
//     thread of it waits on a serial sum. Both kernels count as one launch.
//   * The grid is split over the state's rows as well: state[p, :] evolves
//     on its own for each p, so a block per (b, h, slice of PS of the P
//     columns) carries only its rows, with no exchange between blocks. With
//     PS < P each block re-reads its chunk's B, C, cum and dt (from the L2)
//     and recomputes C.B^T.
//   * 8 warps. Tiles are copied with cp.async in 16-byte pieces, zero-filled
//     past the sequence, into rows padded by 16 bytes. The state is f32 in
//     the registers of four warps across the whole walk; each chunk writes
//     it to shared memory, which the next chunk's C.state^T reads.
//   * A ragged last chunk is padded with x = B = C = adt = dt = 0: adt = 0
//     keeps the cumsum flat and dt = 0 adds nothing to the state or to any
//     output, so the padded rows are computed and never written.
//   * P must be a multiple of PS (16, 32 or 64) and N one of 16, 32, 64,
//     128; every row of x, B and C must start on 16 bytes. The wrapper pads
//     or copies what does not fit that. The inputs may be strided views (x
//     is a transpose of a reshape, B and C column slices of one projection
//     in the Mamba2 block): every element offset comes from the strides the
//     wrapper passes; the innermost dimension has stride 1. y is written
//     contiguous (B,H,S,P) in x's dtype. Exponentials are ex2.approx
//     (relative error ~2^-22).
//
// bf16 route (ssd_mma_kernel, every launch of the bf16 model):
//   * Tiles stay bf16 in shared memory, read by ldmatrix. One copy of the
//     tiles: chunk c+1's x, B, C, cum and dt are issued once every warp is
//     done with chunk c, and the SM's other resident block (two fit at PS =
//     64, N <= 64) computes while this one waits for them. P-slice 64 where
//     P allows it, so that no block recomputes another's C.B^T.
//   * mma.sync m16n8k16, bf16 in, f32 accumulate. Each warp owns 16 rows of
//     the chunk: y = exp(cum_i) C.state^T, then for each column tile on or
//     below the diagonal G = C.B^T, the scores G exp(cum_i - cum_j) dt_j
//     (masked to j <= i on the diagonal tile) formed in registers and fed
//     straight back as the A fragment of scores.x (as FlashAttention feeds P
//     to P.V).
//   * The four warps with the light rows (0..63) also carry the state:
//     state = exp(cum_last) state + (w x)^T.B, w_j = exp(cum_last - cum_j)
//     dt_j, while the other warps finish their rows; each chunk writes it
//     to the other of two copies in shared memory, so one barrier a chunk
//     suffices.
//   * f32 operands (the scores, w x, the state) are split into bf16 hi + lo
//     (lo = bf16(v - f32(hi))) and both halves go through the product into
//     one f32 accumulator; the bf16 inputs x, B, C are exact. Rounded once
//     to bf16 instead, the output parts from the plain version by up to 1.0
//     at Zamba2's shape (scripts/ssd_ablation.py), far outside the
//     tolerance.
//
// f32 route (ssd_tf32_kernel, the f32 checks): the same walk in 3xTF32
// (tf32_mma.cuh): every f32 operand x = hi + lo, three `mma.sync m16n8k8
// .tf32` products lo.hi + hi.lo + hi.hi into one f32 accumulator, which
// keeps the products to ~2^-20 relative (one TF32 product keeps ~2^-11, and
// misses the tolerance by 0.54 at Zamba2's shape). hi is the operand's own
// bits and lo = x - hi is left for the tensor cores to truncate, not
// rounded to tf32 first (split_tf32_rz: -16% against the rounded lo, the
// error still 3.8e-4 at Zamba2's outputs of up to ~300, scripts/ssd_ablation.py).
//   * f32 tiles are twice the bytes of bf16 ones, so the chunk is what two
//     blocks an SM hold (the wrapper's kernel_chunk halves it until they
//     do: 64 at Zamba2's P-slice 64, N 64). The tiles stay as they landed
//     (their own hi: the tensor cores read a .tf32 operand's top 19 bits)
//     and each warp makes the lo of its fragments as it loads them; only
//     the state, read by every row warp, is stored split (hi and lo), by
//     the warps that carry it.
//   * Warp w owns row tile w of the chunk; at QP <= 64 warps 4..7 have no
//     rows and carry the state, else warps 0..3, the light rows, carry it
//     as well. The state is written after the chunk's closing barrier, so
//     one copy serves, and the last chunk does not update it.
//   * What sets its pace is the products and their splits, not HBM or the
//     exponentials (scripts/ssd_ablation.py: one TF32 product in place of
//     three -36%, no exponentials ~0%); C.B^T computed once per (b, chunk)
//     by a pre-pass and read by every block ran slower than each block
//     computing it (PERF.md).
//   * C's A fragments and the state's and B's B fragments come by ldmatrix
//     (8 x 4 f32 matrices read as 8 x 8 b16 ones). The scores' accumulator
//     holds columns 2t, 2t + 1 of each 8 where an A fragment wants t, t + 4:
//     scores.x reads x's rows 2t, 2t + 1 in their place (the sum over j
//     does not care), so the scores feed it from registers; the state
//     update orders its k-steps the same way for (w x)^T and B. Rows of
//     width + 4 floats keep ldmatrix and those scalar loads free of bank
//     conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxQ = 128;  // rows of a chunk

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
// bf16 route: warps 0..3 own the chunk's rows 0..63, the light half of the
// triangle of scores, and carry the state as well.
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

// The main kernels' arguments: x, B, C and y of the route's element type T.
template <typename T>
struct ScanArgs {
  const T* x;
  const T* bm;
  const T* cm;
  const float* cum;  // (B, H, S) from ssd_cumsum_kernel
  const float* dt;   // (B, H, S)
  T* y;              // (B, H, S, P)
  int64_t xs_b, xs_h, xs_s, bs_b, bs_s, cs_b, cs_s;
  int B, H, S, P, Q, QP;
};
using MmaArgs = ScanArgs<bf16>;
using TfArgs = ScanArgs<float>;

// Shared memory of one block, in bytes: x (QP, PS), B and C (QP, N), each
// row padded by 8 bf16; two copies (one read, one written per chunk) of the
// state's hi and lo halves (PS, N); cum and dt (QP,) in f32.
__host__ __device__ inline int64_t mma_smem_bytes(int QP, int PS, int N) {
  return 2 * ((int64_t)QP * (PS + 8) + 2LL * QP * (N + 8) + 4LL * PS * (N + 8)) +
         4 * (2LL * QP);
}

// Floats of the f32 route's chunk tiles: x (QP, PS), B and C (QP, N), each
// row padded by 4 floats; cum and dt (QP,). One chunk is staged at a time:
// the SM's other block computes while this one waits for the next chunk
// (two stages hold one block an SM and ran slower, PERF.md).
__host__ __device__ inline int64_t tf32_stage_floats(int QP, int PS, int N) {
  return (int64_t)QP * (PS + 4) + 2LL * QP * (N + 4) + 2LL * QP;
}
// Bytes of one block of the f32 route: its chunk tiles and the state's hi
// and lo (PS, N + 4).
__host__ __device__ inline int64_t tf32_smem_bytes(int QP, int PS, int N) {
  return 4 * (tf32_stage_floats(QP, PS, N) + 2LL * PS * (N + 4));
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

// The lo halves (left for the tensor cores to truncate) of four f32 values
// whose own bits serve as their hi.
__device__ __forceinline__ void tf32_los(const uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) lo[e] = tf32_lo_rz(__uint_as_float(hi[e]));
}

// Copy chunk rows [c0, c0 + len) of this block's tiles (zero rows up to QP),
// rows padded by 16 bytes.
template <typename T, int PS, int N>
__device__ __forceinline__ void issue_chunk(const ScanArgs<T>& a, int b, int h, int p0, int c0,
                                            int len, T* xs, T* bs, T* cs, float* cum,
                                            float* dts) {
  constexpr int V = 16 / sizeof(T);  // elements a copy
  constexpr int XV = PS / V, NV = N / V, LX = PS + V, LN = N + V;
  const int QP = a.QP;
  const T* xg = a.x + b * a.xs_b + h * a.xs_h + p0;
  for (int e = threadIdx.x; e < QP * XV; e += kMmaThreads) {
    const int i = e / XV, v = e % XV;
    const bool in = i < len;
    cp_async16(xs + i * LX + v * V, in ? xg + (int64_t)(c0 + i) * a.xs_s + v * V : a.x, in);
  }
  const T* bg = a.bm + b * a.bs_b;
  const T* cg = a.cm + b * a.cs_b;
  for (int e = threadIdx.x; e < QP * NV; e += kMmaThreads) {
    const int i = e / NV, v = e % NV;
    const bool in = i < len;
    cp_async16(bs + i * LN + v * V, in ? bg + (int64_t)(c0 + i) * a.bs_s + v * V : a.bm, in);
    cp_async16(cs + i * LN + v * V, in ? cg + (int64_t)(c0 + i) * a.cs_s + v * V : a.cm, in);
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

  issue_chunk<bf16, PS, N>(a, b, h, p0, 0, min(Q, S), X, Bt, Ct, cum, dtv);
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
      issue_chunk<bf16, PS, N>(a, b, h, p0, c0 + Q, min(Q, S - c0 - Q), X, Bt, Ct, cum, dtv);
      cp_async_commit();
    }
  }
}

// ---------------------------------------------------------------------------
// f32 route: the tensor-core kernel in 3xTF32
// ---------------------------------------------------------------------------

constexpr int kTfStateWarps = 4;

template <int PS, int N>
__global__ void __launch_bounds__(kMmaThreads, (N <= 64 ? 2 : 1)) ssd_tf32_kernel(TfArgs a) {
  constexpr int LX = PS + 4, LN = N + 4, KN = N / 8, NT = PS / 8, NN = N / 8;
  constexpr int ST_TILES = (PS / 16) * NN;
  constexpr int ST_PER_WARP = (ST_TILES + kTfStateWarps - 1) / kTfStateWarps;
  static_assert(NN % ST_PER_WARP == 0, "a state warp's tiles share one row tile");
  extern __shared__ __align__(16) float smf[];
  const int QP = a.QP, S = a.S, Q = a.Q;
  float* sth = smf + tf32_stage_floats(QP, PS, N);  // [PS][LN] the state before this chunk (its hi)
  float* stl = sth + PS * LN;                       // [PS][LN] its lo

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, p0 = blockIdx.y * PS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // ldmatrix: lanes 8m .. 8m + 7 give the rows of matrix m = lm.
  const int lm = lane >> 3, lr = lane & 7;
  const int nch = (S + Q - 1) / Q;
  float* yb = a.y + (int64_t)blockIdx.x * S * a.P + p0;

  // The state warps: 4..7 when the rows fit warps 0..3, else 0..3 (the
  // light rows). State warp sw carries tiles t0 .. t0 + ST_PER_WARP - 1 of
  // the block's (PS / 16) x NN tiles of 16 x 8 (tile t at row tile t / NN,
  // column tile t % NN); spare warps (PS = 16, N = 16) compute a copy of
  // tile 0 and never write it.
  const int sw = warp - (QP <= 64 ? kTfStateWarps : 0);
  const bool st_warp = sw >= 0 && sw < kTfStateWarps;
  const int t0 = (st_warp ? sw : 0) * ST_PER_WARP;
  const bool st_live = st_warp && t0 < ST_TILES;
  const int st_pm = st_live ? t0 / NN : 0, st_nn = st_live ? t0 % NN : 0;
  float st[ST_PER_WARP][4];
#pragma unroll
  for (int k = 0; k < ST_PER_WARP; ++k) st[k][0] = st[k][1] = st[k][2] = st[k][3] = 0.f;

  for (int e = tid; e < 2 * PS * LN; e += kMmaThreads) sth[e] = 0.f;
  issue_chunk<float, PS, N>(a, b, h, p0, 0, min(Q, S), smf, smf + QP * LX,
                            smf + QP * (LX + LN), smf + QP * (LX + 2 * LN),
                            smf + QP * (LX + 2 * LN + 1));
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int c0 = c * Q, len = min(Q, S - c0);
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed; the state it starts from is written
    const float* X = smf;             // [QP][LX]
    const float* Bt = X + QP * LX;    // [QP][LN]
    const float* Ct = Bt + QP * LN;   // [QP][LN]
    const float* cum = Ct + QP * LN;  // [QP]
    const float* dtv = cum + QP;      // [QP]
    const float cum_last = cum[len - 1];

    // ---- y for row tile rt (16 rows) of the chunk ----
    const int rt = warp, i0 = 16 * rt;
    if (i0 < len) {
      // C's A fragments (rows i0 .. i0 + 15, 8 columns a k-step)
      const float* ca = Ct + (i0 + (lm & 1) * 8 + lr) * LN + (lm >> 1) * 4;
      float y[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) y[nt][0] = y[nt][1] = y[nt][2] = y[nt][3] = 0.f;
      // inter-chunk term: exp(cum_i) C_i . state, the state's B fragments
      // (p rows, n columns) from its stored hi and lo
      const int sb = ((lm >> 1) * 8 + lr) * LN + (lm & 1) * 4;
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, ca + ks * 8);
        tf32_los(ah, al);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t sh[4], sl[4];
          ldsm_x4(sh, sth + sb + np * 16 * LN + ks * 8);
          ldsm_x4(sl, stl + sb + np * 16 * LN + ks * 8);
          mma_3xtf32(y[2 * np], ah, al, sh[0], sh[1], sl[0], sl[1]);
          mma_3xtf32(y[2 * np + 1], ah, al, sh[2], sh[3], sl[2], sl[3]);
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
      for (int jt = 0; 16 * jt < len && jt <= rt; ++jt) {
        const int j0 = 16 * jt;
        // G = C . B^T: B's B fragments (j rows, n columns) for 2 x 8 columns
        float g0[4] = {0.f, 0.f, 0.f, 0.f}, g1[4] = {0.f, 0.f, 0.f, 0.f};
        const float* bb = Bt + (j0 + (lm >> 1) * 8 + lr) * LN + (lm & 1) * 4;
#pragma unroll
        for (int kg = 0; kg < KN; ++kg) {
          uint32_t ah[4], al[4], bh[4], bl[4];
          ldsm_x4(ah, ca + kg * 8);
          tf32_los(ah, al);
          ldsm_x4(bh, bb + kg * 8);
          tf32_los(bh, bl);
          mma_3xtf32(g0, ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(g1, ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
        const bool diag = jt == rt;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // the scores of columns j0 + 8 half + (2t, 2t + 1), rows ia, ib
          const int j = j0 + half * 8 + 2 * t4;
          const float* gv = half ? g1 : g0;
          const float d0 = dtv[j], d1 = dtv[j + 1], c0j = cum[j], c1j = cum[j + 1];
          float s[4];
          s[0] = gv[0] * fast_exp(cia - c0j) * d0;
          s[1] = gv[1] * fast_exp(cia - c1j) * d1;
          s[2] = gv[2] * fast_exp(cib - c0j) * d0;
          s[3] = gv[3] * fast_exp(cib - c1j) * d1;
          if (diag) {
            s[0] = j <= ia ? s[0] : 0.f;
            s[1] = j + 1 <= ia ? s[1] : 0.f;
            s[2] = j <= ib ? s[2] : 0.f;
            s[3] = j + 1 <= ib ? s[3] : 0.f;
          }
          // A fragment: slot t <-> column 2t, slot t + 4 <-> column 2t + 1
          uint32_t ph[4], pl[4];
          split_tf32_rz(s[0], ph[0], pl[0]);
          split_tf32_rz(s[2], ph[1], pl[1]);
          split_tf32_rz(s[1], ph[2], pl[2]);
          split_tf32_rz(s[3], ph[3], pl[3]);
          // B fragment: x's rows j, j + 1 in those slots, column nt * 8 + g
          const float* xr = X + j * LX + g;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t xh0, xl0, xh1, xl1;
            split_tf32_rz(xr[nt * 8], xh0, xl0);
            split_tf32_rz(xr[LX + nt * 8], xh1, xl1);
            mma_3xtf32(y[nt], ph, pl, xh0, xh1, xl0, xl1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t4;
        if (ia < len) {
          *reinterpret_cast<float2*>(yb + (int64_t)(c0 + ia) * a.P + col) =
              make_float2(y[nt][0], y[nt][1]);
        }
        if (ib < len) {
          *reinterpret_cast<float2*>(yb + (int64_t)(c0 + ib) * a.P + col) =
              make_float2(y[nt][2], y[nt][3]);
        }
      }
    }

    // ---- state update on the state warps (not after the last chunk):
    //      state = exp(cum_last) state + (w x)^T . B, w_j = exp(cum_last -
    //      cum_j) dt_j; k-step slots t, t + 4 <-> positions j0 + 2t, 2t + 1 ----
    if (st_warp && c + 1 < nch) {
      const float decay = fast_exp(cum_last);
#pragma unroll
      for (int k = 0; k < ST_PER_WARP; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[k][e] *= decay;
      }
      const float* xa = X + 2 * t4 * LX + st_pm * 16 + g;
      const float* ba = Bt + 2 * t4 * LN + st_nn * 8 + g;
      for (int j0 = 0; j0 < len; j0 += 8) {
        const int j = j0 + 2 * t4;
        const float w0 = fast_exp(cum_last - cum[j]) * dtv[j];
        const float w1 = fast_exp(cum_last - cum[j + 1]) * dtv[j + 1];
        // A = (w x)^T: rows p = 16 st_pm + g (+ 8), this warp's row tile
        uint32_t ah[4], al[4];
        split_tf32_rz(w0 * xa[j0 * LX], ah[0], al[0]);
        split_tf32_rz(w0 * xa[j0 * LX + 8], ah[1], al[1]);
        split_tf32_rz(w1 * xa[(j0 + 1) * LX], ah[2], al[2]);
        split_tf32_rz(w1 * xa[(j0 + 1) * LX + 8], ah[3], al[3]);
#pragma unroll
        for (int k = 0; k < ST_PER_WARP; ++k) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_rz(ba[j0 * LN + k * 8], bh0, bl0);
          split_tf32_rz(ba[(j0 + 1) * LN + k * 8], bh1, bl1);
          mma_3xtf32(st[k], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    if (c + 1 == nch) break;
    __syncthreads();  // every warp is done with this chunk's tiles and state
    if (st_live) {
      const int pr = st_pm * 16 + g;
#pragma unroll
      for (int k = 0; k < ST_PER_WARP; ++k) {
        const int o = pr * LN + (st_nn + k) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(sth + o) = make_float2(st[k][0], st[k][1]);
        *reinterpret_cast<float2*>(stl + o) =
            make_float2(__uint_as_float(tf32_lo_rz(st[k][0])), __uint_as_float(tf32_lo_rz(st[k][1])));
        *reinterpret_cast<float2*>(sth + o + 8 * LN) = make_float2(st[k][2], st[k][3]);
        *reinterpret_cast<float2*>(stl + o + 8 * LN) =
            make_float2(__uint_as_float(tf32_lo_rz(st[k][2])), __uint_as_float(tf32_lo_rz(st[k][3])));
      }
    }
    issue_chunk<float, PS, N>(a, b, h, p0, c0 + Q, min(Q, S - c0 - Q), smf, smf + QP * LX,
                              smf + QP * (LX + LN), smf + QP * (LX + 2 * LN),
                              smf + QP * (LX + 2 * LN + 1));
    cp_async_commit();
  }
}

// ---------------------------------------------------------------------------
// Launch, by element type: bf16 -> ssd_mma_kernel, float -> ssd_tf32_kernel
// ---------------------------------------------------------------------------

template <typename T, int PS, int N>
struct Scan;
template <int PS, int N>
struct Scan<bf16, PS, N> {
  static const void* kernel() { return (const void*)ssd_mma_kernel<PS, N>; }
  static int64_t smem(int QP) { return mma_smem_bytes(QP, PS, N); }
  static void launch(dim3 grid, cudaStream_t st, const MmaArgs& a) {
    ssd_mma_kernel<PS, N><<<grid, kMmaThreads, smem(a.QP), st>>>(a);
  }
};
template <int PS, int N>
struct Scan<float, PS, N> {
  static const void* kernel() { return (const void*)ssd_tf32_kernel<PS, N>; }
  static int64_t smem(int QP) { return tf32_smem_bytes(QP, PS, N); }
  static void launch(dim3 grid, cudaStream_t st, const TfArgs& a) {
    ssd_tf32_kernel<PS, N><<<grid, kMmaThreads, smem(a.QP), st>>>(a);
  }
};

template <typename T, int PS, int N>
cudaError_t prepare(int QP) {
  static SmemOptIn opt_in;
  return opt_in.ensure(Scan<T, PS, N>::kernel(), (size_t)Scan<T, PS, N>::smem(QP));
}

template <typename T, int PS, int N>
int launch_scan(const ScanArgs<T>& a, cudaStream_t st) {
  cudaError_t e = prepare<T, PS, N>(a.QP);
  if (e != cudaSuccess) return (int)e;
  Scan<T, PS, N>::launch(dim3(a.B * a.H, a.P / PS), st, a);
  return (int)cudaGetLastError();
}

template <typename T, int PS, int N>
int occupancy(int QP, int* blocks) {
  cudaError_t e = prepare<T, PS, N>(QP);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, Scan<T, PS, N>::kernel(),
                                                      kMmaThreads, Scan<T, PS, N>::smem(QP));
  }
  return (int)e;
}

// Calls F<T, PS, N>(args...) for the supported widths; -1 for any other.
#define SSD_DISPATCH(F, T, PS, N, ...)                                       \
  do {                                                                       \
    switch (PS * 1000 + N) {                                                 \
      case 16016: return F<T, 16, 16>(__VA_ARGS__);                          \
      case 16032: return F<T, 16, 32>(__VA_ARGS__);                          \
      case 16064: return F<T, 16, 64>(__VA_ARGS__);                          \
      case 16128: return F<T, 16, 128>(__VA_ARGS__);                         \
      case 32016: return F<T, 32, 16>(__VA_ARGS__);                          \
      case 32032: return F<T, 32, 32>(__VA_ARGS__);                          \
      case 32064: return F<T, 32, 64>(__VA_ARGS__);                          \
      case 32128: return F<T, 32, 128>(__VA_ARGS__);                         \
      case 64016: return F<T, 64, 16>(__VA_ARGS__);                          \
      case 64032: return F<T, 64, 32>(__VA_ARGS__);                          \
      case 64064: return F<T, 64, 64>(__VA_ARGS__);                          \
      case 64128: return F<T, 64, 128>(__VA_ARGS__);                         \
      default: return -1;                                                    \
    }                                                                        \
  } while (0)

bool widths_ok(int ps, int N) {
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

// Bytes of shared memory a block of the f32 route needs: chunk rows QP (Q
// rounded up to 16), P-slice ps, state dim N.
extern "C" int64_t mamba2_ssd_smem_bytes(int QP, int ps, int N) {
  return tf32_smem_bytes(QP, ps, N);
}

// The same for the bf16 route.
extern "C" int64_t mamba2_ssd_mma_smem_bytes(int QP, int ps, int N) {
  return mma_smem_bytes(QP, ps, N);
}

// Blocks of a route that stay resident on one SM (sets the kernel's
// shared-memory opt-in first).
extern "C" int mamba2_ssd_occupancy(int f32, int QP, int ps, int N, int* blocks) {
  if (!widths_ok(ps, N) || QP < 16 || QP > kMaxQ || QP % 16) {
    return (int)cudaErrorInvalidValue;
  }
  if (f32) SSD_DISPATCH(occupancy, float, ps, N, QP, blocks);
  SSD_DISPATCH(occupancy, bf16, ps, N, QP, blocks);
}

// The pre-pass alone: chunk-local in-order cumsums of adt and a contiguous
// copy of dt, both (B, H, S) f32. `strides` holds adt's and dt's (b, h, s)
// element strides.
extern "C" int mamba2_ssd_cumsum_launch(const float* adt, const float* dt,
                                        const int64_t* strides, int B, int H, int S, int Q,
                                        float* cum, float* dto, void* stream) {
  if (B < 1 || H < 1 || S < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  return launch_cumsum(adt, dt, strides, B, H, S, Q, cum, dto, (cudaStream_t)stream);
}

// The scan: x, B, C, y f32 (f32 != 0: the tf32 kernel) or bf16 (the bf16
// kernel); adt, dt f32. `strides` holds the 13 element strides x (b, h, s),
// adt (b, h, s), dt (b, h, s), B (b, s), C (b, s). P a multiple of ps (16,
// 32 or 64), N in {16, 32, 64, 128}, every row of x, B and C on 16 bytes.
// cum and dto are (B, H, S) f32 scratch. Launches the cumsum pre-pass, then
// the route's kernel.
extern "C" int mamba2_ssd_launch(const void* x, const float* adt, const float* dt,
                                 const void* bm, const void* cm, void* y,
                                 const int64_t* strides, int B, int H, int S, int P, int N,
                                 int Q, int ps, float* cum, float* dto, int f32, void* stream) {
  if (B < 1 || H < 1 || S < 1 || Q < 1 || Q > kMaxQ || !widths_ok(ps, N) || P < ps ||
      P % ps || (int64_t)B * H > 0x7fffffff || (int64_t)P / ps > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t xs_b = strides[0], xs_h = strides[1], xs_s = strides[2];
  const int64_t bs_b = strides[9], bs_s = strides[10], cs_b = strides[11], cs_s = strides[12];
  const int64_t esz = f32 ? 4 : 2;
  const uint64_t align = (uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm | (uint64_t)(xs_b * esz) |
                         (uint64_t)(xs_h * esz) | (uint64_t)(xs_s * esz) |
                         (uint64_t)(bs_b * esz) | (uint64_t)(bs_s * esz) |
                         (uint64_t)(cs_b * esz) | (uint64_t)(cs_s * esz);
  if (align % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  int err = launch_cumsum(adt, dt, strides + 3, B, H, S, Q, cum, dto, st);
  if (err) return err;
  const int QP = (Q + 15) / 16 * 16;
  if (f32) {
    TfArgs a{(const float*)x, (const float*)bm, (const float*)cm, cum, dto, (float*)y,
             xs_b, xs_h, xs_s, bs_b, bs_s, cs_b, cs_s, B, H, S, P, Q, QP};
    SSD_DISPATCH(launch_scan, float, ps, N, a, st);
  }
  MmaArgs a{(const bf16*)x, (const bf16*)bm, (const bf16*)cm, cum, dto, (bf16*)y,
            xs_b, xs_h, xs_s, bs_b, bs_s, cs_b, cs_s, B, H, S, P, Q, QP};
  SSD_DISPATCH(launch_scan, bf16, ps, N, a, st);
}
