// K6: tiled online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces `_flash_kernel` of src/repro/kernels/flash_attention.py. For q
// (B,Hq,S,d) and k, v (B,Hkv,Sk,d), query head h reads kv head
// h / (Hq / Hkv) (GQA, MQA), and
//     out = softmax(q k^T * sm_scale [+ causal mask]) v
// Causal attention needs Sk == S; without the mask Sk is free (a decoder's
// queries over an encoder's keys), and the kv-tile loop and the ragged
// last tile's mask read Sk.
// with the reference's arithmetic: f32 scores and accumulator, masked
// scores set to -1e30, running max m and sum l per query row, and
// out = acc / max(l, 1e-30) cast to q's dtype. In causal mode both routes
// skip the k/v tiles past the q tile's last row (the reference's skip of
// blocks with ik*bk > (iq+1)*bq - 1) and mask the columns past each row.
//
// Two routes, chosen by dtype alone, both on the tensor cores; each
// launches or fails.
//
// bf16: the tensor-core kernel (flash_wgmma_kernel). The two products are
// 4 S^2/2 d flops per head when causal: at Zamba2's prefill (8 x 32 heads,
// S 1024, d 80) 42.9 GFLOP, 0.043 ms at the card's 989 TFLOP/s, against
// 168 MB of q, k, v and out, 0.050 ms at 3.35 TB/s. Only `wgmma` reaches
// that rate, so the design is the FlashAttention-3 shape: one block per
// (b, h, 128-row q tile), the longest causal tile first within each head; a
// producer warpgroup (one thread of it issues the loads) and two consumer
// warpgroups of 64 q rows each (one wgmma M tile), 240 registers a consumer
// thread, moved from the producer's (24) with `setmaxnreg`. The producer
// loads the q tile once and fills a 2-stage ring of K and V tiles (BK
// positions x d, bf16) with TMA (`cp.async.bulk.tensor`), each completing
// on its own mbarrier, so the score product of a tile starts while its V is
// still in flight; the consumers release a stage on an `empty` mbarrier.
// Per tile a consumer warpgroup computes S = Q K^T by `wgmma m64nBKk16` (A
// and B from shared memory, both K-major), runs the online softmax on the
// f32 accumulator fragment in registers, rounds P to bf16 in registers and
// accumulates O += P V by `wgmma m64n{64,32,16}k16` per column panel, with P
// as the register A operand and V from shared memory, MN-major.
//
// What holds it back on this card is the softmax, not the loads or the
// products (scripts/attention_ablation.py times the kernel with its
// exponentials removed, with the library's exp2f and with a third K/V
// stage; PERF.md has the readings). Each score costs one FFMA (scale and
// max folded: p = 2^(s * scale * log2 e - m)), one MUFU.EX2
// (`ex2.approx.ftz`, without the range handling of the library's exp2f), a
// max and an add; the row max and sum reduce over the 4 lanes that share a
// row, the sum only once at the end. The two consumer warpgroups overlap
// one's softmax with the other's products; FlashAttention-3's further
// overlap within a warpgroup (tile j's scores issued while tile j-1's
// softmax runs) is not done. Rounding P to bf16 is the one rounding point
// the reference does not have (it keeps p in f32): about 2^-9 |v| on unit
// inputs, inside the bf16 tolerance 3e-2.
//
// Shared-memory layout: each tile is cut into panels of 64 columns (128-byte
// rows, 128-byte swizzle) and a tail panel of 16 or 32 columns (32- or
// 64-byte swizzle), each filled by one TMA box and read by its own wgmma
// descriptor, because d = 80 is no swizzle width. d is padded to DP, one of
// 16, 32, 64, 80, 128, 192, 256: the columns past d come back as TMA's zero
// fill, as do rows past S, which are masked and never written. BK is 128
// positions (64 at DP >= 192, where registers and shared memory would not
// hold 128). q, k, v may be strided views: a 4-D tensor map (d, s, h, b)
// per operand and panel width carries the (b, h, s) strides, which must be
// multiples of 16 bytes (the wrapper copies a tensor whose strides are
// not, and this source refuses them), and d must be a multiple of 8 (the
// wrapper pads). The tensor-map encoder, cuTensorMapEncodeTiled, lives in
// libcuda; it is taken through cudaGetDriverEntryPoint, so the library
// links against the runtime alone.
//
// f32: 3xTF32 (flash_tf32_kernel). One TF32 product keeps about three
// decimal digits, far from the 2e-5 that the reference holds f32 to; the
// split x = hi + lo into two TF32 values and the three products lo.hi +
// hi.lo + hi.hi, summed in f32, keep x.y to about 2^-21 relative, on
// `mma.sync m16n8k8 .tf32` (f32 operands in 32-bit registers). At Zamba2's
// prefill the products are 3 x 42.9 GFLOP, 0.260 ms at the card's 494.7
// TFLOP/s dense TF32 rate, against 336 MB of f32 q, k, v and out, 0.100 ms
// at 3.35 TB/s. One block per (b, h, BQ-row q tile), the longest causal tile
// first; a warp per strip of 16 q rows, so the online softmax runs on the
// accumulator fragment in registers. All threads copy each K/V tile (BK
// positions x d, f32) into a 2-stage ring with cp.async (16-byte copies when
// d and the strides allow, else 4-byte), zero-filled past Sk and d; the tile
// is split once, in shared memory, for every warp: the tensor cores read a
// .tf32 operand's top 19 bits, so the tile as it landed is hi, and only lo
// is written beside it. q stays as it landed and each warp makes the lo of
// its own A fragments per k-step. ldmatrix reads q and K (8 x 4 f32 matrices as 8 x 8 b16 ones);
// the accumulator's columns (2t, 2t + 1 of each 8) are not the A fragment's
// (t, t + 4), so the P.V product reads V's positions 2t and 2t + 1 in their
// place and P, split in registers, feeds it without a trip through shared
// memory. Rows of DP + 4 floats (an odd number of 16-byte units) keep
// ldmatrix and the V fragments' loads free of bank conflicts. What bounds
// it on this card is not device memory: scripts/attention_ablation.py
// times one product in place of three at -25%, the split pass at -11%, V's
// fragment loads at -5%, the exponentials at nothing, and K's fragments
// loaded a k-step ahead gained nothing; PERF.md has the readings.
// (BQ, BK): (128, 64) to d 80, (128, 32) to 128, (64, 32) to 192, (64, 16)
// to 256, as the shared memory holds them.
//
// The output is contiguous (B,Hq,S,d) in q's dtype.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"
#include "tf32_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

constexpr float kNegInf = -1e30f;

// A block's layout: BQ q rows (a strip of 16 a warp), BK k/v rows a tile, d
// padded to DP (a multiple of 8). Rows of kStride = DP + 4 floats, an odd
// number of 16-byte units, so ldmatrix and the V fragments' scalar loads
// meet no bank conflicts. Floats: q [BQ], K [2 stages][BK] and V [2][BK] as
// they land (their own hi halves), K lo and V lo [BK].
template <int DP, int BQ, int BK>
struct TfLayout {
  static_assert(DP % 8 == 0 && BQ % 16 == 0 && BK % 8 == 0, "tile shapes");
  static constexpr int kWarps = BQ / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStride = DP + 4;
  static constexpr int kK = BQ * kStride;
  static constexpr int kV = kK + 2 * BK * kStride;
  static constexpr int kKlo = kV + 2 * BK * kStride;
  static constexpr int kVlo = kKlo + BK * kStride;
  static constexpr int kBytes = (kVlo + BK * kStride) * 4;
};

struct TfArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  // element strides (b, h, s) of q, k, v
  int64_t qs_b, qs_h, qs_s, ks_b, ks_h, ks_s, vs_b, vs_h, vs_s;
  int S, Sk, d, Hq, group, causal;
  int vec;           // 16-byte copies: d and every stride a multiple of 4, bases 16-byte aligned
  float scale_log2;  // sm_scale * log2(e): p = exp2(s * scale_log2 - m)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !full (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// 2^x by the MUFU unit alone (relative error ~2^-22; denormal results
// flush to 0, which p = 2^(s - max) <= 1 can afford).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + ROWS) of one (b, head) slice into dst [ROWS][DP + 4],
// zero-filled past `limit` rows and past d columns.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void tf_load(float* dst, const float* src, int64_t ss, int r0, int limit,
                                        int d, bool vec, int tid) {
  constexpr int kS = DP + 4;
  if (vec) {
    constexpr int C = DP / 4;
    for (int e = tid; e < ROWS * C; e += NT) {
      const int r = e / C, c = (e - r * C) * 4;
      const bool full = r0 + r < limit && c < d;
      cp_async16(dst + r * kS + c, full ? src + (int64_t)(r0 + r) * ss + c : src, full);
    }
  } else {
    for (int e = tid; e < ROWS * DP; e += NT) {
      const int r = e / DP, c = e - r * DP;
      const bool full = r0 + r < limit && c < d;
      cp_async4(dst + r * kS + c, full ? src + (int64_t)(r0 + r) * ss + c : src, full);
    }
  }
}

// A landed tile [ROWS][DP + 4] split once for every warp: the tile as it
// landed is hi, lo goes beside it.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void tf_split(const float* hi, float* lo, int tid) {
  constexpr int kS = DP + 4, C = DP / 4;
  for (int e = tid; e < ROWS * C; e += NT) {
    const int r = e / C, c = (e - r * C) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + r * kS + c);
    *reinterpret_cast<uint4*>(lo + r * kS + c) =
        make_uint4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
  }
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(TfLayout<DP, BQ, BK>::kThreads, 1)
    flash_tf32_kernel(const TfArgs a) {
  using L = TfLayout<DP, BQ, BK>;
  constexpr int NT = L::kThreads, kS = L::kStride;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = sm + L::kK;
  float* vs = sm + L::kV;
  float* klo = sm + L::kKlo;
  float* vlo = sm + L::kVlo;

  // Longest causal q tile first within each head.
  const int iq = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * BQ, S = a.S, Sk = a.Sk;
  const int k_end = a.causal ? min(S, q0 + BQ) : Sk;
  const int nk = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kvh = h / a.group;
  const float* qg = a.q + b * a.qs_b + h * a.qs_h;
  const float* kg = a.k + b * a.ks_b + kvh * a.ks_h;
  const float* vg = a.v + b * a.vs_b + kvh * a.vs_h;
  const bool vec = a.vec != 0;

  tf_load<DP, BQ, NT>(qs, qg, a.qs_s, q0, S, a.d, vec, tid);
  tf_load<DP, BK, NT>(ks, kg, a.ks_s, 0, Sk, a.d, vec, tid);
  tf_load<DP, BK, NT>(vs, vg, a.vs_s, 0, Sk, a.d, vec, tid);
  cp_async_commit();

  // This warp's strip: rows wr0 .. wr0 + 15; this thread's rows row0 and
  // row1 of the accumulator fragments, columns 2t and 2t + 1 of each 8.
  const int wr0 = q0 + warp * 16, row0 = wr0 + g, row1 = row0 + 8;
  // ldmatrix: matrix m = lane / 8, its row lane % 8. q's A fragment (rows
  // 0-7 / 8-15 x columns 0-3 / 4-7 of a k-step); K's B fragment (hi
  // columns 0-3, 4-7, lo 0-3, 4-7 of 8 positions).
  const int lm = lane / 8, lr = lane % 8;
  const float* qa = qs + (warp * 16 + (lm & 1) * 8 + lr) * kS + (lm >> 1) * 4;
  const int kb_off = lr * kS + (lm & 1) * 4;

  float o[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float sc = a.scale_log2;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j (and q) landed; every warp is done with tile j - 1
    const int st = j & 1;
    float* kt = ks + st * BK * kS;
    float* vt = vs + st * BK * kS;
    if (j + 1 < nk) {
      tf_load<DP, BK, NT>(ks + (st ^ 1) * BK * kS, kg, a.ks_s, (j + 1) * BK, Sk, a.d, vec, tid);
      tf_load<DP, BK, NT>(vs + (st ^ 1) * BK * kS, vg, a.vs_s, (j + 1) * BK, Sk, a.d, vec, tid);
      cp_async_commit();
    }
    tf_split<DP, BK, NT>(kt, klo, tid);
    tf_split<DP, BK, NT>(vt, vlo, tid);
    __syncthreads();
    const int k0 = j * BK;
    if (a.causal && k0 > wr0 + 15) continue;  // every score of the strip is masked

    // S = Q K^T: q split into hi and lo per k-step, K's halves from the tile.
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    const float* kb = (lm < 2 ? kt : klo) + kb_off;
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      uint32_t qr[4], ah[4], al[4];
      ldsm_x4(qr, qa + 8 * kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(qr[e]), ah[e], al[e]);
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        uint32_t kf[4];  // hi b0, hi b1, lo b0, lo b1
        ldsm_x4(kf, kb + jj * 8 * kS + 8 * kk);
        mma_3xtf32(s[jj], ah, al, kf[0], kf[1], kf[2], kf[3]);
      }
    }

    // Online softmax on the fragment: s[jj][e] is row (e < 2 ? row0 : row1),
    // column k0 + 8 jj + 2t + (e & 1). Masked scores become -1e30 before
    // scaling (sm_scale > 0 keeps the order); p = 2^(s * scale_log2 - m).
    if (k0 + BK > Sk || (a.causal && k0 + BK - 1 > wr0)) {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * jj + 2 * t + (e & 1);
          if (col >= Sk || (a.causal && col > (e < 2 ? row0 : row1))) s[jj][e] = kNegInf;
        }
    }
    float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(s[jj][0], s[jj][1]));
      mx1 = fmaxf(mx1, fmaxf(s[jj][2], s[jj][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * sc), mn1 = fmaxf(m1, mx1 * sc);
    const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      s[jj][0] = fast_exp2(fmaf(s[jj][0], sc, -mn0));
      s[jj][1] = fast_exp2(fmaf(s[jj][1], sc, -mn0));
      s[jj][2] = fast_exp2(fmaf(s[jj][2], sc, -mn1));
      s[jj][3] = fast_exp2(fmaf(s[jj][3], sc, -mn1));
      sum0 += s[jj][0] + s[jj][1];
      sum1 += s[jj][2] + s[jj][3];
    }
    l0 = al0 * l0 + sum0;  // this lane's share of the row sum
    l1 = al1 * l1 + sum1;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al0;
      o[i][2] *= al1;
      o[i][3] *= al1;
    }

    // O += P V. The accumulator holds columns 2t, 2t + 1 of each 8 where the
    // A fragment wants columns t, t + 4: the k-step reads positions 2t and
    // 2t + 1 of V in their place (the sum over positions does not care), so
    // P feeds the product from its registers.
    const float* vh = vt + 2 * t * kS + g;
    const float* vl = vlo + 2 * t * kS + g;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      uint32_t ph[4], pl[4];
      split_tf32(s[jj][0], ph[0], pl[0]);
      split_tf32(s[jj][2], ph[1], pl[1]);
      split_tf32(s[jj][1], ph[2], pl[2]);
      split_tf32(s[jj][3], ph[3], pl[3]);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int off = 8 * jj * kS + 8 * i;
        mma_3xtf32(o[i], ph, pl, __float_as_uint(vh[off]), __float_as_uint(vh[off + kS]),
                   __float_as_uint(vl[off]), __float_as_uint(vl[off + kS]));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  float* ob = a.o + ((int64_t)b * a.Hq + h) * S * a.d;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * t + (e & 1), row = e < 2 ? row0 : row1;
      if (col < a.d && row < S) ob[(int64_t)row * a.d + col] = o[i][e] * (e < 2 ? inv0 : inv1);
    }
}

template <int DP, int BQ, int BK>
int launch_tf32(const TfArgs& a, int B, cudaStream_t st) {
  constexpr int bytes = TfLayout<DP, BQ, BK>::kBytes;
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in.ensure((const void*)flash_tf32_kernel<DP, BQ, BK>, bytes);
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, B);
  flash_tf32_kernel<DP, BQ, BK><<<grid, TfLayout<DP, BQ, BK>::kThreads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kWgBQ = 128;         // q rows of a block: two warpgroups of 64
constexpr int kWgConsumers = 256;  // two consumer warpgroups
// + a producer warpgroup: one thread issues the loads, and the group hands
// its registers to the consumers (setmaxnreg works per warpgroup).
constexpr int kWgThreads = kWgConsumers + 128;

// A (rows x DP) bf16 tile in shared memory is DP / 64 panels of 64 columns
// (128-byte rows, 128-byte swizzle) and a tail panel of DP % 64 = 16 or 32
// columns (32- or 64-byte rows and swizzle), each [rows][width] as one TMA
// box writes it.
template <int DP, int BK>
struct WgLayout {
  static constexpr int kFull = DP / 64;
  static constexpr int kTail = DP % 64;
  static_assert(kTail == 0 || kTail == 16 || kTail == 32, "DP % 64 must be 0, 16 or 32");
  static constexpr int kQBytes = kWgBQ * DP * 2;
  static constexpr int kKVBytes = BK * DP * 2;
  // K/V stages of the ring (scripts/attention_ablation.py times a third:
  // the consumers' softmax, not the loads, sets the pace).
  static constexpr int kStages = 2;
  // q, K[kStages], V[kStages], then 1 + 3 kStages mbarriers; + slack to
  // align the base to 1024 B
  static constexpr int kBarOff = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 3 * kStages) + 1024;
};

struct WgArgs {
  __nv_bfloat16* o;
  int S, Sk, d, Hq, group, causal;
  float scale_log2;  // sm_scale * log2(e): p = exp2(s * scale_log2 - m)
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor of a panel `width` columns wide
// (swizzle of 2 * width bytes): start address, leading byte offset (lbo)
// and stride byte offset (sbo), in 16-byte units, and the layout type
// (1: 128-byte swizzle, 2: 64-byte, 3: 32-byte).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, int width, uint32_t lbo, uint32_t sbo) {
  const uint64_t kind = width == 64 ? 1 : width == 32 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (kind << 62);
}

// K-major operand (rows x DP, d contiguous), k-step kk (columns 16 kk ..),
// starting at row r0 (a multiple of 8): within a panel a k-step is 32 bytes
// further along the swizzled rows; 8 rows are 16 * width bytes apart.
template <int DP, int BK>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows, int r0, int kk) {
  using L = WgLayout<DP, BK>;
  const bool full = kk < 4 * L::kFull;
  const int width = full ? 64 : L::kTail;
  const uint32_t panel = tile + (full ? kk / 4 : L::kFull) * rows * 128;
  const uint32_t addr = panel + r0 * width * 2 + (full ? kk % 4 : kk - 4 * L::kFull) * 32;
  return wg_desc(addr, width, 16, 16 * width);  // lbo is unused by swizzled K-major
}

// V (BK x DP, d contiguous) as the MN-major B operand of P V, k-step kk
// (positions 16 kk ..), panel p (< kFull, or the tail): 16 positions are
// 16 swizzled rows further; 8 rows are 16 * width bytes apart (sbo), and
// panels BK * 128 bytes (lbo).
template <int DP, int BK>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int p, int kk) {
  using L = WgLayout<DP, BK>;
  const int width = p < L::kFull ? 64 : L::kTail;
  const uint32_t addr = tile + p * BK * 128 + kk * 16 * width * 2;
  return wg_desc(addr, width, BK * 128, 16 * width);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving register reads or writes of an operand
// across the asynchronous wgmma that owns it.
__device__ __forceinline__ void wg_keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void wg_keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// D(64 x N, f32) (+)= A(64 x 16) B(16 x N), A and B bf16 in shared memory,
// both K-major; scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// D(64 x N, f32) += A(64 x 16) B(16 x N), A bf16 in registers (the m16k16
// fragment of each warp), B bf16 in shared memory, MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP, int BK>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tq_tail,
                       const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tk_tail,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tv_tail,
                       const WgArgs a) {
  using L = WgLayout<DP, BK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;
  constexpr int NS = L::kStages;
  unsigned char* ks = base + L::kQBytes;  // stage st at + st * kKVBytes
  unsigned char* vs = base + L::kQBytes + NS * L::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBarOff);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;       // [NS]
  uint64_t* v_full = bars + 1 + NS;  // [NS]
  uint64_t* empty = bars + 1 + 2 * NS;  // [NS]

  // Longest causal q tile first within each head.
  const int iq = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kWgBQ, S = a.S, Sk = a.Sk;
  const int k_end = a.causal ? min(S, q0 + kWgBQ) : Sk;
  const int nk = (k_end + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], kWgConsumers / 32);  // lane 0 of every consumer warp
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    // ---- producer warpgroup: one thread issues the TMA loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kWgConsumers / 32 && lane == 0) {
      const int kvh = h / a.group;
      // A tile's panels: kFull boxes of 64 columns, then the tail's box;
      // columns past d come back as TMA's zero fill.
      auto load = [&](unsigned char* tile, int rows, const CUtensorMap* full,
                      const CUtensorMap* tail, uint64_t* bar, int row, int head) {
        mbar_expect_tx(bar, rows * DP * 2);
        for (int p = 0; p < L::kFull; ++p) tma_load_4d(tile + p * rows * 128, full, bar, 64 * p, row, head, b);
        if (L::kTail) tma_load_4d(tile + L::kFull * rows * 128, tail, bar, 64 * L::kFull, row, head, b);
      };
      load(qs, kWgBQ, &tq, &tq_tail, q_full, q0, h);
      for (int j = 0; j < nk; ++j) {
        const int st = j % NS;
        if (j >= NS) mbar_wait(&empty[st], (j / NS - 1) & 1);
        load(ks + st * L::kKVBytes, BK, &tk, &tk_tail, &k_full[st], j * BK, kvh);
        load(vs + st * L::kKVBytes, BK, &tv, &tv_tail, &v_full[st], j * BK, kvh);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wgi = tid / 128, wi = (tid % 128) / 32;
    // This thread's two rows of the accumulator fragments, and its column
    // pair within each 8-column chunk.
    const int row0 = q0 + wgi * 64 + wi * 16 + lane / 4, row1 = row0 + 8;
    const int cq = (lane % 4) * 2;
    const uint32_t q_addr = smem_u32(qs);

    float o[DP / 2], s[BK / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int st = j % NS;
      const uint32_t ph = (j / NS) & 1;
      const int k0 = j * BK;

      // S = Q K^T, both K-major, DP / 16 k-steps.
      mbar_wait(&k_full[st], ph);
      const uint32_t k_addr = smem_u32(ks + st * L::kKVBytes);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) wg_keep(s[i]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wgmma_ss<BK>(s, kmajor_desc<DP, BK>(q_addr, kWgBQ, wgi * 64, kk),
                     kmajor_desc<DP, BK>(k_addr, BK, 0, kk), kk > 0);
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) wg_keep(s[i]);

      // Online softmax on the fragment: s[4i + e] is row (e < 2 ? row0 :
      // row1), column k0 + 8i + cq + (e & 1). Masked scores become -1e30
      // before scaling (sm_scale > 0 keeps the order); the max is taken on
      // the raw scores and p = 2^(s * scale_log2 - m) is one FFMA and one
      // MUFU.EX2 per score.
      if (k0 + BK > Sk || (a.causal && k0 + BK - 1 > q0 + wgi * 64)) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * i + cq + (e & 1);
            if (col >= Sk || (a.causal && col > (e < 2 ? row0 : row1))) s[4 * i + e] = -1e30f;
          }
      }
      float mx0 = s[0], mx1 = s[2];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float sc = a.scale_log2;
      const float mn0 = fmaxf(m0, mx0 * sc), mn1 = fmaxf(m1, mx1 * sc);
      const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // P in bf16, laid out as the A fragments of the 16-position k-steps.
      uint32_t p[BK / 16][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float p0 = fast_exp2(fmaf(s[4 * i], sc, -mn0));
        const float p1 = fast_exp2(fmaf(s[4 * i + 1], sc, -mn0));
        const float p2 = fast_exp2(fmaf(s[4 * i + 2], sc, -mn1));
        const float p3 = fast_exp2(fmaf(s[4 * i + 3], sc, -mn1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        p[i / 2][(i & 1) * 2] = pack_bf16(p0, p1);
        p[i / 2][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = al0 * l0 + sum0;  // this lane's share of the row sum
      l1 = al1 * l1 + sum1;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= al0;
        o[4 * i + 1] *= al0;
        o[4 * i + 2] *= al1;
        o[4 * i + 3] *= al1;
      }

      // O += P V: one wgmma per k-step and panel; panel p's 64 columns are
      // o[32 p ..], the tail's o[32 kFull ..].
      mbar_wait(&v_full[st], ph);
      const uint32_t v_addr = smem_u32(vs + st * L::kKVBytes);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) wg_keep(o[i]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int pn = 0; pn < L::kFull; ++pn)
          wgmma_rs<64>(*reinterpret_cast<float(*)[32]>(&o[32 * pn]), p[kk],
                       mnmajor_desc<DP, BK>(v_addr, pn, kk));
        if constexpr (L::kTail > 0)
          wgmma_rs<L::kTail>(*reinterpret_cast<float(*)[L::kTail / 2]>(&o[32 * L::kFull]), p[kk],
                             mnmajor_desc<DP, BK>(v_addr, L::kFull, kk));
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) wg_keep(o[i]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) wg_keep(p[kk][e]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = a.o + ((int64_t)b * a.Hq + h) * S * a.d;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = 8 * i + cq;
      if (col < a.d) {
        if (row0 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row0 * a.d + col) =
              __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        if (row1 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row1 * a.d + col) =
              __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// Errors of cuTensorMapEncodeTiled come back as kEncodeError + its CUresult.
constexpr int kEncodeError = 10000;

// The (d, s, h, b) bf16 tensor at `ptr` with element strides (sb, sh, ss),
// read in boxes of (`width` columns, `rows` positions), swizzled over
// 2 * width bytes.
int encode_map(CUtensorMap* map, const void* ptr, int d, int S, int H, int B, int64_t sb,
               int64_t sh, int64_t ss, int width, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)width, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// The full-panel and tail maps of one operand.
template <int DP>
int encode_operand(CUtensorMap* full, CUtensorMap* tail, const void* ptr, int d, int S, int H,
                   int B, const int64_t* st, int rows) {
  int err = 0;
  if (DP >= 64) err = encode_map(full, ptr, d, S, H, B, st[0], st[1], st[2], 64, rows);
  if (err == 0 && DP % 64) err = encode_map(tail, ptr, d, S, H, B, st[0], st[1], st[2], DP % 64, rows);
  return err;
}

template <int DP, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, const int64_t* st, int B, int Hkv,
                 WgArgs a, cudaStream_t stream) {
  CUtensorMap m[6] = {};
  int err = encode_operand<DP>(&m[0], &m[1], q, a.d, a.S, a.Hq, B, st, kWgBQ);
  if (err == 0) err = encode_operand<DP>(&m[2], &m[3], k, a.d, a.Sk, Hkv, B, st + 3, BK);
  if (err == 0) err = encode_operand<DP>(&m[4], &m[5], v, a.d, a.Sk, Hkv, B, st + 6, BK);
  if (err != 0) return err;
  constexpr int bytes = WgLayout<DP, BK>::kSmem;
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in.ensure((const void*)flash_wgmma_kernel<DP, BK>, bytes);
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((a.S + kWgBQ - 1) / kWgBQ, a.Hq, B);
  flash_wgmma_kernel<DP, BK><<<grid, kWgThreads, bytes, stream>>>(m[0], m[1], m[2], m[3], m[4],
                                                                  m[5], a);
  return (int)cudaGetLastError();
}

}  // namespace

// f32 (3xTF32 on the tensor cores): q (B,Hq,S,d), k and v (B,Hkv,Sk,d),
// each with the element strides (b, h, s) in `strides` (q's three, then
// k's, then v's), d contiguous; out contiguous (B,Hq,S,d). Causal needs
// Sk == S.
extern "C" int flash_attention_f32_launch(const void* q, const void* k, const void* v, void* out,
                                          const int64_t* strides, int B, int Hq, int Hkv, int S,
                                          int Sk, int d, int causal, float scale, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 || Hq % Hkv != 0 || S < 1 ||
      Sk < 1 || (causal && Sk != S) || d < 1 || d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  bool vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 4 == 0;
  const TfArgs a{(const float*)q, (const float*)k, (const float*)v, (float*)out,
                 strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                 strides[6], strides[7], strides[8], S, Sk, d, Hq, Hq / Hkv, causal ? 1 : 0,
                 vec ? 1 : 0, scale * 1.4426950408889634f};
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 16) return launch_tf32<16, 128, 64>(a, B, st);
  if (d <= 32) return launch_tf32<32, 128, 64>(a, B, st);
  if (d <= 64) return launch_tf32<64, 128, 64>(a, B, st);
  if (d <= 80) return launch_tf32<80, 128, 64>(a, B, st);
  if (d <= 128) return launch_tf32<128, 128, 32>(a, B, st);
  if (d <= 192) return launch_tf32<192, 64, 32>(a, B, st);
  return launch_tf32<256, 64, 16>(a, B, st);
}

// bf16 (the tensor-core kernel): as above, with d a multiple of 8, every
// stride a multiple of 8 elements (16 bytes) and q, k, v 16-byte aligned.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k, const void* v, void* out,
                                           const int64_t* strides, int B, int Hq, int Hkv, int S,
                                           int Sk, int d, int causal, float scale, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 || Hq % Hkv != 0 || S < 1 ||
      Sk < 1 || (causal && Sk != S) || d < 8 || d > 256 || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0) return (int)cudaErrorInvalidValue;
  WgArgs a{(__nv_bfloat16*)out, S, Sk, d, Hq, Hq / Hkv, causal ? 1 : 0,
           scale * 1.4426950408889634f};
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 16) return launch_wgmma<16, 128>(q, k, v, strides, B, Hkv, a, st);
  if (d <= 32) return launch_wgmma<32, 128>(q, k, v, strides, B, Hkv, a, st);
  if (d <= 64) return launch_wgmma<64, 128>(q, k, v, strides, B, Hkv, a, st);
  if (d <= 80) return launch_wgmma<80, 128>(q, k, v, strides, B, Hkv, a, st);
  if (d <= 128) return launch_wgmma<128, 128>(q, k, v, strides, B, Hkv, a, st);
  if (d <= 192) return launch_wgmma<192, 64>(q, k, v, strides, B, Hkv, a, st);
  return launch_wgmma<256, 64>(q, k, v, strides, B, Hkv, a, st);
}
