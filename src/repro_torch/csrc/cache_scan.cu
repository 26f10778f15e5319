// K1: set-associative cache scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_cache_scan_kernel` of
// src/repro/kernels/cache_scan.py. Each padded set-group sub-trace (one row
// b of the (B, L) inputs) walks its L accesses in order against a
// (num_sets <= 16, ways) tag + metadata state: LRU timestamps, 2-bit SRRIP
// RRPVs or FIFO fill times. Per access it writes hit and evict.
//
// What bounds it: not bytes. A row is L dependent state updates (each
// access reads the state the previous one wrote), so its time is
// L x (per-step latency) while the inputs are a few MB. The design keeps
// that chain short:
//   * one warp per row, the row's whole state in shared memory (at most
//     16 x ways x 8 bytes), never in device memory;
//   * ways across lanes (each lane loops over ways lane, lane+32, ... so
//     ways > 32 works); first-match by __ballot_sync + __ffs, which breaks
//     ties to the lowest way index exactly like the reference's
//     `cumsum == 1` first-true masks; min/max by __reduce_{min,max}_sync;
//   * 32 accesses are loaded at a time, one per lane, and broadcast with
//     __shfl_sync, so no step waits on a device-memory load; hit/evict are
//     written back 32 at a time, coalesced.
// Rows are independent, so B rows fill the card as B warps.
//
// Semantics copied from the reference step (cache._step):
//   * LRU/FIFO timestamps are the access index t, which counts padding too;
//   * SRRIP ages the set on a miss by max(0, 3 - max(rrpv)) and the aging
//     persists; hit sets RRPV 0, fill sets 2; FIFO hits leave meta alone;
//   * victim = first invalid way, else first way at the extreme;
//   * padding leaves the state untouched and reports a miss and no evict.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRrpv = 3;
constexpr int kLru = 0;
constexpr int kSrrip = 1;
constexpr int kFifo = 2;

// First way (lowest index) whose predicate holds, or -1. Warp-uniform.
template <typename Pred>
__device__ __forceinline__ int first_way(int ways, int lane, Pred pred) {
  for (int c = 0; c < ways; c += 32) {
    const int w = c + lane;
    const unsigned bal = __ballot_sync(kFull, w < ways && pred(w));
    if (bal) return c + __ffs(bal) - 1;
  }
  return -1;
}

template <int POLICY>
__device__ __forceinline__ void access(int* tags, int* meta, int ways,
                                       int tag, int t, int lane,
                                       int* hit_out, int* evict_out) {
  const int hit_way = first_way(ways, lane, [&](int w) { return tags[w] == tag; });
  if (hit_way >= 0) {
    __syncwarp();
    if (lane == 0) {
      if (POLICY == kLru) meta[hit_way] = t;
      if (POLICY == kSrrip) meta[hit_way] = 0;
    }
    __syncwarp();
    *hit_out = 1;
    *evict_out = 0;
    return;
  }
  if (POLICY == kSrrip) {
    int mx = INT_MIN;
    for (int c = 0; c < ways; c += 32) {
      const int w = c + lane;
      mx = max(mx, __reduce_max_sync(kFull, w < ways ? meta[w] : INT_MIN));
    }
    const int inc = max(0, kMaxRrpv - mx);
    const int victim = first_way(ways, lane, [&](int w) { return meta[w] + inc == kMaxRrpv; });
    *evict_out = victim >= 0 && tags[victim] >= 0;
    __syncwarp();
    for (int c = 0; c < ways; c += 32) {
      const int w = c + lane;
      if (w < ways) {
        if (w == victim) {
          meta[w] = kMaxRrpv - 1;
          tags[w] = tag;
        } else {
          meta[w] += inc;
        }
      }
    }
  } else {
    // Invalid ways count as -1 < any timestamp: the first minimum is the
    // first invalid way when one exists.
    int mn = INT_MAX;
    for (int c = 0; c < ways; c += 32) {
      const int w = c + lane;
      const int m = w < ways ? (tags[w] < 0 ? -1 : meta[w]) : INT_MAX;
      mn = min(mn, __reduce_min_sync(kFull, m));
    }
    const int victim = first_way(ways, lane, [&](int w) {
      return (tags[w] < 0 ? -1 : meta[w]) == mn;
    });
    *evict_out = tags[victim] >= 0;
    __syncwarp();
    if (lane == 0) {
      tags[victim] = tag;
      meta[victim] = t;
    }
  }
  __syncwarp();
  *hit_out = 0;
}

template <int POLICY>
__global__ void __launch_bounds__(32)
cache_scan_kernel(const int* __restrict__ sets, const int* __restrict__ tags_in,
                  const uint8_t* __restrict__ valid, uint8_t* __restrict__ hit,
                  uint8_t* __restrict__ evict, int L, int num_sets, int ways) {
  extern __shared__ int smem[];
  const int n_state = num_sets * ways;
  int* tags = smem;
  int* meta = smem + n_state;
  const int lane = threadIdx.x;
  const int meta0 = POLICY == kSrrip ? kMaxRrpv : -1;
  for (int i = lane; i < n_state; i += 32) {
    tags[i] = -1;
    meta[i] = meta0;
  }
  __syncwarp();

  const size_t row = (size_t)blockIdx.x * (size_t)L;
  for (int base = 0; base < L; base += 32) {
    const int idx = base + lane;
    int my_s = 0, my_tag = 0, my_v = 0;
    if (idx < L) {
      my_s = sets[row + idx];
      my_tag = tags_in[row + idx];
      my_v = valid[row + idx];
    }
    int my_hit = 0, my_evict = 0;
    const int n = min(32, L - base);
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(kFull, my_s, j);
      const int tag = __shfl_sync(kFull, my_tag, j);
      const int v = __shfl_sync(kFull, my_v, j);
      int h = 0, e = 0;
      // An out-of-range set index is treated as padding rather than
      // touching memory outside the state.
      if (v && s >= 0 && s < num_sets) {
        access<POLICY>(tags + s * ways, meta + s * ways, ways, tag, base + j,
                       lane, &h, &e);
      }
      if (lane == j) {
        my_hit = h;
        my_evict = e;
      }
    }
    if (idx < L) {
      hit[row + idx] = (uint8_t)my_hit;
      evict[row + idx] = (uint8_t)my_evict;
    }
  }
}

}  // namespace

extern "C" int cache_scan_launch(const int* sets, const int* tags,
                                 const uint8_t* valid, uint8_t* hit,
                                 uint8_t* evict, int B, int L, int num_sets,
                                 int ways, int policy, void* stream) {
  const size_t smem = (size_t)2 * num_sets * ways * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  switch (policy) {
    case kLru:
      cache_scan_kernel<kLru><<<B, 32, smem, st>>>(sets, tags, valid, hit, evict, L, num_sets, ways);
      break;
    case kSrrip:
      cache_scan_kernel<kSrrip><<<B, 32, smem, st>>>(sets, tags, valid, hit, evict, L, num_sets, ways);
      break;
    case kFifo:
      cache_scan_kernel<kFifo><<<B, 32, smem, st>>>(sets, tags, valid, hit, evict, L, num_sets, ways);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
