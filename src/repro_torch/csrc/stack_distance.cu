// K2: LRU stack-distance scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_stack_distance_kernel` of
// src/repro/kernels/stack_distance.py. Each padded set-group sub-trace (one
// row b of the (B, L) inputs) keeps a recency-ordered tag list per set
// (way 0 = MRU, -1 = empty). Per access the position of its tag in the list
// is the stack distance, capped at `ways`; the list then updates by one
// rotate-insert toward MRU. A miss into a full set evicts. A padded slot
// reports distance `ways` and leaves the state alone.
//
// What bounds it: like K1, the L dependent updates of a row, not bytes.
// Design: one warp per row, the (num_sets <= 16, ways) lists in shared
// memory; ways across lanes with a loop for ways > 32; the match is
// __ballot_sync + __ffs (the lowest way, as the reference's masked sum
// gives for the single possible match); the rotate is done chunk by chunk
// from the LRU end, each lane reading its left neighbour before any lane of
// the chunk writes, so no chunk overwrites a value a lower chunk still has
// to read. Inputs are loaded 32 at a time and broadcast by __shfl_sync.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32)
stack_distance_kernel(const int* __restrict__ sets, const int* __restrict__ tags_in,
                      const uint8_t* __restrict__ valid, int* __restrict__ dist,
                      uint8_t* __restrict__ evict, int L, int num_sets, int ways) {
  extern __shared__ int lists[];
  const int lane = threadIdx.x;
  for (int i = lane; i < num_sets * ways; i += 32) lists[i] = -1;
  __syncwarp();

  const int last_chunk = ((ways - 1) / 32) * 32;
  const size_t row = (size_t)blockIdx.x * (size_t)L;
  for (int base = 0; base < L; base += 32) {
    const int idx = base + lane;
    int my_s = 0, my_tag = 0, my_v = 0;
    if (idx < L) {
      my_s = sets[row + idx];
      my_tag = tags_in[row + idx];
      my_v = valid[row + idx];
    }
    int my_dist = ways, my_evict = 0;
    const int n = min(32, L - base);
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(kFull, my_s, j);
      const int tag = __shfl_sync(kFull, my_tag, j);
      const int v = __shfl_sync(kFull, my_v, j);
      int d = ways, e = 0;
      // An out-of-range set index is treated as padding.
      if (v && s >= 0 && s < num_sets) {
        int* list = lists + s * ways;
        int pos = -1;
        for (int c = 0; c < ways; c += 32) {
          const int w = c + lane;
          const unsigned bal = __ballot_sync(kFull, w < ways && list[w] == tag);
          if (bal) {
            pos = c + __ffs(bal) - 1;
            break;
          }
        }
        const bool found = pos >= 0;
        d = found ? pos : ways;
        const int limit = found ? pos : ways - 1;
        e = !found && list[ways - 1] >= 0;
        __syncwarp();
        for (int c = last_chunk; c >= 0; c -= 32) {
          const int w = c + lane;
          int nv = 0;
          bool write = false;
          if (w < ways) {
            if (w == 0) {
              nv = tag;
              write = true;
            } else if (w <= limit) {
              nv = list[w - 1];
              write = true;
            }
          }
          __syncwarp();
          if (write) list[w] = nv;
          __syncwarp();
        }
      }
      if (lane == j) {
        my_dist = d;
        my_evict = e;
      }
    }
    if (idx < L) {
      dist[row + idx] = my_dist;
      evict[row + idx] = (uint8_t)my_evict;
    }
  }
}

}  // namespace

extern "C" int stack_distance_launch(const int* sets, const int* tags,
                                     const uint8_t* valid, int* dist,
                                     uint8_t* evict, int B, int L,
                                     int num_sets, int ways, void* stream) {
  const size_t smem = (size_t)num_sets * ways * sizeof(int);
  stack_distance_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      sets, tags, valid, dist, evict, L, num_sets, ways);
  return (int)cudaGetLastError();
}
