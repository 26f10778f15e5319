// K2: LRU stack-distance scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_stack_distance_kernel` of
// src/repro/kernels/stack_distance.py. Each padded set-group sub-trace (one
// row b of the (B, L) inputs) keeps a recency-ordered tag list per set
// (position 0 = MRU, -1 = empty). Per access, the distance is the position
// of its tag in the list (the reference sums the positions that hold it,
// which is the position for any tag the list holds once), or `ways` if the
// list does not hold it. Then positions [1, limit] take their left
// neighbour and position 0 takes the tag (limit = the distance on a hit, at
// most ways - 1; ways - 1 on a miss). A miss into a full set (the last
// position holds a tag >= 0) evicts. Padding and out-of-range sets report
// `ways` and no evict, and leave the lists alone.
//
// What bounds it: like K1, not bytes but the chain of dependent updates of
// the longest set. The first design walked the whole row with one warp and
// the lists in shared memory (~600 cycles an access behind three __syncwarp
// fences). This one is K1's walk (set_team_scan.cuh): a team of lanes per
// set, one way per lane, with the list as a permutation in registers. A
// lane holds a way's tag and its rank, the way's position in the list
// (initially rank = way, tag = -1, so the empty ways hold the tail as in
// the list). One access is one team sum over the lanes whose tag matches
// (the distance, and whether any matched), then in each lane: rank ==
// limit takes rank 0 and the tag (on a miss it evicts if its old tag is
// >= 0), rank < limit moves one down (rank + 1), any other rank stays.
// That is the reference's rotate-insert, exactly, even for a valid tag of
// -1 that matches several empty positions.
#include "set_team_scan.cuh"

namespace {

constexpr int kNever = 1 << 20;  // the rank of a lane past `ways`: never at or before a limit

// One team's recency list: a tag and a rank per way, in registers.
template <int SLOTS>
struct RankStep {
  using Out = int;
  using Staged = short;  // distances up to 2,016 (the sum of 64 ranks)
  __device__ static Staged pad(int ways) { return (Staged)ways; }

  int tg[SLOTS], rank[SLOTS];
  bool live[SLOTS];
  int ways;

  __device__ __forceinline__ RankStep(const set_team::Lane& ln, int ways_) : ways(ways_) {
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const int w = q * ln.team + ln.lt;
      live[q] = ln.mine >= 0 && w < ways;
      tg[q] = -1;
      rank[q] = live[q] ? w : kNever;
    }
  }

  __device__ __forceinline__ void step(const set_team::Lane& ln, bool act, int tag, int, int p,
                                       short* s_dist, uint8_t* s_ev) {
    // Each matching way adds 1 << 16 | rank: the team's sum holds how many
    // matched above bit 16 and the sum of their ranks below it.
    unsigned part = 0u;
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      part += act && live[q] && tg[q] == tag ? (1u << 16) | (unsigned)rank[q] : 0u;
    }
    const unsigned sum = set_team::team_add(part, ln);
    const bool found = sum >= (1u << 16);
    const int d = found ? (int)(sum & 0xffffu) : ways;
    const int limit = d < ways ? d : ways - 1;
    bool ev = false;
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const bool at = act && rank[q] == limit;
      ev |= at && !found && tg[q] >= 0;
      rank[q] = at ? 0 : (act && rank[q] < limit ? rank[q] + 1 : rank[q]);
      tg[q] = at ? tag : tg[q];
    }
    if (act && ln.lt == 0) s_dist[p] = (short)d;
    if (ev) s_ev[p] = 1;
  }
};

template <int SLOTS>
__global__ void __launch_bounds__(set_team::kMaxThreads, SLOTS == 1 ? 2 : 1)
stack_distance_kernel(const int* __restrict__ sets, const int* __restrict__ tags_in,
                      const uint8_t* __restrict__ valid, int* __restrict__ dist,
                      uint8_t* __restrict__ evict, int L, int num_sets, int ways,
                      int team_log2) {
  set_team::walk_row<RankStep<SLOTS>>(sets, tags_in, valid, dist, evict, L, num_sets, ways,
                                      team_log2);
}

typedef void (*Kernel)(const int*, const int*, const uint8_t*, int*, uint8_t*, int, int, int,
                       int);

// The kernel for a geometry with its block size, team width and shared
// memory; nullptr for what it does not take.
Kernel configure(int L, int num_sets, int ways, int* threads, int* team_log2, size_t* smem) {
  if (L < 1 || !set_team::geometry(num_sets, ways, threads, team_log2)) return nullptr;
  *smem = set_team::smem_bytes<RankStep<1>>(L, num_sets);
  return ways > 32 ? stack_distance_kernel<2> : stack_distance_kernel<1>;
}

}  // namespace

extern "C" int stack_distance_launch(const int* sets, const int* tags,
                                     const uint8_t* valid, int* dist,
                                     uint8_t* evict, int B, int L,
                                     int num_sets, int ways, void* stream) {
  int threads, team_log2;
  size_t smem;
  const Kernel k = configure(L, num_sets, ways, &threads, &team_log2, &smem);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<B, threads, smem, (cudaStream_t)stream>>>(sets, tags, valid, dist, evict, L, num_sets,
                                                 ways, team_log2);
  return (int)cudaGetLastError();
}

// Blocks of one launch's shape resident on one SM of the current card.
extern "C" int stack_distance_occupancy(int L, int num_sets, int ways, int* blocks) {
  int threads, team_log2;
  size_t smem;
  const Kernel k = configure(L, num_sets, ways, &threads, &team_log2, &smem);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads, smem);
}
