// K1: set-associative cache scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_cache_scan_kernel` of
// src/repro/kernels/cache_scan.py. Each padded set-group sub-trace (one row
// b of the (B, L) inputs) walks its L accesses in order against a
// (num_sets, ways) tag + metadata state: LRU timestamps, 2-bit SRRIP RRPVs
// or FIFO fill times. Per access it writes hit and evict.
//
// What bounds it: not bytes. Each access reads the state the one before it
// in the same set wrote, so a set's accesses are a chain of dependent
// steps while the inputs are a few MB. The first design walked the whole
// row with one warp (~800 cycles an access: shared-memory state behind
// __syncwarp fences); this one walks the sets of a row in parallel, a team
// of lanes per set with the set's tags and metadata in registers, through
// the walk of set_team_scan.cuh (shared with K2). A hit is one compare and
// a ballot, a miss one more min-reduction over a key that packs the
// victim's order and its way, and a register update.
//
// Semantics copied from the reference step (cache._step):
//   * LRU/FIFO timestamps are the access index t in the row, which counts
//     padding too;
//   * SRRIP ages the set on a miss by max(0, 3 - max(rrpv)) and the aging
//     persists; hit sets RRPV 0, fill sets 2; FIFO hits leave meta alone;
//   * victim = first invalid way, else first way at the extreme (SRRIP: the
//     first way whose aged RRPV is 3, which is the first way at the largest
//     RRPV, since every RRPV stays in 0..3);
//   * padding leaves the state untouched and reports a miss and no evict.
#include "set_team_scan.cuh"

namespace {

constexpr int kMaxRrpv = 3;
constexpr int kLru = 0;
constexpr int kSrrip = 1;
constexpr int kFifo = 2;
constexpr int kWayBits = 6;          // ways <= 64: the way index in a victim key
constexpr int kMaxL = 1 << 25;       // timestamps + 1 fit beside the way in 32 bits

// One team's cache set: a tag and a metadata word (timestamp or RRPV) per
// way, in registers.
template <int POLICY, int SLOTS>
struct CacheStep {
  using Out = uint8_t;
  using Staged = uint8_t;
  __device__ static Staged pad(int) { return 0; }  // a miss, no evict

  int tg[SLOTS], meta[SLOTS];
  bool live[SLOTS];

  __device__ __forceinline__ CacheStep(const set_team::Lane& ln, int ways) {
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      tg[q] = -1;
      meta[q] = POLICY == kSrrip ? kMaxRrpv : -1;
      live[q] = ln.mine >= 0 && q * ln.team + ln.lt < ways;
    }
  }

  __device__ __forceinline__ void step(const set_team::Lane& ln, bool act, int tag, int t, int p,
                                       uint8_t* s_hit, uint8_t* s_ev) {
    unsigned hb = 0u;
    int hq = 0;
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const unsigned b =
          (__ballot_sync(set_team::kFull, act && live[q] && tg[q] == tag) >> ln.first) & ln.low;
      if (hb == 0u && b != 0u) {
        hb = b;
        hq = q;
      }
    }
    // Miss: key = (order << 6) | way; the least key is the victim.
    // LRU/FIFO order: an invalid way is -1 < any timestamp, so +1.
    // SRRIP order: 3 - rrpv, so the least is the largest RRPV, and it is
    // also the aging step 3 - max(rrpv).
    const bool miss = act && hb == 0u;
    unsigned key = ~0u;
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const unsigned order = POLICY == kSrrip ? (unsigned)(kMaxRrpv - meta[q])
                                              : (unsigned)(tg[q] < 0 ? 0 : meta[q] + 1);
      if (miss && live[q]) key = min(key, (order << kWayBits) | (unsigned)(q * ln.team + ln.lt));
    }
    const unsigned red = set_team::team_min(key, ln);
    const int victim = (int)(red & ((1u << kWayBits) - 1u));
    const int inc = (int)(red >> kWayBits);
    const int hit_way = hq * ln.team + __ffs(hb) - 1;
    bool is_hit = false, is_evict = false;
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const int w = q * ln.team + ln.lt;
      const bool h = hb != 0u && w == hit_way;     // the first way holding the tag
      const bool fill = miss && live[q] && w == victim;
      is_hit |= h;
      is_evict |= fill && tg[q] >= 0;
      int m = meta[q];
      if (POLICY == kLru) m = h ? t : m;
      if (POLICY == kSrrip) m = h ? 0 : (miss && live[q] ? m + inc : m);
      meta[q] = fill ? (POLICY == kSrrip ? kMaxRrpv - 1 : t) : m;
      tg[q] = fill ? tag : tg[q];
    }
    if (is_hit) s_hit[p] = 1;
    if (is_evict) s_ev[p] = 1;
  }
};

template <int POLICY, int SLOTS>
__global__ void __launch_bounds__(set_team::kMaxThreads, SLOTS == 1 ? 2 : 1)
cache_scan_kernel(const int* __restrict__ sets, const int* __restrict__ tags_in,
                  const uint8_t* __restrict__ valid, uint8_t* __restrict__ hit,
                  uint8_t* __restrict__ evict, int L, int num_sets, int ways,
                  int team_log2) {
  set_team::walk_row<CacheStep<POLICY, SLOTS>>(sets, tags_in, valid, hit, evict, L, num_sets,
                                                ways, team_log2);
}

typedef void (*Kernel)(const int*, const int*, const uint8_t*, uint8_t*, uint8_t*, int, int,
                       int, int);

// The kernel for a policy and geometry with its block size, team width and
// shared memory; nullptr for what it does not take.
Kernel configure(int policy, int L, int num_sets, int ways, int* threads, int* team_log2,
                 size_t* smem) {
  if (L < 1 || L > kMaxL || !set_team::geometry(num_sets, ways, threads, team_log2)) {
    return nullptr;
  }
  *smem = set_team::smem_bytes<CacheStep<kLru, 1>>(L, num_sets);
  const bool two = ways > 32;
  switch (policy) {
    case kLru: return two ? cache_scan_kernel<kLru, 2> : cache_scan_kernel<kLru, 1>;
    case kSrrip: return two ? cache_scan_kernel<kSrrip, 2> : cache_scan_kernel<kSrrip, 1>;
    case kFifo: return two ? cache_scan_kernel<kFifo, 2> : cache_scan_kernel<kFifo, 1>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" int cache_scan_launch(const int* sets, const int* tags,
                                 const uint8_t* valid, uint8_t* hit,
                                 uint8_t* evict, int B, int L, int num_sets,
                                 int ways, int policy, void* stream) {
  int threads, team_log2;
  size_t smem;
  const Kernel k = configure(policy, L, num_sets, ways, &threads, &team_log2, &smem);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<B, threads, smem, (cudaStream_t)stream>>>(sets, tags, valid, hit, evict, L, num_sets,
                                                 ways, team_log2);
  return (int)cudaGetLastError();
}

// Blocks of one launch's shape resident on one SM of the current card.
extern "C" int cache_scan_occupancy(int L, int num_sets, int ways, int policy, int* blocks) {
  int threads, team_log2;
  size_t smem;
  const Kernel k = configure(policy, L, num_sets, ways, &threads, &team_log2, &smem);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, threads, smem);
}
