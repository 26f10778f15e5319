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
// steps while the inputs are a few MB. But the sets of a row never touch
// each other's state (an LRU/FIFO timestamp is only compared within its
// set), so the chain is the longest set's, not the row's. The first design
// walked the whole row with one warp (~800 cycles an access: shared-memory
// state behind __syncwarp fences); this one walks the sets in parallel:
//   * a block is one row; each set of the row has a team of `ways` lanes
//     rounded up to a power of two (at most 32; 16 sets x 16 ways = 256
//     threads, so a 1,024-row classification fits the card in one round);
//   * a team keeps its set's state in registers, one way per lane (a second
//     slot per lane past 32 ways): a hit is one compare and a ballot, a
//     miss one more min-reduction over a key that packs the victim's order
//     and its way, and a register update;
//   * the row is staged in shared memory a tile at a time (coalesced loads;
//     invalid or out-of-range accesses get set -1), and its positions are
//     sorted by set into one list per team: the teams of a warp read the
//     tile `team` positions at a time, ballot `set == mine` and place
//     their matches after the sets before theirs, which shared-memory
//     atomics counted while the tile was staged (the compaction, inside
//     the kernel);
//   * the teams of a warp walk their lists in step, as many steps as the
//     longest of them, so every collective is over the whole warp (one
//     instruction, no divergence check; a team's minimum is one reduction
//     per team of 16 or 32 lanes, a butterfly below that). Each step reads
//     the next access's position and tag before its own state chain;
//   * hit/evict land in shared memory (zeroed: padding is a miss and no
//     evict) and go out coalesced when the tile is done.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRrpv = 3;
constexpr int kLru = 0;
constexpr int kSrrip = 1;
constexpr int kFifo = 2;
constexpr int kTile = 1024;          // row positions staged at once
constexpr int kMaxThreads = 1024;    // num_sets x team
constexpr int kWayBits = 6;          // ways <= 64: the way index in a victim key
constexpr int kMaxL = 1 << 25;       // timestamps + 1 fit beside the way in 32 bits

// The least key of each team of 2^team_log2 lanes, in every lane of it.
// Every lane of the warp takes part: collectives over the whole warp
// compile to one instruction each, with no divergence check.
__device__ __forceinline__ unsigned team_min(unsigned key, int team_log2, int lane) {
  if (team_log2 == 5) return __reduce_min_sync(kFull, key);
  if (team_log2 == 4) {
    const unsigned lo = __reduce_min_sync(kFull, lane < 16 ? key : ~0u);
    const unsigned hi = __reduce_min_sync(kFull, lane < 16 ? ~0u : key);
    return lane < 16 ? lo : hi;
  }
  for (int o = 1; o < (1 << team_log2); o <<= 1) key = min(key, __shfl_xor_sync(kFull, key, o));
  return key;
}

template <int POLICY, int SLOTS>
__global__ void __launch_bounds__(kMaxThreads, SLOTS == 1 ? 2 : 1)
cache_scan_kernel(const int* __restrict__ sets, const int* __restrict__ tags_in,
                  const uint8_t* __restrict__ valid, uint8_t* __restrict__ hit,
                  uint8_t* __restrict__ evict, int L, int num_sets, int ways,
                  int team_log2) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile = min(L, kTile);
  int* s_tag = (int*)smem;
  int* s_count = s_tag + tile;                           // [num_sets]
  short* s_set = (short*)(s_count + num_sets);
  unsigned short* s_list = (unsigned short*)(s_set + tile);  // positions, by set
  uint8_t* s_hit = (uint8_t*)(s_list + tile);
  uint8_t* s_ev = s_hit + tile;

  const int tid = threadIdx.x;
  const int team = 1 << team_log2;
  // Lanes past num_sets x team (the block is whole warps) form teams with
  // no set: they take part in the collectives and never match.
  const int mine = tid >> team_log2 < num_sets ? tid >> team_log2 : -2;
  const int lt = tid & (team - 1);              // lane in the team: way lt (+ 32 in slot 1)
  const int lane = tid & 31;
  const int first = lane & ~(team - 1);         // the team's first lane in its warp
  const unsigned low = team == 32 ? kFull : (1u << team) - 1u;
  const unsigned below = (1u << lt) - 1u;       // the team's lanes before this one

  int tg[SLOTS], meta[SLOTS];
  bool live[SLOTS];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    tg[q] = -1;
    meta[q] = POLICY == kSrrip ? kMaxRrpv : -1;
    live[q] = mine >= 0 && q * team + lt < ways;
  }

  const size_t row = (size_t)blockIdx.x * (size_t)L;
  for (int base = 0; base < L; base += kTile) {
    const int n = min(kTile, L - base);
    if (tid < num_sets) s_count[tid] = 0;
    __syncthreads();  // the last tile's hit/evict have gone out
#pragma unroll 4
    for (int p = tid; p < n; p += blockDim.x) {
      const int s = sets[row + base + p];
      // An out-of-range set index is treated as padding rather than
      // touching state outside the row's.
      const bool in = valid[row + base + p] && s >= 0 && s < num_sets;
      s_set[p] = in ? (short)s : (short)-1;
      s_tag[p] = tags_in[row + base + p];
      s_hit[p] = 0;
      s_ev[p] = 0;
      if (in) atomicAdd(s_count + s, 1);
    }
    __syncthreads();

    // Compaction: each team's positions of the tile, in order, into its
    // stretch of s_list (the sets' counts, taken while staging, place the
    // stretches). The teams of a warp read the same `team` positions at a
    // time and ballot `set == mine` once for all of them.
    const int count = mine >= 0 ? s_count[mine] : 0;
    int start = 0;
    for (int s = 0; s < mine; ++s) start += s_count[s];
    unsigned short* list = s_list + start;
#pragma unroll 4
    for (int c = 0, k = 0; c < n; c += team) {
      const bool match = c + lt < n && s_set[c + lt] == mine;
      const unsigned b = (__ballot_sync(kFull, match) >> first) & low;
      if (match) list[k + __popc(b & below)] = (unsigned short)(c + lt);
      k += __popc(b);
    }
    __syncwarp();

    // The walk: the teams of a warp in step, each through its own list.
    // The next access's position and tag are read before this one's state
    // chain, so no shared-memory load sits on it.
    const int steps = (int)__reduce_max_sync(kFull, (unsigned)count);
    int p_next = count > 0 ? list[0] : 0;
    int tag_next = s_tag[p_next];
    for (int i = 0; i < steps; ++i) {
      const bool act = i < count;
      const int p = p_next, tag = tag_next, t = base + p;
      if (i + 1 < count) {
        p_next = list[i + 1];
        tag_next = s_tag[p_next];
      }
      unsigned hb = 0u;
      int hq = 0;
#pragma unroll
      for (int q = 0; q < SLOTS; ++q) {
        const unsigned b = (__ballot_sync(kFull, act && live[q] && tg[q] == tag) >> first) & low;
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
        if (miss && live[q]) key = min(key, (order << kWayBits) | (unsigned)(q * team + lt));
      }
      const unsigned red = team_min(key, team_log2, lane);
      const int victim = (int)(red & ((1u << kWayBits) - 1u));
      const int inc = (int)(red >> kWayBits);
      const int hit_way = hq * team + __ffs(hb) - 1;
      bool is_hit = false, is_evict = false;
#pragma unroll
      for (int q = 0; q < SLOTS; ++q) {
        const int w = q * team + lt;
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
    __syncthreads();
#pragma unroll 4
    for (int p = tid; p < n; p += blockDim.x) {
      hit[row + base + p] = s_hit[p];
      evict[row + base + p] = s_ev[p];
    }
  }
}

typedef void (*Kernel)(const int*, const int*, const uint8_t*, uint8_t*, uint8_t*, int, int,
                       int, int);

// The kernel for a policy and geometry with its block size, team width and
// shared memory; nullptr for what it does not take.
Kernel configure(int policy, int L, int num_sets, int ways, int* threads, int* team_log2,
                 size_t* smem) {
  if (num_sets < 1 || ways < 1 || ways > 2 * 32 || L < 1 || L > kMaxL) return nullptr;
  *team_log2 = 0;
  while ((1 << *team_log2) < min(ways, 32)) ++*team_log2;
  *threads = ((num_sets << *team_log2) + 31) / 32 * 32;
  if (*threads > kMaxThreads) return nullptr;
  *smem = (size_t)min(L, kTile) * (4 + 2 + 2 + 1 + 1) + (size_t)num_sets * 4;
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
