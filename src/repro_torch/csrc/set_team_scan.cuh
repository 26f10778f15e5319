// The set-team walk shared by K1 (cache_scan.cu) and K2 (stack_distance.cu).
//
// Both kernels run B padded set-group sub-traces, the rows of (B, L) sets,
// tags and valid, against a per-set state, and each access reads the state
// the access before it in the same set wrote. The sets of a row never touch
// each other's state, so the chain of dependent steps is the longest set's,
// not the row's. This walk takes that chain and nothing more:
//   * a block is one row; each set of the row has a team of `ways` lanes
//     rounded up to a power of two (at most 32; 16 sets x 16 ways = 256
//     threads, so a 1,024-row classification fits the card in one round);
//   * a team keeps its set's state in registers, one way per lane (a second
//     slot per lane past 32 ways): the kernel's Step holds it and runs one
//     access on it;
//   * the row is staged in shared memory a tile at a time (coalesced loads;
//     invalid or out-of-range accesses get set -1), and its positions are
//     sorted by set into one list per team: the teams of a warp read the
//     tile `team` positions at a time, ballot `set == mine` and place
//     their matches after the sets before theirs, which shared-memory
//     atomics counted while the tile was staged (the compaction, inside
//     the kernel);
//   * the teams of a warp walk their lists in step, as many steps as the
//     longest of them, so every collective is over the whole warp (one
//     instruction, no divergence check; a team's reduction is one per team
//     of 16 or 32 lanes, a butterfly below that). Each step reads the next
//     access's position and tag before its own state chain;
//   * the Step's outputs land in shared memory (set to what padding
//     reports) and go out coalesced when the tile is done.
//
// A Step provides `Out` (the first output's element type), `Staged` (its
// type in shared memory), `static Staged pad(int ways)` (what padding and
// out-of-range accesses report), a constructor `Step(const Lane&, int
// ways)` that sets the team's initial state, and
// `step(const Lane&, bool act, int tag, int t, int p, Staged* s_out,
// uint8_t* s_ev)`, which every lane of the warp calls at every step (`act`
// false when its team's list is done) and which writes the outputs of row
// position p (t = the position in the row, p = in the tile).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace set_team {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 1024;          // row positions staged at once
constexpr int kMaxThreads = 1024;    // num_sets x team
constexpr int kMaxWays = 64;         // a lane holds one way, or two past 32

// A lane's place in its team and warp.
struct Lane {
  int mine;        // the team's set; -2 for lanes past num_sets x team
  int lt;          // lane in the team: way lt (+ 32 in slot 1)
  int lane;        // lane in the warp
  int first;       // the team's first lane in its warp
  int team, team_log2;
  unsigned low;    // a team's bits, at bit 0
  unsigned below;  // the team's lanes before this one
  __device__ __forceinline__ Lane(int num_sets, int team_log2_) {
    const int tid = threadIdx.x;
    team_log2 = team_log2_;
    team = 1 << team_log2;
    // Lanes past num_sets x team (the block is whole warps) form teams with
    // no set: they take part in the collectives and never match.
    mine = tid >> team_log2 < num_sets ? tid >> team_log2 : -2;
    lt = tid & (team - 1);
    lane = tid & 31;
    first = lane & ~(team - 1);
    low = team == 32 ? kFull : (1u << team) - 1u;
    below = (1u << lt) - 1u;
  }
};

// The least key of each team, in every lane of it. Every lane of the warp
// takes part: collectives over the whole warp compile to one instruction
// each, with no divergence check.
__device__ __forceinline__ unsigned team_min(unsigned key, const Lane& ln) {
  if (ln.team_log2 == 5) return __reduce_min_sync(kFull, key);
  if (ln.team_log2 == 4) {
    const unsigned lo = __reduce_min_sync(kFull, ln.lane < 16 ? key : ~0u);
    const unsigned hi = __reduce_min_sync(kFull, ln.lane < 16 ? ~0u : key);
    return ln.lane < 16 ? lo : hi;
  }
  for (int o = 1; o < ln.team; o <<= 1) key = min(key, __shfl_xor_sync(kFull, key, o));
  return key;
}

// The sum over each team, in every lane of it (as team_min).
__device__ __forceinline__ unsigned team_add(unsigned x, const Lane& ln) {
  if (ln.team_log2 == 5) return __reduce_add_sync(kFull, x);
  if (ln.team_log2 == 4) {
    const unsigned lo = __reduce_add_sync(kFull, ln.lane < 16 ? x : 0u);
    const unsigned hi = __reduce_add_sync(kFull, ln.lane < 16 ? 0u : x);
    return ln.lane < 16 ? lo : hi;
  }
  for (int o = 1; o < ln.team; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// A launch's team width (log2) and block size; false for what the walk
// does not take (ways past 64, more than 1,024 threads).
inline bool geometry(int num_sets, int ways, int* threads, int* team_log2) {
  if (num_sets < 1 || ways < 1 || ways > kMaxWays) return false;
  *team_log2 = 0;
  while ((1 << *team_log2) < (ways < 32 ? ways : 32)) ++*team_log2;
  *threads = ((num_sets << *team_log2) + 31) / 32 * 32;
  return *threads <= kMaxThreads;
}

// Dynamic shared memory of one block: a tile's tags, sets, list positions,
// first outputs and evict flags, and the tile's count per set.
template <class Step>
size_t smem_bytes(int L, int num_sets) {
  return (size_t)(L < kTile ? L : kTile) * (4 + 2 + 2 + sizeof(typename Step::Staged) + 1) +
         (size_t)num_sets * 4;
}

// One row (blockIdx.x) of the launch through Step.
template <class Step>
__device__ __forceinline__ void walk_row(const int* __restrict__ sets,
                                         const int* __restrict__ tags_in,
                                         const uint8_t* __restrict__ valid,
                                         typename Step::Out* __restrict__ out,
                                         uint8_t* __restrict__ evict, int L, int num_sets,
                                         int ways, int team_log2) {
  using Staged = typename Step::Staged;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile = min(L, kTile);
  int* s_tag = (int*)smem;
  int* s_count = s_tag + tile;                               // [num_sets]
  short* s_set = (short*)(s_count + num_sets);
  unsigned short* s_list = (unsigned short*)(s_set + tile);  // positions, by set
  Staged* s_out = (Staged*)(s_list + tile);
  uint8_t* s_ev = (uint8_t*)(s_out + tile);

  const int tid = threadIdx.x;
  const Lane ln(num_sets, team_log2);
  Step state(ln, ways);
  const Staged pad = Step::pad(ways);

  const size_t row = (size_t)blockIdx.x * (size_t)L;
  for (int base = 0; base < L; base += kTile) {
    const int n = min(kTile, L - base);
    if (tid < num_sets) s_count[tid] = 0;
    __syncthreads();  // the last tile's outputs have gone out
#pragma unroll 4
    for (int p = tid; p < n; p += blockDim.x) {
      const int s = sets[row + base + p];
      // An out-of-range set index is treated as padding rather than
      // touching state outside the row's.
      const bool in = valid[row + base + p] && s >= 0 && s < num_sets;
      s_set[p] = in ? (short)s : (short)-1;
      s_tag[p] = tags_in[row + base + p];
      s_out[p] = pad;
      s_ev[p] = 0;
      if (in) atomicAdd(s_count + s, 1);
    }
    __syncthreads();

    // Compaction: each team's positions of the tile, in order, into its
    // stretch of s_list (the sets' counts, taken while staging, place the
    // stretches). The teams of a warp read the same `team` positions at a
    // time and ballot `set == mine` once for all of them.
    const int count = ln.mine >= 0 ? s_count[ln.mine] : 0;
    int start = 0;
    for (int s = 0; s < ln.mine; ++s) start += s_count[s];
    unsigned short* list = s_list + start;
#pragma unroll 4
    for (int c = 0, k = 0; c < n; c += ln.team) {
      const bool match = c + ln.lt < n && s_set[c + ln.lt] == ln.mine;
      const unsigned b = (__ballot_sync(kFull, match) >> ln.first) & ln.low;
      if (match) list[k + __popc(b & ln.below)] = (unsigned short)(c + ln.lt);
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
      const int p = p_next, tag = tag_next;
      if (i + 1 < count) {
        p_next = list[i + 1];
        tag_next = s_tag[p_next];
      }
      state.step(ln, act, tag, base + p, p, s_out, s_ev);
    }
    __syncthreads();
#pragma unroll 4
    for (int p = tid; p < n; p += blockDim.x) {
      out[row + base + p] = (typename Step::Out)s_out[p];
      evict[row + base + p] = s_ev[p];
    }
  }
}

}  // namespace set_team
