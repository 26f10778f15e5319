// D2: FIFO / SRRIP per-set row scans for Hopper (sm_90a).
//
// Replaces the two `lax.scan`s of src/repro/core/memory/rrip.py,
// `_fifo_scan_rows` and `_srrip_scan_rows` (scans, not Pallas kernels; run
// as a Python loop of torch ops they cost one launch per op per step). A
// row is one cache set's compressed access sequence; it is walked with the
// set's state in registers, writing one hit flag per position.
//   FIFO:  a ring of `ways` tags (init -1) and a head. A hit changes
//          nothing; a valid miss writes the tag at the head and advances it
//          mod `ways`.
//   SRRIP: `ways` (tag, key) pairs (init -1, 0), an age A and a fill count
//          nf. A hit sets the matching ways' key to A; a valid miss with
//          nf < ways fills way nf with key A - 2 (nf += 1); a warm miss
//          takes m = min(keys), fills the FIRST way holding m with key m + 1
//          and sets A = m + 3.
// An invalid position (padding) changes nothing and reports no hit. All
// arithmetic is int32, signed (A - 2 is negative at the start), as the
// reference's.
//
// The rows of a call lie in one flat buffer, described by a row table
// (offset, length and, on the chunked route, the first chunk of each row);
// rows of similar length are neighbours in it.
//
// What bounds it: latency. A row is L dependent steps (~39 ns a step on
// one lane: a compare per way, an OR tree, the update's selects), and rows
// are few where they are long: the on-chip cache gives tens of thousands of
// rows of at most 128 steps, but a TLB's L1 gives 16 rows of up to ~29,000
// steps, which one lane each would take ~1.1 ms to walk. Two routes:
//   * short (every row < LONG_ROW steps, kernels/rrip_scan.py): one launch
//     of `rrip_scan_walk_kernel`, a lane per row;
//   * chunked (some row >= LONG_ROW): each row is cut into chunks of C
//     steps, each chunk a lane's *virtual row*: the K steps before the
//     chunk from the empty state (no hits written), then the chunk, its
//     state stored where the chunk starts and where it ends (the speculate
//     launch, `rrip_scan_walk_kernel` again). Then `rrip_scan_fixup_kernel`,
//     a warp per row, walks the row's chunks in order: a chunk whose
//     speculative start state differs from the (true) end state of the
//     chunk before it is run again from that state, its hits and end state
//     overwritten.
//     Exact by induction for any K; with K of 4 steps a way (at least 16)
//     no TLB chunk of the full-size workload needs a re-run, because a
//     set's presorted stream is nearly all misses and a ring refills within
//     a few steps a way. The warp compares 32 chunks at once (a ballot of
//     "differs"), so the L1's longest row, 454 chunks of 64, costs 15
//     rounds of loads when nothing re-runs. C, K and the threshold are
//     chosen in kernels/rrip_scan.py (CHUNK, warmup_steps, LONG_ROW), with
//     their measurement.
//     States compare canonically: a FIFO ring as read from its head (two
//     rotations under their heads give the same hits forever); an SRRIP
//     state by its tags, nf and each filled way's key - A (every update
//     keeps its meaning when one constant is added to A and every key; the
//     first argmin goes by physical way, so ways compare in place).
// Within a walk everything but the state update stays off a step's chain,
// as in D1 (csrc/dram_scan.cu):
//   * a block is one compute warp (lane = virtual row) and two loader
//     warps. The loaders bring tiles of up to kMaxTile steps of all 32 rows
//     into shared memory with 16-byte cp.async, kStages tiles ahead; named
//     barriers hand each stage from loaders to compute (FULL) and back
//     (EMPTY);
//   * the compute lane reads 16 steps of its row at a time with 16-byte
//     shared loads (row strides of an odd number of 16-byte units: no bank
//     conflicts) and writes their 16 hit flags with one 16-byte store;
//   * the ways are a compile-time power of two W >= ways, held in
//     registers. Ways past the real count (W > ways) never match and are
//     never a victim (their key is INT_MAX); an instance with W == ways
//     drops those checks (12-27% faster at 4, 8 and 16 ways than the
//     masked instance: scripts/scan_ablation.py, variant masked-only);
//   * a step is straight-line code: the "any way matches" and "min key"
//     are trees of depth log2(W), the first way holding the minimum is a
//     find-first-set of a bit mask, and every state update is a select, so
//     one step's independent work overlaps the last one's chain;
//   * a block walks as far as its longest row, and groups of 16 steps in
//     which no row of the block has a valid step are skipped, on one
//     warp-uniform branch a group.
// A block whose rows do not all start and end on 16 steps, or a pointer
// off 16 bytes, is copied element by element.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "per_device.cuh"

#include <type_traits>

namespace {

constexpr int kRows = 32;               // virtual rows a block walks: one per compute lane
constexpr int kLoaders = 64;            // two loader warps
constexpr int kThreads = 32 + kLoaders;
constexpr int kMaxTile = 64;            // steps of a row per stage
constexpr int kStages = 2;
constexpr int kGroup = 16;              // steps a compute lane reads at once
constexpr int kMaxWays = 64;
constexpr int kFixWarps = 4;            // fix-up: rows (a warp each) per block
constexpr unsigned kFull = 0xffffffffu;

// A stage holds `tile` steps of each row: the longest row's steps rounded
// up to 16, at most kMaxTile. Row strides are an odd number of 16-byte units.
int tile_of(int steps) {
  const int t = (steps + kGroup - 1) / kGroup * kGroup;
  return t < kGroup ? kGroup : (t < kMaxTile ? t : kMaxTile);
}
__host__ __device__ __forceinline__ int tag_stride(int tile) { return tile + 4; }  // ints
__host__ __device__ __forceinline__ int byte_stride(int tile) {                     // bytes
  return tile + ((tile / 16) % 2 ? 0 : 16);
}
__host__ __device__ __forceinline__ size_t stage_bytes(int tile) {
  return (size_t)kRows * tag_stride(tile) * 4 + (size_t)kRows * byte_stride(tile);
}
size_t shared_bytes(int tile) { return kStages * stage_bytes(tile); }

// Barrier ids: FULL(s) = 1 + s (loaders arrive, compute waits),
// EMPTY(s) = 1 + kStages + s (compute arrives, loaders wait).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

struct Args {
  const int* tags;
  const uint8_t* valid;
  uint8_t* hits;
  const int* table;   // off[R], len[R], then (chunked) the first chunk of each row, cb[R + 1]
  int R, V;           // rows, virtual rows (chunks on the chunked route, else rows)
  int ways, tile;
  int chunk, warmup;  // chunk == 0: the short route
  int* states;        // chunked: V start states, then V end states
  int* reruns;        // chunked: chunks the fix-up ran again
  bool vec;           // tags, valid, hits 16-byte aligned
};

// The steps of a virtual row: from flat index `src`, `n` steps, of which
// the first `warm` (a multiple of 16) run before the chunk (no hits
// written; the start state is taken after them) and the first `lead`
// (< 16, when K is not a multiple of 16) are not walked at all.
struct Span {
  int src, n, warm, lead;
};

__device__ Span span_of(const Args& a, int v) {
  const int* off = a.table;
  const int* len = a.table + a.R;
  if (a.chunk == 0) return Span{off[v], len[v], 0, 0};
  const int* cb = a.table + 2 * a.R;
  int lo = 0, hi = a.R;  // cb[lo] <= v < cb[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (cb[mid] <= v) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int s = (v - cb[lo]) * a.chunk;
  const int e = min(s + a.chunk, len[lo]);
  const int k16 = (a.warmup + kGroup - 1) / kGroup * kGroup;
  const int w = min(s, k16);
  return Span{off[lo] + s - w, e - s + w, w, w - min(s, a.warmup)};
}

// Loader: steps [i0, i0 + n) of the block's rows into stage st (n a
// multiple of 16); steps past a row's own end are marked invalid.
__device__ void load_tile(uint8_t* st, const Args& a, const Span* sp, int rows, int i0, int n,
                          bool vec, int lt) {
  const int ts = tag_stride(a.tile), bs = byte_stride(a.tile);
  int* tg = (int*)st;
  uint8_t* vd = st + (size_t)kRows * ts * 4;
  if (vec) {  // every row's src and n are multiples of 16
    const int q4 = n / 4;
    for (int e = lt; e < rows * q4; e += kLoaders) {
      const int r = e / q4, q = (e - r * q4) * 4;
      if (i0 + q < sp[r].n) cp_async16(tg + r * ts + q, a.tags + sp[r].src + i0 + q);
    }
    const int q16 = n / 16;
    for (int e = lt; e < rows * q16; e += kLoaders) {
      const int r = e / q16, q = (e - r * q16) * 16;
      if (i0 + q < sp[r].n) {
        cp_async16(vd + r * bs + q, a.valid + sp[r].src + i0 + q);
      } else {
        *(uint4*)(vd + r * bs + q) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_wait_all();
  } else {
    for (int e = lt; e < rows * n; e += kLoaders) {
      const int r = e / n, q = e - r * n;
      if (i0 + q < sp[r].n) {
        const int g = sp[r].src + i0 + q;
        tg[r * ts + q] = a.tags[g];
        vd[r * bs + q] = a.valid[g];
      } else {
        vd[r * bs + q] = 0;  // past the row: a step that changes nothing
      }
    }
  }
}

struct Or {
  template <typename T>
  __device__ __forceinline__ T operator()(T x, T y) const { return x | y; }
};
struct Min {
  __device__ __forceinline__ int operator()(int x, int y) const { return x < y ? x : y; }
};

// x[0] op x[1] op ... op x[W-1] as a tree of depth log2(W); overwrites x.
template <int W, typename T, typename Op>
__device__ __forceinline__ T tree(T (&x)[W], Op op) {
#pragma unroll
  for (int s = 1; s < W; s *= 2) {
#pragma unroll
    for (int j = 0; j + s < W; j += 2 * s) x[j] = op(x[j], x[j + s]);
  }
  return x[0];
}

// FIFO state of one row. W: ways held (a power of two); FULL: W == ways.
// Stored as the ring's `ways` tags and the head.
template <int W, bool FULL>
struct FifoRow {
  int t[W];
  int head, ways;
  __device__ __forceinline__ void init(int ways_) {
    ways = ways_;
    head = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = -1;
  }
  __device__ __forceinline__ bool step(int tag, bool v) {
    bool e[W];
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = (FULL || j < ways) && t[j] == tag;
    const bool hit = tree(e, Or());
    const bool miss = v && !hit;
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = (miss && head == j) ? tag : t[j];
    const int nxt = head + 1;
    head = miss ? (nxt == ways ? 0 : nxt) : head;
    return v && hit;
  }
  __device__ void store(int* p) const {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (FULL || j < ways) p[j] = t[j];
    }
    p[ways] = head;
  }
  __device__ void load(const int* p) {
#pragma unroll
    for (int j = 0; j < W; ++j) t[j] = (FULL || j < ways) ? p[j] : -1;
    head = p[ways];
  }
  // The two stored rings read from their heads, way for way.
  __device__ static bool same(const int* x, const int* y, int ways) {
    for (int j = 0, i = x[ways], k = y[ways]; j < ways; ++j) {
      if (x[i] != y[k]) return false;
      i = i + 1 == ways ? 0 : i + 1;
      k = k + 1 == ways ? 0 : k + 1;
    }
    return true;
  }
};

// SRRIP state of one row: (tag, key) per way, the age A, the fill count nf.
// Stored as the tags, each filled way's key - A (0 past nf) and nf.
template <int W, bool FULL>
struct SrripRow {
  using Mask = typename std::conditional<(W > 32), unsigned long long, unsigned>::type;
  int t[W], k[W];
  int A, nf, ways;
  __device__ __forceinline__ void init(int ways_) {
    ways = ways_;
    A = 0;
    nf = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      t[j] = -1;
      k[j] = (FULL || j < ways) ? 0 : INT_MAX;  // a way past `ways` is never the minimum
    }
  }
  __device__ __forceinline__ bool step(int tag, bool v) {
    bool e[W], any[W];
    int km[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      e[j] = (FULL || j < ways) && t[j] == tag;
      any[j] = e[j];
      km[j] = k[j];
    }
    const bool hit = tree(any, Or());
    const int m = tree(km, Min());
    Mask bits[W];
#pragma unroll
    for (int j = 0; j < W; ++j) bits[j] = (Mask)(k[j] == m) << j;
    const Mask at_min = tree(bits, Or());
    int first;
    if constexpr (W > 32) {
      first = __ffsll((long long)at_min) - 1;
    } else {
      first = __ffs((int)at_min) - 1;
    }
    const bool warm = nf >= ways;
    const int vic = warm ? first : nf;
    const int fill = warm ? m + 1 : A - 2;
    const bool hitb = v && hit, missb = v && !hit;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const bool put = missb && vic == j;
      t[j] = put ? tag : t[j];
      k[j] = (hitb && e[j]) ? A : (put ? fill : k[j]);
    }
    A = (missb && warm) ? m + 3 : A;
    nf = (missb && !warm) ? nf + 1 : nf;
    return hitb;
  }
  __device__ void store(int* p) const {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (FULL || j < ways) {
        p[j] = t[j];
        p[ways + j] = j < nf ? k[j] - A : 0;
      }
    }
    p[2 * ways] = nf;
  }
  __device__ void load(const int* p) {
    nf = p[2 * ways];
    A = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const bool in = FULL || j < ways;
      t[j] = in ? p[j] : -1;
      k[j] = in ? (j < nf ? p[ways + j] : 0) : INT_MAX;
    }
  }
  __device__ static bool same(const int* x, const int* y, int ways) {
    for (int j = 0; j <= 2 * ways; ++j) {
      if (x[j] != y[j]) return false;
    }
    return true;
  }
};

template <int W, bool FULL, bool SRRIP>
using RowOf = typename std::conditional<SRRIP, SrripRow<W, FULL>, FifoRow<W, FULL>>::type;

__host__ __device__ __forceinline__ int state_ints(int ways, bool srrip) {
  return srrip ? 2 * ways + 1 : ways + 1;
}

// The walk: a lane per virtual row (a row on the short route, a chunk and
// its warm-up on the chunked one).
template <int W, bool FULL, bool SRRIP>
__global__ void __launch_bounds__(kThreads)
rrip_scan_walk_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Span s_span[kRows];
  __shared__ int s_steps, s_vec;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, a.V - row0);
  const size_t sb = stage_bytes(a.tile);
  const int lane = threadIdx.x;
  if (threadIdx.x < 32) {
    const Span sp = lane < rows ? span_of(a, row0 + lane) : Span{0, 0, 0, 0};
    s_span[lane] = sp;
    const unsigned longest = __reduce_max_sync(kFull, (unsigned)sp.n);
    const bool vec = __all_sync(kFull, ((sp.src | sp.n) & (kGroup - 1)) == 0);
    if (lane == 0) {
      s_steps = (int)(longest + kGroup - 1) / kGroup * kGroup;
      s_vec = vec && a.vec;
      if (a.reruns != nullptr && blockIdx.x == 0) *a.reruns = 0;  // the fix-up counts from 0
    }
  }
  __syncthreads();
  const int steps = s_steps;
  const int ntiles = (steps + a.tile - 1) / a.tile;

  if (threadIdx.x >= 32) {  // loader warps
    const int lt = threadIdx.x - 32;
    const bool vec = s_vec != 0;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kStages;
      if (it >= kStages) bar_sync(1 + kStages + s);
      const int i0 = it * a.tile;
      load_tile(smem + s * sb, a, s_span, rows, i0, min(a.tile, steps - i0), vec, lt);
      bar_arrive(1 + s);
    }
    return;
  }

  // The compute warp. A lane past the block's rows walks whatever its
  // stage holds and stores nothing.
  const Span sp = s_span[lane];
  const bool mine = lane < rows;
  const bool vec = s_vec != 0;
  RowOf<W, FULL, SRRIP> row;
  row.init(a.ways);
  const int S = state_ints(a.ways, SRRIP);
  int* start = a.states == nullptr ? nullptr : a.states + (size_t)(row0 + lane) * S;
  const int ts = tag_stride(a.tile), bs = byte_stride(a.tile);
  uint8_t* out = a.hits + sp.src;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    const uint8_t* st = smem + s * sb;
    const int i0 = it * a.tile;
    const int n = min(a.tile, steps - i0);
    const int* tg = (const int*)st + lane * ts;
    const uint8_t* vd = st + (size_t)kRows * ts * 4 + lane * bs;
    bar_sync(1 + s);
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      const int p = i0 + g0;  // the group's first step in the virtual row
      if (start != nullptr && mine && p == sp.warm) row.store(start);
      const uint4 vq = *(const uint4*)(vd + g0);
      unsigned vw[4] = {vq.x, vq.y, vq.z, vq.w};
      if (p == 0 && sp.lead > 0) {  // steps before the warm-up are not walked
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cut = sp.lead - 4 * q;
          vw[q] &= cut <= 0 ? kFull : (cut >= 4 ? 0u : kFull << (8 * cut));
        }
      }
      unsigned hw[4] = {0u, 0u, 0u, 0u};
      // A group in which no row of the block has a valid step (the padding
      // past a row's end) changes no state: its steps are skipped, one
      // warp-uniform branch a group.
      const bool live = mine && (vw[0] | vw[1] | vw[2] | vw[3]) != 0u;
      if (__any_sync(kFull, live)) {
        int tag[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; j += 4) {
          const int4 q = *(const int4*)(tg + g0 + j);
          tag[j] = q.x;
          tag[j + 1] = q.y;
          tag[j + 2] = q.z;
          tag[j + 3] = q.w;
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const bool v = ((vw[j / 4] >> (8 * (j % 4))) & 0xffu) != 0u;
          hw[j / 4] |= (unsigned)row.step(tag[j], v) << (8 * (j % 4));
        }
      }
      if (mine && p >= sp.warm && p < sp.n) {
        if (vec) {
          *(uint4*)(out + p) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
        } else {
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            if (p + j < sp.n) out[p + j] = (uint8_t)(hw[j / 4] >> (8 * (j % 4)));
          }
        }
      }
    }
    if (it + kStages < ntiles) bar_arrive(1 + kStages + s);  // the loaders refill it
  }
  if (start != nullptr && mine) row.store(start + (size_t)a.V * S);
}

// The fix-up's re-run of chunk c of row r from the stored state `from`:
// its hits, and its end state into `to`. The chunk goes in pieces of 32
// steps: each lane loads one step's tag and valid flag (coalesced) and
// puts them in the warp's staging area `st_tag`/`st_v`, the next piece's
// loads are issued, and every lane walks the piece alike, reading 16 steps
// at a time with 16-byte shared loads as the walk does (off the chain),
// then writes the hit of its own step, so one coalesced store writes the
// piece's hits.
template <int W, bool SRRIP>
__device__ void rerun(const Args& a, int r, int c, const int* from, int* to, int lane,
                      int* st_tag, uint8_t* st_v) {
  RowOf<W, false, SRRIP> row;
  row.init(a.ways);
  row.load(from);
  const int off = a.table[r];
  const int s = c * a.chunk, e = min(s + a.chunk, a.table[a.R + r]);
  int tag = s + lane < e ? a.tags[off + s + lane] : 0;
  uint8_t v = s + lane < e ? a.valid[off + s + lane] : 0;
  for (int q = s; q < e; q += 32) {
    st_tag[lane] = tag;
    st_v[lane] = v;  // 0 past the chunk's end: a step that changes nothing
    __syncwarp();
    const int pn = q + 32 + lane;
    tag = pn < e ? a.tags[off + pn] : 0;
    v = pn < e ? a.valid[off + pn] : 0;
    unsigned hm = 0u;
#pragma unroll
    for (int g = 0; g < 32; g += kGroup) {
      int t[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; j += 4) {
        const int4 x = *(const int4*)(st_tag + g + j);
        t[j] = x.x;
        t[j + 1] = x.y;
        t[j + 2] = x.z;
        t[j + 3] = x.w;
      }
      const uint4 vq = *(const uint4*)(st_v + g);
      const unsigned vw[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const bool vj = ((vw[j / 4] >> (8 * (j % 4))) & 0xffu) != 0u;
        hm |= (unsigned)row.step(t[j], vj) << (g + j);
      }
    }
    if (q + lane < e) a.hits[off + q + lane] = (uint8_t)((hm >> lane) & 1u);
    __syncwarp();  // the piece is read by every lane before the next overwrites it
  }
  if (lane == 0) {
    row.store(to);
    atomicAdd(a.reruns, 1);
  }
  __syncwarp();
}

// The fix-up: a warp per row walks its chunks in order. Chunk c's stored
// results hold when its speculative start state equals the end state of
// chunk c - 1 (chunk 0 starts from the empty state, as speculated); else
// it runs again from that end state. The lanes first compare 32 chunks at
// once; a comparison is taken again only after the chunk before it ran
// again (its end state changed).
template <int W, bool SRRIP>
__global__ void __launch_bounds__(32 * kFixWarps)
rrip_scan_fixup_kernel(Args a) {
  using Row = RowOf<W, false, SRRIP>;
  __shared__ __align__(16) int s_tag[kFixWarps * 32];
  __shared__ __align__(16) uint8_t s_v[kFixWarps * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int r = blockIdx.x * kFixWarps + warp;
  if (r >= a.R) return;
  const int* cb = a.table + 2 * a.R;
  const int base = cb[r], nch = cb[r + 1] - base;
  const size_t S = state_ints(a.ways, SRRIP);
  const int* start = a.states + base * S;
  int* end = a.states + ((size_t)a.V + base) * S;
  bool after_rerun = false;  // warp-uniform: chunk w0 + i - 1 ran again
  for (int w0 = 1; w0 < nch; w0 += 32) {
    const int c = w0 + lane;
    const bool differs = c < nch && !Row::same(end + (c - 1) * S, start + c * S, a.ways);
    const unsigned fail = __ballot_sync(kFull, differs);
    const int n = min(32, nch - w0);
    for (int i = 0; i < n; ++i) {
      const int cc = w0 + i;
      if (!after_rerun) {
        const unsigned f = fail >> i;
        if (f == 0u) break;
        i += __ffs(f) - 1;
      } else if (Row::same(end + (cc - 1) * S, start + cc * S, a.ways)) {
        after_rerun = false;
        continue;
      }
      const int ci = w0 + i;
      rerun<W, SRRIP>(a, r, ci, end + (ci - 1) * S, end + ci * S, lane, s_tag + 32 * warp,
                      s_v + 32 * warp);
      after_rerun = true;
    }
  }
}

// One instance: set its shared-memory limit (once), then report its
// occupancy (occ != nullptr) or launch the walk and, on the chunked route,
// the fix-up.
template <int W, bool FULL, bool SRRIP>
cudaError_t run(const Args& a, cudaStream_t stream, int* occ) {
  const auto walk = rrip_scan_walk_kernel<W, FULL, SRRIP>;
  static SmemOptIn opt_in;
  const cudaError_t opted = opt_in.ensure((const void*)walk, shared_bytes(kMaxTile));
  if (opted != cudaSuccess) return opted;
  const size_t smem = shared_bytes(a.tile);
  if (occ != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, walk, kThreads, smem);
  }
  walk<<<(a.V + kRows - 1) / kRows, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.chunk == 0) return err;
  rrip_scan_fixup_kernel<W, SRRIP><<<(a.R + kFixWarps - 1) / kFixWarps, 32 * kFixWarps, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int W, bool SRRIP>
cudaError_t by_full(const Args& a, cudaStream_t stream, int* occ) {
  if constexpr (W == 1) {
    return run<1, true, SRRIP>(a, stream, occ);
  } else {
    return a.ways == W ? run<W, true, SRRIP>(a, stream, occ)
                       : run<W, false, SRRIP>(a, stream, occ);
  }
}

template <bool SRRIP>
cudaError_t by_ways(const Args& a, cudaStream_t stream, int* occ) {
  if (a.ways <= 1) return by_full<1, SRRIP>(a, stream, occ);
  if (a.ways <= 2) return by_full<2, SRRIP>(a, stream, occ);
  if (a.ways <= 4) return by_full<4, SRRIP>(a, stream, occ);
  if (a.ways <= 8) return by_full<8, SRRIP>(a, stream, occ);
  if (a.ways <= 16) return by_full<16, SRRIP>(a, stream, occ);
  if (a.ways <= 32) return by_full<32, SRRIP>(a, stream, occ);
  return by_full<64, SRRIP>(a, stream, occ);
}

cudaError_t dispatch(const Args& a, int policy, cudaStream_t stream, int* occ) {
  if (a.ways < 1 || a.ways > kMaxWays || (policy != 0 && policy != 1) || a.V < 1 ||
      a.chunk < 0 || a.chunk % kGroup != 0 || a.warmup < 0 ||
      (a.chunk > 0 && (a.states == nullptr || a.reruns == nullptr) && occ == nullptr)) {
    return cudaErrorInvalidValue;
  }
  return policy == 1 ? by_ways<true>(a, stream, occ) : by_ways<false>(a, stream, occ);
}

}  // namespace

// Blocks of 32 virtual rows of the walk resident on one SM of the current
// card, for virtual rows of at most `steps` steps. policy: 0 = FIFO, 1 = SRRIP.
extern "C" int rrip_scan_occupancy(int steps, int ways, int policy, int* blocks) {
  const Args a{nullptr, nullptr, nullptr, nullptr, 1, 1, ways, tile_of(steps),
               0, 0, nullptr, nullptr, false};
  return (int)dispatch(a, policy, nullptr, blocks);
}

// The rows of `table` (R rows; V virtual rows, each at most `steps` steps
// staged): the walk alone (chunk == 0), or with chunks of `chunk` steps and
// `warmup` steps before each, the speculate walk and the fix-up, with
// scratch for 2 V states of `state_ints` int32s and the re-run count.
extern "C" int rrip_scan_launch(const int* tags, const uint8_t* valid, uint8_t* hits,
                                const int* table, int R, int V, int steps, int ways, int policy,
                                int chunk, int warmup, int* states, int* reruns, void* stream) {
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15u) == 0; };
  const bool vec = aligned(tags) && aligned(valid) && aligned(hits);
  const Args a{tags, valid, hits, table, R, V, ways, tile_of(steps),
               chunk, warmup, states, reruns, vec};
  return (int)dispatch(a, policy, (cudaStream_t)stream, nullptr);
}
