// D1: chunked DRAM event scan for Hopper (sm_90a).
//
// Replaces the `lax.scan` of `_scan_channel_chunked` in
// src/repro/core/memory/dram.py (a scan, not a Pallas kernel; run as a
// Python loop of torch ops it cost one launch per op per step). One thread
// walks one (segment, channel) row over its Lc chunks, carrying the
// per-bank open row and bank-free cycle, the bus-free cycle and the row's
// aggregates (latency sum, row-hit count, latest completion). Per chunk it
// writes the first completion and whether the chunk's first access hit the
// open row.
//
// What bounds it: latency. A row is Lc dependent steps, each a chain of
// up to 2 * k_max dependent f32 adds, on as many threads as there are rows
// (32 for 16 channels x 2 segments), so the card's bandwidth and FLOP rate
// do not enter. The design keeps each step's chain to the adds the
// reference makes and nothing else: the bank state of a thread lives in
// shared memory laid out [bank][thread] (no bank conflicts), the inputs are
// streamed without depending on the chain, and nothing is synchronised.
//
// The f32 chain is bitwise equal to the reference's: every add is
// __fadd_rn, in the reference's order (lc = done0 + t_cas, then
// lc + (dlast + t_cas) for each further access of the chunk), and the
// library is built with -fmad=false. The scalar timings arrive already
// rounded to f32 by the caller, as JAX rounds them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
dram_scan_kernel(const int* __restrict__ bkc, const int* __restrict__ rowc,
                 const int* __restrict__ kc, const uint8_t* __restrict__ valid,
                 int R, int Lc, int banks, int k_max, float t_row_act,
                 float t_cas, float bus, float* __restrict__ lat_out,
                 int* __restrict__ hit_out, float* __restrict__ dmax_out,
                 float* __restrict__ done0_out, uint8_t* __restrict__ row_hit_out) {
  extern __shared__ int sm[];
  int* open_row = sm;                                         // [banks][kThreads]
  float* bank_free = (float*)(sm + banks * kThreads);         // [banks][kThreads]
  const int tid = threadIdx.x;
  const int r = blockIdx.x * kThreads + tid;
  for (int b = 0; b < banks; ++b) {
    open_row[b * kThreads + tid] = -1;
    bank_free[b * kThreads + tid] = 0.0f;
  }
  if (r >= R) return;

  float bus_free = 0.0f, lat = 0.0f, dmax = 0.0f;
  int hits = 0;
  const size_t base = (size_t)r * (size_t)Lc;
  for (int i = 0; i < Lc; ++i) {
    const int b = bkc[base + i];
    const int rw = rowc[base + i];
    const int k = kc[base + i];
    const bool v = valid[base + i] != 0;
    const bool in = b >= 0 && b < banks;
    const int slot = (in ? b : 0) * kThreads + tid;
    const bool row_hit = in && open_row[slot] == rw;
    const float occ = row_hit ? 0.0f : t_row_act;
    const float bank_prev = in ? bank_free[slot] : -INFINITY;
    const float bank_avail = __fadd_rn(fmaxf(0.0f, bank_prev), occ);
    const float done0 = __fadd_rn(fmaxf(bank_avail, bus_free), bus);
    float dlast = done0;
    float lc = __fadd_rn(done0, t_cas);
    for (int j = 1; j < k_max; ++j) {
      if (j < k) {
        dlast = __fadd_rn(dlast, bus);
        lc = __fadd_rn(lc, __fadd_rn(dlast, t_cas));
      }
    }
    if (v) {
      if (in) {
        open_row[slot] = rw;
        bank_free[slot] = dlast;
      }
      bus_free = dlast;
      lat = __fadd_rn(lat, lc);
      hits += k - 1 + (row_hit ? 1 : 0);
      dmax = fmaxf(dmax, dlast);
    }
    done0_out[base + i] = v ? done0 : 0.0f;
    row_hit_out[base + i] = (uint8_t)(row_hit && v);
  }
  lat_out[r] = lat;
  hit_out[r] = hits;
  dmax_out[r] = dmax;
}

}  // namespace

extern "C" int dram_scan_launch(const int* bkc, const int* rowc, const int* kc,
                                const uint8_t* valid, int R, int Lc, int banks,
                                int k_max, float t_row_act, float t_cas,
                                float bus, float* lat, int* hit, float* dmax,
                                float* done0, uint8_t* row_hit, void* stream) {
  const int grid = (R + kThreads - 1) / kThreads;
  const size_t smem = (size_t)2 * banks * kThreads * sizeof(int);
  dram_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      bkc, rowc, kc, valid, R, Lc, banks, k_max, t_row_act, t_cas, bus, lat,
      hit, dmax, done0, row_hit);
  return (int)cudaGetLastError();
}
