// Latency probes behind the latency bounds that chip_smoke.py reports.
//
// This file holds no kernel of the port. K1, K2 and D1 are chains of
// dependent steps, so the least time they can take is their longest chain
// times the latency of one step, whatever the card's bandwidth or issue
// rate. Each probe runs one such chain of n steps on a single warp, where
// nothing hides the latency; the caller times two chain lengths with CUDA
// events and divides the difference by the difference in steps.
//
//   vote_chain: the least step of a set-associative state machine (K1, K2):
//     compare a tag on every lane, vote across the warp (__ballot_sync),
//     take the first match (__ffs) and feed it into the next compare. A
//     cache access needs at least this: its hit decision combines the
//     compares of all ways, and the next access to the same set waits on it.
//   f32_chain: a dependent f32 max, then a dependent f32 add: the links of
//     D1's bus chain (bus_free -> max -> + bus). Half a step is one
//     dependent f32 op.
//
// Each writes its final value, so the chain is kept.
#include <cuda_runtime.h>

namespace {

__global__ void vote_chain_kernel(const int* __restrict__ in, int n,
                                  int* __restrict__ out) {
  const int lane = threadIdx.x;
  const int tag = in[lane];
  int x = in[32 + lane];
  for (int i = 0; i < n; ++i) {
    const unsigned hit = __ballot_sync(0xffffffffu, x == tag);
    x += __ffs(hit);
  }
  out[lane] = x;
}

__global__ void f32_chain_kernel(const float* __restrict__ in, int n,
                                 float* __restrict__ out) {
  const int lane = threadIdx.x;
  const float lo = in[lane];
  const float step = in[32 + lane];
  float x = in[64 + lane];
  for (int i = 0; i < n; ++i) x = __fadd_rn(fmaxf(x, lo), step);
  out[lane] = x;
}

}  // namespace

extern "C" int vote_chain_launch(const int* in, int n, int* out, void* stream) {
  vote_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(in, n, out);
  return (int)cudaGetLastError();
}

extern "C" int f32_chain_launch(const float* in, int n, float* out,
                                void* stream) {
  f32_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(in, n, out);
  return (int)cudaGetLastError();
}
