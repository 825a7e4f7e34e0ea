// The single-block ILANS2 encode loop on Hopper (sm_90a), used by
// exact_family.cu for kernel 14 (the S=32 reference-exact encoder over
// per-symbol (cum, prob) planes).  One block of 1024 threads codes the
// whole message: per step each warp ballots its 32 lanes' flags, a block
// scan turns the per-warp popcounts into group offsets, and each thread
// walks its lanes one after another (lane = row * 1024 + thread), loading
// and storing each lane state in device memory once per step.  On an H100
// a step costs about 1.5 us at L = 128 and 1.0-1.5 us more per 1024 lanes
// (chip_smoke.py, sweep): the lane loop's latency on one SM, not the
// barriers, bounds it.  Every other coder runs ilans2_wide.cuh's cluster
// decode or its two-pass encode (the categorical coder at both presets,
// ilans2.cu; kernels 13, 15 and 16, exact_family.cu's table models, and
// kernel 17, its PlaneLanesModel; kernel 11, ilans2_family.cu's
// FamilyModel; kernel 12's lane pass over family_records.cuh's
// RecordLanesModel); a model moves there by providing that header's
// fetch / interval.
//
// The loop is templated on the preset (W, S) and on an encode model:
//   __device__ void stage(uint32_t* smem_cdf);
//   __device__ void lookup(int64_t i, uint32_t& cum, uint32_t& prob) const;
//   __device__ uint32_t prob(int64_t i) const;
// (the interval of symbol i).

#pragma once

#include "lanes.cuh"

namespace {

// Encode n symbols, walking steps T-1 .. 0.  states[L]: encoder start states
// (the seeds) in, final states (the decoder's initial states) out.  buf[cap]:
// the words of step t land right to left below an end pointer e, so on
// return the stream is buf[*end_out : cap].
template <int W, int S, class Model>
__global__ void __launch_bounds__(kThreads, 1)
    ilans2_encode_kernel(typename StateOf<S>::type* __restrict__ states,
                         Model model, int64_t n, uint32_t* __restrict__ buf,
                         int64_t cap, int64_t* __restrict__ end_out, int L,
                         int P, int T) {
  using State = typename StateOf<S>::type;
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
  model.stage(s.cdf());
  __syncthreads();

  constexpr State kWordMask = W == 32 ? State(kFull) : State((1u << W) - 1u);
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int rows = (L + kThreads - 1) / kThreads;
  int64_t e = cap;  // words of the finished steps occupy buf[e : cap]

  // Iteration j emits and codes step T - j (flagged in iteration j - 1),
  // then flags the renorming lanes of step T - 1 - j.
  for (int j = 0; j <= T; ++j) {
    const int cur = j & 1, prev = cur ^ 1;
    const int t = T - 1 - j;
    for (int r = 0; r < rows; ++r) {
      if (r * kThreads + (tid & ~31) >= L) break;  // warp-uniform
      const int l = r * kThreads + tid;
      const int g = l >> 5;
      State x = states[l];
      if (j > 0) {
        const int64_t i = static_cast<int64_t>(t + 1) * L + l;
        if (i < n) {
          uint32_t cum, prob;
          model.lookup(i, cum, prob);
          if ((x >> (S - P)) >= prob) {  // the decision flagged last iteration
            const int64_t idx = e + s.prefix(prev)[g] +
                                __popc(s.ballots(prev)[g] & lt_mask);
            buf[idx] = static_cast<uint32_t>(x & kWordMask);
            x >>= W;
          }
          x = ((x / prob) << P) | static_cast<State>(cum + x % prob);
        }
      }
      if (j < T) {
        const int64_t i = static_cast<int64_t>(t) * L + l;
        const bool renorm = i < n && (x >> (S - P)) >= model.prob(i);
        const unsigned bal = __ballot_sync(kFull, renorm);
        if (lane == 0) s.ballots(cur)[g] = bal;
      }
      states[l] = x;
    }
    if (j == T) break;
    __syncthreads();
    const uint32_t total = scan_groups(s.ballots(cur), s.prefix(cur),
                                       s.warp_sums(), G);
    __syncthreads();
    e -= total;
  }
  if (tid == 0) *end_out = e;
}

}  // namespace
