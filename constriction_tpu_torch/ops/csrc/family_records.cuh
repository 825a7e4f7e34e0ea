// The per-symbol division records of the device families on Hopper
// (sm_90a): the tables pass shared by the two family encodes, kernel 12
// (ilans2_family.cu, the rANS encode) and kernel 22 (tchain.cu, the
// TChain-12 bits-back encode), and the encode model that reads its
// records.
//
// Both encodes need each symbol's interval (cum, prob) under its own model
// (mean, scale): two evaluations of family.cuh's left(), the
// operation-bound part of an encode, which reads no lane state.  So it
// runs ahead of the lanes, one thread per symbol over the whole grid
// (family_tables_kernel): the model, the symbol clamped into the support
// (callers validate symbols), family::tables (the pinned ends: cum 0 at
// min_sym, right 2^12 at max_sym) and the symbol's DivisionRecord32 (cum <
// 2^12, prob <= 2^12; 8 bytes) into recs[i], for every i < n.  Kernel 12's
// lane pass (ilans2_wide.cuh's encode_lanes_kernel) and kernel 22's
// cluster step then read one record a symbol through RecordLanesModel.
// What bounds the pass: 20 bytes a symbol moved (symbol, mean, scale in,
// an 8-byte record out) against two left() and a record build (one u64
// division, DivisionRecord32::build); every SM runs it.  On an NVIDIA
// H100 80GB HBM3 at 700 W it took 0.091 ms at 2^23 symbols (kernel 12's
// family row) and 0.100-0.104 ms on kernel 22's, against a byte bound of
// 0.050 (chip_ab.py).

#pragma once

#include "family.cuh"
#include "ilans2_wide.cuh"

namespace {

constexpr int kTablesThreads = 256;

template <int F>
__global__ void __launch_bounds__(kTablesThreads)
    family_tables_kernel(const int32_t* __restrict__ syms,
                         const float* __restrict__ means,
                         const float* __restrict__ scales,
                         DivisionRecord32* __restrict__ recs, int64_t n,
                         family::Support sup) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kTablesThreads + threadIdx.x;
  if (i >= n) return;
  const family::Model m = family::load_model(means, scales, i);
  const int sym = min(max(syms[i], sup.min_sym), sup.max_sym);
  uint32_t cum, prob;
  family::tables<F>(sym, m, sup, &cum, &prob);
  recs[i] = DivisionRecord32::build(cum, prob);
}

// The tables pass over symbols 0 .. n - 1 (n < 2^31 * kTablesThreads) on
// `stream`; the caller has checked the support and selected the device.
template <int F>
int launch_family_tables(const void* syms, const void* means,
                         const void* scales, void* recs, long long n,
                         int min_sym, int max_sym, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n + kTablesThreads - 1) / kTablesThreads;
  family_tables_kernel<F><<<static_cast<unsigned>(blocks), kTablesThreads,
                            0, stream>>>(
      static_cast<const int32_t*>(syms), static_cast<const float*>(means),
      static_cast<const float*>(scales),
      static_cast<DivisionRecord32*>(recs), static_cast<int64_t>(n),
      family::make_support(min_sym, max_sym));
  return static_cast<int>(cudaGetLastError());
}

// The encode model over those records: the token is the symbol's record
// itself, read a step before it is coded, so interval() reads no memory
// and nothing is staged (the shape of exact_family.cu's PlaneLanesModel).
struct RecordLanesModel {
  using Token = DivisionRecord32;
  using Interval = DivisionRecord32;
  const DivisionRecord32* recs;

  __device__ void stage(uint32_t*) {}
  __device__ Token fetch(int64_t i) const { return recs[i]; }
  __device__ Interval interval(Token rec) const { return rec; }
};

}  // namespace
