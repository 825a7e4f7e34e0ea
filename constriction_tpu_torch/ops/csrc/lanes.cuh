// Lane machinery shared by the coders on Hopper (sm_90a): StateOf, the CDF
// staging (shared memory when it fits, device memory otherwise), the
// quantile -> symbol search, valid_args and prepare.
//
// Every coder runs L lanes that share one word stream, so each coding step
// needs an exclusive prefix count over all L lanes (refill ranks when
// decoding, emission offsets when encoding).  They all run
// ilans2_wide.cuh's cluster decodes or its two-pass encode (ilans2.cu's
// categorical coder at both presets, kernels 1-4; the range decode at both
// presets, kernels 5 and 6; the exact table decodes, kernels 15 and 16 at
// S=64 and 13 at S=32, and encodes, kernel 17 at S=64 and 14 at S=32; the
// family decode, kernel 11, and encode, kernel 12; the compaction behind
// ilans2_range.cu's carry resolves and tchain.cu's decodes, kernels 19, 21
// and 23; tchain.cu's cluster encodes, kernels 20, 22 and 24), which scan
// across CTAs themselves.  No coder runs on one block.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // the lane multiple of tchain.cu's TChain-12 chain
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a launch may ask for (the card offers 227 KB)
constexpr size_t kSmemBudget = 200 * 1024;

template <int S>
struct StateOf;
template <>
struct StateOf<32> {
  using type = uint32_t;
};
template <>
struct StateOf<64> {
  using type = uint64_t;
};

// CDF copied into shared memory at `dst` when it fits, else read from
// device memory.  The caller puts a barrier after it.
__device__ __forceinline__ const uint32_t* stage_cdf(uint32_t* dst,
                                                     const uint32_t* cdf_g,
                                                     int K, int cdf_in_smem) {
  if (!cdf_in_smem) return cdf_g;
  for (int i = threadIdx.x; i <= K; i += blockDim.x) dst[i] = cdf_g[i];
  return dst;
}

// Largest s in [0, K) with cdf[s] <= q: searchsorted(cdf, q, "right") - 1,
// so zero-probability entries resolve as the host oracle does.  Needs
// cdf[0] <= q < cdf[K], which holds for q < 2^P; any other q still reads
// in bounds and returns K - 1.
__device__ __forceinline__ int find_symbol(const uint32_t* cdf, int K,
                                           uint32_t q) {
  int lo = 0, hi = K;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] <= q) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Bytes of a staged CDF, and whether it fits beside `scratch` bytes.
inline size_t cdf_smem_bytes(size_t scratch, int K, int* cdf_in_smem) {
  const size_t cdf = (static_cast<size_t>(K) + 1) * sizeof(uint32_t);
  *cdf_in_smem = scratch + cdf <= kSmemBudget;
  return *cdf_in_smem ? cdf : 0;
}

// The lane counts, alphabets and precisions the kernels take.
inline bool valid_args(int L, int P, int K) {
  return L > 0 && L % 32 == 0 && K >= 1 && P >= 1 && P <= 24;
}

// Selects the device and allows `bytes` of dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, size_t bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
  }
  return err;
}

}  // namespace
