// Lane machinery shared by the coders on Hopper (sm_90a).
//
// Every such coder runs L lanes that share one word stream, so each
// coding step needs an exclusive prefix count over all L lanes (refill
// ranks when decoding, emission offsets when encoding).  Two designs use
// what is here:
//
// - The single-block coder: ilans2.cuh's encode loop over
//   exact_family.cu's plane model (kernel 14).  One block of kThreads
//   threads codes the message; the prefix comes from a warp ballot per 32
//   lanes, a block scan of the per-warp popcounts (scan_groups, over the
//   Smem carve-up below) and a popc of the ballot below the lane.
// - ilans2_wide.cuh's cluster decodes and two-pass encode (ilans2.cu's
//   categorical coder at both presets, kernels 1-4; the range decode at
//   both presets, kernels 5 and 6; the exact table decodes, kernels 15
//   and 16 at S=64 and 13 at S=32, and encode, kernel 17; the family
//   decode, kernel 11, and encode, kernel 12; the compaction behind
//   ilans2_range.cu's carry resolves and tchain.cu's decodes, kernels 19,
//   21 and 23; tchain.cu's cluster encodes, kernels 20, 22 and 24), which
//   take StateOf, the CDF staging,
//   the symbol search, valid_args and prepare from here and scan across
//   CTAs themselves.
//
// Also here: the CDF staging (shared memory when it fits, device memory
// otherwise) and the quantile -> symbol search.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;  // threads of a single-block coder
constexpr int kWarps = kThreads / 32;
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

// Shared-memory carve-up of a single-block coder: ballots and group
// prefixes for two steps (the fused loop reads step t's while it writes
// step t + 1's), the per-warp sums of the block scan, then the CDF when it
// fits.  Buffers are picked by pointer arithmetic on the step parity, which
// keeps them out of local memory.
struct Smem {
  uint32_t* base;
  int G;
  __device__ uint32_t* ballots(int parity) const { return base + parity * G; }
  __device__ uint32_t* prefix(int parity) const {
    return base + (2 + parity) * G;
  }
  __device__ uint32_t* warp_sums() const { return base + 4 * G; }
  __device__ uint32_t* cdf() const { return base + 4 * G + kWarps; }
};

__host__ __device__ constexpr size_t scratch_words(int G) {
  return 4 * static_cast<size_t>(G) + kWarps;
}

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

// Exclusive block scan over the G = L / 32 per-group popcounts of `ballots`
// into `prefix`; returns the step's total.  Each thread sums a contiguous
// run of groups, warps scan with shuffles, and every warp rescans the 32
// warp sums itself (one barrier fewer than a warp-0 pass).  The caller puts
// a barrier after it before `prefix` is read.  Needs kThreads threads.
__device__ __forceinline__ uint32_t scan_groups(const uint32_t* ballots,
                                                uint32_t* prefix,
                                                uint32_t* warp_sums, int G) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (G + kThreads - 1) / kThreads;
  const int g0 = tid * per;
  uint32_t local = 0;
  for (int k = 0; k < per; ++k) {
    if (g0 + k < G) local += __popc(ballots[g0 + k]);
  }
  uint32_t incl = local;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  const uint32_t ws = warp_sums[lane];
  uint32_t wincl = ws;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(kFull, wincl, off);
    if (lane >= off) wincl += v;
  }
  const uint32_t warp_base = __shfl_sync(kFull, wincl - ws, warp);
  const uint32_t total = __shfl_sync(kFull, wincl, 31);
  uint32_t run = warp_base + incl - local;
  for (int k = 0; k < per; ++k) {
    if (g0 + k < G) {
      prefix[g0 + k] = run;
      run += __popc(ballots[g0 + k]);
    }
  }
  return total;
}

// Bytes of a staged CDF, and whether it fits beside `scratch` bytes.
inline size_t cdf_smem_bytes(size_t scratch, int K, int* cdf_in_smem) {
  const size_t cdf = (static_cast<size_t>(K) + 1) * sizeof(uint32_t);
  *cdf_in_smem = scratch + cdf <= kSmemBudget;
  return *cdf_in_smem ? cdf : 0;
}

// Shared-memory size of a single-block coder's launch; decides whether the
// CDF is staged.
inline size_t smem_bytes(int L, int K, int* cdf_in_smem) {
  const size_t scratch = scratch_words(L / 32) * sizeof(uint32_t);
  return scratch + cdf_smem_bytes(scratch, K, cdf_in_smem);
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
