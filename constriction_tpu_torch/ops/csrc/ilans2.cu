// ILANS2 shared-stream interleaved rANS on Hopper (sm_90a): the encode and
// decode kernels of the i.i.d. categorical coder, templated on the preset
// (W, S) in {(16, 32), (32, 64)}.
//
// Replaces the Pallas kernels
//   constriction_tpu/ops/pallas_coder.py    _decode_kernel_body   (W=16, S=32)
//   constriction_tpu/ops/pallas_coder.py    _encode_kernel_body   (W=16, S=32)
//   constriction_tpu/ops/pallas_coder64.py  _decode_kernel_body64 (W=32, S=64)
//   constriction_tpu/ops/pallas_coder64.py  _encode_kernel_body64 (W=32, S=64)
// and holds the same wire format: symbol i belongs to lane i mod L; every
// lane runs the reference rANS algebra; all lanes share one word stream in
// decode-consumption order (at each step the refilling lanes take the next
// words in ascending lane order).
//
// What bounds it on this card: the T coding steps form a serial chain, and
// every step needs an exclusive prefix count over all L lanes (the refill
// ranks when decoding, the emission offsets when encoding), so no step can
// start before the previous step's prefix is known.  This first design runs
// the whole message in ONE thread block: per step, each warp ballots its 32
// lanes' refill/renorm flags, a block scan turns the per-warp popcounts into
// group offsets, and each lane's word index is base + group offset +
// popc(ballot & lanemask_lt).  Measured on an H100 (chip_smoke.py, sweep),
// a step costs about 1.5 us at L = 128 (barriers and scan) and 1.0-1.5 us
// more per 1024 lanes: each thread walks its lanes one after another, and
// each lane is a chain of dependent loads (state, CDF search, refill word),
// so at L = 32768 the lane loop's latency, not the barriers, bounds a step.
// The other SMs idle.  Lane ownership is strided
// (lane = row * 1024 + thread) so symbol reads and writes coalesce, and the
// refill (or emission) of step t is fused with the coding of step t + 1 so
// each lane state is loaded and stored once per step.  Lane states live in
// device memory (the caller's state tensor, updated in place; 256 KB at
// L = 32768, S = 64, which stays in L2); the ballots, the group prefixes and
// the CDF (when it fits) live in shared memory.  A cluster- or grid-wide
// scan that spreads the lanes over many SMs is later work.  The two loops
// are in ilans2.cuh, templated on the model (here one CDF, CdfModel below;
// exact_family.cu instantiates them over per-symbol tables); the ballot,
// the block scan, the CDF staging and the symbol search are in lanes.cuh,
// shared with the range coder (ilans2_range.cu).

#include "ilans2.cuh"

namespace {

// One CDF for every symbol: the decode side searches it, the encode side
// reads a symbol's interval (symbols outside [0, K) are clamped to K-1 to
// keep CDF reads in bounds; callers validate them).  The CDF lives in
// shared memory when it fits.
struct CdfModel {
  const int32_t* syms;  // encode only
  const uint32_t* cdf;
  int K;
  int cdf_in_smem;

  __device__ void stage(uint32_t* smem_cdf) {
    cdf = stage_cdf(smem_cdf, cdf, K, cdf_in_smem);
  }
  __device__ int invert(int, int, uint32_t q, uint32_t& cum,
                        uint32_t& prob) const {
    const int sym = find_symbol(cdf, K, q);
    cum = cdf[sym];
    prob = cdf[sym + 1] - cum;
    return sym;
  }
  __device__ uint32_t symbol(int64_t i) const {
    return min(static_cast<uint32_t>(syms[i]), static_cast<uint32_t>(K - 1));
  }
  __device__ void lookup(int64_t i, uint32_t& cum, uint32_t& prob) const {
    const uint32_t sym = symbol(i);
    cum = cdf[sym];
    prob = cdf[sym + 1] - cum;
  }
  __device__ uint32_t prob(int64_t i) const {
    const uint32_t sym = symbol(i);
    return cdf[sym + 1] - cdf[sym];
  }
};

template <int W, int S>
int launch_decode(void* states, const void* stream, long long slen,
                  const void* cdf, int K, void* syms, long long n, int L,
                  int P, void* cuda_stream, int device) {
  int cdf_in_smem = 0;
  const size_t bytes = smem_bytes(L, K, &cdf_in_smem);
  auto kernel = ilans2_decode_kernel<W, S, CdfModel, false>;
  if (!valid_args(L, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  const CdfModel model{nullptr, static_cast<const uint32_t*>(cdf), K,
                       cdf_in_smem};
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<typename StateOf<S>::type*>(states),
      static_cast<const uint32_t*>(stream), slen, model,
      static_cast<int32_t*>(syms), n, L, P, T, nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int S>
int launch_encode(void* states, const void* syms, long long n, const void* cdf,
                  int K, void* buf, long long cap, void* end_out, int L, int P,
                  void* cuda_stream, int device) {
  int cdf_in_smem = 0;
  const size_t bytes = smem_bytes(L, K, &cdf_in_smem);
  auto kernel = ilans2_encode_kernel<W, S, CdfModel>;
  if (!valid_args(L, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  const CdfModel model{static_cast<const int32_t*>(syms),
                       static_cast<const uint32_t*>(cdf), K, cdf_in_smem};
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<typename StateOf<S>::type*>(states), model, n,
      static_cast<uint32_t*>(buf), cap, static_cast<int64_t*>(end_out), L, P,
      T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (constriction_tpu_torch/ops/_build.py).
// Each entry launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 on success).
extern "C" {

int ctt_ilans2_decode_w16s32(void* states, const void* stream, long long slen,
                             const void* cdf, int K, void* syms, long long n,
                             int L, int P, void* cuda_stream, int device) {
  return launch_decode<16, 32>(states, stream, slen, cdf, K, syms, n, L, P,
                               cuda_stream, device);
}

int ctt_ilans2_decode_w32s64(void* states, const void* stream, long long slen,
                             const void* cdf, int K, void* syms, long long n,
                             int L, int P, void* cuda_stream, int device) {
  return launch_decode<32, 64>(states, stream, slen, cdf, K, syms, n, L, P,
                               cuda_stream, device);
}

int ctt_ilans2_encode_w16s32(void* states, const void* syms, long long n,
                             const void* cdf, int K, void* buf, long long cap,
                             void* end_out, int L, int P, void* cuda_stream,
                             int device) {
  return launch_encode<16, 32>(states, syms, n, cdf, K, buf, cap, end_out, L,
                               P, cuda_stream, device);
}

int ctt_ilans2_encode_w32s64(void* states, const void* syms, long long n,
                             const void* cdf, int K, void* buf, long long cap,
                             void* end_out, int L, int P, void* cuda_stream,
                             int device) {
  return launch_encode<32, 64>(states, syms, n, cdf, K, buf, cap, end_out, L,
                               P, cuda_stream, device);
}

const char* ctt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
