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
// scan that spreads the lanes over many SMs is later work.  The ballot,
// the block scan, the CDF staging and the symbol search are in lanes.cuh,
// shared with the range coder (ilans2_range.cu).

#include "lanes.cuh"

namespace {

// Decode n symbols.  states[L]: initial decoder states in, final states out.
// stream[slen]: W-bit words, one per u32; reads past the end yield 0 (a
// truncated or corrupt stream decodes to garbage, never faults).
template <int W, int S>
__global__ void __launch_bounds__(kThreads, 1)
    ilans2_decode_kernel(typename StateOf<S>::type* __restrict__ states,
                         const uint32_t* __restrict__ stream, int64_t slen,
                         const uint32_t* __restrict__ cdf_g, int K,
                         int32_t* __restrict__ syms, int64_t n, int L, int P,
                         int T, int cdf_in_smem) {
  using State = typename StateOf<S>::type;
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
  const uint32_t* cdf = stage_cdf(s.cdf(), cdf_g, K, cdf_in_smem);
  __syncthreads();

  constexpr State kLower = State(1) << (S - W);
  constexpr uint32_t kWordMask = W == 32 ? kFull : ((1u << W) - 1u);
  const uint32_t qmask = (1u << P) - 1u;
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int rows = (L + kThreads - 1) / kThreads;
  int64_t base = 0;         // first stream word of the pending step's refills
  uint32_t last_total = 0;  // words the pending step consumed

  // Iteration t refills for step t - 1, then decodes step t.
  for (int t = 0; t <= T; ++t) {
    const int cur = t & 1, prev = cur ^ 1;
    for (int r = 0; r < rows; ++r) {
      if (r * kThreads + (tid & ~31) >= L) break;  // warp-uniform
      const int l = r * kThreads + tid;
      const int g = l >> 5;
      State x = states[l];
      if (t > 0 && x < kLower) {
        const int64_t idx = base + s.prefix(prev)[g] +
                            __popc(s.ballots(prev)[g] & lt_mask);
        const uint32_t word = idx < slen ? stream[idx] : 0u;
        x = (x << W) | static_cast<State>(word & kWordMask);
      }
      if (t < T) {
        const int64_t i = static_cast<int64_t>(t) * L + l;
        const uint32_t q = static_cast<uint32_t>(x) & qmask;
        const int sym = find_symbol(cdf, K, q);
        const uint32_t cum = cdf[sym];
        const uint32_t prob = cdf[sym + 1] - cum;
        if (i < n) {
          x = (x >> P) * prob + (q - cum);
          syms[i] = sym;
        }
        const unsigned bal = __ballot_sync(kFull, x < kLower);
        if (lane == 0) s.ballots(cur)[g] = bal;
      }
      states[l] = x;
    }
    if (t == T) break;
    __syncthreads();
    const uint32_t total = scan_groups(s.ballots(cur), s.prefix(cur),
                                       s.warp_sums(), G);
    __syncthreads();
    base += last_total;
    last_total = total;
  }
}

// Encode n symbols, walking steps T-1 .. 0.  states[L]: encoder start states
// (the seeds) in, final states (the decoder's initial states) out.  buf[cap]:
// the words of step t land right to left below an end pointer e, so on
// return the stream is buf[*end_out : cap].  Symbols outside [0, K) are
// clamped to K-1 to keep CDF reads in bounds; callers validate them.
template <int W, int S>
__global__ void __launch_bounds__(kThreads, 1)
    ilans2_encode_kernel(typename StateOf<S>::type* __restrict__ states,
                         const int32_t* __restrict__ syms, int64_t n,
                         const uint32_t* __restrict__ cdf_g, int K,
                         uint32_t* __restrict__ buf, int64_t cap,
                         int64_t* __restrict__ end_out, int L, int P, int T,
                         int cdf_in_smem) {
  using State = typename StateOf<S>::type;
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
  const uint32_t* cdf = stage_cdf(s.cdf(), cdf_g, K, cdf_in_smem);
  __syncthreads();

  constexpr State kWordMask = W == 32 ? State(kFull) : State((1u << W) - 1u);
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int rows = (L + kThreads - 1) / kThreads;
  const uint32_t kmax = static_cast<uint32_t>(K - 1);
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
          const uint32_t sym = min(static_cast<uint32_t>(syms[i]), kmax);
          const uint32_t cum = cdf[sym];
          const uint32_t prob = cdf[sym + 1] - cum;
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
        bool renorm = false;
        if (i < n) {
          const uint32_t sym = min(static_cast<uint32_t>(syms[i]), kmax);
          const uint32_t prob = cdf[sym + 1] - cdf[sym];
          renorm = (x >> (S - P)) >= prob;
        }
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

template <int W, int S>
int launch_decode(void* states, const void* stream, long long slen,
                  const void* cdf, int K, void* syms, long long n, int L,
                  int P, void* cuda_stream, int device) {
  int cdf_in_smem = 0;
  const size_t bytes = smem_bytes(L, K, &cdf_in_smem);
  auto kernel = ilans2_decode_kernel<W, S>;
  if (!valid_args(L, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<typename StateOf<S>::type*>(states),
      static_cast<const uint32_t*>(stream), slen,
      static_cast<const uint32_t*>(cdf), K, static_cast<int32_t*>(syms), n, L,
      P, T, cdf_in_smem);
  return static_cast<int>(cudaGetLastError());
}

template <int W, int S>
int launch_encode(void* states, const void* syms, long long n, const void* cdf,
                  int K, void* buf, long long cap, void* end_out, int L, int P,
                  void* cuda_stream, int device) {
  int cdf_in_smem = 0;
  const size_t bytes = smem_bytes(L, K, &cdf_in_smem);
  auto kernel = ilans2_encode_kernel<W, S>;
  if (!valid_args(L, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<typename StateOf<S>::type*>(states),
      static_cast<const int32_t*>(syms), n, static_cast<const uint32_t*>(cdf),
      K, static_cast<uint32_t*>(buf), cap, static_cast<int64_t*>(end_out), L,
      P, T, cdf_in_smem);
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
