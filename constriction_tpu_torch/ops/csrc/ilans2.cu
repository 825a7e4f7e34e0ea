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
// scan that spreads the lanes over many SMs is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
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

// Shared-memory carve-up: ballots and group prefixes for two steps (the
// fused loop reads step t's while it writes step t + 1's), the per-warp
// sums of the block scan, then the CDF when it fits.  Buffers are picked by
// pointer arithmetic on the step parity, which keeps them out of local
// memory.
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

// CDF in shared memory when it fits, else read from device memory.
__device__ __forceinline__ const uint32_t* stage_cdf(const Smem& s,
                                                     const uint32_t* cdf_g,
                                                     int K, int cdf_in_smem) {
  if (!cdf_in_smem) return cdf_g;
  uint32_t* cdf = s.cdf();
  for (int i = threadIdx.x; i <= K; i += kThreads) cdf[i] = cdf_g[i];
  return cdf;
}

// Largest s in [0, K) with cdf[s] <= q: searchsorted(cdf, q, "right") - 1,
// so zero-probability entries resolve as the host oracle does.  Needs
// cdf[0] <= q < cdf[K], which holds for q < 2^P.
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
// a barrier after it before `prefix` is read.
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
  const uint32_t* cdf = stage_cdf(s, cdf_g, K, cdf_in_smem);
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
  const uint32_t* cdf = stage_cdf(s, cdf_g, K, cdf_in_smem);
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

// Shared-memory size for a launch; decides whether the CDF is staged.
size_t smem_bytes(int L, int K, int* cdf_in_smem) {
  const size_t scratch = scratch_words(L / 32) * sizeof(uint32_t);
  const size_t cdf = (static_cast<size_t>(K) + 1) * sizeof(uint32_t);
  *cdf_in_smem = scratch + cdf <= kSmemBudget;
  return scratch + (*cdf_in_smem ? cdf : 0);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int device, int L, int P, int K,
                    size_t bytes) {
  if (L <= 0 || L % 32 != 0 || K < 1 || P < 1 || P > 24) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
  }
  return err;
}

template <int W, int S>
int launch_decode(void* states, const void* stream, long long slen,
                  const void* cdf, int K, void* syms, long long n, int L,
                  int P, void* cuda_stream, int device) {
  int cdf_in_smem = 0;
  const size_t bytes = smem_bytes(L, K, &cdf_in_smem);
  auto kernel = ilans2_decode_kernel<W, S>;
  const cudaError_t err = prepare(kernel, device, L, P, K, bytes);
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
  const cudaError_t err = prepare(kernel, device, L, P, K, bytes);
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
