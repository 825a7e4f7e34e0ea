// TChain bits-back coding on Hopper (sm_90a).  TChain-12 with per-symbol
// continuous families: the decoder turns 12-bit quantiles into symbols and
// gathers the information they did not need into per-lane remainder heads
// and a shared word stream; the encoder is its exact reverse.
//
// Replaces the Pallas kernels
//   constriction_tpu/ops/tchain.py  _tchain12_family_decode_kernel
//   constriction_tpu/ops/tchain.py  _tchain12_family_encode_kernel
// (W=16, S=32, P=12; heads seeded at 2^(S-W-P) = 16 and kept in
// [2^4, 2^20)).  Symbol i belongs to lane i mod L; a message is T full
// steps of L lanes, L a multiple of 1024.
//
// Quantiles keep the Pallas wire layout (ops/tchain.py pack_q12): within a
// step, the eight lanes l = 1024 k + 128 j + c (j = 0 .. 7) share the three
// u32 words at (3 k + {0, 1, 2}) * 128 + c, lane j's 12 bits starting at bit
// 12 j of the 96.  The TPU kernel unpacks whole [3R/8, 128] planes; here a
// lane computes its own word index and shift, reads one or two words, and
// the encoder ORs its bits into the zeroed output with atomicOr (lanes of
// eight different warps share a word).
//
// What bounds them on this card: like ilans2_family.cu, operations and
// latency: a bisection over left() per decoded quantile, two evaluations
// per re-encoded symbol, on one thread block whose steps chain through
// the per-step prefix count (lanes.cuh).  In the decoder only the word
// placement couples the lanes; spreading the rest over all SMs is later
// work.  The encoder keeps each lane's pending (cum, prob) in a scratch
// array (`tab`) as the rANS family encoder does.

#include "family.cuh"
#include "lanes.cuh"

namespace {

constexpr int kW = 16, kP = family::kFx;
constexpr uint32_t kWordMask = 0xffffu;
constexpr uint32_t kFlushAt = 1u << (32 - kP);  // heads stay below 2^(S-P)
constexpr int kRefillShift = 32 - kW - kP;      // refill: head < prob << 4

// Where lane l's 12-bit quantile lives within a step's 3L/8 words.
struct QSlot {
  int word;   // index of the word holding its low bits
  int shift;  // bit offset in that word; above 20 it runs into word + 128
};

__device__ __forceinline__ QSlot q_slot(int l) {
  const int row = l >> 7, c = l & 127;
  const int bit = 12 * (row & 7);
  return QSlot{(3 * (row >> 3) + (bit >> 5)) * 128 + c, bit & 31};
}

__device__ __forceinline__ uint32_t load_q(const uint32_t* __restrict__ qw,
                                           int l) {
  const QSlot s = q_slot(l);
  uint32_t v = qw[s.word] >> s.shift;
  if (s.shift > 20) v |= qw[s.word + 128] << (32 - s.shift);
  return v & 0xfffu;
}

__device__ __forceinline__ void store_q(uint32_t* __restrict__ qw, int l,
                                        uint32_t q) {
  const QSlot s = q_slot(l);
  atomicOr(&qw[s.word], q << s.shift);
  if (s.shift > 20) atomicOr(&qw[s.word + 128], q >> (32 - s.shift));
}

// Bits-back decode of T * L quantiles.  heads[L]: the seeds (16) in, the
// final heads out.  buf[cap]: the flushed words of step t land right to
// left below an end pointer, so on return the remainder stream is
// buf[*end_out : cap].
template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    tchain12_family_decode_kernel(uint32_t* __restrict__ heads,
                                  const uint32_t* __restrict__ qw,
                                  const float* __restrict__ means,
                                  const float* __restrict__ scales,
                                  int32_t* __restrict__ syms,
                                  uint32_t* __restrict__ buf, int64_t cap,
                                  int64_t* __restrict__ end_out, int L, int T,
                                  family::Support sup) {
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int rows = L / kThreads;
  const int64_t step_words = 3 * static_cast<int64_t>(L) / 8;
  int64_t e = cap;  // words of the finished steps occupy buf[e : cap]

  // Iteration t writes the words step t - 1 flushed (a head still at or
  // above 2^20 carries its pending word in its low 16 bits), then decodes
  // step t.
  for (int t = 0; t <= T; ++t) {
    const int cur = t & 1, prev = cur ^ 1;
    for (int r = 0; r < rows; ++r) {
      const int l = r * kThreads + tid;
      const int g = l >> 5;
      uint32_t h = heads[l];
      if (t > 0 && h >= kFlushAt) {
        const int64_t idx = e + s.prefix(prev)[g] +
                            __popc(s.ballots(prev)[g] & lt_mask);
        buf[idx] = h & kWordMask;
        h >>= kW;
      }
      if (t < T) {
        const int64_t i = static_cast<int64_t>(t) * L + l;
        const family::Model m = family::load_model(means, scales, i);
        const uint32_t q = load_q(qw + t * step_words, l);
        uint32_t cum, prob;
        syms[i] = family::invert<F>(static_cast<int>(q), m, sup, &cum, &prob);
        h = h * prob + (q - cum);
        const unsigned bal = __ballot_sync(kFull, h >= kFlushAt);
        if (lane == 0) s.ballots(cur)[g] = bal;
      }
      heads[l] = h;
    }
    if (t == T) break;
    __syncthreads();
    const uint32_t total = scan_groups(s.ballots(cur), s.prefix(cur),
                                       s.warp_sums(), G);
    __syncthreads();
    e -= total;
  }
  if (tid == 0) *end_out = e;
}

// The reverse pass over T * L symbols, steps T-1 .. 0.  heads[L]: the
// decoder's final heads in, the heads before step 0 out (16 each after a
// full reverse).  words[wlen]: the remainder stream; reads past its end
// yield 0.  qw: T * 3L/8 words, zeroed by the caller.  tab[L]: scratch,
// cum | prob << 16 of each lane's pending step.  Symbols are clamped into
// the support; callers validate them.
template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    tchain12_family_encode_kernel(uint32_t* __restrict__ heads,
                                  const int32_t* __restrict__ syms,
                                  const float* __restrict__ means,
                                  const float* __restrict__ scales,
                                  const uint32_t* __restrict__ words,
                                  int64_t wlen, uint32_t* __restrict__ tab,
                                  uint32_t* __restrict__ qw, int L, int T,
                                  family::Support sup) {
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int rows = L / kThreads;
  const int64_t step_words = 3 * static_cast<int64_t>(L) / 8;
  int64_t base = 0;         // first word of the pending step's refills
  uint32_t last_total = 0;  // words the pending step consumed

  // Iteration j refills and un-codes step T - j (flagged in iteration
  // j - 1), then evaluates and flags step T - 1 - j.
  for (int j = 0; j <= T; ++j) {
    const int cur = j & 1, prev = cur ^ 1;
    const int t = T - 1 - j;
    for (int r = 0; r < rows; ++r) {
      const int l = r * kThreads + tid;
      const int g = l >> 5;
      uint32_t h = heads[l];
      if (j > 0) {
        const uint32_t packed = tab[l];
        const uint32_t cum = packed & 0xffffu, prob = packed >> 16;
        if (h < (prob << kRefillShift)) {  // the decision flagged last time
          const int64_t idx = base + s.prefix(prev)[g] +
                              __popc(s.ballots(prev)[g] & lt_mask);
          const uint32_t word = idx < wlen ? words[idx] : 0u;
          h = (h << kW) | (word & kWordMask);
        }
        store_q(qw + (t + 1) * step_words, l, cum + h % prob);
        h /= prob;
      }
      if (j < T) {
        const int64_t i = static_cast<int64_t>(t) * L + l;
        const family::Model m = family::load_model(means, scales, i);
        const int sym = min(max(syms[i], sup.min_sym), sup.max_sym);
        uint32_t cum, prob;
        family::tables<F>(sym, m, sup, &cum, &prob);
        tab[l] = cum | (prob << 16);
        const unsigned bal =
            __ballot_sync(kFull, h < (prob << kRefillShift));
        if (lane == 0) s.ballots(cur)[g] = bal;
      }
      heads[l] = h;
    }
    if (j == T) break;
    __syncthreads();
    const uint32_t total = scan_groups(s.ballots(cur), s.prefix(cur),
                                       s.warp_sums(), G);
    __syncthreads();
    base += last_total;
    last_total = total;
  }
}

bool valid_chain(int L, long long T, int min_sym, int max_sym) {
  return L > 0 && L % kThreads == 0 && T >= 0 && T <= (1 << 30) &&
         family::valid_support(min_sym, max_sym);
}

template <int F>
int launch_decode(void* heads, const void* qw, const void* means,
                  const void* scales, void* syms, void* buf, long long cap,
                  void* end_out, int L, int T, int min_sym, int max_sym,
                  void* cuda_stream, int device) {
  if (!valid_chain(L, T, min_sym, max_sym)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = scratch_words(L / 32) * sizeof(uint32_t);
  auto kernel = tchain12_family_decode_kernel<F>;
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<uint32_t*>(heads), static_cast<const uint32_t*>(qw),
      static_cast<const float*>(means), static_cast<const float*>(scales),
      static_cast<int32_t*>(syms), static_cast<uint32_t*>(buf), cap,
      static_cast<int64_t*>(end_out), L, T,
      family::make_support(min_sym, max_sym));
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_encode(void* heads, const void* syms, const void* means,
                  const void* scales, const void* words, long long wlen,
                  void* tab, void* qw, int L, int T, int min_sym, int max_sym,
                  void* cuda_stream, int device) {
  if (!valid_chain(L, T, min_sym, max_sym)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = scratch_words(L / 32) * sizeof(uint32_t);
  auto kernel = tchain12_family_encode_kernel<F>;
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<uint32_t*>(heads), static_cast<const int32_t*>(syms),
      static_cast<const float*>(means), static_cast<const float*>(scales),
      static_cast<const uint32_t*>(words), wlen, static_cast<uint32_t*>(tab),
      static_cast<uint32_t*>(qw), L, T,
      family::make_support(min_sym, max_sym));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (constriction_tpu_torch/ops/_build.py).
// Each entry launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 on success).  `fam` indexes
// (gaussian, laplace, logistic, cauchy).
extern "C" {

int ctt_tchain12_family_decode(void* heads, const void* qw, const void* means,
                               const void* scales, void* syms, void* buf,
                               long long cap, void* end_out, int L, int T,
                               int fam, int min_sym, int max_sym,
                               void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_decode, heads, qw, means, scales,
                             syms, buf, cap, end_out, L, T, min_sym, max_sym,
                             cuda_stream, device);
}

int ctt_tchain12_family_encode(void* heads, const void* syms,
                               const void* means, const void* scales,
                               const void* words, long long wlen, void* tab,
                               void* qw, int L, int T, int fam, int min_sym,
                               int max_sym, void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_encode, heads, syms, means, scales,
                             words, wlen, tab, qw, L, T, min_sym, max_sym,
                             cuda_stream, device);
}

}  // extern "C"
