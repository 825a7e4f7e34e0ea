// Device-family ILANS2 rANS on Hopper (sm_90a): encode and decode at W=16,
// S=32, P=12 where every symbol has its own continuous model (mean, scale)
// of one family, evaluated in the kernel by family.cuh's integer CDF.
//
// Replaces the Pallas kernels
//   constriction_tpu/ops/pallas_family.py  _family_decode_kernel_body
//   constriction_tpu/ops/pallas_family.py  _family_encode_kernel_body
// and holds the same wire format as ilans2.cu: symbol i belongs to lane
// i mod L, lanes are seeded at 2^16, all lanes share one word stream in
// decode-consumption order.
//
// What bounds them on this card: operations and latency, not bytes.  A
// decoded symbol costs one bisection over left() (8 evaluations for a
// 201-symbol support), each a dependent chain of some fifty integer and
// float operations with two float divisions; an encoded symbol costs two
// evaluations.  Like ilans2.cu, one thread block codes the whole message:
// the T steps are a serial chain through the per-step prefix count over
// all L lanes (warp ballot, block scan: lanes.cuh), and each thread walks
// its L / 1024 lanes one after another.  What the Pallas kernels do about
// the TPU does not carry over: no double-buffered parameter DMA (a lane
// loads its own mean and scale, coalesced), no table staging (there is no
// table), native u32 division.
//
// The encoder's renorm decision of step t needs prob(t), and its state
// update, made one iteration later once the step's emission offsets are
// known, needs (cum, prob)(t) again: the kernel keeps them per lane in a
// scratch array in device memory (`tab`, L words, L2-resident) rather than
// evaluating left() twice more.

#include "family.cuh"
#include "lanes.cuh"

namespace {

constexpr int kW = 16, kP = family::kFx;
constexpr uint32_t kLower = 1u << kW;  // 2^(S-W)
constexpr uint32_t kWordMask = 0xffffu;

// Decode n symbols.  states[L]: initial decoder states in, final states
// out.  means / scales: one model per symbol.  Reads past the end of the
// stream yield 0.
template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    family_decode_kernel(uint32_t* __restrict__ states,
                         const uint32_t* __restrict__ stream, int64_t slen,
                         const float* __restrict__ means,
                         const float* __restrict__ scales,
                         int32_t* __restrict__ syms, int64_t n, int L, int T,
                         family::Support sup) {
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
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
      uint32_t x = states[l];
      if (t > 0 && x < kLower) {
        const int64_t idx = base + s.prefix(prev)[g] +
                            __popc(s.ballots(prev)[g] & lt_mask);
        const uint32_t word = idx < slen ? stream[idx] : 0u;
        x = (x << kW) | (word & kWordMask);
      }
      if (t < T) {
        const int64_t i = static_cast<int64_t>(t) * L + l;
        if (i < n) {
          const family::Model m = family::load_model(means, scales, i);
          const uint32_t q = x & ((1u << kP) - 1u);
          uint32_t cum, prob;
          const int sym =
              family::invert<F>(static_cast<int>(q), m, sup, &cum, &prob);
          x = (x >> kP) * prob + (q - cum);
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

// Encode n symbols, walking steps T-1 .. 0.  states[L]: the seeds in, the
// decoder's initial states out.  buf[cap]: the words of step t land right
// to left below an end pointer, so on return the stream is
// buf[*end_out : cap].  tab[L]: scratch, cum | prob << 16 of each lane's
// pending step.  Symbols are clamped into the support; callers validate
// them.
template <int F>
__global__ void __launch_bounds__(kThreads, 1)
    family_encode_kernel(uint32_t* __restrict__ states,
                         const int32_t* __restrict__ syms, int64_t n,
                         const float* __restrict__ means,
                         const float* __restrict__ scales,
                         uint32_t* __restrict__ tab,
                         uint32_t* __restrict__ buf, int64_t cap,
                         int64_t* __restrict__ end_out, int L, int T,
                         family::Support sup) {
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int rows = (L + kThreads - 1) / kThreads;
  int64_t e = cap;  // words of the finished steps occupy buf[e : cap]

  // Iteration j emits and codes step T - j (flagged in iteration j - 1),
  // then evaluates and flags step T - 1 - j.
  for (int j = 0; j <= T; ++j) {
    const int cur = j & 1, prev = cur ^ 1;
    const int t = T - 1 - j;
    for (int r = 0; r < rows; ++r) {
      if (r * kThreads + (tid & ~31) >= L) break;  // warp-uniform
      const int l = r * kThreads + tid;
      const int g = l >> 5;
      uint32_t x = states[l];
      if (j > 0 && static_cast<int64_t>(t + 1) * L + l < n) {
        const uint32_t packed = tab[l];
        const uint32_t cum = packed & 0xffffu, prob = packed >> 16;
        if ((x >> (32 - kP)) >= prob) {  // the decision flagged last iteration
          const int64_t idx = e + s.prefix(prev)[g] +
                              __popc(s.ballots(prev)[g] & lt_mask);
          buf[idx] = x & kWordMask;
          x >>= kW;
        }
        x = ((x / prob) << kP) | (cum + x % prob);
      }
      if (j < T) {
        const int64_t i = static_cast<int64_t>(t) * L + l;
        bool renorm = false;
        if (i < n) {
          const family::Model m = family::load_model(means, scales, i);
          const int sym = min(max(syms[i], sup.min_sym), sup.max_sym);
          uint32_t cum, prob;
          family::tables<F>(sym, m, sup, &cum, &prob);
          tab[l] = cum | (prob << 16);
          renorm = (x >> (32 - kP)) >= prob;
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

// left(x[i]) under model i, elementwise: the integer CDF by itself, so a
// test can hold it against the plain arithmetic value by value.
template <int F>
__global__ void family_left_kernel(const int32_t* __restrict__ x,
                                   const float* __restrict__ means,
                                   const float* __restrict__ scales,
                                   int32_t* __restrict__ out, int64_t count,
                                   int min_sym, int free) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    out[i] = family::left<F>(x[i], family::load_model(means, scales, i),
                             min_sym, free);
  }
}

bool valid_lanes(int L) { return L > 0 && L % 32 == 0; }

template <int F>
int launch_decode(void* states, const void* stream, long long slen,
                  const void* means, const void* scales, void* syms,
                  long long n, int L, int min_sym, int max_sym,
                  void* cuda_stream, int device) {
  if (!valid_lanes(L) || !family::valid_support(min_sym, max_sym)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = scratch_words(L / 32) * sizeof(uint32_t);
  auto kernel = family_decode_kernel<F>;
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<uint32_t*>(states), static_cast<const uint32_t*>(stream),
      slen, static_cast<const float*>(means),
      static_cast<const float*>(scales), static_cast<int32_t*>(syms), n, L, T,
      family::make_support(min_sym, max_sym));
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_encode(void* states, const void* syms, long long n,
                  const void* means, const void* scales, void* tab, void* buf,
                  long long cap, void* end_out, int L, int min_sym,
                  int max_sym, void* cuda_stream, int device) {
  if (!valid_lanes(L) || !family::valid_support(min_sym, max_sym)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = scratch_words(L / 32) * sizeof(uint32_t);
  auto kernel = family_encode_kernel<F>;
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<uint32_t*>(states), static_cast<const int32_t*>(syms), n,
      static_cast<const float*>(means), static_cast<const float*>(scales),
      static_cast<uint32_t*>(tab), static_cast<uint32_t*>(buf), cap,
      static_cast<int64_t*>(end_out), L, T,
      family::make_support(min_sym, max_sym));
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_left(const void* x, const void* means, const void* scales,
                void* out, long long count, int min_sym, int free,
                void* cuda_stream, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const long long want = (count + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  family_left_kernel<F>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
          static_cast<const int32_t*>(x), static_cast<const float*>(means),
          static_cast<const float*>(scales), static_cast<int32_t*>(out),
          count, min_sym, free);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (constriction_tpu_torch/ops/_build.py).
// Each entry launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 on success).  `fam` indexes
// (gaussian, laplace, logistic, cauchy).
extern "C" {

int ctt_family_decode(void* states, const void* stream, long long slen,
                      const void* means, const void* scales, void* syms,
                      long long n, int L, int fam, int min_sym, int max_sym,
                      void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_decode, states, stream, slen, means,
                             scales, syms, n, L, min_sym, max_sym,
                             cuda_stream, device);
}

int ctt_family_encode(void* states, const void* syms, long long n,
                      const void* means, const void* scales, void* tab,
                      void* buf, long long cap, void* end_out, int L, int fam,
                      int min_sym, int max_sym, void* cuda_stream,
                      int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_encode, states, syms, n, means,
                             scales, tab, buf, cap, end_out, L, min_sym,
                             max_sym, cuda_stream, device);
}

int ctt_family_left(const void* x, const void* means, const void* scales,
                    void* out, long long count, int fam, int min_sym,
                    int free, void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_left, x, means, scales, out, count,
                             min_sym, free, cuda_stream, device);
}

}  // extern "C"
