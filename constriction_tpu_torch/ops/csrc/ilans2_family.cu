// Device-family ILANS2 rANS on Hopper (sm_90a): encode and decode at W=16,
// S=32, P=12 where every symbol has its own continuous model (mean, scale)
// of one family, evaluated in the kernel by family.cuh's integer CDF.
//
// Replaces the Pallas kernels
//   constriction_tpu/ops/pallas_family.py  _family_decode_kernel_body  (11)
//   constriction_tpu/ops/pallas_family.py  _family_encode_kernel_body  (12)
// and holds the same wire format as ilans2.cu: symbol i belongs to lane
// i mod L, lanes are seeded at 2^16, all lanes share one word stream in
// decode-consumption order.
//
// What bounds them on this card: operations and latency, not bytes.  A
// decoded symbol costs one bisection over left() (8 evaluations for a
// 201-symbol support), each a dependent chain of some fifty integer and
// float operations with two or three float divisions; an encoded symbol
// costs two evaluations.
//
// Decode (kernel 11): ilans2_wide.cuh's cluster decode over FamilyModel.
// Its quantile is the lane state's low 12 bits, so the bisection stays on
// the serial step (unlike the TChain-12 decode's, whose quantiles are
// inputs): up to 16 CTAs, the lane states in registers, one exchange a
// step, and a thread's lanes bisected two at a time in lock step: every
// level evaluates both lanes' left() together, with no branch that depends
// on the lane (family.cuh's atan_fix selects), so the two dependent chains
// interleave.  A lane's next mean and scale are read at the end of a step,
// so the loads' latency passes behind the exchange, and the scale is
// inverted (__fdiv_rn, correctly rounded as the wire format needs) at the
// start of the next.  What is left is issue rate on the cluster's 16 SMs:
// on an NVIDIA H100 80GB HBM3 at 700 W a step takes 9.4 us at 2 lanes a
// thread (L = 4096 .. 32768), 5.3 at one and 17.5 at four (chip_smoke.py,
// sweep), about 90 issued instructions a left() evaluation.
//
// Encode (kernel 12): one thread block codes the whole message: the T
// steps are a serial chain through the per-step prefix count over all L
// lanes (warp ballot, block scan: lanes.cuh), and each thread walks its
// L / 1024 lanes one after another.  The renorm decision of step t needs
// prob(t), and its state update, made one iteration later once the step's
// emission offsets are known, needs (cum, prob)(t) again: the kernel keeps
// them per lane in a scratch array in device memory (`tab`, L words,
// L2-resident) rather than evaluating left() twice more.  What the Pallas
// kernels do about the TPU does not carry over: no double-buffered
// parameter DMA (a lane loads its own mean and scale, coalesced), no table
// staging (there is no table), native u32 division.

#include "family.cuh"
#include "ilans2_wide.cuh"
#include "lanes.cuh"

namespace {

constexpr int kW = 16, kP = family::kFx;
constexpr uint32_t kWordMask = 0xffffu;

// Lanes of a thread bisected together: the R = 2 instance's chains fill
// the 64 registers a thread of a 1024-thread CTA has; at R = 4 four chains
// at once spilled (ptxas: 52-60 bytes).
constexpr int kLockStep = 2;

// Kernel 11's decode model: symbol i's (mean, scale) from the padded
// parameter planes [T * L] (mean 0 and scale 1 past n, so every lane of a
// partial last step evaluates a valid model whose result is unused),
// inverted by family::invert's bisection, the lanes of a thread in lock
// step kLockStep at a time.  Lanes past L (a CTA's last warps) read lane
// L - 1's model.  It carries each lane's (mean, scale) of the coming step
// from one invert_lanes call to the next (slot r of R): read at the end of
// a step, so the loads' latency passes behind the step's exchange, and the
// scale inverted at the start of the next (step 0's are read in the first
// call).
template <int F>
struct FamilyModel {
  const float* means;
  const float* scales;
  int L;
  int T;
  family::Support sup;
  float mean[kMaxRows];
  float scale[kMaxRows];

  __device__ void stage(uint32_t*) {}

  template <int R>
  __device__ void load(int t, const int (&l)[R]) {
    const int64_t at = static_cast<int64_t>(t) * L;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t i = at + min(l[r], L - 1);
      mean[r] = means[i];
      scale[r] = scales[i];
    }
  }

  template <int R>
  __device__ void invert_lanes(int t, const int (&l)[R],
                               const uint32_t (&q)[R], int (&sym)[R],
                               uint32_t (&cum)[R], uint32_t (&prob)[R]) {
    static_assert(R <= kMaxRows, "more lanes a thread than slots");
    constexpr int K = R < kLockStep ? R : kLockStep;
    if (t == 0) load(0, l);
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += K) {
      // family::invert for lanes r0 .. r0 + K - 1, level by level:
      // max{x : left(x) <= q}, never evaluating left(min_sym), the
      // surviving ends' values carried along
      float inv[K];
      int lo[K], hi[K], c[K], right[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        inv[k] = __fdiv_rn(1.0f, scale[r0 + k]);
        lo[k] = sup.min_sym;
        hi[k] = sup.max_sym + 1;
        c[k] = 0;
        right[k] = family::kOne;
      }
      for (int it = 0; it < sup.iters; ++it) {
        int mid[K], lmid[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          mid[k] = max((lo[k] + hi[k]) >> 1, sup.min_sym + 1);
          lmid[k] = family::left<F>(
              mid[k], family::Model{mean[r0 + k], inv[k]}, sup.min_sym,
              sup.free);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool take = lmid[k] <= static_cast<int>(q[r0 + k]);
          lo[k] = take ? mid[k] : lo[k];
          c[k] = take ? lmid[k] : c[k];
          hi[k] = take ? hi[k] : mid[k];
          right[k] = take ? right[k] : lmid[k];
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sym[r0 + k] = lo[k];
        cum[r0 + k] = static_cast<uint32_t>(c[k]);
        prob[r0 + k] = static_cast<uint32_t>(right[k] - c[k]);
      }
    }
    // the next step's models (the last step reads its own again)
    load(min(t + 1, T - 1), l);
  }
};

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

// Kernel 11 on a cluster of `cluster` CTAs (0: the size picked from L).
template <int F>
int launch_decode(void* states, const void* stream, long long slen,
                  const void* means, const void* scales, void* syms,
                  long long n, int L, int cluster, int min_sym, int max_sym,
                  void* cuda_stream, int device) {
  if (!valid_lanes(L) || !family::valid_support(min_sym, max_sym)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ClusterGeometry geo;
  ClusterDecodeFn<kW, 32, FamilyModel<F>, false> kernel;
  cudaError_t err = plan_cluster_decode<kW, 32, FamilyModel<F>, false>(
      L, cluster, 0, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  const FamilyModel<F> model{static_cast<const float*>(means),
                             static_cast<const float*>(scales), L, T,
                             family::make_support(min_sym, max_sym)};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      geo, 0, static_cast<cudaStream_t>(cuda_stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<uint32_t*>(states),
      static_cast<const uint32_t*>(stream), static_cast<int64_t>(slen), model,
      static_cast<int32_t*>(syms), static_cast<int64_t>(n), L, kP, T,
      geo.groups_per_cta, static_cast<int64_t*>(nullptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 11's geometry for L lanes (`cluster` 0: the size it picks) into
// out[5]: cluster size, groups per CTA, lanes per thread, threads per CTA,
// the card's maximum of active clusters of that shape.
template <int F>
int geometry(int L, int cluster, long long* out, int device) {
  if (!valid_lanes(L)) return static_cast<int>(cudaErrorInvalidValue);
  ClusterGeometry geo;
  ClusterDecodeFn<kW, 32, FamilyModel<F>, false> kernel;
  const cudaError_t err = plan_cluster_decode<kW, 32, FamilyModel<F>, false>(
      L, cluster, 0, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[5] = {geo.cluster, geo.groups_per_cta, geo.rows,
                             geo.threads, geo.max_active_clusters};
  for (int k = 0; k < 5; ++k) out[k] = vals[k];
  return 0;
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
                             scales, syms, n, L, 0, min_sym, max_sym,
                             cuda_stream, device);
}

// The same decode on a cluster of `cluster` CTAs (1 .. 16).
int ctt_family_decode_cluster(void* states, const void* stream,
                              long long slen, const void* means,
                              const void* scales, void* syms, long long n,
                              int L, int fam, int min_sym, int max_sym,
                              int cluster, void* cuda_stream, int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return CTT_DISPATCH_FAMILY(fam, launch_decode, states, stream, slen, means,
                             scales, syms, n, L, cluster, min_sym, max_sym,
                             cuda_stream, device);
}

int ctt_family_geometry(int L, int fam, int cluster, long long* out,
                        void* cuda_stream, int device) {
  (void)cuda_stream;
  return CTT_DISPATCH_FAMILY(fam, geometry, L, cluster, out, device);
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
