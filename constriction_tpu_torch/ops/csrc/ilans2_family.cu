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
// Encode (kernel 12): three launches over the whole grid.  A lane's renorm
// decision and next state read only its own state and symbol, and a
// symbol's interval (two left() evaluations, the operation-bound part)
// reads no state at all; the lanes meet only where their words land.  So:
//   (a) family_records.cuh's tables pass (family_tables_kernel, kernel
//       22's too), one thread per symbol: each symbol's DivisionRecord32
//       (its (cum, prob) and the multiply-high reciprocal of prob) into
//       recs[n];
//   (b) pass A, ilans2_wide.cuh's encode_lanes_kernel<16, 32,
//       RecordLanesModel> at P = 12 (kernel 3's pass A): one thread per
//       lane runs steps T-1 .. 0 with its state in a register, each record
//       fetched a step ahead, the division a __umulhi, each emitted word
//       into a dense scratch words[t * L + l] and one ballot per (step,
//       32-lane group) into flags;
//   (c) pass B, the row-major compaction (launch_compact) into the
//       stream.
// (a) holds the evaluations and fills the card, (b) is a chain of T short
// steps a lane, (c) moves one word per u32.  The Pallas kernel's
// double-buffered parameter DMA and in-kernel compaction do not carry
// over.

#include "family.cuh"
#include "family_records.cuh"
#include "ilans2_wide.cuh"

namespace {

constexpr int kW = 16, kP = family::kFx;

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

// Kernel 12's pass A alone over the records of (a): words[T * L] (left as
// they are where a lane does not renorm) and flags[T * L / 32] out, states
// coded in place.
int launch_encode_lanes(void* states, const void* recs, long long n,
                        void* words, void* flags, int L, void* cuda_stream,
                        int device) {
  if (!valid_lanes(L)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = encode_lanes_kernel<kW, 32, RecordLanesModel>;
  const cudaError_t err = prepare(kernel, device, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  kernel<<<ceil_div(L, kLaneThreads), kLaneThreads, 0,
           static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<uint32_t*>(states),
      RecordLanesModel{static_cast<const DivisionRecord32*>(recs)},
      static_cast<int64_t>(n), static_cast<uint32_t*>(words),
      static_cast<uint32_t*>(flags), L, kP, T);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 12's tables pass (a) alone: recs[n] (8 bytes each).
template <int F>
int launch_tables(const void* syms, const void* means, const void* scales,
                  void* recs, long long n, int min_sym, int max_sym,
                  void* cuda_stream, int device) {
  if (n < 0 || !family::valid_support(min_sym, max_sym)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_family_tables<F>(syms, means, scales, recs, n, min_sym,
                                 max_sym,
                                 static_cast<cudaStream_t>(cuda_stream));
}

// Kernel 12: (a), (b) and (c) into buf[*end_out : cap].  Scratch the caller
// allocates: recs[n] (8 bytes each), words[T * L], flags[T * L / 32],
// offsets[kScanBlocks] (u64).  Symbols are clamped into the support;
// callers validate them.
template <int F>
int launch_encode(void* states, const void* syms, long long n,
                  const void* means, const void* scales, void* recs,
                  void* buf, long long cap, void* end_out, void* words,
                  void* flags, void* offsets, int L, int min_sym, int max_sym,
                  void* cuda_stream, int device) {
  if (!valid_lanes(L)) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_tables<F>(syms, means, scales, recs, n, min_sym, max_sym,
                             cuda_stream, device);
  if (err != 0 || n <= 0) return err;
  err = launch_encode_lanes(states, recs, n, words, flags, L, cuda_stream,
                            device);
  if (err != 0) return err;
  const long long n_flags = (n + L - 1) / L * (L / 32);
  return launch_compact(flags, words, n_flags, buf, cap, end_out, offsets,
                        cuda_stream, device);
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

// Kernel 12: recs[n] (8 bytes each), words[T * L], flags[T * L / 32] and
// offsets[kScanBlocks] (u64) are scratch.
int ctt_family_encode(void* states, const void* syms, long long n,
                      const void* means, const void* scales, void* recs,
                      void* buf, long long cap, void* end_out, void* words,
                      void* flags, void* offsets, int L, int fam, int min_sym,
                      int max_sym, void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_encode, states, syms, n, means,
                             scales, recs, buf, cap, end_out, words, flags,
                             offsets, L, min_sym, max_sym, cuda_stream,
                             device);
}

// Kernel 12's steps alone: (a) the tables pass, (b) pass A (pass B alone is
// ctt_ilans2_compact).
int ctt_family_tables_pass(const void* syms, const void* means,
                           const void* scales, void* recs, long long n,
                           int fam, int min_sym, int max_sym,
                           void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_tables, syms, means, scales, recs, n,
                             min_sym, max_sym, cuda_stream, device);
}

int ctt_family_encode_lanes(void* states, const void* recs, long long n,
                            void* words, void* flags, int L,
                            void* cuda_stream, int device) {
  return launch_encode_lanes(states, recs, n, words, flags, L, cuda_stream,
                             device);
}

int ctt_family_left(const void* x, const void* means, const void* scales,
                    void* out, long long count, int fam, int min_sym,
                    int free, void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_left, x, means, scales, out, count,
                             min_sym, free, cuda_stream, device);
}

}  // extern "C"
