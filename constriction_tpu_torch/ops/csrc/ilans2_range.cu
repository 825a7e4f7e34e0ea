// ILANS2-R shared-stream interleaved RANGE coding on Hopper (sm_90a): the
// range decoder and the two phases of the range encoder, templated on the
// preset (W, S) in {(16, 32), (32, 64)}.
//
// Replaces the Pallas kernels
//   constriction_tpu/ops/pallas_coder.py     _range_decode_kernel_body   (W=16, S=32)
//   constriction_tpu/ops/pallas_coder64.py   _range_decode_kernel_body64 (W=32, S=64)
//   constriction_tpu/ops/pallas_range_enc.py _range_record_kernel        (phase A, S=32)
//   constriction_tpu/ops/pallas_range_enc.py _range_record_kernel64      (phase A, S=64)
//   constriction_tpu/ops/pallas_range_enc.py _range_resolve_kernel       (phase B, S=32)
//   constriction_tpu/ops/pallas_range_enc.py _range_resolve_kernel64     (phase B, S=64)
// and holds the same wire format: symbol i belongs to lane i mod L; each
// lane is a reference range coder (lower, range, point); all lanes share one
// word stream in decode-consumption order (at each step the refilling lanes
// take the next words in ascending lane order); a lane's first S/W words
// are its initial point.  The TPU kernels hold S=64 values as u32 pairs
// (_mul40x25, _div64_by_scale, _pair_add); here they are native uint64_t,
// and the decode's division by the scale an f64 estimate with one
// correcting product at both presets.
//
// Encoding is the two-phase big-number formulation of pallas_range_enc.py:
// a range coder's emitted words are base-2^W digits of an unbounded
// `lower`, and a wrap of the S-bit lower adds +1 to the digits already
// emitted.  Phase A runs the interval updates forward and records, per
// (step, lane), the provisional word, the renorm flag and the carry flag;
// the seal (range_enc.py, on the device) turns the final (lower, range)
// into the last word and a last carry; phase B walks the steps backward,
// resolves the carries with a pending +1 per lane, and places each lane's
// words through a 2-deep delay line (the r-th renorm of a lane carries the
// lane's word r + 2; words 0 and 1 form the point header).
//
// What bounds them on this card:
// - The decode is serial over the T steps, and each step needs an
//   exclusive prefix over all L lanes (refill ranks).  At both presets
//   (kernel 5 at S=64, kernel 6 at S=32) it runs ilans2_wide.cuh's
//   cluster design (cluster_range_decode_kernel over
//   BucketCdfModel, shared with the rANS decodes): up to 16 CTAs, each
//   lane's num = point - lower and range in registers for the whole
//   message (the point in device memory, touched by refills only), one
//   distributed-shared-memory exchange and cluster barrier per step, a
//   bucket table in front of the CDF search (at P <= 12 it holds every
//   quantile's symbol), and the quantile's integer division replaced by an
//   f64 estimate from an approximate reciprocal and one correcting product
//   (f64_quotient).  The step's barriers and its chain (quotient, search,
//   products, refill load) bound it.  Phase B at both presets (kernel 8 at
//   S=32, kernel 10 at S=64) is a lane pass over the whole grid and the
//   encoders' row-major compaction (range_resolve_lanes_kernel, then
//   launch_compact): a lane's carry chain reads only its own records,
//   whose renorm flags fix where its words land, so nothing couples the
//   lanes inside the step loop; the record loads bound it (u32 records at
//   S=32, u64 at S=64).
// - Phase A has no cross-lane dependency: a grid of L / 128 blocks, one
//   thread per lane looping over T (range_record_ring_kernel), with symbol
//   reads and record writes coalesced across a warp.  It moves T * L
//   symbols in and T * L records out, so device memory bounds it once
//   enough loads are in flight; at L = 32768 only 8 warps an SM run, so a
//   lane keeps its next 32 symbols in registers, each step issuing the
//   load 32 steps ahead (one load in flight a lane left it at one device
//   round trip a step).

#include "ilans2_wide.cuh"

namespace {

// Record layout (phase A -> phase B), one State-wide word per (step, lane):
// bits [0, W) the provisional renorm word (0 without renorm), bit W the
// renorm flag, bit W + 1 the carry flag.  At S=32 this is the Pallas u32
// record; at S=64 it packs the Pallas kernel's record and flags planes.

// One lane of phase A: (lower, range) and the step on one symbol, which
// returns the step's record.  Symbols outside [0, K) are clamped to K-1;
// callers validate them.
template <int W, int S>
struct RecordLane {
  using State = typename StateOf<S>::type;
  static constexpr State kLower = State(1) << (S - W);
  State lower = 0, range = ~State(0);

  __device__ __forceinline__ State step(const uint32_t* cdf, uint32_t kmax,
                                        int P, int32_t s) {
    const uint32_t sym = min(static_cast<uint32_t>(s), kmax);
    const uint32_t cum = cdf[sym];
    const uint32_t prob = cdf[sym + 1] - cum;
    const State scale = range >> P;
    const State add = scale * cum;
    lower += add;  // wraps mod 2^S: the big-number +1 event
    const State carry = lower < add ? 1 : 0;
    range = scale * prob;
    State rec = carry << (W + 1);
    if (range < kLower) {
      rec |= (lower >> (S - W)) | (State(1) << W);
      lower <<= W;
      range <<= W;
    }
    return rec;
  }
};

// Phase A as a register ring.  A grid of L / kLanes blocks, one
// thread per lane over the T steps; each thread holds its lane's next
// kDepth symbols in registers, and each step's use of a slot issues the
// load kDepth steps ahead into it, so kDepth loads a lane stay in flight.
// The lane's loads and stores walk two pointers by L a step, and the steps
// it codes are one 32-bit count (so no 64-bit index is kept per slot).
// records[T * L] out (steps at i >= n leave the lane unchanged with record
// 0); low_out / rng_out[L]: the final (lower, range) per lane.
template <int W, int S, int kLanes, int kDepth>
__global__ void __launch_bounds__(kLanes)
    range_record_ring_kernel(const int32_t* __restrict__ syms, int64_t n,
                             const uint32_t* __restrict__ cdf_g, int K,
                             typename StateOf<S>::type* __restrict__ records,
                             typename StateOf<S>::type* __restrict__ low_out,
                             typename StateOf<S>::type* __restrict__ rng_out,
                             int L, int P, int T, int cdf_in_smem) {
  using State = typename StateOf<S>::type;
  extern __shared__ __align__(16) uint32_t smem_model[];
  const uint32_t* cdf = stage_cdf(smem_model, cdf_g, K, cdf_in_smem);
  __syncthreads();
  const int l = blockIdx.x * kLanes + threadIdx.x;
  if ((l & ~31) >= L) return;  // warp-uniform: L % 32 == 0
  const uint32_t kmax = static_cast<uint32_t>(K - 1);
  // the steps at which lane l codes a symbol: t < tl <=> t * L + l < n
  const int tl = l < n ? static_cast<int>((n - 1 - l) / L) + 1 : 0;
  const int32_t* src = syms + l;
  State* dst = records + l;
  RecordLane<W, S> lane;
  int32_t ring[kDepth];
#pragma unroll
  for (int j = 0; j < kDepth; ++j) {
    ring[j] = j < tl ? *src : 0;
    src += L;
  }
  for (int t0 = 0; t0 < T; t0 += kDepth) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int t = t0 + j;
      const int32_t cur = ring[j];
      ring[j] = t + kDepth < tl ? *src : 0;
      src += L;
      if (t < T) {
        *dst = t < tl ? lane.step(cdf, kmax, P, cur) : State(0);
        dst += L;
      }
    }
  }
  low_out[l] = lane.lower;
  rng_out[l] = lane.range;
}

// Phase B (kernel 8 at S=32, kernel 10 at S=64) as a lane pass and the
// encoders' row-major compaction.  A lane's pending carry and delay line
// (p, d1, d2) read only the lane's own records, and where a word lands is
// fixed by the renorm flags phase A already wrote into the records (bit
// W): the lanes meet only there, as in the TChain-12 decode (tchain.cu,
// kernel 21).  So range_resolve_lanes_kernel runs one thread per lane over
// the grid (blocks of kResolveThreads, a per-warp guard: L is any multiple
// of 32), walks t = T-1 .. 0 with (p, d1, d2) in u32 registers, seeded
// from the seal (p = seal carry, d1 = the seal's word, d2 = 0), and its
// records loaded kResolveAhead steps ahead; at a renorm it writes d2 to a
// dense words[t * L + l], each step one ballot of renorm flags per 32-lane
// group to flags[t * G + g], and at the end points[l] = d1 << W | d2.  At
// W=32 the word plus the pending carry can reach 2^32 (vfull is 64 bits):
// the new word is then 0 and the carry moves on in p.  Pass B
// (launch_compact) writes the rows in ascending order: the stream runs
// from step 0 to step T-1, lanes ascending within a step: the decoder's
// consumption order.  The lane pass is a chain of T
// short steps a lane; its loads are the records, coalesced across a warp.
constexpr int kResolveThreads = 128;
constexpr int kResolveAhead = 8;  // records a lane has in flight

template <int W, int S>
__global__ void __launch_bounds__(kResolveThreads)
    range_resolve_lanes_kernel(
        const typename StateOf<S>::type* __restrict__ records,
        const uint32_t* __restrict__ s0,
        const uint32_t* __restrict__ seal_carry,
        uint32_t* __restrict__ words, uint32_t* __restrict__ flags,
        typename StateOf<S>::type* __restrict__ points, int L, int T) {
  using State = typename StateOf<S>::type;
  constexpr uint64_t kWordMask = (uint64_t(1) << W) - 1;
  const int l = blockIdx.x * kResolveThreads + threadIdx.x;
  if ((l & ~31) >= L) return;  // warp-uniform: L % 32 == 0
  const int lane = threadIdx.x & 31, g = l >> 5, G = L >> 5;
  uint32_t p = seal_carry[l], d1 = s0[l], d2 = 0;
  State cur[kResolveAhead], nxt[kResolveAhead];
#pragma unroll
  for (int j = 0; j < kResolveAhead; ++j) {
    const int t = T - 1 - j;
    cur[j] = t >= 0 ? records[static_cast<int64_t>(t) * L + l] : State(0);
  }
  for (int t0 = T - 1; t0 >= 0; t0 -= kResolveAhead) {
#pragma unroll
    for (int j = 0; j < kResolveAhead; ++j) {
      const int t = t0 - kResolveAhead - j;
      nxt[j] = t >= 0 ? records[static_cast<int64_t>(t) * L + l] : State(0);
    }
#pragma unroll
    for (int j = 0; j < kResolveAhead; ++j) {
      const int t = t0 - j;
      if (t >= 0) {  // uniform
        const State rec = cur[j];
        const bool renorm = ((rec >> W) & 1) != 0;
        if (renorm) {
          words[static_cast<int64_t>(t) * L + l] = d2;  // resolved two later
          const uint64_t vfull = (uint64_t(rec) & kWordMask) + p;
          d2 = d1;
          d1 = static_cast<uint32_t>(vfull & kWordMask);
          p = static_cast<uint32_t>(vfull >> W);
        }
        p += static_cast<uint32_t>((rec >> (W + 1)) & 1);
        const unsigned bal = __ballot_sync(kFull, renorm);
        if (lane == 0) flags[static_cast<int64_t>(t) * G + g] = bal;
      }
    }
#pragma unroll
    for (int j = 0; j < kResolveAhead; ++j) cur[j] = nxt[j];
  }
  points[l] = (State(d1) << W) | State(d2);
}

int num_steps(long long n, int L) {
  return static_cast<int>((n + L - 1) / L);
}

// Phase A's launch shape: lanes a block and steps a lane has in flight.
// Timed on the H100 at L=32768 and 65536 over both presets (chip_ab.py):
// 32 steps was the best depth overall (48 gained up to 2% at 32768 and
// lost up to 10% at 65536, 16 lost 7-9% at 32768), 64 lanes a block tied
// 128, and a TMA ring of shared-memory tiles (one cp.async.bulk a step row,
// an mbarrier a stage) was 14-17% slower at L=32768 and tied at best.
constexpr int kRecordLanes = 128;
constexpr int kRecordDepth = 32;

// Phase A: records[T * L], low_out / rng_out[L].
template <int W, int S>
int launch_record(const void* syms, long long n, const void* cdf, int K,
                  void* records, void* low_out, void* rng_out, int L, int P,
                  void* cuda_stream, int device) {
  using State = typename StateOf<S>::type;
  auto kernel = range_record_ring_kernel<W, S, kRecordLanes, kRecordDepth>;
  if (!valid_args(L, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  int cdf_in_smem = 0;
  const size_t bytes = cdf_smem_bytes(0, K, &cdf_in_smem);
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  kernel<<<ceil_div(L, kRecordLanes), kRecordLanes, bytes,
           static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(syms), n, static_cast<const uint32_t*>(cdf),
      K, static_cast<State*>(records), static_cast<State*>(low_out),
      static_cast<State*>(rng_out), L, P, num_steps(n, L), cdf_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// Phase A's launch shape for L lanes and K symbols, into out[5]: lanes a
// block, blocks, steps a lane has in flight, dynamic shared-memory bytes,
// whether the CDF is in shared memory.
int record_geometry(int L, int K, long long* out) {
  if (!valid_args(L, 1, K)) return static_cast<int>(cudaErrorInvalidValue);
  int cdf_in_smem = 0;
  const size_t bytes = cdf_smem_bytes(0, K, &cdf_in_smem);
  const long long vals[5] = {kRecordLanes, ceil_div(L, kRecordLanes),
                             kRecordDepth, static_cast<long long>(bytes),
                             cdf_in_smem};
  for (int k = 0; k < 5; ++k) out[k] = vals[k];
  return 0;
}

// Phase B's lane pass alone: words[T * L] (left as they are where a lane
// does not renorm) and flags[T * L / 32] out.
template <int W, int S>
int launch_resolve_lanes(const void* records, const void* s0,
                         const void* seal_carry, void* words, void* flags,
                         void* points, int L, int T, void* cuda_stream,
                         int device) {
  using State = typename StateOf<S>::type;
  if (L <= 0 || L % 32 != 0 || T < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  range_resolve_lanes_kernel<W, S><<<ceil_div(L, kResolveThreads),
                                     kResolveThreads, 0,
                                     static_cast<cudaStream_t>(
                                         cuda_stream)>>>(
      static_cast<const State*>(records), static_cast<const uint32_t*>(s0),
      static_cast<const uint32_t*>(seal_carry), static_cast<uint32_t*>(words),
      static_cast<uint32_t*>(flags), static_cast<State*>(points), L, T);
  return static_cast<int>(cudaGetLastError());
}

// Phase B: the lane pass, then pass B into buf[*end_out : cap].  Scratch
// the caller allocates: words[T * L], flags[T * L / 32], offsets[kScanBlocks]
// (u64).
template <int W, int S>
int launch_resolve(const void* records, const void* s0,
                   const void* seal_carry, void* buf, long long cap,
                   void* end_out, void* points, void* words, void* flags,
                   void* offsets, int L, int T, void* cuda_stream,
                   int device) {
  const int err = launch_resolve_lanes<W, S>(records, s0, seal_carry, words,
                                             flags, points, L, T,
                                             cuda_stream, device);
  if (err != 0 || T == 0) return err;
  return launch_compact(flags, words, static_cast<long long>(T) * (L / 32),
                        buf, cap, end_out, offsets, cuda_stream, device);
}

// The cluster decode (kernels 5 and 6); `cluster` 0 picks the cluster size
// from L.
template <int W, int S>
int launch_cluster_decode(void* lows, void* rngs, void* pts,
                          const void* stream, long long slen, const void* cdf,
                          int K, void* syms, long long n, int L, int P,
                          void* bad, int cluster, void* cuda_stream,
                          int device) {
  using State = typename StateOf<S>::type;
  if (!valid_args(L, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  BucketCdfModel model{static_cast<const uint32_t*>(cdf), K, 0, P, 0,
                       nullptr};
  const size_t bytes = bucket_smem_bytes(&model);
  ClusterGeometry geo;
  ClusterRangeDecodeFn<W, S, BucketCdfModel> kernel;
  cudaError_t err = plan_cluster_range_decode<W, S, BucketCdfModel>(
      L, cluster, bytes, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      geo, bytes, static_cast<cudaStream_t>(cuda_stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<State*>(lows), static_cast<State*>(rngs),
      static_cast<State*>(pts), static_cast<const uint32_t*>(stream),
      static_cast<int64_t>(slen), model, static_cast<int32_t*>(syms),
      static_cast<int64_t>(n), L, P, num_steps(n, L), geo.groups_per_cta,
      static_cast<unsigned long long*>(bad));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cluster decode's geometry for L lanes, K symbols and precision P
// (`cluster` 0: the size the decode picks), into out[8]: cluster size,
// groups per CTA, lanes per thread, threads per CTA, the card's maximum of
// active clusters of that shape, the dynamic shared memory bytes, whether
// the CDF is in shared memory, the bucket table's lut_bits.
template <int W, int S>
int cluster_geometry(int L, int K, int P, int cluster, long long* out,
                     int device) {
  if (!valid_args(L, P, K)) return static_cast<int>(cudaErrorInvalidValue);
  BucketCdfModel model{nullptr, K, 0, P, 0, nullptr};
  const size_t bytes = bucket_smem_bytes(&model);
  ClusterGeometry geo;
  ClusterRangeDecodeFn<W, S, BucketCdfModel> kernel;
  const cudaError_t err = plan_cluster_range_decode<W, S, BucketCdfModel>(
      L, cluster, bytes, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[8] = {geo.cluster, geo.groups_per_cta, geo.rows,
                             geo.threads, geo.max_active_clusters,
                             static_cast<long long>(bytes),
                             model.cdf_in_smem, model.lut_bits};
  for (int k = 0; k < 8; ++k) out[k] = vals[k];
  return 0;
}

}  // namespace

// Plain C interface, bound with ctypes (constriction_tpu_torch/ops/_build.py).
// Each entry launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 on success).
extern "C" {

int ctt_ilans2_range_record_w16s32(const void* syms, long long n,
                                   const void* cdf, int K, void* records,
                                   void* low_out, void* rng_out, int L, int P,
                                   void* cuda_stream, int device) {
  return launch_record<16, 32>(syms, n, cdf, K, records, low_out, rng_out, L,
                               P, cuda_stream, device);
}

int ctt_ilans2_range_record_w32s64(const void* syms, long long n,
                                   const void* cdf, int K, void* records,
                                   void* low_out, void* rng_out, int L, int P,
                                   void* cuda_stream, int device) {
  return launch_record<32, 64>(syms, n, cdf, K, records, low_out, rng_out, L,
                               P, cuda_stream, device);
}

// Phase A's launch shape (either preset: the kernel's shape is the same).
int ctt_ilans2_range_record_geometry(int L, int K, long long* out,
                                     void* cuda_stream, int device) {
  (void)cuda_stream;
  (void)device;
  return record_geometry(L, K, out);
}

// Phase B: kernel 8 (S=32) and kernel 10 (S=64).  words[T * L],
// flags[T * L / 32] and offsets[kScanBlocks] are scratch; s0 and seal_carry
// are read only.
int ctt_ilans2_range_resolve_w16s32(const void* records, const void* s0,
                                    const void* seal_carry, void* buf,
                                    long long cap, void* end_out,
                                    void* points, void* words, void* flags,
                                    void* offsets, int L, int T,
                                    void* cuda_stream, int device) {
  return launch_resolve<16, 32>(records, s0, seal_carry, buf, cap, end_out,
                                points, words, flags, offsets, L, T,
                                cuda_stream, device);
}

int ctt_ilans2_range_resolve_w32s64(const void* records, const void* s0,
                                    const void* seal_carry, void* buf,
                                    long long cap, void* end_out,
                                    void* points, void* words, void* flags,
                                    void* offsets, int L, int T,
                                    void* cuda_stream, int device) {
  return launch_resolve<32, 64>(records, s0, seal_carry, buf, cap, end_out,
                                points, words, flags, offsets, L, T,
                                cuda_stream, device);
}

// Phase B's lane pass alone (pass B alone is ctt_ilans2_compact).
int ctt_ilans2_range_resolve_lanes_w16s32(const void* records, const void* s0,
                                          const void* seal_carry, void* words,
                                          void* flags, void* points, int L,
                                          int T, void* cuda_stream,
                                          int device) {
  return launch_resolve_lanes<16, 32>(records, s0, seal_carry, words, flags,
                                      points, L, T, cuda_stream, device);
}

int ctt_ilans2_range_resolve_lanes_w32s64(const void* records, const void* s0,
                                          const void* seal_carry, void* words,
                                          void* flags, void* points, int L,
                                          int T, void* cuda_stream,
                                          int device) {
  return launch_resolve_lanes<32, 64>(records, s0, seal_carry, words, flags,
                                      points, L, T, cuda_stream, device);
}

int ctt_ilans2_range_decode_w16s32(void* lows, void* rngs, void* pts,
                                   const void* stream, long long slen,
                                   const void* cdf, int K, void* syms,
                                   long long n, int L, int P, void* bad,
                                   void* cuda_stream, int device) {
  return launch_cluster_decode<16, 32>(lows, rngs, pts, stream, slen, cdf, K,
                                       syms, n, L, P, bad, 0, cuda_stream,
                                       device);
}

int ctt_ilans2_range_decode_w32s64(void* lows, void* rngs, void* pts,
                                   const void* stream, long long slen,
                                   const void* cdf, int K, void* syms,
                                   long long n, int L, int P, void* bad,
                                   void* cuda_stream, int device) {
  return launch_cluster_decode<32, 64>(lows, rngs, pts, stream, slen, cdf, K,
                                       syms, n, L, P, bad, 0, cuda_stream,
                                       device);
}

// The same decodes on a cluster of `cluster` CTAs (1 .. 16).
int ctt_ilans2_range_decode_cluster_w16s32(
    void* lows, void* rngs, void* pts, const void* stream, long long slen,
    const void* cdf, int K, void* syms, long long n, int L, int P, void* bad,
    int cluster, void* cuda_stream, int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster_decode<16, 32>(lows, rngs, pts, stream, slen, cdf, K,
                                       syms, n, L, P, bad, cluster,
                                       cuda_stream, device);
}

int ctt_ilans2_range_decode_cluster_w32s64(
    void* lows, void* rngs, void* pts, const void* stream, long long slen,
    const void* cdf, int K, void* syms, long long n, int L, int P, void* bad,
    int cluster, void* cuda_stream, int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster_decode<32, 64>(lows, rngs, pts, stream, slen, cdf, K,
                                       syms, n, L, P, bad, cluster,
                                       cuda_stream, device);
}

int ctt_ilans2_range_geometry_w16s32(int L, int K, int P, int cluster,
                                     long long* out, void* cuda_stream,
                                     int device) {
  (void)cuda_stream;
  return cluster_geometry<16, 32>(L, K, P, cluster, out, device);
}

int ctt_ilans2_range_geometry_w32s64(int L, int K, int P, int cluster,
                                     long long* out, void* cuda_stream,
                                     int device) {
  (void)cuda_stream;
  return cluster_geometry<32, 64>(L, K, P, cluster, out, device);
}

}  // extern "C"
