// The ILANS2 decode and encode loops spread over many SMs (sm_90a): a
// decode that runs the lanes on a cluster of CTAs with each lane's state in
// a register for the whole message, and an encode split into a lane-parallel
// pass over the whole grid and a row-major compaction of the emitted words.
// ilans2.cu instantiates them for the categorical coder at both presets
// (W=32/S=64 and W=16/S=32, one CDF); exact_family.cu the decode for the
// S=64 reference-exact tables, whole message (kernel 15) or one segment of
// a grouped message (kernel 16, Seg), and for the S=32 narrow tables
// (kernel 13, NarrowTableModel), and the encode over their (cum, prob)
// planes (kernel 17 at S=64, kernel 14 at S=32, PlaneLanesModel); ilans2_family.cu the decode for the
// per-symbol families (kernel 11) and the encode over their division
// records (kernel 12, family_records.cuh's RecordLanesModel, behind a
// tables pass); ilans2_range.cu the range decode's twin
// of the cluster decode at both presets (cluster_range_decode_kernel,
// kernels 5 and 6), which shares its step exchange (exchange_step), and
// the compaction (launch_compact) behind its carry resolves at both
// presets (kernels 8 and 10);
// and tchain.cu the step exchange, the encode model (RecordCdfModel),
// DivisionRecord32 and plan_cluster for its cluster encodes (kernels 20,
// 22 and 24), the decode model (BucketCdfModel) for the searches inside
// its TChain-16 and TChain-24 head passes, and the compaction behind its
// decodes (kernels 19, 21 and 23).
// They are templated on (W, S, Model); a model provides, besides stage():
//   decode: template <int R> invert_lanes(t, l[R], q[R], sym[R], cum[R],
//           prob[R]) -- the R quantiles of one thread at once (l may lie
//           past L in a CTA's last warps; the result is then unused).  The
//           kernel calls it once a step, steps in order, on its own copy of
//           the model, so a model may carry registers from step to step:
//           FamilyModel carries each lane's (mean, scale) of the next
//           step, read at the end of a step;
//   encode: Token fetch(i) and Interval interval(Token) -- the device-
//           memory read of symbol i's model, issued a step before the
//           (shared-memory) interval is needed; an Interval has cum(),
//           prob(), divide(x) (x / prob) and a static unit() (cum 0,
//           prob 1).
// BucketCdfModel below (decode: a bucket table in front of the CDF
// search), RecordCdfModel below (encode: a division record per symbol, the
// division as a multiply-high; DivisionRecord at S=64, DivisionRecord32 at
// S=32), exact_family.cu's PlaneLanesModel (encode: the (cum, prob) pair
// as the token, the division from an f64 estimate), TableModel and
// NarrowTableModel (decode: the packed wide or narrow tables in device
// memory, searched in lock step), family_records.cuh's RecordLanesModel
// (encode: a symbol's record as the token) and ilans2_family.cu's
// FamilyModel (decode: family.cuh's bisection over the integer CDF, in
// lock step) provide them.
//
// Decode (cluster_decode_kernel).  A decode step needs the exclusive count of
// refilling lanes below each lane over all L lanes, and that count depends on
// every lane's decoded state, so the steps stay serial and the design makes one
// step cheap.  The 32-lane groups are split into C contiguous runs, one per CTA
// of a cluster (C <= 16); in CTA `rank` warp w owns R consecutive groups (slot
// r: group g_begin + w * R + r), and each thread keeps its R lane states in
// registers from the first step to the last.  One step: decode the R lanes
// (quantile, the model's symbol search, state update, symbol write); ballot
// each slot's refill flags; one block barrier and a warp
// reduction of the per-warp counts give each warp its offset in the CTA; each
// CTA writes its step total into slot [t & 1][rank] of every CTA of the cluster
// through distributed shared memory; one cluster barrier (arrive.release /
// wait.acquire); a warp reduction of the totals of lower ranks gives the CTA's
// offset.  A refilling lane then reads stream word base + CTA offset + warp
// offset + earlier slots' counts + popc(ballot & lanemask_lt) (the R loads
// issued before any is used), and base advances by the cluster total.
// Double-buffering the totals and warp counts by step parity makes one cluster
// barrier a step enough: a buffer is written again two steps later, after every
// CTA has passed the barrier that follows its last read.  Each step also
// prefetches into L2 the stream words the next two steps can reach (2L words
// from the next step's first word).
//
// Range decode (cluster_range_decode_kernel, both presets).  The same step
// with a range lane in place of the rANS state: the lane keeps num = point -
// lower and range in registers (the quantile num / (range >> P), the
// model's search, num -= scale cum and range = scale prob, the refill flag
// range < 2^(S-W), the same exchange, and a refill that shifts both left by
// W and adds the word), and its point in device memory, where only a refill
// touches it; the final lower is point - num.  The quotient is below 2^P
// <= 2^24 wherever the data is valid, so in place of the card's integer
// division (a software routine of some tens of instructions on the lane's
// chain) it is an f64 estimate from an approximate reciprocal, off by at
// most one, corrected by one product (f64_quotient); the invalid case q >=
// 2^P is told apart first, exactly, as num >= scale << P.
//
// Encode (encode_lanes_kernel, then compact_*_kernel).  A lane's renorm
// decision and next state depend on its own state and symbol only; the lanes
// meet only in where their words land in the stream.  Pass A: one thread per
// lane over the grid runs its lane through steps T-1 .. 0 in registers (the
// model's division: RecordCdfModel's multiply-high in place of the card's
// integer division, which is a software routine at 32 and 64 bits;
// PlaneLanesModel's f64 estimate and one correcting product, as its
// planes hold no reciprocal),
// writes each emitted word to a dense scratch words[t * L + l] and one
// warp ballot of renorm flags per (step, group) to flags[t * G + g]; no
// barrier inside the step loop.  Pass B: an exclusive scan of popc(flags)
// in row-major order (step ascending, group ascending: the decoder's
// consumption order) by block sums (compact_count_kernel), one block
// scanning those sums (compact_offsets_kernel) and a scan within each block
// that scatters the flagged words (compact_scatter_kernel).  Word k of the
// stream lands at buf[cap - total + k], so the stream is buf[*end_out :
// cap].  Pass B moves one word per u32 whatever W is.

#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "lanes.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;  // non-portable cluster size on the H100
constexpr int kPortableCluster = 8;
constexpr int kClusterWarps = 32;  // warps of one cluster CTA at most
constexpr int kMaxRows = 32;  // lanes a thread of a cluster decode at most
// the geometry picked from L gives each CTA up to this many groups (two
// lanes a thread) until the cluster has kMaxCluster CTAs
constexpr int kAutoGroupsPerCta = 64;
constexpr int kLaneThreads = 128;  // threads of a pass-A block, one per lane
constexpr int kScanThreads = 256;  // threads of a compaction block
constexpr int kScanPer = 8;  // flag words a compaction thread scans a tile
constexpr int kScanTile = kScanThreads * kScanPer;
// compaction blocks at most; the wrapper sizes the offsets scratch by it
// (constriction_tpu_torch/ops/coder.py, SCAN_BLOCKS)
constexpr int kScanBlocks = 1024;

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v,
                                                        int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// floor(2^N rem / prob) for rem < prob, by N steps of shift and subtract
// (U: the N-bit result type).
template <typename U>
__device__ U scaled_quotient(uint32_t rem, uint32_t prob) {
  U q = 0;
  for (int k = 0; k < 8 * static_cast<int>(sizeof(U)); ++k) {
    rem <<= 1;  // rem < prob <= 2^24 before the shift
    q <<= 1;
    if (rem >= prob) {
      rem -= prob;
      q |= 1;
    }
  }
  return q;
}

__device__ __forceinline__ int ceil_log2(uint32_t prob) {
  return prob > 1 ? 32 - __clz(prob - 1) : 0;
}

// A symbol's interval for the encode, with the division by its probability
// as a multiply-high (Granlund and Montgomery, "Division by invariant
// integers using multiplication", 1994, fig. 4.1): for N-bit states,
// 1 <= prob <= 2^24 and l = ceil(log2 prob), magic = floor(2^N (2^l - prob)
// / prob) + 1 < 2^N and
//   x / prob = (t + ((x - t) >> min(l, 1))) >> max(l - 1, 0),
//   t = mulhi_N(magic, x),
// for every N-bit x (constriction_tpu_torch/ops/coder64.py and coder.py
// hold the same arithmetic exact against integer division, division_magic
// and division_magic32).  This record is the S=64 one (N = 64).
struct __align__(16) DivisionRecord {
  uint64_t magic;
  uint32_t start;  // cum
  uint32_t prob_log;  // prob | l << 25

  __device__ static DivisionRecord unit() { return {1, 0, 1}; }
  // prob 0 gives a record that is never used: callers validate symbols
  __device__ static DivisionRecord build(uint32_t cum, uint32_t prob) {
    const int l = ceil_log2(prob);
    const uint64_t q =
        prob > 0 ? scaled_quotient<uint64_t>((1u << l) - prob, prob) : 0;
    return {q + 1, cum, prob | (static_cast<uint32_t>(l) << 25)};
  }
  __device__ uint32_t cum() const { return start; }
  __device__ uint32_t prob() const { return prob_log & ((1u << 25) - 1u); }
  __device__ uint64_t divide(uint64_t x) const {
    const int l = static_cast<int>(prob_log >> 25);
    const uint64_t t = __umul64hi(magic, x);
    return (t + ((x - t) >> (l > 0 ? 1 : 0))) >> (l > 0 ? l - 1 : 0);
  }
};

// The S=32 record (N = 32, 1 <= prob <= 2^16, cum < 2^16): the state never
// needs 64 bits, so the division is one __umulhi in place of
// __umul64hi's several 32-bit multiplies, a short link in pass A's chain of
// dependent steps; 8 bytes a record, l recomputed from prob.  build takes
// magic from one u64 division, ((2^l - prob) << 32) / prob + 1 (the
// numerator below 2^48): in the family tables pass (family_records.cuh),
// which builds a record a symbol, it took 0.091 ms at 2^23 symbols against
// 0.126-0.128 by 32 steps of shift and subtract (scaled_quotient), on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_ab.py).
struct __align__(8) DivisionRecord32 {
  uint32_t magic;
  uint32_t cum_prob;  // cum | (prob - 1) << 16

  __device__ static DivisionRecord32 unit() { return {1, 0}; }
  __device__ static DivisionRecord32 build(uint32_t cum, uint32_t prob) {
    const int l = ceil_log2(prob);
    const uint32_t q =
        prob > 0 ? static_cast<uint32_t>(
                       (static_cast<uint64_t>((1u << l) - prob) << 32) / prob)
                 : 0;
    return {q + 1, (cum & 0xFFFFu) | ((prob - 1) << 16)};
  }
  __device__ uint32_t cum() const { return cum_prob & 0xFFFFu; }
  __device__ uint32_t prob() const { return (cum_prob >> 16) + 1; }
  __device__ uint32_t divide(uint32_t x) const {
    const int l = ceil_log2(prob());
    const uint32_t t = __umulhi(magic, x);
    return (t + ((x - t) >> (l > 0 ? 1 : 0))) >> (l > 0 ? l - 1 : 0);
  }
};

template <int S>
struct RecordOf;
template <>
struct RecordOf<32> {
  using type = DivisionRecord32;
};
template <>
struct RecordOf<64> {
  using type = DivisionRecord;
};

// The division record of each of the K symbols of a CDF.
template <class Record>
__global__ void __launch_bounds__(128)
    division_records_kernel(const uint32_t* __restrict__ cdf, int K,
                            Record* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= K) return;
  out[s] = Record::build(cdf[s], cdf[s + 1] - cdf[s]);
}

// The encode model of pass A (ilans2.cu, kernels 2 and 3) and of the
// categorical TChain cluster encodes (tchain.cu, kernels 20 and 24): each
// symbol's division record (its interval and the multiply-high reciprocal
// of its probability, built from the CDF by division_records_kernel), in
// shared memory when the K records fit.  Symbols outside [0, K) are clamped to
// K-1 to keep the reads in bounds (callers validate them).
template <class Record>
struct RecordCdfModel {
  using Token = uint32_t;  // the symbol
  using Interval = Record;
  const int32_t* syms;
  const Record* records;
  int K;
  int in_smem;

  __device__ void stage(uint32_t* smem) {
    if (!in_smem) return;
    auto* dst = reinterpret_cast<Record*>(smem);
    for (int s = threadIdx.x; s < K; s += blockDim.x) dst[s] = records[s];
    records = dst;
  }
  __device__ Token fetch(int64_t i) const {
    return min(static_cast<uint32_t>(syms[i]), static_cast<uint32_t>(K - 1));
  }
  __device__ Interval interval(Token sym) const { return records[sym]; }
};

// Dynamic shared memory of an encode over RecordCdfModel: the K division
// records when they fit.
template <class Record>
size_t record_smem_bytes(RecordCdfModel<Record>* model) {
  const size_t bytes = static_cast<size_t>(model->K) * sizeof(Record);
  model->in_smem = bytes <= kSmemBudget;
  return model->in_smem ? bytes : 0;
}

// The decode model of the categorical coders' cluster decodes (rANS,
// kernels 1 and 4; range, kernels 5 and 6) and of the TChain-16 and
// TChain-24 decodes' head passes (tchain.cu, kernels 19 and 23): the CDF,
// in shared memory when it fits, behind a bucket table in shared memory:
// lut[b] is the symbol of quantile b << (P - lut_bits), so quantile q's
// symbol lies between lut[q >> (P - lut_bits)] and the next entry, and a
// binary search between the two (zero or one probe for most quantiles of
// a K=100 model at P=24) gives find_symbol's answer.  With lut_bits == P,
// lut[q] is that answer and nothing is searched.
struct BucketCdfModel {
  const uint32_t* cdf;
  int K;
  int cdf_in_smem;
  int P;
  int lut_bits;
  const uint32_t* lut;  // set by stage

  __device__ void stage(uint32_t* smem) {
    const uint32_t* cdf_g = cdf;
    uint32_t* table = smem;
    const int shift = P - lut_bits;
    for (int b = threadIdx.x; b <= (1 << lut_bits); b += blockDim.x) {
      table[b] = find_symbol(cdf_g, K, static_cast<uint32_t>(b) << shift);
    }
    lut = table;
    cdf = stage_cdf(smem + (1 << lut_bits) + 1, cdf_g, K, cdf_in_smem);
  }
  template <int R>
  __device__ void invert_lanes(int, const int (&)[R], const uint32_t (&q)[R],
                               int (&sym)[R], uint32_t (&cum)[R],
                               uint32_t (&prob)[R]) const {
    const int shift = P - lut_bits;
    // a complete table (shift 0) gives the answer in lut[b]: the bucket's
    // upper end is then read from the same entry and nothing is searched
    const uint32_t* upper = lut + (shift != 0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t b = q[r] >> shift;
      int lo = static_cast<int>(lut[b]);
      int hi = static_cast<int>(upper[b]);
      while (lo < hi) {  // the largest s in [lo, hi] with cdf[s] <= q
        const int mid = (lo + hi + 1) >> 1;
        if (cdf[mid] <= q[r]) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      sym[r] = lo;
      cum[r] = cdf[lo];
      prob[r] = cdf[lo + 1] - cum[r];
    }
  }
};

constexpr int kLutBits = 12;  // the decode's bucket table: 2^12 + 1 words

// Dynamic shared memory of a BucketCdfModel decode: the bucket table, then
// the CDF when it fits beside it; fills in the model's table size and CDF
// placement.
inline size_t bucket_smem_bytes(BucketCdfModel* model) {
  model->lut_bits = std::min(model->P, kLutBits);
  const size_t lut = ((size_t(1) << model->lut_bits) + 1) * sizeof(uint32_t);
  return lut + cdf_smem_bytes(lut, model->K, &model->cdf_in_smem);
}

// The refill counts of one decode step in shared memory, double-buffered by
// step parity: each warp's in its CTA, and every CTA's of the cluster in
// every CTA (written remotely).
struct StepExchange {
  uint32_t warp_counts[2][kClusterWarps];
  uint32_t cta_totals[2][kMaxCluster];
};

// Where a warp's refills of one step start: past those of the lower warps
// of its CTA (warp) and of the lower CTAs of the cluster (cta); total is
// the step's count over the cluster.
struct StepOffsets {
  uint32_t warp;
  uint32_t cta;
  uint32_t total;
};

// One step's exchange, called by every thread of the cluster with its
// warp's refill count and the step parity: the per-warp counts, one block
// barrier, this CTA's total written into slot [par][rank] of every CTA of
// the cluster through distributed shared memory, one cluster barrier
// (arrive.release / wait.acquire), and warp reductions for the offsets.
// lane, warp and warps: the caller's lane, warp and warp count.
__device__ __forceinline__ StepOffsets exchange_step(
    StepExchange& x, cg::cluster_group& cluster, uint32_t count, int par,
    int rank, int C, int lane, int warp, int warps) {
  if (lane == 0) x.warp_counts[par][warp] = count;
  __syncthreads();
  const uint32_t wc = lane < warps ? x.warp_counts[par][lane] : 0u;
  StepOffsets off;
  off.warp = __reduce_add_sync(kFull, lane < warp ? wc : 0u);
  const uint32_t cta_total = __reduce_add_sync(kFull, wc);
  if (warp == 0 && lane < C) {
    *cluster.map_shared_rank(&x.cta_totals[par][rank], lane) = cta_total;
  }
  cluster_barrier();
  const uint32_t ct = lane < C ? x.cta_totals[par][lane] : 0u;
  off.cta = __reduce_add_sync(kFull, lane < rank ? ct : 0u);
  off.total = __reduce_add_sync(kFull, ct);
  return off;
}

// Decode n symbols on a cluster of CTAs.  states[L]: initial decoder states
// in, final states out.  stream[slen]: W-bit words, one per u32; reads past
// the end yield 0.  groups_per_cta: the run of 32-lane groups of one CTA
// (the last CTAs may hold fewer or none).  With Seg, the first stream word
// index comes from *base_io and the index after the last refill goes back
// there (consecutive launches decode one continuous stream).
template <int W, int S, int R, class Model, bool Seg>
__global__ void __launch_bounds__(kClusterWarps * 32, 1)
    cluster_decode_kernel(typename StateOf<S>::type* __restrict__ states,
                          const uint32_t* __restrict__ stream, int64_t slen,
                          Model model, int32_t* __restrict__ syms, int64_t n,
                          int L, int P, int T, int groups_per_cta,
                          int64_t* __restrict__ base_io) {
  using State = typename StateOf<S>::type;
  extern __shared__ __align__(16) uint32_t smem_model[];
  __shared__ StepExchange xch;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());

  constexpr State kLower = State(1) << (S - W);
  constexpr uint32_t kWordMask = W == 32 ? kFull : ((1u << W) - 1u);
  const uint32_t qmask = (1u << P) - 1u;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int G = L / 32;
  const int g_end = min(G, (rank + 1) * groups_per_cta);
  const int g0 = rank * groups_per_cta + warp * R;  // slot 0's group

  model.stage(smem_model);
  State x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x[r] = g0 + r < g_end ? states[(g0 + r) * 32 + lane] : State(0);
  }
  int64_t base = Seg ? *base_io : 0;  // first stream word of this step
  // the first two steps' words into L2
  const int64_t cluster_tid = static_cast<int64_t>(rank) * blockDim.x + tid;
  const int64_t reach_lines = (2 * static_cast<int64_t>(L) + 31) / 32 + 1;
  {
    const int64_t at = (base & ~int64_t(31)) + cluster_tid * 32;
    if (cluster_tid < reach_lines && at < slen) prefetch_l2(stream + at);
  }
  // the staged CDF is visible, and every CTA of the cluster runs before
  // the first remote write
  cluster_barrier();

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    // decode the R lanes
    int l[R], sym[R];
    uint32_t q[R], cum[R], prob[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] = (g0 + r) * 32 + lane;
      q[r] = static_cast<uint32_t>(x[r]) & qmask;
    }
    model.invert_lanes(t, l, q, sym, cum, prob);
    uint32_t count = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (g0 + r < g_end) {  // warp-uniform
        const int64_t i = static_cast<int64_t>(t) * L + l[r];
        if (i < n) {
          x[r] = (x[r] >> P) * prob[r] + (q[r] - cum[r]);
          syms[i] = sym[r];
        }
        count += __popc(__ballot_sync(kFull, x[r] < kLower));
      }
    }
    const StepOffsets off =
        exchange_step(xch, cluster, count, par, rank, C, lane, warp, warps);

    // refill: the step's flagged lanes take the next words in lane order;
    // all R loads are issued before any is used
    int64_t idx = base + off.cta + off.warp;
    uint32_t word[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      word[r] = 0u;
      if (g0 + r < g_end) {
        const bool refill = x[r] < kLower;
        const unsigned bal = __ballot_sync(kFull, refill);
        const int64_t at = idx + __popc(bal & lt_mask);
        if (refill && at < slen) word[r] = stream[at];
        idx += __popc(bal);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (g0 + r < g_end && x[r] < kLower) {
        x[r] = (x[r] << W) | static_cast<State>(word[r] & kWordMask);
      }
    }
    base += off.total;
    const int64_t at = (base & ~int64_t(31)) + cluster_tid * 32;
    if (cluster_tid < reach_lines && at < slen) prefetch_l2(stream + at);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (g0 + r < g_end) states[(g0 + r) * 32 + lane] = x[r];
  }
  if (Seg && rank == 0 && tid == 0) *base_io = base;
}

// floor(num / scale) for 0 < scale and num < scale << P with P <= 24 (the
// quotient below 2^24), without the card's integer division: an f64
// estimate num * r, r the reciprocal of the scale from rcp.approx.ftz.f64
// and one Newton step, and one correcting product.  The approximate
// reciprocal comes from the top 32 bits of the scale's double and is good
// to at least 2^-19 relatively, the Newton step squares that to below
// 2^-37, and the conversions and the product add a few 2^-53: the
// estimate is within 2^-36 of num / scale relatively, 2^-12 absolutely,
// so its truncation is off by at most one either way, and
// one product against num tells which (it cannot overflow: (q + 1) scale
// <= scale << P <= range < 2^S).  Unlike __ddiv_rn, the sequence has no
// slow-path call, whose register saves spilled the R = 4 kernels
// (ROADMAP C.5).  Elsewhere the result is some value the caller does not
// use; nothing faults.  constriction_tpu_torch/ops/coder.py
// (range_correct) holds the correction exact against integer division
// from every estimate within one.
template <typename State>
__device__ __forceinline__ uint32_t f64_quotient(State num, State scale) {
  const double d = __ull2double_rn(static_cast<unsigned long long>(scale));
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  r = __fma_rn(r, __fma_rn(-d, r, 1.0), r);
  const uint32_t q = __double2uint_rz(
      __dmul_rn(__ull2double_rn(static_cast<unsigned long long>(num)), r));
  const State p = static_cast<State>(q) * scale;
  if (p > num) return q - 1u;
  return num - p >= scale ? q + 1u : q;
}

// A range lane's quantile (point - lower) / scale with scale = range >> P,
// clamped to 2^P - 1, and in *over whether it was >= 2^P (data
// inconsistent with the model; only a lane holding a symbol reports it);
// 0 where scale is 0, which only corrupt checkpoint planes give.  q >= 2^P
// exactly when num >= scale << P, and that shift cannot overflow: (range >>
// P) << P <= range.
template <typename State>
__device__ __forceinline__ uint32_t range_quantile(State num, State scale,
                                                   int P, bool* over) {
  *over = scale != 0 && num >= (scale << P);
  const uint32_t q = f64_quotient(num, scale);
  return scale == 0 ? 0u : (*over ? (1u << P) - 1u : q);
}

// Range-decode n symbols on a cluster of CTAs (the lanes split as in
// cluster_decode_kernel).  lows / rngs / pts[L]: the initial (lower, range,
// point) planes in (lower 0 and range 2^S - 1 unless resuming from a
// checkpoint), the final planes out.  stream[slen]: W-bit words, one per
// u32; reads past the end yield 0.  *bad: the caller sets n; the kernel
// lowers it to the first symbol whose quantile is >= 2^P, and decodes on
// with that quantile clamped to 2^P - 1.
//
// A lane holds num = point - lower and range in registers, the two values
// on its chain: the quantile is num / (range >> P), a step subtracts
// scale cum from num, a refill shifts num and range left by W and adds the
// word.  The point stays in pts[l], rewritten only by a refill (a load and
// a store nothing waits on), and the final lower is rebuilt as point - num
// (mod 2^S).  With W < 32 a stream word may hold bits above W (a corrupt
// stream), which the reference ORs into the shifted point; the lane then
// keeps the point's low W bits (plo) so that num follows the same bits:
// ((p << W) | w) - (p << W) = w & ~(p << W).
template <int W, int S, int R, class Model>
__global__ void __launch_bounds__(kClusterWarps * 32, 1)
    cluster_range_decode_kernel(typename StateOf<S>::type* __restrict__ lows,
                                typename StateOf<S>::type* __restrict__ rngs,
                                typename StateOf<S>::type* __restrict__ pts,
                                const uint32_t* __restrict__ stream,
                                int64_t slen, Model model,
                                int32_t* __restrict__ syms, int64_t n, int L,
                                int P, int T, int groups_per_cta,
                                unsigned long long* __restrict__ bad) {
  using State = typename StateOf<S>::type;
  extern __shared__ __align__(16) uint32_t smem_model[];
  __shared__ StepExchange xch;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());

  constexpr State kLower = State(1) << (S - W);
  constexpr bool kWideWords = W < 32;  // a u32 word can exceed W bits
  constexpr uint32_t kWordMask = W == 32 ? kFull : ((1u << W) - 1u);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int G = L / 32;
  const int g_end = min(G, (rank + 1) * groups_per_cta);
  const int g0 = rank * groups_per_cta + warp * R;  // slot 0's group

  model.stage(smem_model);
  State num[R], rg[R];
  uint32_t plo[R];  // the point's low W bits (used when kWideWords)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = (g0 + r) * 32 + lane;
    const bool live = g0 + r < g_end;
    const State pt = live ? pts[l] : State(0);
    num[r] = live ? State(pt - lows[l]) : State(0);
    rg[r] = live ? rngs[l] : State(0);
    plo[r] = static_cast<uint32_t>(pt) & kWordMask;
  }
  int64_t base = 0;  // first stream word of this step
  // the first two steps' words into L2: thread k of the cluster fetches
  // line k past the step's first word
  const int64_t cluster_tid = static_cast<int64_t>(rank) * blockDim.x + tid;
  const bool prefetcher =
      cluster_tid < (2 * static_cast<int64_t>(L) + 31) / 32 + 1;
  const int64_t line = cluster_tid * 32;
  if (prefetcher && line < slen) prefetch_l2(stream + line);
  // the staged CDF is visible, and every CTA of the cluster runs before
  // the first remote write
  cluster_barrier();

  for (int t = 0; t < T; ++t) {
    const int par = t & 1;
    // lanes below `active` hold a symbol this step (only the last step can
    // be partial)
    const int64_t left = n - static_cast<int64_t>(t) * L;
    const int active = left < L ? static_cast<int>(left) : L;
    // the R quantiles, then the model's search over all of them (the
    // scale is shifted out again after it: registers, not a held array)
    int l[R], sym[R];
    uint32_t q[R], cum[R], prob[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] = (g0 + r) * 32 + lane;
      bool over;
      q[r] = range_quantile(num[r], rg[r] >> P, P, &over);
      if (over && g0 + r < g_end && l[r] < active) {
        atomicMin(bad, static_cast<unsigned long long>(t) * L + l[r]);
      }
    }
    model.invert_lanes(t, l, q, sym, cum, prob);
    uint32_t count = 0;
    bool refill[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      refill[r] = false;
      if (g0 + r < g_end) {  // warp-uniform
        if (l[r] < active) {
          const State scale = rg[r] >> P;
          num[r] -= scale * cum[r];  // mod 2^S
          rg[r] = scale * prob[r];
          syms[static_cast<int64_t>(t) * L + l[r]] = sym[r];
          refill[r] = rg[r] < kLower;
        }
        count += __popc(__ballot_sync(kFull, refill[r]));
      }
    }
    const StepOffsets off =
        exchange_step(xch, cluster, count, par, rank, C, lane, warp, warps);

    // refill: the step's flagged lanes take the next words in lane order;
    // all R loads are issued before any is used
    int64_t idx = base + off.cta + off.warp;
    uint32_t word[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      word[r] = 0u;
      if (g0 + r < g_end) {
        const unsigned bal = __ballot_sync(kFull, refill[r]);
        const int64_t at = idx + __popc(bal & lt_mask);
        if (refill[r] && at < slen) word[r] = stream[at];
        idx += __popc(bal);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (refill[r]) {
        uint32_t add = word[r];
        if constexpr (kWideWords) {
          add &= ~(plo[r] << W);
          plo[r] = word[r] & kWordMask;
        }
        num[r] = (num[r] << W) + static_cast<State>(add);
        rg[r] <<= W;
        State* p = pts + (g0 + r) * 32 + lane;
        *p = (*p << W) | static_cast<State>(word[r]);
      }
    }
    base += off.total;
    const int64_t at = (base & ~int64_t(31)) + line;
    if (prefetcher && at < slen) prefetch_l2(stream + at);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (g0 + r < g_end) {
      const int l = (g0 + r) * 32 + lane;
      lows[l] = pts[l] - num[r];
      rngs[l] = rg[r];
    }
  }
}

// Pass A of the encode: lane l = blockIdx.x * blockDim.x + threadIdx.x runs
// steps T-1 .. 0.  states[L]: start states in, final states out.  At step t
// a renorming lane writes its word to words[t * L + l]; flags[t * G + g] is
// the ballot of group g's renorming lanes (other words are left as they
// are).  Lanes of a partial last step (t * L + l >= n) neither code nor
// flag.  The model's interval of step t - 1 is read while step t codes.
template <int W, int S, class Model>
__global__ void __launch_bounds__(kLaneThreads)
    encode_lanes_kernel(typename StateOf<S>::type* __restrict__ states,
                        Model model, int64_t n, uint32_t* __restrict__ words,
                        uint32_t* __restrict__ flags, int L, int P, int T) {
  using State = typename StateOf<S>::type;
  extern __shared__ __align__(16) uint32_t smem_model[];
  model.stage(smem_model);
  __syncthreads();
  constexpr State kWordMask = W == 32 ? State(kFull) : State((1u << W) - 1u);
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if ((l & ~31) >= L) return;  // warp-uniform: L % 32 == 0
  const int lane = threadIdx.x & 31, g = l >> 5, G = L >> 5;
  using Interval = typename Model::Interval;
  State x = states[l];
  int64_t i = static_cast<int64_t>(T - 1) * L + l;
  bool active = i < n;  // only the last step can be partial
  Interval cur = active ? model.interval(model.fetch(i)) : Interval::unit();
  // step t - 1's token, read a step before its interval is needed
  typename Model::Token next = T > 1 ? model.fetch(i - L)
                                     : typename Model::Token{};
  for (int t = T - 1; t >= 0; --t) {
    const typename Model::Token after =
        t > 1 ? model.fetch(i - 2 * static_cast<int64_t>(L))
              : typename Model::Token{};
    const Interval following = t > 0 ? model.interval(next) : Interval::unit();
    const uint32_t prob = cur.prob();
    const bool renorm = active && (x >> (S - P)) >= prob;
    if (renorm) {
      words[i] = static_cast<uint32_t>(x & kWordMask);
      x >>= W;
    }
    const unsigned bal = __ballot_sync(kFull, renorm);
    if (lane == 0) flags[static_cast<int64_t>(t) * G + g] = bal;
    if (active) {  // (x / prob) << P | (cum + x % prob)
      const State q = cur.divide(x);
      x = (q << P) | static_cast<State>(cur.cum() + (x - q * prob));
    }
    cur = following;
    next = after;
    active = true;
    i -= L;
  }
  states[l] = x;
}

// Flag words a compaction block scans: whole tiles, so that at most
// kScanBlocks blocks cover n_flags.
__host__ __device__ inline int64_t scan_chunk(int64_t n_flags) {
  const int64_t per = (n_flags + kScanBlocks - 1) / kScanBlocks;
  return (per + kScanTile - 1) / kScanTile * kScanTile;
}

// Pass B, 1 of 3: the renorm count of each block's chunk of flags.
__global__ void __launch_bounds__(kScanThreads)
    compact_count_kernel(const uint32_t* __restrict__ flags, int64_t n_flags,
                         int64_t chunk, uint64_t* __restrict__ offsets) {
  __shared__ uint32_t warp_sums[kScanThreads / 32];
  const int64_t begin = blockIdx.x * chunk;
  const int64_t end = begin + chunk < n_flags ? begin + chunk : n_flags;
  uint32_t s = 0;
  for (int64_t k = begin + threadIdx.x; k < end; k += kScanThreads) {
    s += __popc(flags[k]);
  }
  s = __reduce_add_sync(kFull, s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t total = 0;
    for (int w = 0; w < kScanThreads / 32; ++w) total += warp_sums[w];
    offsets[blockIdx.x] = total;
  }
}

// Pass B, 2 of 3: one block of 1024 threads turns the blocks' counts into
// exclusive offsets in place and writes the stream's start cap - total.
__global__ void __launch_bounds__(1024)
    compact_offsets_kernel(uint64_t* __restrict__ offsets, int blocks,
                           int64_t cap, int64_t* __restrict__ end_out) {
  __shared__ uint64_t warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint64_t v = tid < blocks ? offsets[tid] : 0;
  uint64_t incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const uint64_t u = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  const uint64_t ws = warp_sums[lane];
  uint64_t w_incl = ws;
  for (int off = 1; off < 32; off <<= 1) {
    const uint64_t u = __shfl_up_sync(kFull, w_incl, off);
    if (lane >= off) w_incl += u;
  }
  const uint64_t warp_base = __shfl_sync(kFull, w_incl - ws, warp);
  if (tid < blocks) offsets[tid] = warp_base + incl - v;
  if (tid == 1023) *end_out = cap - static_cast<int64_t>(warp_base + incl);
}

// Pass B, 3 of 3: each block scans its chunk tile by tile and scatters the
// flagged words: flag word k (step t = k / G, group g = k % G) covers
// words[k * 32 .. k * 32 + 31], and its lane j's word, when flagged, lands
// at buf[start + offset(k) + popc(flags[k] & lanemask_lt(j))].
__global__ void __launch_bounds__(kScanThreads)
    compact_scatter_kernel(const uint32_t* __restrict__ flags,
                           const uint32_t* __restrict__ words, int64_t n_flags,
                           int64_t chunk, const uint64_t* __restrict__ offsets,
                           const int64_t* __restrict__ end_io,
                           uint32_t* __restrict__ buf) {
  __shared__ uint32_t tile_flags[kScanTile];
  __shared__ uint32_t tile_offsets[kScanTile];
  __shared__ uint32_t warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int64_t begin = blockIdx.x * chunk;
  const int64_t end = begin + chunk < n_flags ? begin + chunk : n_flags;
  int64_t run = *end_io + static_cast<int64_t>(offsets[blockIdx.x]);
  for (int64_t tile = begin; tile < end; tile += kScanTile) {
    uint32_t f[kScanPer];
    uint32_t local = 0;
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      const int64_t k = tile + tid * kScanPer + u;
      f[u] = k < end ? flags[k] : 0u;
      local += __popc(f[u]);
    }
    const uint32_t incl = warp_inclusive_scan(local, lane);
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    const uint32_t ws = lane < kScanThreads / 32 ? warp_sums[lane] : 0u;
    const uint32_t w_incl = warp_inclusive_scan(ws, lane);
    uint32_t o = __shfl_sync(kFull, w_incl - ws, warp) + incl - local;
    const uint32_t tile_total = __shfl_sync(kFull, w_incl, 31);
#pragma unroll
    for (int u = 0; u < kScanPer; ++u) {
      tile_flags[tid * kScanPer + u] = f[u];
      tile_offsets[tid * kScanPer + u] = o;
      o += __popc(f[u]);
    }
    __syncthreads();
    const int span =
        end - tile < kScanTile ? static_cast<int>(end - tile) : kScanTile;
#pragma unroll 4
    for (int j = warp; j < span; j += kScanThreads / 32) {
      const uint32_t fl = tile_flags[j];
      if ((fl >> lane) & 1u) {
        buf[run + tile_offsets[j] + __popc(fl & lt_mask)] =
            words[(tile + j) * 32 + lane];
      }
    }
    run += tile_total;
    __syncthreads();  // before the next tile overwrites the buffers
  }
}

// Pass B: n_flags ballots (row-major, one per 32-lane group of a row) and
// their words words[k * 32 + j] into buf[*end_out : cap]; offsets[kScanBlocks]
// is scratch.  Three launches on `cuda_stream`.
inline int launch_compact(const void* flags, const void* words,
                          long long n_flags, void* buf, long long cap,
                          void* end_out, void* offsets, void* cuda_stream,
                          int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_flags <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  const int64_t chunk = scan_chunk(n_flags);
  const int blocks = static_cast<int>((n_flags + chunk - 1) / chunk);
  const auto* f = static_cast<const uint32_t*>(flags);
  auto* off = static_cast<uint64_t*>(offsets);
  auto* end = static_cast<int64_t*>(end_out);
  compact_count_kernel<<<blocks, kScanThreads, 0, stream>>>(f, n_flags, chunk,
                                                            off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_offsets_kernel<<<1, 1024, 0, stream>>>(off, blocks, cap, end);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scatter_kernel<<<blocks, kScanThreads, 0, stream>>>(
      f, static_cast<const uint32_t*>(words), n_flags, chunk, off, end,
      static_cast<uint32_t*>(buf));
  return static_cast<int>(cudaGetLastError());
}

// Launch geometry of cluster_decode_kernel: C CTAs of `threads` threads,
// each thread holding `rows` lanes (R, a power of two up to 32) of a CTA's
// run of groups.
struct ClusterGeometry {
  int cluster;
  int groups_per_cta;
  int rows;
  int threads;
  int max_active_clusters;  // the card's answer for this geometry
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

inline ClusterGeometry cluster_shape(int L, int cluster) {
  ClusterGeometry geo{};
  geo.cluster = cluster;
  geo.groups_per_cta = ceil_div(L / 32, cluster);
  geo.rows = pow2_at_least(ceil_div(geo.groups_per_cta, kClusterWarps));
  geo.threads = ceil_div(geo.groups_per_cta, geo.rows) * 32;
  return geo;
}

// The cluster size picked from L: CTAs of up to kAutoGroupsPerCta groups,
// a power of two up to kMaxCluster.
inline int auto_cluster(int L) {
  return std::min(kMaxCluster,
                  pow2_at_least(ceil_div(L / 32, kAutoGroupsPerCta)));
}

template <int W, int S, class Model, bool Seg>
using ClusterDecodeFn = void (*)(typename StateOf<S>::type*, const uint32_t*,
                                 int64_t, Model, int32_t*, int64_t, int, int,
                                 int, int, int64_t*);

template <int W, int S, class Model, bool Seg>
ClusterDecodeFn<W, S, Model, Seg> cluster_decode_for(int rows) {
  switch (rows) {
    case 1: return cluster_decode_kernel<W, S, 1, Model, Seg>;
    case 2: return cluster_decode_kernel<W, S, 2, Model, Seg>;
    case 4: return cluster_decode_kernel<W, S, 4, Model, Seg>;
    case 8: return cluster_decode_kernel<W, S, 8, Model, Seg>;
    case 16: return cluster_decode_kernel<W, S, 16, Model, Seg>;
    case 32: return cluster_decode_kernel<W, S, 32, Model, Seg>;
    default: return nullptr;
  }
}

inline cudaLaunchConfig_t cluster_config(const ClusterGeometry& geo,
                                         size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(geo.cluster, 1, 1);
  cfg.blockDim = dim3(geo.threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = geo.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int W, int S, class Model>
using ClusterRangeDecodeFn = void (*)(
    typename StateOf<S>::type*, typename StateOf<S>::type*,
    typename StateOf<S>::type*, const uint32_t*, int64_t, Model, int32_t*,
    int64_t, int, int, int, int, unsigned long long*);

template <int W, int S, class Model>
ClusterRangeDecodeFn<W, S, Model> cluster_range_decode_for(int rows) {
  switch (rows) {
    case 1: return cluster_range_decode_kernel<W, S, 1, Model>;
    case 2: return cluster_range_decode_kernel<W, S, 2, Model>;
    case 4: return cluster_range_decode_kernel<W, S, 4, Model>;
    case 8: return cluster_range_decode_kernel<W, S, 8, Model>;
    case 16: return cluster_range_decode_kernel<W, S, 16, Model>;
    case 32: return cluster_range_decode_kernel<W, S, 32, Model>;
    default: return nullptr;
  }
}

// Picks a cluster decode's geometry and kernel for L lanes and prepares the
// kernel: `cluster` CTAs when it is given (> 0), else auto_cluster(L),
// halved while the card reports that it cannot co-schedule such a cluster;
// for_rows(R) gives the kernel instance of R lanes a thread.  A geometry
// the card cannot run, or one past 32 lanes a thread (L above 16 * 32 * 32
// * 32), returns an error.
template <class Kernel>
cudaError_t plan_cluster(int L, int cluster, size_t smem, int device,
                         ClusterGeometry* geo, Kernel* kernel,
                         Kernel (*for_rows)(int)) {
  if (cluster > kMaxCluster || L <= 0 || L % 32) return cudaErrorInvalidValue;
  int C = cluster > 0 ? cluster : auto_cluster(L);
  for (;;) {
    *geo = cluster_shape(L, C);
    *kernel = for_rows(geo->rows);
    if (*kernel == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = prepare(*kernel, device, smem);
    if (err == cudaSuccess && C > kPortableCluster) {
      err = cudaFuncSetAttribute(
          *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(*geo, smem, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&geo->max_active_clusters, *kernel,
                                         &cfg);
    if (err != cudaSuccess) return err;
    if (geo->max_active_clusters > 0) return cudaSuccess;
    if (cluster > 0 || C == 1) return cudaErrorInvalidConfiguration;
    C /= 2;
  }
}

template <int W, int S, class Model, bool Seg>
cudaError_t plan_cluster_decode(int L, int cluster, size_t smem, int device,
                                ClusterGeometry* geo,
                                ClusterDecodeFn<W, S, Model, Seg>* kernel) {
  return plan_cluster(L, cluster, smem, device, geo, kernel,
                      cluster_decode_for<W, S, Model, Seg>);
}

template <int W, int S, class Model>
cudaError_t plan_cluster_range_decode(
    int L, int cluster, size_t smem, int device, ClusterGeometry* geo,
    ClusterRangeDecodeFn<W, S, Model>* kernel) {
  return plan_cluster(L, cluster, smem, device, geo, kernel,
                      cluster_range_decode_for<W, S, Model>);
}

}  // namespace
