// TChain bits-back coding on Hopper (sm_90a).  A decoder turns quantiles
// into symbols and gathers the information they did not need into per-lane
// remainder heads and a shared word stream; the encoder is its exact
// reverse.  Symbol i belongs to lane i mod L; a message is T full steps of
// L lanes.
//
// Replaces the Pallas kernels of constriction_tpu/ops/tchain.py:
//   _tchain_decode_kernel / _tchain_encode_kernel       TChain-16: W=16,
//       S=32, P=16, one categorical CDF, heads seeded at 1
//   _tchain24_decode_kernel / _tchain24_encode_kernel   TChain-24: W=32,
//       S=64, P=24, one categorical CDF, u64 heads seeded at 2^8
//   _tchain12_family_decode_kernel / _tchain12_family_encode_kernel
//       TChain-12: W=16, S=32, P=12, per-symbol continuous families,
//       heads seeded at 16
// Every preset keeps its heads in [2^(S-W-P), 2^(S-P)) between steps: a
// decoded head at or above 2^(S-P) flushes its low W bits, an encoded head
// below prob << (S-W-P) refills W bits, the one the exact inverse of the
// other.
//
// The decodes run over the whole grid, their lanes meeting only where
// their flushed words land: a head pass of one thread per lane
// (tchain_heads_kernel, one template for the three presets) and
// ilans2_wide.cuh's row-major compaction (launch_compact).  The TChain-16
// and TChain-24 decodes (kernels 19 and 23) find each quantile's symbol
// inside the head pass, each lane searching its next quantiles in its
// block's staged bucket table (QuantileSteps over BucketCdfModel); the
// TChain-12 decode (kernel 21) runs a bisection over left() per quantile
// in a pass of its own ahead of the head pass (tchain12_invert_kernel).
//
// The encodes (kernels 20, 24 and 22) run on ilans2_wide.cuh's cluster
// step (cluster_tchain_encode_kernel, below): heads in registers, one
// exchange a step, the division a multiply-high by each symbol's division
// record (DivisionRecord32 at S=32, DivisionRecord at S=64).  Kernels 20
// and 24 build the K records of their CDF ahead of the step; kernel 22,
// whose symbols each have a model of their own, builds one record a symbol
// in a tables pass over the whole grid (family_records.cuh's
// family_tables_kernel, shared with kernel 12: the two evaluations of
// left() a symbol, which read no head) and the step reads each lane's
// record a step ahead.
//
// Quantile layouts keep the Pallas wire format.  TChain-24: one quantile
// per u32 word.  TChain-16 (ops/tchain.py pack_quantiles): within a step
// of L/2 words, lane l < L/2 is the low half of word l and lane l >= L/2
// the high half of word l - L/2; lanes read and write their own 16-bit
// half, so two lanes of different warps never touch the same bytes and
// the encoder's output needs no zeroing and no atomics.  TChain-12 (pack_q12):
// eight 128-lane rows share three word rows; the encoder's cluster step
// stores each quantile as a u16 into a scratch, and a packing pass of one
// thread per word writes the rows.  The cluster step stores through a
// policy (PlanarStore, HalfStore) so that one template writes each layout.
//
// What bounds them on this card.  The grid decodes: kernel 21's inversion
// pass holds its operation-bound work (a bisection over left() per
// quantile); the head passes are chains of T short steps a lane (kernels
// 19 and 23 with their searches inside), and the compaction moves one word
// per u32.  The cluster encodes run on up to 16 SMs: their refills couple
// the lanes at every step, so the step's exchange and its chain (record,
// ballot, barriers, one L2 load, a multiply-high) bound them; kernel 22's
// tables pass holds its operation-bound work (two left() and a record a
// symbol) and fills the card.

#include "family.cuh"
#include "family_records.cuh"
#include "ilans2_wide.cuh"

namespace {

// ---------------------------------------------------------------------------
// TChain-16 and TChain-24: one categorical CDF for every symbol
// ---------------------------------------------------------------------------

// The u16 half that holds lane l's quantile in a TChain-16 step of L/2
// words (little-endian: the low half of word w is half 2w).
__device__ __forceinline__ int64_t planar_half(int l, int L) {
  return l < L / 2 ? 2 * static_cast<int64_t>(l)
                   : 2 * static_cast<int64_t>(l - L / 2) + 1;
}

template <int S>
__device__ __forceinline__ uint32_t load_quantile(const uint32_t* __restrict__ q,
                                                  int t, int l, int L) {
  if constexpr (S == 32) {
    const uint16_t* half = reinterpret_cast<const uint16_t*>(q);
    return half[static_cast<int64_t>(t) * L + planar_half(l, L)];
  } else {
    return q[static_cast<int64_t>(t) * L + l];
  }
}

// L a positive multiple of `lane_multiple` (256 planar at S=32, 128 at
// S=64), at least one symbol, T steps whose symbol indices fit int64.
template <int S>
bool valid_cat(int L, int K, long long T) {
  const int lane_multiple = S == 32 ? 256 : 128;
  return L > 0 && L % lane_multiple == 0 && K >= 1 && T >= 0 &&
         T <= (1 << 30);
}

// The grid decodes' head pass (kernels 19, 21 and 23).  A lane's head
// update h = h * prob + (q - cum) reads its own head only, and finding a
// quantile's symbol reads no head at all; the lanes meet only where their
// flushed words land.  So these decodes run over the whole grid: a head
// pass of one thread per lane, lane l = blockIdx.x * kHeadThreads +
// threadIdx.x, through steps 0 .. T-1, then ilans2_wide.cuh's row-major
// compaction (launch_compact).  heads[L]: the seeds 2^(S-W-P) in, the
// final heads out.  A head at or above 2^(S-P) after a step flushes its low
// W bits into a dense scratch words[row * L + l] and shifts right by W, and
// flags[row * G + g] is the ballot of group g's flushing lanes, row = T -
// 1 - t, so that the compaction puts the step chunks right to left, lanes
// ascending in a step (other words are left as they are).  A step source
// fetches lane l's token of step t and gives each step's (prob, q - cum),
// kHeadAhead steps ahead:
//   RecordSteps, kernel 21: the records (q - cum) | prob << 16 that its
//       inversion pass wrote, one thread per symbol (a bisection over
//       left() per quantile, the operation-bound work, which fills the
//       card on its own);
//   QuantileSteps<S>, kernels 19 (S=32: the lane's planar u16 half) and
//       23 (S=64: one quantile a word): the quantiles themselves, each
//       lane's next kHeadAhead searched at once in the block's staged
//       bucket table and CDF (BucketCdfModel; the CDF stays in device
//       memory when it does not fit beside the table) and their symbols
//       written.  For kernel 23 a search pass of its own (a persistent grid
//       writing u64 records (q - cum) | prob << 32) took 0.31 ms with the
//       head pass and the compaction against 0.24 ms for this form at 2^24
//       quantiles on an H100 (PERF.md §6): the search overlaps the head
//       chain, and the records never go through device memory.
// Kernel 19's u32 heads stay below 2^16 between steps and prob <= 2^16 (a
// one-symbol model has prob = 2^16 and flushes every lane at every step),
// so h * prob + (q - cum) < 2^32; kernel 23's u64 heads stay below 2^40
// and prob <= 2^24, so h * prob + (q - cum) < 2^64.
constexpr int kHeadThreads = 128;
constexpr int kHeadAhead = 8;  // steps a lane has in flight

template <typename Rec>
struct RecordSteps {
  static constexpr bool kStaged = false;
  static constexpr int kHalf = 4 * sizeof(Rec);  // prob above q - cum
  using Token = Rec;
  const Rec* recs;

  __device__ void stage(uint32_t*) {}
  __device__ Token fetch(int t, int l, int L) const {
    return recs[static_cast<int64_t>(t) * L + l];
  }
  template <int N>
  __device__ void resolve(const Token (&tok)[N], int, int, int, int,
                          uint32_t (&prob)[N], uint32_t (&rem)[N]) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      prob[j] = static_cast<uint32_t>(tok[j] >> kHalf);
      rem[j] = static_cast<uint32_t>(tok[j] & ((Rec(1) << kHalf) - 1u));
    }
  }
};

template <int S>
struct QuantileSteps {
  static constexpr bool kStaged = true;
  using Token = uint32_t;
  const uint32_t* q;  // below 2^P (the wrappers check)
  BucketCdfModel model;
  int32_t* syms;

  __device__ void stage(uint32_t* smem) { model.stage(smem); }
  __device__ Token fetch(int t, int l, int L) const {
    return load_quantile<S>(q, t, l, L);
  }
  // steps t0 .. t0 + N - 1 of lane l (those below T hold a symbol)
  template <int N>
  __device__ void resolve(const Token (&tok)[N], int t0, int l, int L, int T,
                          uint32_t (&prob)[N], uint32_t (&rem)[N]) const {
    const int lanes[N] = {};  // unused by this model
    int sym[N];
    uint32_t cum[N];
    model.invert_lanes(0, lanes, tok, sym, cum, prob);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (t0 + j < T) syms[static_cast<int64_t>(t0 + j) * L + l] = sym[j];
      rem[j] = tok[j] - cum[j];
    }
  }
};

template <int W, int S, int P, class Source>
__global__ void __launch_bounds__(kHeadThreads)
    tchain_heads_kernel(typename StateOf<S>::type* __restrict__ heads,
                        Source src, uint32_t* __restrict__ words,
                        uint32_t* __restrict__ flags, int L, int T) {
  using Head = typename StateOf<S>::type;
  using Token = typename Source::Token;
  constexpr Head kFlushAt = Head(1) << (S - P);
  constexpr Head kMask = (Head(1) << W) - 1u;
  extern __shared__ __align__(16) uint32_t smem_model[];
  if constexpr (Source::kStaged) {
    src.stage(smem_model);
    __syncthreads();
  }
  const int l = blockIdx.x * kHeadThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, g = l >> 5, G = L >> 5;
  Head h = heads[l];
  Token cur[kHeadAhead], nxt[kHeadAhead];
#pragma unroll
  for (int j = 0; j < kHeadAhead; ++j) {
    cur[j] = j < T ? src.fetch(j, l, L) : Token(0);
  }
  for (int t0 = 0; t0 < T; t0 += kHeadAhead) {
#pragma unroll
    for (int j = 0; j < kHeadAhead; ++j) {
      const int t = t0 + kHeadAhead + j;
      nxt[j] = t < T ? src.fetch(t, l, L) : Token(0);
    }
    uint32_t prob[kHeadAhead], rem[kHeadAhead];
    src.resolve(cur, t0, l, L, T, prob, rem);
#pragma unroll
    for (int j = 0; j < kHeadAhead; ++j) {
      const int t = t0 + j;
      if (t < T) {  // uniform
        h = h * static_cast<Head>(prob[j]) + static_cast<Head>(rem[j]);
        const bool flush = h >= kFlushAt;
        const int64_t row = T - 1 - t;
        if (flush) {
          words[row * L + l] = static_cast<uint32_t>(h & kMask);
          h >>= W;
        }
        const unsigned bal = __ballot_sync(kFull, flush);
        if (lane == 0) flags[row * G + g] = bal;
      }
    }
#pragma unroll
    for (int j = 0; j < kHeadAhead; ++j) cur[j] = nxt[j];
  }
  heads[l] = h;
}

// The head pass alone, L a positive multiple of `lane_multiple` (itself a
// multiple of kHeadThreads), with `smem` bytes of the source's staging.
template <int W, int S, int P, class Source>
int launch_heads(void* heads, Source src, size_t smem, void* words,
                 void* flags, int L, int T, int lane_multiple,
                 void* cuda_stream, int device) {
  if (L <= 0 || L % lane_multiple != 0 || T < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = tchain_heads_kernel<W, S, P, Source>;
  const cudaError_t err = prepare(kernel, device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  kernel<<<L / kHeadThreads, kHeadThreads, smem,
           static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<typename StateOf<S>::type*>(heads), src,
      static_cast<uint32_t*>(words), static_cast<uint32_t*>(flags), L, T);
  return static_cast<int>(cudaGetLastError());
}

// A categorical decode's head pass alone (kernel 19: TChain-16, q the
// T * L/2 planar words; kernel 23: TChain-24, q[T * L]): syms[T * L],
// words[T * L], flags[T * L / 32] and the heads.
template <int W, int S, int P>
int launch_cat_heads(void* heads, const void* q, const void* cdf, int K,
                     void* syms, void* words, void* flags, int L, int T,
                     void* cuda_stream, int device) {
  if (!valid_cat<S>(L, K, T)) return static_cast<int>(cudaErrorInvalidValue);
  QuantileSteps<S> src{
      static_cast<const uint32_t*>(q),
      {static_cast<const uint32_t*>(cdf), K, 0, P, 0, nullptr},
      static_cast<int32_t*>(syms)};
  const size_t smem = bucket_smem_bytes(&src.model);
  return launch_heads<W, S, P>(heads, src, smem, words, flags, L, T,
                               kHeadThreads, cuda_stream, device);
}

// A whole categorical decode: the head pass and the three compaction
// launches.  Scratch the caller allocates: words[T * L], flags[T * L / 32],
// offsets[kScanBlocks] (u64).  On return the stream is buf[*end_out :
// cap].
template <int W, int S, int P>
int launch_cat_decode(void* heads, const void* q, const void* cdf, int K,
                      void* syms, void* buf, long long cap, void* end_out,
                      void* words, void* flags, void* offsets, int L, int T,
                      void* cuda_stream, int device) {
  const int err = launch_cat_heads<W, S, P>(heads, q, cdf, K, syms, words,
                                            flags, L, T, cuda_stream, device);
  if (err != 0 || T == 0) return err;
  return launch_compact(flags, words, static_cast<long long>(T) * (L / 32),
                        buf, cap, end_out, offsets, cuda_stream, device);
}

// The quantile store of the categorical encodes: a planar u16 half at
// S=32 (load_quantile's), a word at S=64.  Kernel 22's is HalfStore,
// below.
template <int S>
struct PlanarStore {
  __device__ static void store(uint32_t* __restrict__ q, int t, int l, int L,
                               uint32_t v) {
    if constexpr (S == 32) {
      reinterpret_cast<uint16_t*>(q)[static_cast<int64_t>(t) * L +
                                     planar_half(l, L)] =
          static_cast<uint16_t>(v);
    } else {
      q[static_cast<int64_t>(t) * L + l] = v;
    }
  }
};

// The encodes (kernel 20, TChain-16; kernel 24, TChain-24; kernel 22,
// TChain-12) on a cluster of CTAs, the lanes split as in ilans2_wide.cuh's
// cluster_decode_kernel (R lanes a thread, their heads in registers for
// the whole message: u32 at S=32, u64 at S=64).  A lane's refill decision
// h < prob << (S-W-P) at step t reads the head that step t + 1's refill
// made, and that refill's word index depends on every lane's decision
// there: the lanes are coupled as an rANS decode's are, and the steps stay
// serial.  One step, T-1 .. 0: each lane's division record (the model's
// token read a step ahead, its interval: RecordCdfModel over the preset's
// record, RecordOf<S>, for kernels 20 and 24, the symbol the token and the
// K records staged in shared memory when they fit; RecordLanesModel for
// kernel 22, the record itself the token), the refill ballot, the
// cluster's exchange (exchange_step), the R word loads (all issued before
// any is used; the remainder stream read forward from word 0, in the order
// the decoder wrote it), h = h << W | word (a 16-bit word keeps its low 16
// bits), the division by prob as a multiply-high, and the quantile cum + h
// mod prob, stored by the Store policy.  The division is exact for every
// S-bit h, and a refilled head fits: h < prob << (S-W-P) before the shift,
// so h < prob << (S-P) <= 2^S after it.  The L2 prefetch of the next two
// steps' words is the decode's.  heads[L]: the decoder's final heads in,
// the heads before step 0 out.  words[wlen]: the remainder stream; reads
// past its end yield 0.  q: the quantiles out (TChain-16: T * L/2 planar
// words; TChain-24: T * L; TChain-12: T * L u16 halves), every one
// written.
template <int W, int S, int P, int R, class Model, class Store>
__global__ void __launch_bounds__(kClusterWarps * 32, 1)
    cluster_tchain_encode_kernel(typename StateOf<S>::type* __restrict__ heads,
                                 Model model,
                                 const uint32_t* __restrict__ words,
                                 int64_t wlen, uint32_t* __restrict__ q,
                                 int L, int T, int groups_per_cta) {
  using Head = typename StateOf<S>::type;
  using Token = typename Model::Token;
  using Interval = typename Model::Interval;
  extern __shared__ __align__(16) uint32_t smem_model[];
  __shared__ StepExchange xch;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());

  constexpr int kShift = S - W - P;  // refill: head < prob << (S-W-P)
  constexpr uint32_t kWordMask = W == 32 ? kFull : ((1u << W) - 1u);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int G = L / 32;
  const int g_end = min(G, (rank + 1) * groups_per_cta);
  const int g0 = rank * groups_per_cta + warp * R;  // slot 0's group

  model.stage(smem_model);
  Head h[R];
  Token tok[R];  // the tokens of the step being coded
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = (g0 + r) * 32 + lane;
    const bool live = g0 + r < g_end;
    h[r] = live ? heads[l] : Head(0);
    tok[r] = live ? model.fetch(static_cast<int64_t>(T - 1) * L + l)
                  : Token{};
  }
  int64_t base = 0;  // first stream word of this step's refills
  // the first two steps' words into L2
  const int64_t cluster_tid = static_cast<int64_t>(rank) * blockDim.x + tid;
  const int64_t reach_lines = (2 * static_cast<int64_t>(L) + 31) / 32 + 1;
  {
    const int64_t at = cluster_tid * 32;
    if (cluster_tid < reach_lines && at < wlen) prefetch_l2(words + at);
  }
  // the staged records are visible, and every CTA of the cluster runs
  // before the first remote write
  cluster_barrier();

  for (int t = T - 1; t >= 0; --t) {
    const int par = t & 1;
    // the next step's tokens, a step ahead; this step's records and refill
    // decisions
    Token nxt[R];
    Interval rec[R];
    bool refill[R];
    uint32_t count = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int l = (g0 + r) * 32 + lane;
      const bool live = g0 + r < g_end;
      nxt[r] = live && t > 0
                   ? model.fetch(static_cast<int64_t>(t - 1) * L + l)
                   : Token{};
      rec[r] = model.interval(tok[r]);
      refill[r] = false;
      if (live) {  // warp-uniform
        refill[r] = h[r] < (static_cast<Head>(rec[r].prob()) << kShift);
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
        if (refill[r] && at < wlen) word[r] = words[at];
        idx += __popc(bal);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (g0 + r < g_end) {
        if (refill[r]) {
          h[r] = (h[r] << W) | static_cast<Head>(word[r] & kWordMask);
        }
        const Head quot = rec[r].divide(h[r]);
        const uint32_t rem = static_cast<uint32_t>(
            h[r] - quot * static_cast<Head>(rec[r].prob()));
        Store::store(q, t, (g0 + r) * 32 + lane, L, rec[r].cum() + rem);
        h[r] = quot;
      }
      tok[r] = nxt[r];
    }
    base += off.total;
    const int64_t at = (base & ~int64_t(31)) + cluster_tid * 32;
    if (cluster_tid < reach_lines && at < wlen) prefetch_l2(words + at);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (g0 + r < g_end) heads[(g0 + r) * 32 + lane] = h[r];
  }
}

template <int S, class Model>
using ClusterEncodeFn = void (*)(typename StateOf<S>::type*, Model,
                                 const uint32_t*, int64_t, uint32_t*, int,
                                 int, int);

template <int W, int S, int P, class Model, class Store>
ClusterEncodeFn<S, Model> cluster_encode_for(int rows) {
  switch (rows) {
    case 1: return cluster_tchain_encode_kernel<W, S, P, 1, Model, Store>;
    case 2: return cluster_tchain_encode_kernel<W, S, P, 2, Model, Store>;
    case 4: return cluster_tchain_encode_kernel<W, S, P, 4, Model, Store>;
    case 8: return cluster_tchain_encode_kernel<W, S, P, 8, Model, Store>;
    case 16: return cluster_tchain_encode_kernel<W, S, P, 16, Model, Store>;
    case 32: return cluster_tchain_encode_kernel<W, S, P, 32, Model, Store>;
    default: return nullptr;
  }
}

// One launch of a planned cluster encode on `cuda_stream`.
template <int S, class Model>
int launch_cluster_encode(ClusterEncodeFn<S, Model> kernel,
                          const ClusterGeometry& geo, size_t bytes,
                          void* heads, Model model, const void* words,
                          long long wlen, void* q, int L, int T,
                          void* cuda_stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      geo, bytes, static_cast<cudaStream_t>(cuda_stream), &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<typename StateOf<S>::type*>(heads), model,
      static_cast<const uint32_t*>(words), static_cast<int64_t>(wlen),
      static_cast<uint32_t*>(q), L, T, geo.groups_per_cta);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cluster geometry into out[7]: cluster size, groups per CTA, lanes
// per thread, threads per CTA, the card's maximum of active clusters of
// that shape, the dynamic shared memory bytes, whether the records are in
// shared memory.
inline void geometry_out(const ClusterGeometry& geo, size_t bytes,
                         int in_smem, long long* out) {
  const long long vals[7] = {geo.cluster, geo.groups_per_cta, geo.rows,
                             geo.threads, geo.max_active_clusters,
                             static_cast<long long>(bytes), in_smem};
  for (int k = 0; k < 7; ++k) out[k] = vals[k];
}

template <int S>
using TChainModel = RecordCdfModel<typename RecordOf<S>::type>;
template <int S>
using TChainEncodeFn = ClusterEncodeFn<S, TChainModel<S>>;

// The categorical encode's model, shared memory and plan for L lanes and K
// symbols (`cluster` 0: the size picked from L).
template <int W, int S, int P>
cudaError_t plan_tchain_encode(int L, int K, int cluster, int device,
                               TChainModel<S>* model, size_t* bytes,
                               ClusterGeometry* geo,
                               TChainEncodeFn<S>* kernel) {
  *bytes = record_smem_bytes(model);
  return plan_cluster(
      L, cluster, *bytes, device, geo, kernel,
      cluster_encode_for<W, S, P, TChainModel<S>, PlanarStore<S>>);
}

// A categorical encode: the division records of the CDF's symbols into
// records[K] (scratch the caller allocates: 16 bytes each at S=64, 8 at
// S=32), then the cluster encode; `cluster` 0 picks the cluster size from
// L.
template <int W, int S, int P>
int launch_tchain_encode(void* heads, const void* syms, const void* cdf,
                         int K, const void* words, long long wlen, void* q,
                         void* records, int L, int T, int cluster,
                         void* cuda_stream, int device) {
  using Record = typename RecordOf<S>::type;
  if (!valid_cat<S>(L, K, T)) return static_cast<int>(cudaErrorInvalidValue);
  TChainModel<S> model{static_cast<const int32_t*>(syms),
                       static_cast<const Record*>(records), K, 0};
  size_t bytes;
  ClusterGeometry geo;
  TChainEncodeFn<S> kernel;
  cudaError_t err = plan_tchain_encode<W, S, P>(L, K, cluster, device, &model,
                                                &bytes, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  division_records_kernel<Record>
      <<<ceil_div(K, 128), 128, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
          static_cast<const uint32_t*>(cdf), K,
          static_cast<Record*>(records));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_cluster_encode<S>(kernel, geo, bytes, heads, model, words,
                                  wlen, q, L, T, cuda_stream);
}

// The categorical encode's geometry for L lanes and K symbols (`cluster`
// 0: the size the encode picks), into out[7] (geometry_out).
template <int W, int S, int P>
int tchain_geometry(int L, int K, int cluster, long long* out, int device) {
  if (!valid_cat<S>(L, K, 0)) return static_cast<int>(cudaErrorInvalidValue);
  TChainModel<S> model{nullptr, nullptr, K, 0};
  size_t bytes;
  ClusterGeometry geo;
  TChainEncodeFn<S> kernel;
  const cudaError_t err = plan_tchain_encode<W, S, P>(
      L, K, cluster, device, &model, &bytes, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  geometry_out(geo, bytes, model.in_smem, out);
  return 0;
}

// ---------------------------------------------------------------------------
// TChain-12: per-symbol continuous families
// ---------------------------------------------------------------------------

constexpr int kW = 16, kP = family::kFx;

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

// The TChain-12 decode in three steps over the whole grid.  A lane's head
// update h = h * prob + (q - cum) reads its own head only, and the
// expensive part of a step, the model's inversion (a bisection over
// left()), reads no head at all; the lanes meet only where their flushed
// words land.  So:
//   (a) tchain12_invert_kernel, one thread per symbol: the quantile, the
//       model, the bisection; writes the symbol and a record
//       (q - cum) | prob << 16 (prob <= 2^12);
//   (b) tchain_heads_kernel<16, 32, 12, uint32_t> (above), one thread per
//       lane: the head chain through steps 0 .. T-1 on the records alone,
//       each flushed word into a dense scratch words[row * L + l] and one
//       ballot per (step, 32-lane group) into flags[row * G + g], with row
//       = T - 1 - t;
//   (c) ilans2_wide.cuh's row-major compaction (launch_compact), which
//       writes rows in ascending order: the stream's step chunks right to
//       left, lanes ascending within a step, as the host oracle lays
//       them out.
// (a) holds the operation-bound work (about 8 evaluations of left() a
// symbol) and fills the card; (b) is a chain of T short steps a lane with
// the next records loaded ahead; (c) moves one word per u32.
constexpr int kInvertThreads = 256;  // L is a multiple of 1024

template <int F>
__global__ void __launch_bounds__(kInvertThreads)
    tchain12_invert_kernel(const uint32_t* __restrict__ qw,
                           const float* __restrict__ means,
                           const float* __restrict__ scales,
                           int32_t* __restrict__ syms,
                           uint32_t* __restrict__ recs, int L,
                           family::Support sup) {
  const int per_step = L / kInvertThreads;
  const int t = blockIdx.x / per_step;
  const int l = (blockIdx.x - t * per_step) * kInvertThreads + threadIdx.x;
  const int64_t i = static_cast<int64_t>(t) * L + l;
  const uint32_t q = load_q(qw + t * (3 * static_cast<int64_t>(L) / 8), l);
  const family::Model m = family::load_model(means, scales, i);
  uint32_t cum, prob;
  syms[i] = family::invert<F>(static_cast<int>(q), m, sup, &cum, &prob);
  recs[i] = (q - cum) | (prob << 16);
}

// The TChain-12 encode (kernel 22) in three steps.  Its refills couple the
// lanes at every step, as the categorical encodes' do, but a symbol's
// interval (two evaluations of left(), the operation-bound work) reads no
// head.  So:
//   (a) family_records.cuh's tables pass (family_tables_kernel, one
//       thread per symbol over the whole grid, kernel 12's too): the
//       symbol's DivisionRecord32 into recs[T * L];
//   (b) cluster_tchain_encode_kernel<16, 32, 12, R, RecordLanesModel,
//       HalfStore> (above): kernel 20's cluster step, each lane's record
//       (family_records.cuh's RecordLanesModel) read a step ahead as its
//       token, the refill test h < prob << 4, the quantile a u16 into
//       q16[T * L];
//   (c) tchain12_pack_kernel, one thread per packed word over the whole
//       grid (pack_q12).
// (a) fills the card; (b) is the serial step on up to 16 SMs.  ORing each
// quantile into its 12-bit slot of zeroed words from (b) with atomicOr, in
// place of (c), took 0.85-0.88 ms for (b) against 0.81-0.83 for (b) and
// (c) at 2^23 symbols on an H100 (PERF.md §6).

// Kernel 22's quantile store: a u16 a symbol into q16[T * L].
struct HalfStore {
  __device__ static void store(uint32_t* __restrict__ q, int t, int l, int L,
                               uint32_t v) {
    reinterpret_cast<uint16_t*>(q)[static_cast<int64_t>(t) * L + l] =
        static_cast<uint16_t>(v);
  }
};

// Step (c): word i of the T * 3L/8 packed words from the u16 quantiles
// q16[T * L] (pack_q12: word row 3k + j of a step holds rows 8k .. 8k+7's
// quantiles of its column, 12 bits each, low bits first).
__global__ void __launch_bounds__(kInvertThreads)
    tchain12_pack_kernel(const uint16_t* __restrict__ q16,
                         uint32_t* __restrict__ qw, int L, int64_t n_words) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kInvertThreads + threadIdx.x;
  if (i >= n_words) return;
  const int64_t step_words = 3 * static_cast<int64_t>(L) / 8;
  const int64_t t = i / step_words;
  const int w = static_cast<int>(i - t * step_words);
  const int row = w >> 7, k = row / 3, j = row - 3 * k;
  const uint16_t* g = q16 + t * L + 8 * k * 128 + (w & 127);
  uint32_t v;
  if (j == 0) {
    v = g[0] | (uint32_t(g[128]) << 12) | (uint32_t(g[256]) << 24);
  } else if (j == 1) {
    v = (uint32_t(g[256]) >> 8) | (uint32_t(g[384]) << 4) |
        (uint32_t(g[512]) << 16) | (uint32_t(g[640]) << 28);
  } else {
    v = (uint32_t(g[640]) >> 4) | (uint32_t(g[768]) << 8) |
        (uint32_t(g[896]) << 20);
  }
  qw[i] = v;
}

using Encode12Fn = ClusterEncodeFn<32, RecordLanesModel>;

// Kernel 22's cluster step for L lanes (`cluster` 0: the size picked from
// L); nothing is staged.
cudaError_t plan_encode12(int L, int cluster, int device,
                          ClusterGeometry* geo, Encode12Fn* kernel) {
  return plan_cluster(
      L, cluster, 0, device, geo, kernel,
      cluster_encode_for<kW, 32, kP, RecordLanesModel, HalfStore>);
}

bool valid_chain(int L, long long T, int min_sym, int max_sym) {
  return L > 0 && L % kThreads == 0 && T >= 0 && T <= (1 << 30) &&
         family::valid_support(min_sym, max_sym);
}

// The grid of a pass of one thread per symbol over T steps of L lanes
// (kernel 21's inversion, kernel 22's tables pass): after the checks and
// the device, T * L / kInvertThreads blocks into *blocks (0 when T is 0).
int symbol_grid(int L, int T, int min_sym, int max_sym, int device,
                unsigned* blocks) {
  *blocks = 0;
  if (!valid_chain(L, T, min_sym, max_sym)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(T) * (L / kInvertThreads);
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

template <int F>
int launch_invert(const void* qw, const void* means, const void* scales,
                  void* syms, void* recs, int L, int T, int min_sym,
                  int max_sym, void* cuda_stream, int device) {
  unsigned blocks;
  const int err = symbol_grid(L, T, min_sym, max_sym, device, &blocks);
  if (err != 0 || blocks == 0) return err;
  tchain12_invert_kernel<F><<<blocks, kInvertThreads, 0,
                              static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(qw), static_cast<const float*>(means),
      static_cast<const float*>(scales), static_cast<int32_t*>(syms),
      static_cast<uint32_t*>(recs), L,
      family::make_support(min_sym, max_sym));
  return static_cast<int>(cudaGetLastError());
}

int launch_heads12(void* heads, const void* recs, void* words, void* flags,
                   int L, int T, void* cuda_stream, int device) {
  const RecordSteps<uint32_t> src{static_cast<const uint32_t*>(recs)};
  return launch_heads<kW, 32, kP>(heads, src, 0, words, flags, L, T, kThreads,
                                  cuda_stream, device);
}

// The whole decode: (a), (b) and the three compaction launches.  Scratch
// the caller allocates: recs[T * L], words[T * L], flags[T * L / 32],
// offsets[kScanBlocks] (u64).  On return the stream is buf[*end_out : cap].
template <int F>
int launch_decode(void* heads, const void* qw, const void* means,
                  const void* scales, void* syms, void* buf, long long cap,
                  void* end_out, void* recs, void* words, void* flags,
                  void* offsets, int L, int T, int min_sym, int max_sym,
                  void* cuda_stream, int device) {
  int err = launch_invert<F>(qw, means, scales, syms, recs, L, T, min_sym,
                             max_sym, cuda_stream, device);
  if (err != 0 || T == 0) return err;
  err = launch_heads12(heads, recs, words, flags, L, T, cuda_stream, device);
  if (err != 0) return err;
  return launch_compact(flags, words, static_cast<long long>(T) * (L / 32),
                        buf, cap, end_out, offsets, cuda_stream, device);
}

// Step (a) of the encode alone: recs[T * L] (8 bytes each) from the
// symbols and their models.
template <int F>
int launch_tables(const void* syms, const void* means, const void* scales,
                  void* recs, int L, int T, int min_sym, int max_sym,
                  void* cuda_stream, int device) {
  unsigned blocks;
  const int err = symbol_grid(L, T, min_sym, max_sym, device, &blocks);
  if (err != 0 || blocks == 0) return err;
  return launch_family_tables<F>(syms, means, scales, recs,
                                 static_cast<long long>(T) * L, min_sym,
                                 max_sym,
                                 static_cast<cudaStream_t>(cuda_stream));
}

// Steps (b) and (c) on the records of step (a), (b) on a cluster of
// `cluster` CTAs (0: the size picked from L).  heads[L]: the decoder's
// final heads in, the heads before step 0 out.  words[wlen]: the remainder
// stream.  q16[T * L] (u16): scratch.  qw: the T * 3L/8 packed words, every
// one written.
int launch_encode_step(void* heads, const void* recs, const void* words,
                       long long wlen, void* q16, void* qw, int L, int T,
                       int cluster, void* cuda_stream, int device) {
  if (L <= 0 || L % kThreads != 0 || T < 0 || T > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ClusterGeometry geo;
  Encode12Fn kernel;
  const cudaError_t err = plan_encode12(L, cluster, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  const int e = launch_cluster_encode<32>(
      kernel, geo, 0, heads,
      RecordLanesModel{static_cast<const DivisionRecord32*>(recs)}, words,
      wlen, q16, L, T, cuda_stream);
  if (e != 0) return e;
  const int64_t n_words = static_cast<int64_t>(T) * (3 * (L / 8));
  tchain12_pack_kernel<<<static_cast<unsigned>(
                             (n_words + kInvertThreads - 1) / kInvertThreads),
                         kInvertThreads, 0,
                         static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint16_t*>(q16), static_cast<uint32_t*>(qw), L,
      n_words);
  return static_cast<int>(cudaGetLastError());
}

// The whole encode: (a), (b) on a cluster of `cluster` CTAs (0: the size
// picked from L) and (c).  recs[T * L] (8 bytes each) and q16[T * L] (u16):
// scratch the caller allocates.  Symbols are clamped into the support;
// callers validate them.
template <int F>
int launch_encode(void* heads, const void* syms, const void* means,
                  const void* scales, const void* words, long long wlen,
                  void* recs, void* q16, void* qw, int L, int T, int min_sym,
                  int max_sym, int cluster, void* cuda_stream, int device) {
  const int err = launch_tables<F>(syms, means, scales, recs, L, T, min_sym,
                                   max_sym, cuda_stream, device);
  if (err != 0) return err;
  return launch_encode_step(heads, recs, words, wlen, q16, qw, L, T, cluster,
                            cuda_stream, device);
}

// Kernel 22's cluster geometry for L lanes (`cluster` 0: the size the
// encode picks), into out[7] (geometry_out; no shared memory).
int geometry12(int L, int cluster, long long* out, int device) {
  if (L <= 0 || L % kThreads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ClusterGeometry geo;
  Encode12Fn kernel;
  const cudaError_t err = plan_encode12(L, cluster, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  geometry_out(geo, 0, 0, out);
  return 0;
}

}  // namespace

// Plain C interface, bound with ctypes (constriction_tpu_torch/ops/_build.py).
// Each entry launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 on success).  `K` is the
// alphabet size (the CDF has K + 1 entries); `fam` indexes (gaussian,
// laplace, logistic, cauchy).
extern "C" {

// words[T * L], flags[T * L / 32], offsets[kScanBlocks] (u64): scratch
// for the head pass and the compaction.  qw: the T * L/2 planar words.
int ctt_tchain16_decode(void* heads, const void* qw, const void* cdf, int K,
                        void* syms, void* buf, long long cap, void* end_out,
                        void* words, void* flags, void* offsets, int L, int T,
                        void* cuda_stream, int device) {
  return launch_cat_decode<16, 32, 16>(heads, qw, cdf, K, syms, buf, cap,
                                       end_out, words, flags, offsets, L, T,
                                       cuda_stream, device);
}

// The decode's head pass alone (pass B alone is ctt_ilans2_compact).
int ctt_tchain16_head_pass(void* heads, const void* qw, const void* cdf,
                           int K, void* syms, void* words, void* flags, int L,
                           int T, void* cuda_stream, int device) {
  return launch_cat_heads<16, 32, 16>(heads, qw, cdf, K, syms, words, flags,
                                      L, T, cuda_stream, device);
}

// The same two entries for TChain-24 (q: T * L words).
int ctt_tchain24_decode(void* heads, const void* q, const void* cdf, int K,
                        void* syms, void* buf, long long cap, void* end_out,
                        void* words, void* flags, void* offsets, int L, int T,
                        void* cuda_stream, int device) {
  return launch_cat_decode<32, 64, 24>(heads, q, cdf, K, syms, buf, cap,
                                       end_out, words, flags, offsets, L, T,
                                       cuda_stream, device);
}

int ctt_tchain24_head_pass(void* heads, const void* q, const void* cdf, int K,
                           void* syms, void* words, void* flags, int L, int T,
                           void* cuda_stream, int device) {
  return launch_cat_heads<32, 64, 24>(heads, q, cdf, K, syms, words, flags, L,
                                      T, cuda_stream, device);
}

// records[K]: scratch for the division records (8 bytes each).
int ctt_tchain16_encode(void* heads, const void* syms, const void* cdf, int K,
                        const void* words, long long wlen, void* qw,
                        void* records, int L, int T, void* cuda_stream,
                        int device) {
  return launch_tchain_encode<16, 32, 16>(heads, syms, cdf, K, words, wlen,
                                          qw, records, L, T, 0, cuda_stream,
                                          device);
}

// The same encode on a cluster of `cluster` CTAs (1 .. 16).
int ctt_tchain16_encode_cluster(void* heads, const void* syms,
                                const void* cdf, int K, const void* words,
                                long long wlen, void* qw, void* records,
                                int L, int T, int cluster, void* cuda_stream,
                                int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tchain_encode<16, 32, 16>(heads, syms, cdf, K, words, wlen,
                                          qw, records, L, T, cluster,
                                          cuda_stream, device);
}

int ctt_tchain16_geometry(int L, int K, int cluster, long long* out,
                          void* cuda_stream, int device) {
  (void)cuda_stream;
  return tchain_geometry<16, 32, 16>(L, K, cluster, out, device);
}

// records[K]: scratch for the division records (16 bytes each).
int ctt_tchain24_encode(void* heads, const void* syms, const void* cdf, int K,
                        const void* words, long long wlen, void* q,
                        void* records, int L, int T, void* cuda_stream,
                        int device) {
  return launch_tchain_encode<32, 64, 24>(heads, syms, cdf, K, words, wlen, q,
                                          records, L, T, 0, cuda_stream,
                                          device);
}

// The same encode on a cluster of `cluster` CTAs (1 .. 16).
int ctt_tchain24_encode_cluster(void* heads, const void* syms,
                                const void* cdf, int K, const void* words,
                                long long wlen, void* q, void* records, int L,
                                int T, int cluster, void* cuda_stream,
                                int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tchain_encode<32, 64, 24>(heads, syms, cdf, K, words, wlen, q,
                                          records, L, T, cluster, cuda_stream,
                                          device);
}

int ctt_tchain24_geometry(int L, int K, int cluster, long long* out,
                          void* cuda_stream, int device) {
  (void)cuda_stream;
  return tchain_geometry<32, 64, 24>(L, K, cluster, out, device);
}

int ctt_tchain12_family_decode(void* heads, const void* qw, const void* means,
                               const void* scales, void* syms, void* buf,
                               long long cap, void* end_out, void* recs,
                               void* words, void* flags, void* offsets, int L,
                               int T, int fam, int min_sym, int max_sym,
                               void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_decode, heads, qw, means, scales,
                             syms, buf, cap, end_out, recs, words, flags,
                             offsets, L, T, min_sym, max_sym, cuda_stream,
                             device);
}

// The decode's first two steps alone: (a) the inversion pass, (b) the head
// pass (pass B alone is ctt_ilans2_compact).
int ctt_tchain12_invert_pass(const void* qw, const void* means,
                             const void* scales, void* syms, void* recs,
                             int L, int T, int fam, int min_sym, int max_sym,
                             void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_invert, qw, means, scales, syms,
                             recs, L, T, min_sym, max_sym, cuda_stream,
                             device);
}

int ctt_tchain12_head_pass(void* heads, const void* recs, void* words,
                           void* flags, int L, int T, void* cuda_stream,
                           int device) {
  return launch_heads12(heads, recs, words, flags, L, T, cuda_stream,
                        device);
}

// recs[T * L] (8 bytes each) and q16[T * L] (u16): scratch for the division
// records of step (a) and the quantiles of step (b).
int ctt_tchain12_family_encode(void* heads, const void* syms,
                               const void* means, const void* scales,
                               const void* words, long long wlen, void* recs,
                               void* q16, void* qw, int L, int T, int fam,
                               int min_sym, int max_sym, void* cuda_stream,
                               int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_encode, heads, syms, means, scales,
                             words, wlen, recs, q16, qw, L, T, min_sym,
                             max_sym, 0, cuda_stream, device);
}

// The same encode on a cluster of `cluster` CTAs (1 .. 16).
int ctt_tchain12_family_encode_cluster(void* heads, const void* syms,
                                       const void* means, const void* scales,
                                       const void* words, long long wlen,
                                       void* recs, void* q16, void* qw, int L,
                                       int T, int fam, int min_sym,
                                       int max_sym, int cluster,
                                       void* cuda_stream, int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return CTT_DISPATCH_FAMILY(fam, launch_encode, heads, syms, means, scales,
                             words, wlen, recs, q16, qw, L, T, min_sym,
                             max_sym, cluster, cuda_stream, device);
}

// The encode's steps alone: (a) the tables pass; (b) the cluster step on
// its records (the cluster size picked from L) with (c) the packing pass.
int ctt_tchain12_tables_pass(const void* syms, const void* means,
                             const void* scales, void* recs, int L, int T,
                             int fam, int min_sym, int max_sym,
                             void* cuda_stream, int device) {
  return CTT_DISPATCH_FAMILY(fam, launch_tables, syms, means, scales, recs, L,
                             T, min_sym, max_sym, cuda_stream, device);
}

int ctt_tchain12_encode_step(void* heads, const void* recs, const void* words,
                             long long wlen, void* q16, void* qw, int L, int T,
                             void* cuda_stream, int device) {
  return launch_encode_step(heads, recs, words, wlen, q16, qw, L, T, 0,
                            cuda_stream, device);
}

int ctt_tchain12_geometry(int L, int cluster, long long* out,
                          void* cuda_stream, int device) {
  (void)cuda_stream;
  return geometry12(L, cluster, out, device);
}

}  // extern "C"
