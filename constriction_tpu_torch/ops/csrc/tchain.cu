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
// The TChain-16 decode (kernel 19) is a single-block template over (W, S,
// P), in the shape of the TChain-12 encoder below: one thread block codes
// the message, heads live in device memory (updated in place), the words
// a step flushes are written in the next iteration once the block scan
// (lanes.cuh) has placed them, the CDF is staged in shared memory when it
// fits, and a quantile finds its symbol by binary search (find_symbol).
// Lanes are strided (lane = row * 1024 + thread) and the last row is
// guarded per warp, so any L that is a multiple of 32 runs (the wrappers
// take multiples of 256, as the JAX package does).  The head update is
// native u32 (head < 2^16 and prob <= 2^16 keep head * prob + (q - cum)
// below 2^32; the CDF and prob are never held in 16 bits, since a
// one-symbol model has prob = 2^16).
//
// The encodes (kernels 20 and 24) run on ilans2_wide.cuh's cluster step
// (cluster_tchain_encode_kernel, below): heads in registers, one exchange
// a step, the division a multiply-high by each symbol's division record
// (DivisionRecord32 at S=32, DivisionRecord at S=64).  The TChain-24
// decode (kernel 23) and the TChain-12 decode (kernel 21) run as three
// steps over the whole grid: a pass that finds each quantile's symbol
// (a bucket-table search for kernel 23, a bisection over left() for
// kernel 21), a head pass of one thread per lane
// (tchain_heads_kernel, one template for both) and ilans2_wide.cuh's
// row-major compaction.
//
// Quantile layouts keep the Pallas wire format.  TChain-24: one quantile
// per u32 word.  TChain-16 (ops/tchain.py pack_quantiles): within a step
// of L/2 words, lane l < L/2 is the low half of word l and lane l >= L/2
// the high half of word l - L/2; lanes read and write their own 16-bit
// half, so two lanes of different warps never touch the same bytes and
// the encoder's output needs no zeroing and no atomics.  TChain-12 (pack_q12):
// eight 128-lane rows share three word rows; the encoder ORs its bits into
// zeroed words with atomicOr.
//
// What bounds them on this card.  The grid decodes (kernels 21 and 23):
// kernel 21's inversion pass holds its operation-bound work (a bisection
// over left() per quantile); kernel 23's search pass moves bytes (a
// quantile in, a symbol and an 8-byte record out, a few shared-memory
// reads between); the head passes are chains of T short steps a lane,
// and the compaction moves one word per u32.  The cluster encodes
// (kernels 20 and 24) run on up to 16 SMs: their refills couple the lanes
// at every step, so the step's exchange and its chain (record, ballot,
// barriers, one L2 load, a multiply-high) bound them.  The other two
// kernels (19, the TChain-16 decode; 22, the TChain-12 encode) run on one
// SM: latency and issue.  The family encoder adds two evaluations of
// left() per re-encoded symbol (it keeps each lane's pending (cum, prob)
// in a scratch array, `tab`, as the rANS family encoder does).  The
// TChain-16 decode has kernel 23's lane independence and can take its
// passes at (16, 32, 16), its records u64 (prob reaches 2^16, so
// (q - cum) | prob << 16 needs 33 bits).

#include "family.cuh"
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

template <int S>
__device__ __forceinline__ void store_quantile(uint32_t* __restrict__ q, int t,
                                               int l, int L, uint32_t v) {
  if constexpr (S == 32) {
    uint16_t* half = reinterpret_cast<uint16_t*>(q);
    half[static_cast<int64_t>(t) * L + planar_half(l, L)] =
        static_cast<uint16_t>(v);
  } else {
    q[static_cast<int64_t>(t) * L + l] = v;
  }
}

// Bits-back decode of T * L quantiles under cdf_g[K+1] (total 2^P).
// heads[L]: the seeds 2^(S-W-P) in, the final heads out.  q: TChain-16
// planar words (T * L/2) or TChain-24 words (T * L), values below 2^P.
// buf[cap]: the flushed words of step t land right to left below an end
// pointer, so on return the remainder stream is buf[*end_out : cap].
template <int W, int S, int P>
__global__ void __launch_bounds__(kThreads, 1)
    tchain_decode_kernel(typename StateOf<S>::type* __restrict__ heads,
                         const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ cdf_g, int K,
                         int32_t* __restrict__ syms, uint32_t* __restrict__ buf,
                         int64_t cap, int64_t* __restrict__ end_out, int L,
                         int T, int cdf_in_smem) {
  using Head = typename StateOf<S>::type;
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
  const uint32_t* cdf = stage_cdf(s.cdf(), cdf_g, K, cdf_in_smem);
  __syncthreads();

  constexpr Head kFlush = Head(1) << (S - P);
  constexpr Head kMask = (Head(1) << W) - 1u;
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int rows = (L + kThreads - 1) / kThreads;
  int64_t e = cap;  // words of the finished steps occupy buf[e : cap]

  // Iteration t writes the words step t - 1 flushed (a head still at or
  // above 2^(S-P) carries its pending word in its low W bits), then decodes
  // step t.
  for (int t = 0; t <= T; ++t) {
    const int cur = t & 1, prev = cur ^ 1;
    for (int r = 0; r < rows; ++r) {
      if (r * kThreads + (tid & ~31) >= L) break;  // warp-uniform
      const int l = r * kThreads + tid;
      const int g = l >> 5;
      Head h = heads[l];
      if (t > 0 && h >= kFlush) {
        const int64_t idx = e + s.prefix(prev)[g] +
                            __popc(s.ballots(prev)[g] & lt_mask);
        buf[idx] = static_cast<uint32_t>(h & kMask);
        h >>= W;
      }
      if (t < T) {
        const uint32_t qv = load_quantile<S>(q, t, l, L);
        const int sym = find_symbol(cdf, K, qv);
        const uint32_t cum = cdf[sym];
        const uint32_t prob = cdf[sym + 1] - cum;
        h = h * prob + (qv - cum);
        syms[static_cast<int64_t>(t) * L + l] = sym;
        const unsigned bal = __ballot_sync(kFull, h >= kFlush);
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

// L a positive multiple of `lane_multiple` (256 planar at S=32, 128 at
// S=64), at least one symbol, T steps whose symbol indices fit int64.
template <int S>
bool valid_cat(int L, int K, long long T) {
  const int lane_multiple = S == 32 ? 256 : 128;
  return L > 0 && L % lane_multiple == 0 && K >= 1 && T >= 0 &&
         T <= (1 << 30);
}

template <int W, int S, int P>
int launch_cat_decode(void* heads, const void* q, const void* cdf, int K,
                      void* syms, void* buf, long long cap, void* end_out,
                      int L, int T, void* cuda_stream, int device) {
  if (!valid_cat<S>(L, K, T)) return static_cast<int>(cudaErrorInvalidValue);
  int cdf_in_smem = 0;
  const size_t bytes = smem_bytes(L, K, &cdf_in_smem);
  auto kernel = tchain_decode_kernel<W, S, P>;
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<typename StateOf<S>::type*>(heads),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(cdf), K,
      static_cast<int32_t*>(syms), static_cast<uint32_t*>(buf), cap,
      static_cast<int64_t*>(end_out), L, T, cdf_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// The grid decodes' head pass (kernels 21 and 23).  A lane's head update h
// = h * prob + (q - cum) reads its own head only, and finding a quantile's
// symbol reads no head at all; the lanes meet only where their flushed
// words land.  So these decodes run over the whole grid: a head pass of one
// thread per lane, lane l = blockIdx.x * kHeadThreads + threadIdx.x, through
// steps 0 .. T-1, then ilans2_wide.cuh's row-major compaction
// (launch_compact).  heads[L]: the seeds 2^(S-W-P) in, the final heads
// out.  A head at or above 2^(S-P) after a step flushes its low W bits into
// a dense scratch words[row * L + l] and shifts right by W, and
// flags[row * G + g] is the ballot of group g's flushing lanes, row = T -
// 1 - t, so that the compaction puts the step chunks right to left, lanes
// ascending in a step (other words are left as they are).  A step source
// gives each step's (prob, q - cum), kHeadAhead steps ahead:
//   RecordSteps, kernel 21: the records (q - cum) | prob << 16 that its
//       inversion pass wrote, one thread per symbol (a bisection over
//       left() per quantile, the operation-bound work, which fills the
//       card on its own);
//   QuantileSteps, kernel 23: the quantiles themselves, each lane's next
//       kHeadAhead searched at once in the block's staged bucket table and
//       CDF (BucketCdfModel) and their symbols written.  A search pass of
//       its own (a persistent grid writing u64 records (q - cum) | prob <<
//       32) took 0.31 ms with the head pass and the compaction against
//       0.24 ms for this form at 2^24 quantiles on an H100 (PERF.md §6):
//       the search overlaps the head chain, and 128 MiB of records never
//       go through device memory.
// The u64 heads of kernel 23 stay below 2^40 between steps and prob <=
// 2^24, so h * prob + (q - cum) < 2^64.
constexpr int kHeadThreads = 128;
constexpr int kHeadAhead = 8;  // steps a lane has in flight

template <typename Rec>
struct RecordSteps {
  static constexpr bool kStaged = false;
  static constexpr int kHalf = 4 * sizeof(Rec);  // prob above q - cum
  using Token = Rec;
  const Rec* recs;

  __device__ void stage(uint32_t*) {}
  __device__ Token fetch(int64_t i) const { return recs[i]; }
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

struct QuantileSteps {
  static constexpr bool kStaged = true;
  using Token = uint32_t;
  const uint32_t* q;  // below 2^P (the wrappers check)
  BucketCdfModel model;
  int32_t* syms;

  __device__ void stage(uint32_t* smem) { model.stage(smem); }
  __device__ Token fetch(int64_t i) const { return q[i]; }
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
    cur[j] = j < T ? src.fetch(static_cast<int64_t>(j) * L + l) : Token(0);
  }
  for (int t0 = 0; t0 < T; t0 += kHeadAhead) {
#pragma unroll
    for (int j = 0; j < kHeadAhead; ++j) {
      const int t = t0 + kHeadAhead + j;
      nxt[j] = t < T ? src.fetch(static_cast<int64_t>(t) * L + l) : Token(0);
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

// Kernel 23's head pass alone: syms[T * L], words[T * L], flags[T * L /
// 32] and the heads from q[T * L].
int launch_heads24(void* heads, const void* q, const void* cdf, int K,
                   void* syms, void* words, void* flags, int L, int T,
                   void* cuda_stream, int device) {
  if (!valid_cat<64>(L, K, T)) return static_cast<int>(cudaErrorInvalidValue);
  QuantileSteps src{static_cast<const uint32_t*>(q),
                    {static_cast<const uint32_t*>(cdf), K, 0, 24, 0, nullptr},
                    static_cast<int32_t*>(syms)};
  const size_t smem = bucket_smem_bytes(&src.model);
  return launch_heads<32, 64, 24>(heads, src, smem, words, flags, L, T, 128,
                                  cuda_stream, device);
}

// The whole TChain-24 decode: the head pass and the three compaction
// launches.  Scratch the caller allocates: words[T * L], flags[T * L / 32],
// offsets[kScanBlocks] (u64).  On return the stream is buf[*end_out :
// cap].
int launch_tchain24_decode(void* heads, const void* q, const void* cdf, int K,
                           void* syms, void* buf, long long cap,
                           void* end_out, void* words, void* flags,
                           void* offsets, int L, int T, void* cuda_stream,
                           int device) {
  const int err = launch_heads24(heads, q, cdf, K, syms, words, flags, L, T,
                                 cuda_stream, device);
  if (err != 0 || T == 0) return err;
  return launch_compact(flags, words, static_cast<long long>(T) * (L / 32),
                        buf, cap, end_out, offsets, cuda_stream, device);
}

// The categorical encodes (kernel 20, TChain-16; kernel 24, TChain-24) on
// a cluster of CTAs, the lanes split as in ilans2_wide.cuh's
// cluster_decode_kernel (R lanes a thread, their heads in registers for
// the whole message: u32 at S=32, u64 at S=64).  A lane's refill decision
// h < prob << (S-W-P) at step t reads the head that step t + 1's refill
// made, and that refill's word index depends on every lane's decision
// there: the lanes are coupled as an rANS decode's are, and the steps stay
// serial.  One step, T-1 .. 0: each lane's division record (RecordCdfModel
// over the preset's record, RecordOf<S>: DivisionRecord at S=64,
// DivisionRecord32 at S=32; staged in shared memory when the K records
// fit; the symbols read a step ahead), the refill ballot, the cluster's
// exchange (exchange_step), the R word loads (all issued before any is
// used; the remainder stream read forward from word 0, in the order the
// decoder wrote it), h = h << W | word (a TChain-16 word keeps its low 16
// bits), the division by prob as a multiply-high, and the quantile cum + h
// mod prob, stored by store_quantile (a planar u16 half at S=32).  The
// division is exact for every S-bit h, and a refilled head fits: h < prob
// << (S-W-P) before the shift, so h < prob << (S-P) <= 2^S after it.  The
// L2 prefetch of the next two steps' words is the decode's.  heads[L]: the
// decoder's final heads in, the heads before step 0 out.  words[wlen]: the
// remainder stream; reads past its end yield 0.  q: the quantiles out
// (TChain-16: T * L/2 planar words; TChain-24: T * L), every one written.
template <int W, int S, int P, int R, class Model>
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
  Token tok[R];  // the symbols of the step being coded
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
    // the next step's symbols, a step ahead; this step's records and
    // refill decisions
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
        store_quantile<S>(q, t, (g0 + r) * 32 + lane, L, rec[r].cum() + rem);
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

template <int S>
using TChainModel = RecordCdfModel<typename RecordOf<S>::type>;
template <int S>
using TChainEncodeFn = void (*)(typename StateOf<S>::type*, TChainModel<S>,
                                const uint32_t*, int64_t, uint32_t*, int, int,
                                int);

template <int W, int S, int P>
TChainEncodeFn<S> tchain_encode_for(int rows) {
  using Model = TChainModel<S>;
  switch (rows) {
    case 1: return cluster_tchain_encode_kernel<W, S, P, 1, Model>;
    case 2: return cluster_tchain_encode_kernel<W, S, P, 2, Model>;
    case 4: return cluster_tchain_encode_kernel<W, S, P, 4, Model>;
    case 8: return cluster_tchain_encode_kernel<W, S, P, 8, Model>;
    case 16: return cluster_tchain_encode_kernel<W, S, P, 16, Model>;
    case 32: return cluster_tchain_encode_kernel<W, S, P, 32, Model>;
    default: return nullptr;
  }
}

// The cluster encode's model, shared memory and plan for L lanes and K
// symbols (`cluster` 0: the size picked from L).
template <int W, int S, int P>
cudaError_t plan_tchain_encode(int L, int K, int cluster, int device,
                               TChainModel<S>* model, size_t* bytes,
                               ClusterGeometry* geo,
                               TChainEncodeFn<S>* kernel) {
  *bytes = record_smem_bytes(model);
  return plan_cluster(L, cluster, *bytes, device, geo, kernel,
                      tchain_encode_for<W, S, P>);
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
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  division_records_kernel<Record><<<ceil_div(K, 128), 128, 0, stream>>>(
      static_cast<const uint32_t*>(cdf), K, static_cast<Record*>(records));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(geo, bytes, stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<typename StateOf<S>::type*>(heads), model,
      static_cast<const uint32_t*>(words), static_cast<int64_t>(wlen),
      static_cast<uint32_t*>(q), L, T, geo.groups_per_cta);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cluster encode's geometry for L lanes and K symbols (`cluster` 0:
// the size the encode picks), into out[7]: cluster size, groups per CTA,
// lanes per thread, threads per CTA, the card's maximum of active clusters
// of that shape, the dynamic shared memory bytes, whether the records are
// in shared memory.
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
  const long long vals[7] = {geo.cluster, geo.groups_per_cta, geo.rows,
                             geo.threads, geo.max_active_clusters,
                             static_cast<long long>(bytes), model.in_smem};
  for (int k = 0; k < 7; ++k) out[k] = vals[k];
  return 0;
}

// ---------------------------------------------------------------------------
// TChain-12: per-symbol continuous families
// ---------------------------------------------------------------------------

constexpr int kW = 16, kP = family::kFx;
constexpr uint32_t kWordMask = 0xffffu;
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
int launch_invert(const void* qw, const void* means, const void* scales,
                  void* syms, void* recs, int L, int T, int min_sym,
                  int max_sym, void* cuda_stream, int device) {
  if (!valid_chain(L, T, min_sym, max_sym)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks =
      static_cast<long long>(T) * (L / kInvertThreads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tchain12_invert_kernel<F><<<static_cast<unsigned>(blocks), kInvertThreads,
                              0, static_cast<cudaStream_t>(cuda_stream)>>>(
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
// nothing, and returns cudaGetLastError() (0 on success).  `K` is the
// alphabet size (the CDF has K + 1 entries); `fam` indexes (gaussian,
// laplace, logistic, cauchy).
extern "C" {

int ctt_tchain16_decode(void* heads, const void* qw, const void* cdf, int K,
                        void* syms, void* buf, long long cap, void* end_out,
                        int L, int T, void* cuda_stream, int device) {
  return launch_cat_decode<16, 32, 16>(heads, qw, cdf, K, syms, buf, cap,
                                       end_out, L, T, cuda_stream, device);
}

// words[T * L], flags[T * L / 32], offsets[kScanBlocks] (u64): scratch
// for the head pass and the compaction.
int ctt_tchain24_decode(void* heads, const void* q, const void* cdf, int K,
                        void* syms, void* buf, long long cap, void* end_out,
                        void* words, void* flags, void* offsets, int L, int T,
                        void* cuda_stream, int device) {
  return launch_tchain24_decode(heads, q, cdf, K, syms, buf, cap, end_out,
                                words, flags, offsets, L, T, cuda_stream,
                                device);
}

// The decode's head pass alone (pass B alone is ctt_ilans2_compact).
int ctt_tchain24_head_pass(void* heads, const void* q, const void* cdf, int K,
                           void* syms, void* words, void* flags, int L, int T,
                           void* cuda_stream, int device) {
  return launch_heads24(heads, q, cdf, K, syms, words, flags, L, T,
                        cuda_stream, device);
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
