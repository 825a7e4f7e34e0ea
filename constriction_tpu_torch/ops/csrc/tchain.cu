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
// The categorical decodes and the TChain-16 encode are one template over
// (W, S, P), in the shape of the TChain-12 encoder below: one thread block
// codes the message, heads live in device memory (updated in place), the
// words a step flushes are written in the next iteration once the block
// scan (lanes.cuh) has placed them, the CDF is staged in shared memory
// when it fits, and a quantile finds its symbol by binary search
// (find_symbol).  Lanes are strided (lane = row * 1024 + thread) and the
// last row is guarded per warp, so any L that is a multiple of 32 runs (the
// wrappers take multiples of 256 and 128, as the JAX package does).  The
// head update is native: u32 at S=32 (head < 2^16 and prob <= 2^16 keep
// head * prob + (q - cum) below 2^32; the CDF and prob are never held in
// 16 bits, since a one-symbol model has prob = 2^16), u64 at S=64 (head <
// 2^40, prob <= 2^24: the product stays below 2^64).  The TChain-24 encode
// (kernel 24) runs on ilans2_wide.cuh's cluster step instead
// (cluster_tchain_encode_kernel, below): its heads in registers, one
// exchange a step, the u64 division a multiply-high by each symbol's
// DivisionRecord.
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
// What bounds them on this card.  The TChain-12 decode (kernel 21) runs
// over the whole grid in three steps (below, before its launchers): an
// inversion pass of one thread per symbol, which holds its
// operation-bound work (a bisection over left() per quantile), a head
// pass of one thread per lane, and ilans2_wide.cuh's row-major compaction.
// The TChain-24 encode (kernel 24) runs on a cluster of up to 16 SMs: its
// refills couple the lanes at every step, so the step's exchange and its
// chain (record, ballot, barriers, one L2 load, a multiply-high) bound it.
// The other four kernels run on one SM: latency and issue.  The table pair
// does what the ILANS2 rANS kernels do per symbol (a dependent chain of
// head load, CDF search, head update and store), so it should cost what
// they cost per step; the family encoder adds two evaluations of left()
// per re-encoded symbol (it keeps each lane's pending (cum, prob) in a
// scratch array, `tab`, as the rANS family encoder does).  The TChain-16
// and TChain-24 decodes have the TChain-12 decode's lane independence and
// can take its head pass and compaction by instantiation; the TChain-16
// encode can take kernel 24's cluster step.

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

// The reverse pass over T * L symbols, steps T-1 .. 0.  heads[L]: the
// decoder's final heads in, the heads before step 0 out (the seeds after a
// full reverse).  words[wlen]: the remainder stream; reads past its end
// yield 0.  q: the quantiles out, every one written.  Symbols are clamped
// to K-1; callers validate them (and reject symbols of zero probability,
// which would divide by 0).
template <int W, int S, int P>
__global__ void __launch_bounds__(kThreads, 1)
    tchain_encode_kernel(typename StateOf<S>::type* __restrict__ heads,
                         const int32_t* __restrict__ syms,
                         const uint32_t* __restrict__ cdf_g, int K,
                         const uint32_t* __restrict__ words, int64_t wlen,
                         uint32_t* __restrict__ q, int L, int T,
                         int cdf_in_smem) {
  using Head = typename StateOf<S>::type;
  extern __shared__ uint32_t smem[];
  const int G = L / 32;
  const Smem s{smem, G};
  const uint32_t* cdf = stage_cdf(s.cdf(), cdf_g, K, cdf_in_smem);
  __syncthreads();

  constexpr int kShift = S - W - P;  // refill: head < prob << (S-W-P)
  constexpr uint32_t kMask = W == 32 ? kFull : ((1u << W) - 1u);
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const int rows = (L + kThreads - 1) / kThreads;
  const uint32_t kmax = static_cast<uint32_t>(K - 1);
  int64_t base = 0;         // first word of the pending step's refills
  uint32_t last_total = 0;  // words the pending step consumed

  // Iteration j refills and un-codes step T - j (flagged in iteration
  // j - 1), then flags the refilling lanes of step T - 1 - j.
  for (int j = 0; j <= T; ++j) {
    const int cur = j & 1, prev = cur ^ 1;
    const int t = T - 1 - j;
    for (int r = 0; r < rows; ++r) {
      if (r * kThreads + (tid & ~31) >= L) break;  // warp-uniform
      const int l = r * kThreads + tid;
      const int g = l >> 5;
      Head h = heads[l];
      if (j > 0) {
        const uint32_t sym = min(
            static_cast<uint32_t>(syms[static_cast<int64_t>(t + 1) * L + l]),
            kmax);
        const uint32_t cum = cdf[sym];
        const uint32_t prob = cdf[sym + 1] - cum;
        if (h < (static_cast<Head>(prob) << kShift)) {  // flagged last time
          const int64_t idx = base + s.prefix(prev)[g] +
                              __popc(s.ballots(prev)[g] & lt_mask);
          const uint32_t word = idx < wlen ? words[idx] : 0u;
          h = (h << W) | static_cast<Head>(word & kMask);
        }
        const Head quot = h / prob;
        store_quantile<S>(q, t + 1, l, L,
                          cum + static_cast<uint32_t>(h - quot * prob));
        h = quot;
      }
      if (j < T) {
        const uint32_t sym = min(
            static_cast<uint32_t>(syms[static_cast<int64_t>(t) * L + l]), kmax);
        const uint32_t prob = cdf[sym + 1] - cdf[sym];
        const unsigned bal =
            __ballot_sync(kFull, h < (static_cast<Head>(prob) << kShift));
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

template <int W, int S, int P>
int launch_cat_encode(void* heads, const void* syms, const void* cdf, int K,
                      const void* words, long long wlen, void* q, int L, int T,
                      void* cuda_stream, int device) {
  if (!valid_cat<S>(L, K, T)) return static_cast<int>(cudaErrorInvalidValue);
  int cdf_in_smem = 0;
  const size_t bytes = smem_bytes(L, K, &cdf_in_smem);
  auto kernel = tchain_encode_kernel<W, S, P>;
  const cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<typename StateOf<S>::type*>(heads),
      static_cast<const int32_t*>(syms), static_cast<const uint32_t*>(cdf), K,
      static_cast<const uint32_t*>(words), wlen, static_cast<uint32_t*>(q), L,
      T, cdf_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// The TChain-24 encode (kernel 24) on a cluster of CTAs, the lanes split
// as in ilans2_wide.cuh's cluster_decode_kernel (R lanes a thread, their
// u64 heads in registers for the whole message).  A lane's refill decision
// h < prob << 8 at step t reads the head that step t + 1's refill made,
// and that refill's word index depends on every lane's decision there: the
// lanes are coupled as an rANS decode's are, and the steps stay serial.
// One step, T-1 .. 0: each lane's division record (RecordCdfModel over
// DivisionRecord, staged in shared memory when the K records fit; the
// symbols read a step ahead), the refill ballot, the cluster's exchange
// (exchange_step), the R word loads (all issued before any is used; the
// remainder stream read forward from word 0, in the order the decoder
// wrote it), h = h << 32 | word, the division by prob as a multiply-high
// (exact for every u64 h), and the quantile cum + h mod prob.  The L2
// prefetch of the next two steps' words is the decode's.  heads[L]: the
// decoder's final heads in, the heads before step 0 out.  words[wlen]: the
// remainder stream; reads past its end yield 0.  q[T * L]: the quantiles
// out, every one written.
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
        q[static_cast<int64_t>(t) * L + (g0 + r) * 32 + lane] =
            rec[r].cum() + rem;
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

using TChain24Model = RecordCdfModel<DivisionRecord>;
using TChain24EncodeFn = void (*)(uint64_t*, TChain24Model, const uint32_t*,
                                  int64_t, uint32_t*, int, int, int);

TChain24EncodeFn tchain24_encode_for(int rows) {
  switch (rows) {
    case 1: return cluster_tchain_encode_kernel<32, 64, 24, 1, TChain24Model>;
    case 2: return cluster_tchain_encode_kernel<32, 64, 24, 2, TChain24Model>;
    case 4: return cluster_tchain_encode_kernel<32, 64, 24, 4, TChain24Model>;
    case 8: return cluster_tchain_encode_kernel<32, 64, 24, 8, TChain24Model>;
    case 16:
      return cluster_tchain_encode_kernel<32, 64, 24, 16, TChain24Model>;
    case 32:
      return cluster_tchain_encode_kernel<32, 64, 24, 32, TChain24Model>;
    default: return nullptr;
  }
}

// The cluster encode's model, shared memory and plan for L lanes and K
// symbols (`cluster` 0: the size picked from L).
cudaError_t plan_tchain24_encode(int L, int K, int cluster, int device,
                                 TChain24Model* model, size_t* bytes,
                                 ClusterGeometry* geo,
                                 TChain24EncodeFn* kernel) {
  *bytes = record_smem_bytes(model);
  return plan_cluster(L, cluster, *bytes, device, geo, kernel,
                      tchain24_encode_for);
}

// The TChain-24 encode: the division records of the CDF's symbols into
// records[K] (scratch the caller allocates, 16 bytes each), then the
// cluster encode; `cluster` 0 picks the cluster size from L.
int launch_tchain24_encode(void* heads, const void* syms, const void* cdf,
                           int K, const void* words, long long wlen, void* q,
                           void* records, int L, int T, int cluster,
                           void* cuda_stream, int device) {
  if (!valid_cat<64>(L, K, T)) return static_cast<int>(cudaErrorInvalidValue);
  TChain24Model model{static_cast<const int32_t*>(syms),
                      static_cast<const DivisionRecord*>(records), K, 0};
  size_t bytes;
  ClusterGeometry geo;
  TChain24EncodeFn kernel;
  cudaError_t err = plan_tchain24_encode(L, K, cluster, device, &model,
                                         &bytes, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  division_records_kernel<DivisionRecord><<<ceil_div(K, 128), 128, 0,
                                            stream>>>(
      static_cast<const uint32_t*>(cdf), K,
      static_cast<DivisionRecord*>(records));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(geo, bytes, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<uint64_t*>(heads), model,
                           static_cast<const uint32_t*>(words),
                           static_cast<int64_t>(wlen),
                           static_cast<uint32_t*>(q), L, T,
                           geo.groups_per_cta);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cluster encode's geometry for L lanes and K symbols (`cluster` 0:
// the size the encode picks), into out[7]: cluster size, groups per CTA,
// lanes per thread, threads per CTA, the card's maximum of active clusters
// of that shape, the dynamic shared memory bytes, whether the records are
// in shared memory.
int tchain24_geometry(int L, int K, int cluster, long long* out,
                      int device) {
  if (!valid_cat<64>(L, K, 0)) return static_cast<int>(cudaErrorInvalidValue);
  TChain24Model model{nullptr, nullptr, K, 0};
  size_t bytes;
  ClusterGeometry geo;
  TChain24EncodeFn kernel;
  const cudaError_t err = plan_tchain24_encode(L, K, cluster, device, &model,
                                               &bytes, &geo, &kernel);
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

// The TChain-12 decode in three steps over the whole grid.  A lane's head
// update h = h * prob + (q - cum) reads its own head only, and the
// expensive part of a step, the model's inversion (a bisection over
// left()), reads no head at all; the lanes meet only where their flushed
// words land.  So:
//   (a) tchain12_invert_kernel, one thread per symbol: the quantile, the
//       model, the bisection; writes the symbol and a record
//       (q - cum) | prob << 16 (prob <= 2^12);
//   (b) tchain12_heads_kernel, one thread per lane: the head chain through
//       steps 0 .. T-1 on the records alone, each flushed word into a
//       dense scratch words[row * L + l] and one ballot per (step, 32-lane
//       group) into flags[row * G + g], with row = T - 1 - t;
//   (c) ilans2_wide.cuh's row-major compaction (launch_compact), which
//       writes rows in ascending order: the stream's step chunks right to
//       left, lanes ascending within a step, as the host oracle lays
//       them out.
// (a) holds the operation-bound work (about 8 evaluations of left() a
// symbol) and fills the card; (b) is a chain of T short steps a lane with
// the next records loaded ahead; (c) moves one word per u32.
constexpr int kInvertThreads = 256;  // L is a multiple of 1024
constexpr int kHeadThreads = 128;
constexpr int kHeadAhead = 8;  // records a lane has in flight

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

// heads[L]: the seeds (16) in, the final heads out.  recs[T * L] from (a).
__global__ void __launch_bounds__(kHeadThreads)
    tchain12_heads_kernel(uint32_t* __restrict__ heads,
                          const uint32_t* __restrict__ recs,
                          uint32_t* __restrict__ words,
                          uint32_t* __restrict__ flags, int L, int T) {
  const int l = blockIdx.x * kHeadThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, g = l >> 5, G = L >> 5;
  uint32_t h = heads[l];
  uint32_t cur[kHeadAhead], nxt[kHeadAhead];
#pragma unroll
  for (int j = 0; j < kHeadAhead; ++j) {
    cur[j] = j < T ? recs[static_cast<int64_t>(j) * L + l] : 0u;
  }
  for (int t0 = 0; t0 < T; t0 += kHeadAhead) {
#pragma unroll
    for (int j = 0; j < kHeadAhead; ++j) {
      const int t = t0 + kHeadAhead + j;
      nxt[j] = t < T ? recs[static_cast<int64_t>(t) * L + l] : 0u;
    }
#pragma unroll
    for (int j = 0; j < kHeadAhead; ++j) {
      const int t = t0 + j;
      if (t < T) {  // uniform
        h = h * (cur[j] >> 16) + (cur[j] & 0xffffu);
        const bool flush = h >= kFlushAt;
        const int64_t row = T - 1 - t;
        if (flush) {
          words[row * L + l] = h & kWordMask;
          h >>= kW;
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

int launch_heads(void* heads, const void* recs, void* words, void* flags,
                 int L, int T, void* cuda_stream, int device) {
  if (L <= 0 || L % kThreads != 0 || T < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return static_cast<int>(cudaGetLastError());
  tchain12_heads_kernel<<<L / kHeadThreads, kHeadThreads, 0,
                          static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<uint32_t*>(heads), static_cast<const uint32_t*>(recs),
      static_cast<uint32_t*>(words), static_cast<uint32_t*>(flags), L, T);
  return static_cast<int>(cudaGetLastError());
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
  err = launch_heads(heads, recs, words, flags, L, T, cuda_stream, device);
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

int ctt_tchain24_decode(void* heads, const void* q, const void* cdf, int K,
                        void* syms, void* buf, long long cap, void* end_out,
                        int L, int T, void* cuda_stream, int device) {
  return launch_cat_decode<32, 64, 24>(heads, q, cdf, K, syms, buf, cap,
                                       end_out, L, T, cuda_stream, device);
}

int ctt_tchain16_encode(void* heads, const void* syms, const void* cdf, int K,
                        const void* words, long long wlen, void* qw, int L,
                        int T, void* cuda_stream, int device) {
  return launch_cat_encode<16, 32, 16>(heads, syms, cdf, K, words, wlen, qw,
                                       L, T, cuda_stream, device);
}

// records[K]: scratch for the division records (16 bytes each).
int ctt_tchain24_encode(void* heads, const void* syms, const void* cdf, int K,
                        const void* words, long long wlen, void* q,
                        void* records, int L, int T, void* cuda_stream,
                        int device) {
  return launch_tchain24_encode(heads, syms, cdf, K, words, wlen, q, records,
                                L, T, 0, cuda_stream, device);
}

// The same encode on a cluster of `cluster` CTAs (1 .. 16).
int ctt_tchain24_encode_cluster(void* heads, const void* syms,
                                const void* cdf, int K, const void* words,
                                long long wlen, void* q, void* records, int L,
                                int T, int cluster, void* cuda_stream,
                                int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tchain24_encode(heads, syms, cdf, K, words, wlen, q, records,
                                L, T, cluster, cuda_stream, device);
}

int ctt_tchain24_geometry(int L, int K, int cluster, long long* out,
                          void* cuda_stream, int device) {
  (void)cuda_stream;
  return tchain24_geometry(L, K, cluster, out, device);
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
  return launch_heads(heads, recs, words, flags, L, T, cuda_stream, device);
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
