// Reference-exact per-symbol families on Hopper (sm_90a), at the DEFAULT
// preset (W=32, S=64, 16 < P <= 24) and at the small preset (W=16, S=32,
// P <= 16): the encoder over per-symbol (cum, prob) planes, the decoder
// against packed decode tables (wide at S=64, whole message or one segment
// of a core-size-grouped message; narrow at S=32), and the window
// evaluator of the on-card table builder.
//
// Replaces the Pallas kernels
//   constriction_tpu/ops/exact_family.py  _build_exact_encoder64     (17)
//   constriction_tpu/ops/exact_family.py  _build_exact_decoder64     (15)
//   constriction_tpu/ops/exact_family.py  _build_exact_decoder64_seg (16)
//   constriction_tpu/ops/df32_pallas.py   _build_eval                (18)
//   constriction_tpu/ops/exact_family.py  _build_exact_encoder       (14)
//   constriction_tpu/ops/exact_family.py  _build_exact_decoder       (13)
// and holds the same wire format and table layout.
//
// Kernels 17 and 14 are ilans2_wide.cuh's two-pass encode over
// PlaneLanesModel, at W=32, S=64 and at W=16, S=32: pass A
// (encode_lanes_kernel, one thread per lane over the grid, the state in a
// register, the planes read two steps ahead, the division from an f64
// estimate at S=64, the native u32 division at S=32, words and renorm
// ballots to dense scratch) and pass B
// (launch_compact, the row-major compaction of kernel 2).  Kernels 15 and 16 are ilans2_wide.cuh's
// cluster decode over TableModel (up to 16 CTAs, states in registers, one
// exchange per step), kernel 13 the same decode at W=16, S=32 over
// NarrowTableModel; kernel 16 is its Seg instance, which starts from
// stream word *base_io and writes the next segment's first word back
// there, so the segments of a grouped message chain on the card with no
// host round trip.  The TPU kernels' chunked table DMA, their 40x25-bit
// multiply limbs, their f32-estimate division (_exact_div) and their
// refill/emit compaction stay behind.  No kernel here runs on one block.
//
// Kernels 17 and 14 read (cum, prob) from the planes at t * L + l.
//
// Kernels 15 and 16 read, per lane and step, the aux plane (core_lo - min |
// ncore << 24) and then the lane's 3G packed planes: four 24-bit (b - 1)
// fields per three u32, ascending within a lane, pads 2^P - 1 (never below
// a quantile).  The table layout [T, CP1, L] is plane-major, so one plane
// of a step is a coalesced row.  The fields are found by a linear scan with
// the Pallas body's select semantics (cnt counts the fields below q, cumc
// is the last one selected, nxtc its successor, 2^P - 1 past the last
// field) or, for wide tables, by a binary search (the wrapper picks by
// width, ops/exact_family.py BISECT_FROM_PLANES); then the left tail, core
// or right tail decide (sym, cum, prob) as _invert_with_tables does.  What
// bounds them: the binary search's chain of dependent loads, about
// log2(4G) + 2 of them a symbol (the scan reads every word of a lane's
// column, independent loads).  Each thread runs its lanes (R = 2 at L =
// 32768) in lock step, so every level of the search issues its R probes
// together, and a step is about ten dependent device-memory reads plus the
// cluster exchange.  Prefetching the next step's table slice into L2 (CP1
// L 4 bytes a step, 18 MB at the exact row's 139 planes) made kernel 15
// slower on an NVIDIA H100 80GB HBM3 at 700 W, line by line (1.75 against
// 1.10 ms) or with bulk prefetches (1.59): the prefetch traffic delays the
// search's own reads (chip_ab.py).
//
// Kernel 18 evaluates the (symbol, window position) entries in native
// float64 with CUDA's erf / exp / atan: tv = trunc(free * CDF(s - 1/2))
// where that is farther than 2^-6 from an integer, else an ambiguity flag
// for the host's exact patch (constriction_tpu_torch/ops/exact_tables.py
// states the rules).  The double-f32 arithmetic of the TPU kernel, which
// had no native f64, is not carried over.  The products and sums use
// __dmul_rn / __dadd_rn / __dsub_rn, so no multiply-add is fused and the
// plain twin's separate torch operations round alike.  A row's entries
// from its live end on, the first j that is out of the support or
// certainly saturated (t - t* > eps), are (free, 0) whatever their CDF:
// both tests are monotone in j for den > 0, so a search with the entry's
// own arithmetic finds that end exactly (exact_tables.py,
// live_ends_plain), and only the entries before it run a CDF.  Each warp
// works on four rows with no barrier (the search, a flat walk of their
// live entries, the fill of their ends); offsets among its rows
// are 32-bit and no entry takes a 64-bit division.  What bounds it:
// instruction issue in the live entries' CDF path, about 200 instructions
// an entry (gaussian, from the SASS), 65 of them on the float64 pipe and
// 68 UMOVs that load erf's 64-bit coefficients (CUDA's erf is one
// straight-line polynomial and an exp, with no branch to sort entries by:
// a form that ran a tile's live entries grouped by |t| < 1 was 3% slower
// on an NVIDIA H100 80GB HBM3 at 700 W, chip_ab.py),
// against the 5 bytes written per entry; every SM runs it.
//
// Kernel 13 reads narrow tables [T, CP1, L]: the aux plane (core_lo - min
// | ncore << 16), then CP1 - 1 planes of two 16-bit (b - 1) fields each,
// the low half first, ascending within a lane, pads 0xFFFF.  Quantiles are
// below 2^P <= 2^16, so the strict field < q never selects a pad, and the
// no-successor value past the last field is 0xFFFF (0x10000 in b space,
// only ever used through min(nxtc, rstart)).  The scan and the binary
// search (the wrapper picks by width, ops/exact_family.py
// BISECT_FROM_PLANES_NARROW) run over the 2 (CP1 - 1) fields, the binary
// search over a thread's R lanes in lock step as kernel 15's does.  What
// bounds it: the table words on a lane's search path (about log2(2 (CP1 -
// 1)) + 2 dependent words a symbol; the scan reads 4 + 2 (CP1 - 1) bytes,
// independent loads) and the cluster step's exchange.  On an NVIDIA H100
// 80GB HBM3 at 700 W a step of the facade's default call (75 planes) took
// 6.2-6.6 us at 2 lanes a thread (L = 4096 .. 32768), 2.8 at L = 128 and
// 14.5 at 4 lanes a thread (chip_smoke.py, exact32_times): 0.24 ms at 2^20
// symbols, L = 32768, against 4.2-4.3 ms on one block (chip_ab.py).

#include "ilans2_wide.cuh"

namespace {

// A symbol's interval read from the planes.  At S=32 (kernel 14, P <= 16)
// divide is the card's native u32 division, a short float-reciprocal
// sequence.  At S=64 (kernel 17) the card's u64 division is a software
// routine of tens of instructions on the lane's chain, and the planes hold
// no reciprocal (building one per symbol costs a division itself), so
// divide takes floor(x / prob) from float64 instead.  Pass A divides only
// states x < prob * 2^(64-P) (the renorm test), so the quotient is below
// 2^(64-P) <= 2^47 (16 < P <= 24).  The estimate is x times the reciprocal
// of prob from rcp.approx.ftz.f64 (good to 2^-19 relatively, f64_quotient's
// note in ilans2_wide.cuh) after two Newton steps (below 2^-37, then a few
// 2^-53), with x and the product rounded once each: within 2^-50 of x /
// prob relatively, 2^-3 absolutely.  Its truncation is off by at most one
// either way, and the remainder x - q prob, exact as a signed 64-bit value
// (it lies in (-prob, 2 prob), and u64 arithmetic wraps where q prob
// reaches 2^64), tells which.  constriction_tpu_torch/ops/exact_family.py
// (plane_correct) holds the correction exact against integer division from
// every estimate within one.  On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_ab.py) kernel 17's pass A took 0.078-0.087 ms this way against
// 0.098-0.101 with the native u64 division; kernel 14's pass A took
// 0.0112-0.0209 ms with the native u32 division against 0.0113-0.0248 with
// this f64 form, in turns in one call.
struct PlaneInterval {
  uint32_t c, p;

  __device__ static PlaneInterval unit() { return {0, 1}; }
  __device__ uint32_t cum() const { return c; }
  __device__ uint32_t prob() const { return p; }
  __device__ uint32_t divide(uint32_t x) const { return x / p; }
  __device__ uint64_t divide(uint64_t x) const {
    const double d = __uint2double_rn(p);
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
    r = __fma_rn(r, __fma_rn(-d, r, 1.0), r);
    r = __fma_rn(r, __fma_rn(-d, r, 1.0), r);
    const uint64_t q = __double2ull_rz(__dmul_rn(__ull2double_rn(x), r));
    const int64_t rem = static_cast<int64_t>(x - q * p);
    if (rem < 0) return q - 1;
    return rem >= static_cast<int64_t>(p) ? q + 1 : q;
  }
};

// Kernels 17 and 14's model (ilans2_wide.cuh's pass A): the token is the
// (cum, prob) pair itself, loaded from the planes two steps before it is
// coded, so interval() reads no memory and nothing is staged.
struct PlaneLanesModel {
  using Token = PlaneInterval;
  using Interval = PlaneInterval;
  const uint32_t* cums;
  const uint32_t* probs;

  __device__ void stage(uint32_t*) {}
  __device__ Token fetch(int64_t i) const { return {cums[i], probs[i]}; }
  __device__ Interval interval(Token pair) const { return pair; }
};

// The regions of _invert_with_tables once the core search has given cnt
// (fields below q), cumc (b - 1 of the last of them) and nxtc (b - 1 of its
// successor): the left tail, the core or the saturated right tail decide
// (sym, cum, prob).
__device__ __forceinline__ int exact_regions(uint32_t q, int cl, int nc,
                                             int cnt, uint32_t cumc,
                                             uint32_t nxtc, int P, int span,
                                             int free, int min_sym,
                                             uint32_t& cum, uint32_t& prob) {
  const int qi = static_cast<int>(q);
  const int cum_c = static_cast<int>(cumc + 1u);  // back to b space
  const int nxt_c = static_cast<int>(nxtc + 1u);
  const int core_hi_rel = cl + nc - 1;
  const int rstart = core_hi_rel >= span ? (1 << P) : free + 1 + core_hi_rel;
  const int s_rel_l = min(qi, cl - 1);
  const int next_l = s_rel_l >= cl - 1 ? nxt_c : s_rel_l + 1;
  const int sym_c = cl + cnt - 1;
  const int next_c = min(nxt_c, rstart);
  const int s_rel_r = min(qi - free, span);
  const int cum_r = free + s_rel_r;
  const int next_r = s_rel_r >= span ? (1 << P) : cum_r + 1;
  const bool right = qi >= rstart;
  const bool leftr = cnt == 0;
  const int s_rel = right ? s_rel_r : (leftr ? s_rel_l : sym_c);
  const int c = right ? cum_r : (leftr ? s_rel_l : cum_c);
  const int nx = right ? next_r : (leftr ? next_l : next_c);
  cum = static_cast<uint32_t>(c);
  prob = static_cast<uint32_t>(nx) - cum;
  return s_rel + min_sym;
}

// Kernels 15 and 16's model (ilans2_wide.cuh's cluster decode): packed
// wide tables [T, CP1, L].  ``bisect`` picks the search: a linear scan with
// the Pallas body's select semantics (every word of the lane, loads
// independent of each other), or a binary search over the ascending fields
// (about log2(4G) + 2 dependent field reads).  On tables the builders
// produce (fields ascending, pads last) both give the same (cnt, cumc,
// nxtc).
struct TableModel {
  const uint32_t* tabs;
  int CP1, L, P, min_sym, span, free;
  bool bisect;

  __device__ void stage(uint32_t*) {}

  // field k (b - 1 of boundary k) of lane l of the step whose aux plane
  // starts at `step`, in a form without branches (the second word's load
  // is predicated), so R lanes' probes issue together: sub-field s = k & 3
  // starts in word 3 s / 4 at bit 24 s mod 32 and spills into the next
  // word for s = 1, 2
  __device__ uint32_t field_at(const uint32_t* step, int l, int k) const {
    const int s = k & 3;
    const uint32_t* w =
        step + static_cast<int64_t>(1 + 3 * (k >> 2) + ((3 * s) >> 2)) * L +
        l;
    const uint32_t lo = w[0];
    const uint32_t hi = s == 1 || s == 2 ? w[L] : 0u;
    return __funnelshift_r(lo, hi, (24 * s) & 31) & 0xFFFFFFu;
  }

  // the select scan over all fields of one lane (the Pallas body's semantics)
  __device__ void scan(const uint32_t* col, uint32_t q, int& cnt,
                       uint32_t& cumc, uint32_t& nxtc) const {
    const int G = (CP1 - 1) / 3;
    uint32_t pend = 0;  // the field awaiting its successor
    // one step of the select scan: field b, followed by field bn
    auto take = [&](uint32_t b, uint32_t bn) {
      if (b < q) {
        ++cnt;
        cumc = b;
        nxtc = bn;
      }
    };
#pragma unroll 2
    for (int g = 0; g < G; ++g) {
      const uint32_t* w = col + static_cast<int64_t>(1 + 3 * g) * L;
      const uint32_t w0 = w[0], w1 = w[L], w2 = w[2 * L];
      const uint32_t b0 = w0 & 0xFFFFFFu;
      const uint32_t b1 = (w0 >> 24) | ((w1 & 0xFFFFu) << 8);
      const uint32_t b2 = (w1 >> 16) | ((w2 & 0xFFu) << 16);
      const uint32_t b3 = w2 >> 8;
      if (g == 0) {
        nxtc = b0;  // covers cnt == 0
      } else {
        take(pend, b0);
      }
      take(b0, b1);
      take(b1, b2);
      take(b2, b3);
      pend = b3;
    }
    take(pend, (1u << P) - 1u);
  }

  // The R lanes of one thread at once.  The binary search runs them in
  // lock step as a branchless lower bound over the N = 4G fields (Khuong
  // and Morin's form: the probe count, ceil(log2 N), is the same for
  // every lane), so each level issues its R probes before any is compared.
  // One last level loads, a lane at a time, the fields before, at and
  // after the bound with the aux word (independent of the search, so they
  // hold no register through it): four values a lane are live there, and
  // for all R lanes at once, beside the bounds and quantiles, they
  // overflowed the 64 registers a thread of a 1024-thread CTA has at R = 4
  // (ptxas: 24 spill bytes; in two halves of R / 2 lanes, 8).  cnt, cumc
  // and nxtc equal the scan's (exact_family.py, invert_tables_bisect, is
  // this probe order in plain PyTorch).  Lanes past L (a CTA's last warps)
  // read lane L - 1's column (min(l, L - 1), recomputed where it is used
  // rather than held).
  template <int R>
  __device__ void invert_lanes(int t, const int (&l)[R],
                               const uint32_t (&q)[R], int (&sym)[R],
                               uint32_t (&cum)[R], uint32_t (&prob)[R]) const {
    const uint32_t* step = tabs + static_cast<int64_t>(t) * CP1 * L;
    if (bisect) {
      const int N = 4 * ((CP1 - 1) / 3);
      int base[R];
#pragma unroll
      for (int r = 0; r < R; ++r) base[r] = 0;
      for (int len = N; len > 1;) {
        const int half = len >> 1;
        uint32_t f[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          f[r] = field_at(step, min(l[r], L - 1), base[r] + half);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (f[r] < q[r]) base[r] += half;
        }
        len -= half;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int lc = min(l[r], L - 1);
        const uint32_t aux = step[lc];
        const uint32_t fp = field_at(step, lc, max(base[r] - 1, 0));
        const uint32_t fb = field_at(step, lc, base[r]);
        const uint32_t fn = field_at(step, lc, min(base[r] + 1, N - 1));
        const bool below = fb < q[r];
        const uint32_t cumc = below ? fb : base[r] > 0 ? fp : 0xFFFFFFFFu;
        const uint32_t nxtc = !below ? fb
                              : base[r] + 1 < N ? fn
                                                : (1u << P) - 1u;
        sym[r] = exact_regions(q[r], static_cast<int>(aux & 0xFFFFFFu),
                               static_cast<int>(aux >> 24),
                               base[r] + (below ? 1 : 0), cumc, nxtc, P,
                               span, free, min_sym, cum[r], prob[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t* col = step + min(l[r], L - 1);
        int cnt = 0;
        uint32_t cumc = 0xFFFFFFFFu, nxtc = 0;
        scan(col, q[r], cnt, cumc, nxtc);
        const uint32_t aux = col[0];
        sym[r] = exact_regions(q[r], static_cast<int>(aux & 0xFFFFFFu),
                               static_cast<int>(aux >> 24), cnt, cumc, nxtc,
                               P, span, free, min_sym, cum[r], prob[r]);
      }
    }
  }
};

// Kernel 13's model (ilans2_wide.cuh's cluster decode): narrow tables [T,
// CP1, L], field k in the 16-bit half k & 1 of plane 1 + k / 2.  The same
// two searches as TableModel over the N = 2 (CP1 - 1) fields, with the pad
// 0xFFFF past the last one.  The binary search is TableModel's lock-step
// lower bound (one load a probe and no funnel shift: a field never spans
// two words); its last level reads, a lane at a time, the field at the
// bound and its successor with the aux word.  The field before the bound,
// which TableModel also reads, is never needed: the bound moves past 0
// only onto a field below q, so cnt = 0 exactly when base is 0 and field
// 0 is not below q.  cnt, cumc and nxtc equal the scan's
// (exact_family.py, invert_tables_bisect, is this probe order in plain
// PyTorch).  Lanes past L read lane L - 1's column.
struct NarrowTableModel {
  const uint32_t* tabs;
  int CP1, L, P, min_sym, span, free;
  bool bisect;

  __device__ void stage(uint32_t*) {}

  // field k of lane l of the step whose aux plane starts at `step`
  __device__ uint32_t field_at(const uint32_t* step, int l, int k) const {
    const uint32_t w = step[static_cast<int64_t>(1 + (k >> 1)) * L + l];
    return (w >> (16 * (k & 1))) & 0xFFFFu;
  }

  // the select scan over all fields of one lane (the Pallas body's
  // semantics)
  __device__ void scan(const uint32_t* col, uint32_t q, int& cnt,
                       uint32_t& cumc, uint32_t& nxtc) const {
    uint32_t pend = 0;  // the field awaiting its successor
    auto take = [&](uint32_t b, uint32_t bn) {
      if (b < q) {
        ++cnt;
        cumc = b;
        nxtc = bn;
      }
    };
#pragma unroll 4
    for (int g = 0; g < CP1 - 1; ++g) {
      const uint32_t w = col[static_cast<int64_t>(1 + g) * L];
      const uint32_t b0 = w & 0xFFFFu;
      const uint32_t b1 = w >> 16;
      if (g == 0) {
        nxtc = b0;  // covers cnt == 0
      } else {
        take(pend, b0);
      }
      take(b0, b1);
      pend = b1;
    }
    take(pend, 0xFFFFu);
  }

  template <int R>
  __device__ void invert_lanes(int t, const int (&l)[R],
                               const uint32_t (&q)[R], int (&sym)[R],
                               uint32_t (&cum)[R], uint32_t (&prob)[R]) const {
    const uint32_t* step = tabs + static_cast<int64_t>(t) * CP1 * L;
    if (bisect) {
      const int N = 2 * (CP1 - 1);
      int base[R];
#pragma unroll
      for (int r = 0; r < R; ++r) base[r] = 0;
      for (int len = N; len > 1;) {
        const int half = len >> 1;
        uint32_t f[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          f[r] = field_at(step, min(l[r], L - 1), base[r] + half);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (f[r] < q[r]) base[r] += half;
        }
        len -= half;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int lc = min(l[r], L - 1);
        const uint32_t aux = step[lc];
        const uint32_t fb = field_at(step, lc, base[r]);
        const uint32_t fn = field_at(step, lc, min(base[r] + 1, N - 1));
        const bool below = fb < q[r];
        const uint32_t cumc = below ? fb : 0xFFFFFFFFu;
        const uint32_t nxtc = !below ? fb : base[r] + 1 < N ? fn : 0xFFFFu;
        sym[r] = exact_regions(q[r], static_cast<int>(aux & 0xFFFFu),
                               static_cast<int>(aux >> 16),
                               base[r] + (below ? 1 : 0), cumc, nxtc, P, span,
                               free, min_sym, cum[r], prob[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t* col = step + min(l[r], L - 1);
        int cnt = 0;
        uint32_t cumc = 0xFFFFFFFFu, nxtc = 0;
        scan(col, q[r], cnt, cumc, nxtc);
        const uint32_t aux = col[0];
        sym[r] = exact_regions(q[r], static_cast<int>(aux & 0xFFFFu),
                               static_cast<int>(aux >> 16), cnt, cumc, nxtc,
                               P, span, free, min_sym, cum[r], prob[r]);
      }
    }
  }
};

// Kernel 18's blocks of kEvalThreads threads, each warp on kWarpRows rows;
// W is at most kEvalMaxW, so that an entry's offset among its warp's rows,
// r * W + j, fits 32 bits.
constexpr int kEvalThreads = 256;
constexpr int kWarpRows = 4;
constexpr int kEvalMaxW = 1 << 25;

// What kernel 18 takes besides the tensors.
struct EvalArgs {
  int max_sym;
  int freei;
  double free;
  double t_star;
  double eps;
  int has_star;
};

template <int F>
__device__ __forceinline__ double eval_den(double scale) {
  return F == 0 ? __dmul_rn(scale, 1.4142135623730951) : scale;
}

// The standardized argument t = ((s - 1/2) - mean) / den of symbol value s.
__device__ __forceinline__ double eval_t(int64_t s, double mean, double den) {
  return __ddiv_rn(__dsub_rn(__dsub_rn(static_cast<double>(s), 0.5), mean),
                   den);
}

// One entry of argument t in the support: (tv, ambig) by the rules of
// exact_tables.py.
struct EvalOut {
  int32_t tv;
  uint8_t ambig;
};

template <int F>
__device__ __forceinline__ EvalOut eval_entry(double t, const EvalArgs& a) {
  constexpr double kMargin = 0.015625;  // 2^-6
  constexpr double kPi = 3.141592653589793;
  double cdf;
  if (F == 0) {
    cdf = __dmul_rn(0.5, __dadd_rn(1.0, erf(t)));
  } else if (F == 1) {
    cdf = t < 0.0 ? __dmul_rn(0.5, exp(t))
                  : __dsub_rn(1.0, __dmul_rn(0.5, exp(-t)));
  } else {
    cdf = __dadd_rn(0.5, __ddiv_rn(atan(t), kPi));
  }
  const double A = __dmul_rn(a.free, cdf);
  const double I = rint(A);
  const double f = __dsub_rn(A, I);
  const double fl = floor(f);
  const int u = static_cast<int>(I) + static_cast<int>(fl);
  const double fr = __dsub_rn(f, fl);
  const bool unamb_frac = fr > kMargin && fr < 1.0 - kMargin;
  // A + margin < 1 pins trunc to 0 regardless of sign wobble near 0
  const bool unamb_zero = u <= 0 && A < 1.0 - kMargin;
  bool certain_sat = false, band = false;
  if (a.has_star) {
    const double d = __dsub_rn(t, a.t_star);
    certain_sat = d > a.eps;
    band = fabs(d) <= a.eps;
  }
  // below the threshold the CDF is certainly < 1.0: A margin-close to
  // free from below pins the value to free - 1
  const bool unamb_top = !certain_sat && !band &&
                         A > __dadd_rn(__dsub_rn(a.free, 1.0), kMargin);
  int v = u > 0 ? u : 0;
  if (unamb_zero) v = 0;
  if (unamb_top) v = a.freei - 1;
  if (certain_sat) v = a.freei;
  const bool unamb = unamb_frac || unamb_zero || unamb_top || certain_sat;
  return {v, static_cast<uint8_t>((!unamb || band) ? 1 : 0)};
}

// Kernel 18.  F: 0 gaussian, 1 laplace, 2 cauchy.  tv[n, W], ambig[n, W]
// (one byte, 0 or 1) for s = ws[i] + j.  Warp g of the grid takes the
// kWarpRows rows from g * kWarpRows on, with no barrier.  Lane 8 rr + q
// works on row rr: the row's eight lanes find its live end by an 8-ary
// search (a probe each a round, about three rounds for a window of 70),
// the warp walks its rows' live entries in one flat index, two a lane at a
// time (the row by three compares against the prefix, its mean, den and ws
// by shuffles from lane 8 rr), and fills their ends with (free, 0).
template <int F>
__global__ void __launch_bounds__(kEvalThreads)
    exact_eval_window_kernel(const double* __restrict__ means,
                             const double* __restrict__ scales,
                             const int32_t* __restrict__ ws, int64_t n, int W,
                             EvalArgs a, int32_t* __restrict__ tv,
                             uint8_t* __restrict__ ambig) {
  const int lane = threadIdx.x & 31;
  const int rr = lane >> 3, q = lane & 7;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) *
                            (kEvalThreads / 32) +
                        (threadIdx.x >> 5)) * kWarpRows;  // the warp's rows
  if (row0 >= n) return;  // warp-uniform
  const bool has_row = row0 + rr < n;
  double mean = 0.0, den = 1.0;
  int w0 = 0, end = 0;
  if (has_row) {
    mean = means[row0 + rr];
    den = eval_den<F>(scales[row0 + rr]);
    w0 = ws[row0 + rr];
    const int64_t room = static_cast<int64_t>(a.max_sym) - w0 + 1;
    end = room <= 0 ? 0 : room < W ? static_cast<int>(room) : W;
  }
  // (a) the live end: the first j in [0, end) with t - t* > eps
  const bool search = has_row && a.has_star && den > 0.0;
  int lo = 0, hi = search ? end : 0;
  while (__any_sync(kFull, lo < hi)) {
    const int len = hi - lo;
    const int p = lo + len * (q + 1) / 9;  // below hi where len > 0
    const bool sat =
        lo < hi && __dsub_rn(eval_t(static_cast<int64_t>(w0) + p, mean, den),
                             a.t_star) > a.eps;
    const unsigned bits = (__ballot_sync(kFull, sat) >> (8 * rr)) & 0xFFu;
    if (lo < hi) {
      if (bits != 0u) {  // the first saturated probe f: (p_{f-1}, p_f]
        const int f = __ffs(bits) - 1;
        hi = lo + len * (f + 1) / 9;
        lo = f > 0 ? lo + len * f / 9 + 1 : lo;
      } else {
        lo = lo + len * 8 / 9 + 1;
      }
    }
  }
  if (search) end = lo;

  // (b) the live entries of the warp's rows in one flat index
  int start[kWarpRows + 1];
  start[0] = 0;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    start[r + 1] = start[r] + __shfl_sync(kFull, end, 8 * r);
  }
  const int total = start[kWarpRows];
  const int64_t base = row0 * W;
  // entry k's argument t and its offset among the warp's rows (the row by
  // three compares; its mean, den and ws from lane 8 r)
  auto locate = [&](int k, int& off) {
    const int r = (k >= start[1]) + (k >= start[2]) + (k >= start[3]);
    const double m = __shfl_sync(kFull, mean, 8 * r);
    const double d = __shfl_sync(kFull, den, 8 * r);
    const int w = __shfl_sync(kFull, w0, 8 * r);
    const int j = k - (r == 0   ? 0
                       : r == 1 ? start[1]
                       : r == 2 ? start[2]
                                : start[3]);
    off = r * W + j;
    return eval_t(static_cast<int64_t>(w) + j, m, d);
  };
  // entries k and k + 32 a lane while more than 32 are left, their CDFs
  // side by side (4% faster than one a lane on the exact row: chip_ab.py,
  // NVIDIA H100 80GB HBM3, 700 W), then one
  int k0 = 0;
  for (; total - k0 > 32; k0 += 64) {
    const int kb = k0 + 32 + lane;
    int off_a, off_b;
    const double ta = locate(k0 + lane, off_a);
    const double tb = locate(min(kb, total - 1), off_b);
    const EvalOut ea = eval_entry<F>(ta, a);
    const EvalOut eb = eval_entry<F>(tb, a);
    tv[base + off_a] = ea.tv;
    ambig[base + off_a] = ea.ambig;
    if (kb < total) {
      tv[base + off_b] = eb.tv;
      ambig[base + off_b] = eb.ambig;
    }
  }
  for (; k0 < total; k0 += 32) {
    const int k = k0 + lane;
    int off;
    const double t = locate(min(k, total - 1), off);
    if (k < total) {
      const EvalOut e = eval_entry<F>(t, a);
      tv[base + off] = e.tv;
      ambig[base + off] = e.ambig;
    }
  }

  // (c) the entries at and past each row's live end: (free, 0)
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    if (row0 + r >= n) break;
    for (int j = start[r + 1] - start[r] + lane; j < W; j += 32) {
      tv[base + r * W + j] = a.freei;
      ambig[base + r * W + j] = 0;
    }
  }
}

// The lane counts and precisions of the wide (S=64) and narrow (S=32)
// coders.
bool valid_exact(int L, int P, bool wide) {
  const bool p_ok = wide ? P > 16 && P <= 24 : P >= 1 && P <= 16;
  return L > 0 && L % 32 == 0 && p_ok;
}

// The table decoders' arguments: lane count and precision of the preset,
// CP1 = 1 + 3G planes (wide) or >= 2 (narrow), a support of at least two
// symbols with free >= 2.
bool table_args(int L, int P, int CP1, long long span, long long free,
                bool wide) {
  const bool planes_ok = wide ? CP1 >= 4 && (CP1 - 1) % 3 == 0 : CP1 >= 2;
  return valid_exact(L, P, wide) && planes_ok && span >= 1 && free >= 2;
}

// Kernels 15 and 16 (W=32, S=64, TableModel) and 13 (W=16, S=32,
// NarrowTableModel): ilans2_wide.cuh's cluster decode (the tables stay in
// device memory; no dynamic shared memory) on `cluster` CTAs (0: the size
// picked from L).  Seg (kernel 16) starts from stream word *base_io and
// writes the next segment's first word back there.
template <int W, int S, class Model, bool Seg>
int launch_cluster_table_decode(void* states, const void* stream,
                                long long slen, const void* tabs, int CP1,
                                void* syms, long long n, int L, int P,
                                int min_sym, int max_sym, int bisect,
                                void* base_io, int cluster, void* cuda_stream,
                                int device) {
  const long long span = static_cast<long long>(max_sym) - min_sym;
  const long long free = (1ll << P) - 1 - span;
  if (!table_args(L, P, CP1, span, free, S == 64) ||
      (Seg && base_io == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ClusterGeometry geo;
  ClusterDecodeFn<W, S, Model, Seg> kernel;
  cudaError_t err = plan_cluster_decode<W, S, Model, Seg>(
      L, cluster, 0, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  const Model model{static_cast<const uint32_t*>(tabs),
                    CP1,
                    L,
                    P,
                    min_sym,
                    static_cast<int>(span),
                    static_cast<int>(free),
                    bisect != 0};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      geo, 0, static_cast<cudaStream_t>(cuda_stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<typename StateOf<S>::type*>(states),
      static_cast<const uint32_t*>(stream), static_cast<int64_t>(slen), model,
      static_cast<int32_t*>(syms), static_cast<int64_t>(n), L, P, T,
      geo.groups_per_cta, static_cast<int64_t*>(Seg ? base_io : nullptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The geometry of a table decode for L lanes (the cluster size it picks)
// into out[5]: cluster size, groups per CTA, lanes per thread, threads per
// CTA, the card's maximum of active clusters of that shape.
template <int W, int S, class Model, bool Seg>
int table_geometry(int L, long long* out, int device) {
  ClusterGeometry geo;
  ClusterDecodeFn<W, S, Model, Seg> kernel;
  const cudaError_t err =
      plan_cluster_decode<W, S, Model, Seg>(L, 0, 0, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[5] = {geo.cluster, geo.groups_per_cta, geo.rows,
                             geo.threads, geo.max_active_clusters};
  for (int k = 0; k < 5; ++k) out[k] = vals[k];
  return 0;
}

// Pass A alone of kernel 17 (W=32, S=64) or kernel 14 (W=16, S=32):
// words[T * L] (left as they are where a lane does not renorm) and
// flags[T * L / 32] out, states coded in place.
template <int W, int S>
int launch_encode_lanes(void* states, const void* cums, const void* probs,
                        long long n, void* words, void* flags, int L, int P,
                        void* cuda_stream, int device) {
  auto kernel = encode_lanes_kernel<W, S, PlaneLanesModel>;
  if (!valid_exact(L, P, S == 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = prepare(kernel, device, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  const PlaneLanesModel model{static_cast<const uint32_t*>(cums),
                              static_cast<const uint32_t*>(probs)};
  kernel<<<ceil_div(L, kLaneThreads), kLaneThreads, 0,
           static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<typename StateOf<S>::type*>(states), model, n,
      static_cast<uint32_t*>(words), static_cast<uint32_t*>(flags), L, P, T);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 17 or 14: pass A, then pass B into buf[*end_out : cap].  Scratch
// the caller allocates: words[T * L], flags[T * L / 32],
// offsets[kScanBlocks] (u64).
template <int W, int S>
int launch_encode(void* states, const void* cums, const void* probs,
                  long long n, void* buf, long long cap, void* end_out,
                  void* words, void* flags, void* offsets, int L, int P,
                  void* cuda_stream, int device) {
  const int err = launch_encode_lanes<W, S>(states, cums, probs, n, words,
                                            flags, L, P, cuda_stream, device);
  if (err != 0 || n <= 0) return err;
  const long long n_flags = (n + L - 1) / L * (L / 32);
  return launch_compact(flags, words, n_flags, buf, cap, end_out, offsets,
                        cuda_stream, device);
}

// Kernel 18: a warp for every kWarpRows rows.  (A grid of only as many
// blocks as the card keeps resident, each warp looping over groups of
// rows, took 1.833-1.845 ms against 1.653-1.661 on the exact row, in turns
// in one chip_ab.py call, NVIDIA H100 80GB HBM3, 700 W.)
template <int F>
int launch_eval(const void* means, const void* scales, const void* ws,
                long long n, int W, int min_sym, int max_sym, int P,
                double t_star, double eps, int has_star, void* tv,
                void* ambig, void* cuda_stream, int device) {
  constexpr long long kBlockRows = kEvalThreads / 32 * kWarpRows;
  const long long freei = (1ll << P) - 1 - (static_cast<long long>(max_sym) -
                                            min_sym);
  if (W < 1 || W > kEvalMaxW || P <= 16 || P > 24 || freei < 2 ||
      n > ((1ll << 31) - 1) * kBlockRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const EvalArgs args{max_sym,      static_cast<int>(freei),
                      static_cast<double>(freei), t_star, eps, has_star};
  exact_eval_window_kernel<F>
      <<<static_cast<unsigned>((n + kBlockRows - 1) / kBlockRows),
         kEvalThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
          static_cast<const double*>(means), static_cast<const double*>(scales),
          static_cast<const int32_t*>(ws), n, W, args,
          static_cast<int32_t*>(tv), static_cast<uint8_t*>(ambig));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (constriction_tpu_torch/ops/_build.py).
// Each entry launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 on success).
extern "C" {

// Kernels 17 (S=64) and 14 (S=32): words[T * L], flags[T * L / 32] and
// offsets[kScanBlocks] are scratch.
int ctt_exact_encode64(void* states, const void* cums, const void* probs,
                       long long n, void* buf, long long cap, void* end_out,
                       void* words, void* flags, void* offsets, int L, int P,
                       void* cuda_stream, int device) {
  return launch_encode<32, 64>(states, cums, probs, n, buf, cap, end_out,
                               words, flags, offsets, L, P, cuda_stream,
                               device);
}

int ctt_exact_encode32(void* states, const void* cums, const void* probs,
                       long long n, void* buf, long long cap, void* end_out,
                       void* words, void* flags, void* offsets, int L, int P,
                       void* cuda_stream, int device) {
  return launch_encode<16, 32>(states, cums, probs, n, buf, cap, end_out,
                               words, flags, offsets, L, P, cuda_stream,
                               device);
}

// Pass A alone of kernel 17 or 14 (pass B alone is ctt_ilans2_compact).
int ctt_exact_encode_lanes64(void* states, const void* cums,
                             const void* probs, long long n, void* words,
                             void* flags, int L, int P, void* cuda_stream,
                             int device) {
  return launch_encode_lanes<32, 64>(states, cums, probs, n, words, flags, L,
                                     P, cuda_stream, device);
}

int ctt_exact_encode_lanes32(void* states, const void* cums,
                             const void* probs, long long n, void* words,
                             void* flags, int L, int P, void* cuda_stream,
                             int device) {
  return launch_encode_lanes<16, 32>(states, cums, probs, n, words, flags, L,
                                     P, cuda_stream, device);
}

// base_io is unused (kernel 15 decodes from stream word 0).
int ctt_exact_decode64(void* states, const void* stream, long long slen,
                       const void* tabs, int CP1, void* syms, long long n,
                       int L, int P, int min_sym, int max_sym, int bisect,
                       void* base_io, void* cuda_stream, int device) {
  (void)base_io;
  return launch_cluster_table_decode<32, 64, TableModel, false>(
      states, stream, slen, tabs, CP1, syms, n, L, P, min_sym, max_sym,
      bisect, nullptr, 0, cuda_stream, device);
}

// The geometry of kernel 15 (seg 0) or kernel 16 (seg 1) for L lanes into
// out[5] (table_geometry).
int ctt_exact_geometry64(int L, int seg, long long* out, void* cuda_stream,
                         int device) {
  (void)cuda_stream;
  return seg ? table_geometry<32, 64, TableModel, true>(L, out, device)
             : table_geometry<32, 64, TableModel, false>(L, out, device);
}

// base_io: the segment's first stream word in, the next segment's out.
int ctt_exact_decode64_seg(void* states, const void* stream, long long slen,
                           const void* tabs, int CP1, void* syms, long long n,
                           int L, int P, int min_sym, int max_sym, int bisect,
                           void* base_io, void* cuda_stream, int device) {
  return launch_cluster_table_decode<32, 64, TableModel, true>(
      states, stream, slen, tabs, CP1, syms, n, L, P, min_sym, max_sym,
      bisect, base_io, 0, cuda_stream, device);
}

// The same segment decode on a cluster of `cluster` CTAs (1 .. 16).
int ctt_exact_decode64_seg_cluster(void* states, const void* stream,
                                   long long slen, const void* tabs, int CP1,
                                   void* syms, long long n, int L, int P,
                                   int min_sym, int max_sym, int bisect,
                                   void* base_io, int cluster,
                                   void* cuda_stream, int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster_table_decode<32, 64, TableModel, true>(
      states, stream, slen, tabs, CP1, syms, n, L, P, min_sym, max_sym,
      bisect, base_io, cluster, cuda_stream, device);
}

// base_io is unused (kernel 13 decodes from stream word 0).
int ctt_exact_decode32(void* states, const void* stream, long long slen,
                       const void* tabs, int CP1, void* syms, long long n,
                       int L, int P, int min_sym, int max_sym, int bisect,
                       void* base_io, void* cuda_stream, int device) {
  (void)base_io;
  return launch_cluster_table_decode<16, 32, NarrowTableModel, false>(
      states, stream, slen, tabs, CP1, syms, n, L, P, min_sym, max_sym,
      bisect, nullptr, 0, cuda_stream, device);
}

// The same decode on a cluster of `cluster` CTAs (1 .. 16).
int ctt_exact_decode32_cluster(void* states, const void* stream,
                               long long slen, const void* tabs, int CP1,
                               void* syms, long long n, int L, int P,
                               int min_sym, int max_sym, int bisect,
                               void* base_io, int cluster, void* cuda_stream,
                               int device) {
  (void)base_io;
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster_table_decode<16, 32, NarrowTableModel, false>(
      states, stream, slen, tabs, CP1, syms, n, L, P, min_sym, max_sym,
      bisect, nullptr, cluster, cuda_stream, device);
}

// Kernel 13's geometry for L lanes into out[5] (table_geometry).
int ctt_exact_geometry32(int L, long long* out, void* cuda_stream,
                         int device) {
  (void)cuda_stream;
  return table_geometry<16, 32, NarrowTableModel, false>(L, out, device);
}

int ctt_exact_eval_window(const void* means, const void* scales,
                          const void* ws, long long n, int W, int family,
                          int min_sym, int max_sym, int P, double t_star,
                          double eps, int has_star, void* tv, void* ambig,
                          void* cuda_stream, int device) {
  switch (family) {
    case 0:
      return launch_eval<0>(means, scales, ws, n, W, min_sym, max_sym, P,
                            t_star, eps, has_star, tv, ambig, cuda_stream,
                            device);
    case 1:
      return launch_eval<1>(means, scales, ws, n, W, min_sym, max_sym, P,
                            t_star, eps, has_star, tv, ambig, cuda_stream,
                            device);
    case 2:
      return launch_eval<2>(means, scales, ws, n, W, min_sym, max_sym, P,
                            t_star, eps, has_star, tv, ambig, cuda_stream,
                            device);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
