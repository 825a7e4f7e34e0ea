// Native host codec of constriction_tpu_torch (the host side of the port;
// no CUDA here).
//
// Exact C++ implementations of the hot host-side paths:
//  - float -> fixed-point entropy-model table building (LeakyQuantizer
//    formulas, the reference's src/stream/model/quantize.rs:525-568) for the
//    Gaussian/Laplace/Cauchy/Binomial families, using the same f64 CDF
//    formula shapes as the Rust `probability` crate (glibc libm is the same
//    fdlibm lineage as the crate's `libm`);
//  - scalar rANS / range / chain coder state machines (bit-exact with the
//    reference: stack.rs:1014-1100, queue.rs:602-710/957-1040,
//    chain.rs:1044-1206) over precomputed (cum, prob) tables and
//    lookup/CDF/quantized decode models;
//  - shared-stream interleaved rANS and range coding (ILANS2, ILANS2-R)
//    and the table builders, the per-element loops parallelized with OpenMP
//    (each element is written independently, so the thread count never
//    changes a result).
//
// Exposed via a plain C ABI for ctypes.  Built at first use by
// constriction_tpu_torch/native/build.py (python -m
// constriction_tpu_torch.native.build); the C ABI is the JAX package's
// constriction_tpu/native/codec.cpp's, without its ILANS v1 exports.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

// One range-coder symbol step -- interval update, deferred-carry (Inverted
// run) resolution, renormalization (queue.rs:126-142, 647-702).  THE single
// implementation of the subtlest logic in the codec, shared by the scalar
// coder (ctpu_range_encode) and the ILANS2-R per-lane encoder; EmitWord is
// any void(uint32_t) sink.  Returns true when a renorm word event occurred.
template <typename EmitWord>
static inline bool range_encode_step(
    uint64_t& lower, uint64_t& range, uint64_t& num_inverted,
    uint32_t& first_inverted, uint32_t cum, uint32_t prob,
    uint64_t word_mask, int32_t top_shift, uint64_t state_mask,
    uint64_t lower_bound, int32_t word_bits, int32_t precision,
    EmitWord emit)
{
    uint64_t scale = range >> precision;
    range = scale * prob;
    uint64_t new_lower = (lower + scale * (uint64_t)cum) & state_mask;
    if (num_inverted != 0 && ((new_lower + range) & state_mask) > new_lower) {
        uint32_t first, consecutive;
        if (new_lower < lower) {
            first = (uint32_t)((first_inverted + 1) & word_mask);
            consecutive = 0;
        } else {
            first = first_inverted;
            consecutive = (uint32_t)word_mask;
        }
        emit(first);
        for (uint64_t k = 1; k < num_inverted; k++) emit(consecutive);
        num_inverted = 0;
    }
    lower = new_lower;
    if (range < lower_bound) {
        range = (range << word_bits) & state_mask;
        uint32_t lower_word = (uint32_t)(lower >> top_shift);
        lower = (lower << word_bits) & state_mask;
        if (num_inverted != 0) {
            num_inverted += 1;
        } else if (((lower + range) & state_mask) > lower) {
            emit(lower_word);
        } else {
            num_inverted = 1;
            first_inverted = lower_word;
        }
        return true;
    }
    return false;
}

extern "C" {

// ---------------------------------------------------------------------------
// Special functions / CDFs (f64, matching the probability crate's formulas)
// ---------------------------------------------------------------------------

static const double SQRT_2 = 1.41421356237309504880168872420969808;

static inline double gaussian_cdf(double x, double mean, double std_) {
    return (1.0 + erf((x - mean) / (std_ * SQRT_2))) / 2.0;
}

static inline double laplace_cdf(double x, double mean, double b) {
    if (x < mean) {
        return 0.5 * exp((x - mean) / b);
    }
    return 1.0 - 0.5 * exp((mean - x) / b);
}

static inline double cauchy_cdf(double x, double loc, double scale) {
    return 0.5 + atan((x - loc) / scale) / M_PI;
}

// Regularized incomplete beta, Algorithm AS 63 (same algorithm as the Rust
// `special` crate's inc_beta, which backs the Binomial CDF).
static double inc_beta(double x, double p, double q, double log_beta) {
    const double ACU = 0.1e-14;
    if (x <= 0.0) return 0.0;
    if (x >= 1.0) return 1.0;

    double psq = p + q;
    bool flip = p < psq * x;
    double xx, cx, pp, qq;
    if (flip) {
        xx = 1.0 - x; cx = x; pp = q; qq = p;
    } else {
        xx = x; cx = 1.0 - x; pp = p; qq = q;
    }

    double term = 1.0, ai = 1.0, alpha = 1.0;
    int ns = (int)(qq + cx * psq);
    double rx = xx / cx;
    double temp = qq - ai;
    if (ns == 0) rx = xx;

    for (;;) {
        term = term * temp * rx / (pp + ai);
        alpha += term;
        temp = fabs(term);
        if (temp <= ACU && temp <= ACU * alpha) break;
        ai += 1.0;
        ns -= 1;
        if (ns >= 0) {
            temp = qq - ai;
            if (ns == 0) rx = xx;
        } else {
            temp = psq;
            psq += 1.0;
        }
    }

    alpha = alpha * exp(pp * log(xx) + (qq - 1.0) * log(cx) - log_beta) / pp;
    return flip ? 1.0 - alpha : alpha;
}

static inline double binomial_cdf(double x, double n, double p) {
    if (x < 0.0) return 0.0;
    double k = floor(x);
    if (k >= n) return 1.0;
    if (p <= 0.0) return 1.0;
    if (p >= 1.0) return 0.0;
    double a = n - k, b = k + 1.0;
    double log_beta = lgamma(a) + lgamma(b) - lgamma(a + b);
    return inc_beta(1.0 - p, a, b, log_beta);
}

// Vectorized libm erf/erfc: the SAME glibc implementations CPython's
// math.erf binds, exposed as array loops (OpenMP) so the host's exact-f64
// model paths run at native speed when scipy's erf is not bit-identical.
void ctpu_erf_array(const double* x, double* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) out[i] = erf(x[i]);
}

void ctpu_erfc_array(const double* x, double* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) out[i] = erfc(x[i]);
}

// Rust `as`-cast semantics: truncate toward zero, saturate, NaN -> 0.
static inline uint32_t trunc_u32(double x) {
    if (!(x > 0.0)) return 0;  // NaN or <= 0
    if (x >= 4294967295.0) return 0xFFFFFFFFu;
    return (uint32_t)x;
}

// ---------------------------------------------------------------------------
// LeakyQuantizer table building (vectorized over symbols, OpenMP parallel)
// ---------------------------------------------------------------------------

enum DistKind : int32_t {
    DIST_GAUSSIAN = 0, DIST_LAPLACE = 1, DIST_CAUCHY = 2,
    // Binomial(n=a trials, p=b): discrete CDF evaluated at x (the quantizer
    // only ever asks at s +- 1/2, i.e. between lattice points), backed by
    // the AS 63 inc_beta above -- matches the reference's `probability`
    // crate Binomial::distribution (pybindings/stream/model.rs:927-966).
    DIST_BINOMIAL = 3,
};

static inline double dist_cdf(int32_t kind, double x, double a, double b) {
    switch (kind) {
        case DIST_GAUSSIAN: return gaussian_cdf(x, a, b);
        case DIST_LAPLACE:  return laplace_cdf(x, a, b);
        case DIST_BINOMIAL: return binomial_cdf(x, a, b);
        default:            return cauchy_cdf(x, a, b);
    }
}

// forward declarations (defined further down / in surrogate.cpp)
static inline bool qm_fast_enabled();
static inline uint32_t qm_tv_margined(
    int32_t kind, double a, double b, double free_weight, int64_t s,
    double A);
void ctpu_surrogate_eval_batch(
    int32_t kind, const double* a, const double* b, double free_weight,
    const double* x, int64_t n, double* A);

// Per-symbol (cum, prob) for a two-parameter quantized family.
// Returns 0 on success, -1 if a symbol is out of support.
int32_t ctpu_quantized_ecp(
    int32_t kind, int32_t min_sym, int32_t max_sym, int32_t precision,
    const int32_t* symbols, const double* pa, const double* pb, int64_t n,
    uint32_t* cums, uint32_t* probs)
{
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));
    const uint32_t total = (uint32_t)(1ull << precision);
    int32_t err = 0;
    if (qm_fast_enabled() && kind != DIST_BINOMIAL && precision <= 24) {
        // Batched surrogate with exact patching: two margined trunc values
        // per symbol (s -+ 1/2), glibc only for the ~2*margin ambiguous
        // fraction.  Identical output to the scalar path below.
        const int64_t BLK = 1024;
#pragma omp parallel for schedule(static)
        for (int64_t i0 = 0; i0 < n; i0 += BLK) {
            const int64_t m = (i0 + BLK < n) ? BLK : (n - i0);
            double xl[BLK], xr[BLK], Al[BLK], Ar[BLK];
            for (int64_t k = 0; k < m; k++) {
                double sd = (double)symbols[i0 + k];
                xl[k] = sd - 0.5;
                xr[k] = sd + 0.5;
            }
            ctpu_surrogate_eval_batch(kind, pa + i0, pb + i0, free_weight,
                                      xl, m, Al);
            ctpu_surrogate_eval_batch(kind, pa + i0, pb + i0, free_weight,
                                      xr, m, Ar);
            for (int64_t k = 0; k < m; k++) {
                const int64_t i = i0 + k;
                int32_t s = symbols[i];
                if (s < min_sym || s > max_sym) {
#pragma omp atomic write
                    err = -1;
                    continue;
                }
                uint32_t slack = (uint32_t)(s - min_sym);
                uint32_t left = (s == min_sym)
                    ? 0u
                    : qm_tv_margined(kind, pa[i], pb[i], free_weight,
                                     s, Al[k]) + slack;
                uint32_t right = (s == max_sym)
                    ? total
                    : qm_tv_margined(kind, pa[i], pb[i], free_weight,
                                     s + 1, Ar[k]) + slack + 1;
                cums[i] = left;
                probs[i] = right - left;
            }
        }
        return err;
    }
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        int32_t s = symbols[i];
        if (s < min_sym || s > max_sym) {
#pragma omp atomic write
            err = -1;
            continue;
        }
        uint32_t slack = (uint32_t)(s - min_sym);
        uint32_t left = (s == min_sym)
            ? 0u
            : trunc_u32(free_weight * dist_cdf(kind, (double)s - 0.5, pa[i], pb[i])) + slack;
        uint32_t right = (s == max_sym)
            ? total
            : trunc_u32(free_weight * dist_cdf(kind, (double)s + 0.5, pa[i], pb[i])) + slack + 1;
        cums[i] = left;
        probs[i] = right - left;
    }
    return err;
}

int32_t ctpu_binomial_ecp(
    int32_t precision,
    const int32_t* symbols, const int32_t* ns, const double* ps, int64_t n,
    uint32_t* cums, uint32_t* probs)
{
    const uint32_t total = (uint32_t)(1ull << precision);
    int32_t err = 0;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        int32_t s = symbols[i];
        int32_t max_sym = ns[i];
        if (s < 0 || s > max_sym || max_sym < 1) {
#pragma omp atomic write
            err = -1;
            continue;
        }
        double free_weight = (double)(((1ull << precision) - 1) - (uint64_t)max_sym);
        uint32_t slack = (uint32_t)s;
        uint32_t left = (s == 0)
            ? 0u
            : trunc_u32(free_weight * binomial_cdf((double)s - 0.5, (double)max_sym, ps[i])) + slack;
        uint32_t right = (s == max_sym)
            ? total
            : trunc_u32(free_weight * binomial_cdf((double)s + 0.5, (double)max_sym, ps[i])) + slack + 1;
        cums[i] = left;
        probs[i] = right - left;
    }
    return err;
}

// Compact exact decode tables for the reference-exact device family path
// (ops/exact_family.py): per symbol, the non-linear CORE of the
// LeakyQuantizer boundary function b(s) = trunc(free*CDF(s-1/2)) + (s-min).
// The trunc value tv(s) is monotone in s, so both core edges are found by
// bisection (log2(span) CDF evals each) instead of evaluating a window:
//   core_lo = first s in (min, max] with tv >= 1            (else max)
//   core_hi = last  s in (min, max] with tv <= free-1       (clamped >= lo)
// aux[i] = (core_lo - min) | ncore << 16; core[i*cmax + j] = b(core_lo + j)
// padded with 0xFFFF.  Returns 0, or 1 + (index of the first symbol whose
// core exceeds cmax).
static inline uint32_t qm_tv(int32_t kind, double a, double b,
                             double free_weight, int64_t s) {
    return trunc_u32(free_weight * dist_cdf(kind, (double)s - 0.5, a, b));
}

// First s in (min_sym, max_sym] whose monotone trunc value reaches
// `threshold`, or max_sym + 1 when none does.  Starts from an approximate
// PPF guess and brackets exponentially, so the typical cost is ~3-5 CDF
// evaluations instead of a full log2(span) bisection.  `dist_ppf` is
// declared below (decode-side guesses share it).
static inline double dist_ppf(int32_t kind, double xi, double a, double b);

// Exact predicate tv(s) >= threshold; with fast=true it is decided by the
// cheap surrogate (defined below) whenever the margin allows, falling back
// to the glibc evaluation only on ambiguity -- the RESULT is identical
// either way, so every search below converges to the same boundary.
static inline bool qm_ge(int32_t kind, double a, double b,
                         double free_weight, uint32_t threshold, int64_t s,
                         bool fast);
static inline bool qm_fast_enabled();

static const double QM_MARGIN = 0x1p-9;

// The surrogate evaluators live in surrogate.cpp, a separate translation
// unit compiled with relaxed FP flags so the loops vectorize; this TU
// keeps strict semantics (see build.py).  A ~ free * CDF; every integer
// decision taken from A is re-derived with exact glibc evaluations when A
// is margin-close to a boundary, so outputs stay bit-identical.
void ctpu_surrogate_window(
    int32_t kind, double a, double b, double free_weight,
    int64_t s0, int64_t m, double* A);
void ctpu_surrogate_eval_batch(
    int32_t kind, const double* a, const double* b, double free_weight,
    const double* x, int64_t n, double* A);

static inline int64_t qm_first_reaching(
    int32_t kind, double a, double b, double free_weight,
    uint32_t threshold, int32_t min_sym, int32_t max_sym, double guess_f,
    bool fast = false)
{
    int64_t g;
    if (guess_f <= (double)(min_sym + 1)) g = min_sym + 1;
    else if (guess_f >= (double)max_sym) g = max_sym;
    else g = (int64_t)floor(guess_f);

    int64_t lo = min_sym, hi;  // invariant: tv(lo) < threshold (tv(min)=0
    int64_t hi_cap = (int64_t)max_sym + 1;  // virtual "true" sentinel
    if (qm_ge(kind, a, b, free_weight, threshold, g, fast)) {
        hi = g;
        int64_t step = 1;
        for (;;) {
            int64_t nxt = hi - step;
            if (nxt <= min_sym) break;
            if (qm_ge(kind, a, b, free_weight, threshold, nxt, fast)) {
                hi = nxt; step <<= 1;
            } else { lo = nxt; break; }
        }
    } else {
        lo = g;
        hi = hi_cap;
        int64_t step = 1;
        for (;;) {
            int64_t nxt = lo + step;
            if (nxt > max_sym) break;
            if (!qm_ge(kind, a, b, free_weight, threshold, nxt, fast)) {
                lo = nxt; step <<= 1;
            } else { hi = nxt; break; }
        }
    }
    while (hi - lo > 1) {
        int64_t mid = lo + ((hi - lo) >> 1);
        if (qm_ge(kind, a, b, free_weight, threshold, mid, fast)) hi = mid;
        else lo = mid;
    }
    return hi;
}

// Core edges for one symbol position (shared by ctpu_exact_boundaries and
// the ncore probe ctpu_exact_ncore).  Guess-seeded: the left edge sits where
// CDF ~ 1/free, the right edge where CDF ~ 1 - 1/free.
static inline void qm_core_edges(
    int32_t kind, double a, double b, double free_weight, uint32_t freeu,
    int32_t min_sym, int32_t max_sym, int64_t* out_lo, int64_t* out_hi,
    bool fast = false)
{
    const double inv_free = 1.0 / free_weight;
    int64_t first_pos = qm_first_reaching(
        kind, a, b, free_weight, 1u, min_sym, max_sym,
        dist_ppf(kind, inv_free, a, b) + 0.5, fast);
    // first s with tv >= 1: max_sym + 1 means all-zero trunc -> clamp
    int64_t core_lo = first_pos > max_sym ? max_sym : first_pos;
    // last s with tv <= free-1  ==  (first s with tv >= free) - 1; the
    // clamp cases (whole support saturated / nothing saturated) fall out of
    // the sentinel and the final max()
    int64_t first_sat = qm_first_reaching(
        kind, a, b, free_weight, freeu, min_sym, max_sym,
        dist_ppf(kind, 1.0 - inv_free, a, b) + 0.5, fast);
    int64_t core_hi = first_sat - 1;
    if (core_hi < core_lo) core_hi = core_lo;
    *out_lo = core_lo;
    *out_hi = core_hi;
}

// ncore probe: per-symbol core sizes only (no boundary values, no cmax cap).
// Lets callers auto-size cmax before paying for the value fill.
void ctpu_exact_ncore(
    int32_t kind, int32_t min_sym, int32_t max_sym, int32_t precision,
    const double* pa, const double* pb, int64_t n, uint32_t* ncore_out)
{
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));
    const uint32_t freeu = (uint32_t)free_weight;
    const bool fast = qm_fast_enabled() && kind != DIST_BINOMIAL
        && precision <= 24;  // the surrogate error bound covers free <= 2^24
    if (!fast) {
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n; i++) {
            int64_t core_lo, core_hi;
            qm_core_edges(kind, pa[i], pb[i], free_weight, freeu,
                          min_sym, max_sym, &core_lo, &core_hi, false);
            ncore_out[i] = (uint32_t)(core_hi - core_lo + 1);
        }
        return;
    }
    // Block-synchronous bisection: all lanes of a block step together so
    // the surrogate evaluates 4-wide; only margin-ambiguous comparisons
    // (~2*margin of evals) fall back to a scalar glibc call.  Converges to
    // the same first-reaching boundaries as qm_core_edges for every input
    // (predicates are exact either way), so ncore is bit-identical.
    const int64_t BLK = 1024;
#pragma omp parallel for schedule(static)
    for (int64_t i0 = 0; i0 < n; i0 += BLK) {
        const int64_t m = (i0 + BLK < n) ? BLK : (n - i0);
        int64_t lo[BLK], hi[BLK];
        double xs[BLK], A[BLK];
        int64_t first1[BLK];
        for (int pass = 0; pass < 2; pass++) {
            const uint32_t th = pass == 0 ? 1u : freeu;
            for (int64_t k = 0; k < m; k++) {
                lo[k] = min_sym;           // virtual false sentinel
                hi[k] = (int64_t)max_sym + 1;  // virtual true sentinel
            }
            for (;;) {
                bool any = false;
                for (int64_t k = 0; k < m; k++) {
                    int64_t mid = lo[k] + ((hi[k] - lo[k]) >> 1);
                    xs[k] = (double)mid - 0.5;
                    if (hi[k] - lo[k] > 1) any = true;
                }
                if (!any) break;
                ctpu_surrogate_eval_batch(kind, pa + i0, pb + i0,
                                          free_weight, xs, m, A);
                for (int64_t k = 0; k < m; k++) {
                    if (hi[k] - lo[k] <= 1) continue;
                    int64_t mid = lo[k] + ((hi[k] - lo[k]) >> 1);
                    bool ge;
                    if (A[k] > (double)th + QM_MARGIN) ge = true;
                    else if (A[k] < (double)th - QM_MARGIN) ge = false;
                    else ge = qm_tv(kind, pa[i0 + k], pb[i0 + k],
                                    free_weight, mid) >= th;
                    if (ge) hi[k] = mid; else lo[k] = mid;
                }
            }
            if (pass == 0) {
                for (int64_t k = 0; k < m; k++)
                    first1[k] = hi[k];
            } else {
                for (int64_t k = 0; k < m; k++) {
                    int64_t core_lo =
                        first1[k] > max_sym ? max_sym : first1[k];
                    int64_t core_hi = hi[k] - 1;  // first_sat - 1
                    if (core_hi < core_lo) core_hi = core_lo;
                    ncore_out[i0 + k] = (uint32_t)(core_hi - core_lo + 1);
                }
            }
        }
    }
}

int64_t ctpu_exact_boundaries(
    int32_t kind, int32_t min_sym, int32_t max_sym, int32_t precision,
    const double* pa, const double* pb, int64_t n, int32_t cmax,
    uint32_t* aux, uint32_t* core)
{
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));
    const uint32_t freeu = (uint32_t)free_weight;
    // narrow tables (P <= 16): u16 pads 0xFFFF, ncore in aux bits 16..;
    // wide tables (16 < P <= 24): pads 2^P (doubles as the no-next
    // sentinel), ncore in aux bits 24.. (core_lo_rel can need 24 bits)
    const int32_t aux_shift = precision > 16 ? 24 : 16;
    const uint32_t padv = precision > 16 ? (1u << precision) : 0xFFFFu;
    int64_t bad = 0;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        int64_t bad_seen;
#pragma omp atomic read
        bad_seen = bad;
        if (bad_seen) continue;
        const double a = pa[i], b = pb[i];
        // left edge by guess-seeded search; the right edge falls out of the
        // forward fill below (each core value is one CDF eval anyway, so
        // probing past the end costs one extra eval, not a second search)
        int64_t first_pos = qm_first_reaching(
            kind, a, b, free_weight, 1u, min_sym, max_sym,
            dist_ppf(kind, 1.0 / free_weight, a, b) + 0.5);
        int64_t core_lo = first_pos > max_sym ? max_sym : first_pos;
        uint32_t* row = core + i * cmax;
        // j = 0 is unconditional: the clamp rule keeps ncore >= 1 even when
        // tv(core_lo) is already saturated (sharp-step models)
        row[0] = qm_tv(kind, a, b, free_weight, core_lo)
               + (uint32_t)(core_lo - min_sym);
        int64_t ncore = 1;
        bool overflow = false;
        for (int64_t s = core_lo + 1; s <= max_sym; s++) {
            uint32_t tv = qm_tv(kind, a, b, free_weight, s);
            if (tv > freeu - 1) break;  // saturated: right-linear regime
            if (ncore >= cmax) { overflow = true; break; }
            row[ncore++] = tv + (uint32_t)(s - min_sym);
        }
        if (overflow) {
#pragma omp critical
            if (!bad || bad > 1 + i) bad = 1 + i;  // lowest index wins
            continue;
        }
        aux[i] = (uint32_t)(core_lo - min_sym) | ((uint32_t)ncore << aux_shift);
        for (int64_t j = ncore; j < cmax; j++) row[j] = padv;
    }
    return bad;
}

// ---------------------------------------------------------------------------
// Fast surrogate evaluation of A ~ free * CDF with an exactness margin.
//
// The exact-table fill is bound by glibc erf/exp/atan calls (~100 ns each on
// an x86 host; ~ncore + search evals per symbol).  The fill only needs
// trunc(free * CDF) -- an INTEGER -- so a cheap approximation A with a
// validated error bound E works whenever A is at least margin-far from an
// integer: floor(A - margin) == floor(A + margin) pins the exact trunc
// value without ever calling libm.  Entries within the margin (~2*margin
// fraction, margin = 2^-9) are re-evaluated with the exact glibc path, so
// THE OUTPUT IS BIT-IDENTICAL to the pure path for every input.
//
// Surrogate accuracy (validated by the JAX package's tests/test_exact_family.py
// surrogate bound test over random parameter sweeps): erf <= ~4e-15 abs, erfc branch
// <= ~4e-12 abs, atan <= ~3e-14 abs, exp <= ~1e-14 rel; free <= 2^24 puts
// |A - Y| <= ~6e-5, a >8000x safety factor under the 2^-9 margin.
// Coefficients are Chebyshev fits (benchmarks/fit_surrogates note in git
// history); branch-free form so g++ -O3 auto-vectorizes the window loops.
// ---------------------------------------------------------------------------

// Always on: the surrogate path's output equals the pure path's for every
// input, so no switch is read (the JAX package's copy reads one from its
// environment).
static inline bool qm_fast_enabled() { return true; }

// Exact trunc value from the surrogate when unambiguous, glibc otherwise.
static inline uint32_t qm_tv_margined(
    int32_t kind, double a, double b, double free_weight, int64_t s,
    double A)
{
    double lo = A - QM_MARGIN, hi = A + QM_MARGIN;
    double flo = std::floor(lo < 0.0 ? 0.0 : lo);
    double fhi = std::floor(hi < 0.0 ? 0.0 : hi);
    if (flo == fhi) return (uint32_t)flo;
    return qm_tv(kind, a, b, free_weight, s);
}

static inline bool qm_ge(int32_t kind, double a, double b,
                         double free_weight, uint32_t threshold, int64_t s,
                         bool fast)
{
    if (fast) {
        double A;
        ctpu_surrogate_window(kind, a, b, free_weight, s, 1, &A);
        if (A > (double)threshold + QM_MARGIN) return true;
        if (A < (double)threshold - QM_MARGIN) return false;
    }
    return qm_tv(kind, a, b, free_weight, s) >= threshold;
}

// Windowed fast row fill: surrogate evaluation in 32-entry chunks (lazily,
// stopping at the first saturated boundary), ambiguous entries patched
// with glibc, and (core_lo, ncore, b-1 values) derived with the same
// clamp rules as the pure walk.  Returns ncore, or -1 when the window is
// inconclusive (caller falls back to the pure per-symbol path), or -2 on
// cmax overflow.
static inline int64_t qm_fill_fast_row(
    int32_t kind, double a, double b, double free_weight, uint32_t freeu,
    int32_t min_sym, int32_t max_sym, int32_t cmax,
    uint32_t* bm1, int64_t* core_lo_out)
{
    const int64_t W_MAX = 272;
    const int64_t CHUNK = 32;
    int64_t W = (int64_t)cmax + 16;
    if (W > W_MAX) W = W_MAX;
    double g = dist_ppf(kind, 1.0 / free_weight, a, b);
    int64_t ws;
    if (g != g || g <= (double)min_sym) {
        ws = min_sym + 1;
    } else {
        double gf = std::floor(g) - 3.0;
        ws = gf <= (double)(min_sym + 1) ? min_sym + 1
            : (gf >= (double)max_sym ? max_sym : (int64_t)gf);
    }
    int64_t n_eval = max_sym - ws + 1;
    if (n_eval > W) n_eval = W;
    double A[W_MAX];
    int64_t evaluated = 0;

    int64_t j0 = -1;        // first index with tv >= 1
    int64_t ncore = 0;
    int64_t core_lo = 0;
    uint32_t last_tv = 0;
    for (int64_t j = 0; j < n_eval; j++) {
        if (j >= evaluated) {
            int64_t m = n_eval - evaluated;
            if (m > CHUNK) m = CHUNK;
            ctpu_surrogate_window(kind, a, b, free_weight, ws + evaluated,
                                  m, A + evaluated);
            evaluated += m;
        }
        uint32_t tv = qm_tv_margined(kind, a, b, free_weight, ws + j, A[j]);
        last_tv = tv;
        if (j0 < 0) {
            if (tv < 1u) continue;
            if (j == 0 && ws != min_sym + 1) return -1;  // left edge unproven
            j0 = j;
            core_lo = ws + j0;
            *core_lo_out = core_lo;
            bm1[0] = tv + (uint32_t)(core_lo - min_sym) - 1u;
            ncore = 1;
            continue;
        }
        if (tv > freeu - 1) return ncore;  // saturated: right-linear regime
        if (ncore >= cmax) return -2;
        bm1[ncore++] = tv + (uint32_t)(ws + j - min_sym) - 1u;
    }
    // ran off the window: conclusive only if it covers the support end
    if (ws + n_eval - 1 < max_sym) return -1;
    if (j0 < 0) {
        // no positive trunc anywhere: core_lo clamps to max_sym
        *core_lo_out = max_sym;
        bm1[0] = last_tv + (uint32_t)(max_sym - min_sym) - 1u;
        return 1;
    }
    return ncore;
}

// Pure (all-glibc) row fill, shared by the fast path's fallback and the
// no-AVX/no-fast builds; identical to the original walk.
static inline int64_t qm_fill_pure_row(
    int32_t kind, double a, double b, double free_weight, uint32_t freeu,
    int32_t min_sym, int32_t max_sym, int32_t cmax,
    uint32_t* bm1, int64_t* core_lo_out)
{
    int64_t first_pos = qm_first_reaching(
        kind, a, b, free_weight, 1u, min_sym, max_sym,
        dist_ppf(kind, 1.0 / free_weight, a, b) + 0.5,
        qm_fast_enabled() && kind != DIST_BINOMIAL
            && free_weight <= 16777216.0);
    int64_t core_lo = first_pos > max_sym ? max_sym : first_pos;
    *core_lo_out = core_lo;
    bm1[0] = qm_tv(kind, a, b, free_weight, core_lo)
           + (uint32_t)(core_lo - min_sym) - 1u;
    int64_t ncore = 1;
    for (int64_t s = core_lo + 1; s <= max_sym; s++) {
        uint32_t tv = qm_tv(kind, a, b, free_weight, s);
        if (tv > freeu - 1) break;
        if (ncore >= cmax) return -2;
        bm1[ncore++] = tv + (uint32_t)(s - min_sym) - 1u;
    }
    return ncore;
}

// One packed wide-table row (aux word + 3*G quad planes) for a single
// (mean, scale): fill (fast with pure fallback) + pad + pack, shared by
// the row-major and fused-transposed builders so the layout can never
// diverge between them.  Returns 0, or -2 on cmax overflow.
static inline int64_t qm_build_packed_row(
    int32_t kind, double a, double b, double free_weight, uint32_t freeu,
    int32_t min_sym, int32_t max_sym, int32_t cmax, int64_t G,
    uint32_t padm1, bool fast, uint32_t* row)
{
    uint32_t bm1[256];
    int64_t core_lo;
    int64_t ncore = fast
        ? qm_fill_fast_row(kind, a, b, free_weight, freeu, min_sym,
                           max_sym, cmax, bm1, &core_lo)
        : -1;
    if (ncore == -1)
        ncore = qm_fill_pure_row(kind, a, b, free_weight, freeu, min_sym,
                                 max_sym, cmax, bm1, &core_lo);
    if (ncore == -2) return -2;
    const int64_t ncore_ret = ncore;
    for (int64_t j = ncore; j < 4 * G; j++) bm1[j] = padm1;
    row[0] = (uint32_t)(core_lo - min_sym) | ((uint32_t)ncore << 24);
    for (int64_t g = 0; g < G; g++) {
        const uint32_t* q = bm1 + 4 * g;
        row[1 + 3 * g]     = q[0] | (q[1] << 24);
        row[1 + 3 * g + 1] = (q[1] >> 8) | (q[2] << 16);
        row[1 + 3 * g + 2] = (q[2] >> 16) | (q[3] << 8);
    }
    return ncore_ret;
}

// Fused wide-table build: boundary fill + the device kernels' packed (b-1)
// 24-bit-quad layout, written directly as [n, 1 + 3*G] u32 planes
// (G = ceil(cmax/4); plane 0 is aux).  Skips the intermediate [n, cmax]
// core array and the numpy packing pass entirely -- on a single-core host
// the numpy pack costs ~4x the CDF evaluations themselves.  Semantics are
// identical to ctpu_exact_boundaries + the Python pack_decode_tables wide
// branch (ops/exact_family.py): pads are (2^P)-1 in (b-1) space, aux keeps
// the RAW cmax cap (ncore < 2^8 for wide tables, so cmax <= 255 and the
// local row buffer is a fixed 256-entry stack array).
int64_t ctpu_exact_tables_packed(
    int32_t kind, int32_t min_sym, int32_t max_sym, int32_t precision,
    const double* pa, const double* pb, int64_t n, int32_t cmax,
    uint32_t* tabs)
{
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));
    const uint32_t freeu = (uint32_t)free_weight;
    const uint32_t padm1 = (1u << precision) - 1;  // (pad 2^P) - 1
    const int64_t G = (cmax + 3) / 4;
    const int64_t CP1 = 1 + 3 * G;
    if (precision <= 16 || cmax > 255) return -1;  // wide tables only
    const bool fast = qm_fast_enabled() && kind != DIST_BINOMIAL
        && precision <= 24;  // the surrogate error bound covers free <= 2^24
    int64_t bad = 0;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        int64_t bad_seen;
#pragma omp atomic read
        bad_seen = bad;
        if (bad_seen) continue;
        if (qm_build_packed_row(kind, pa[i], pb[i], free_weight, freeu,
                                min_sym, max_sym, cmax, G, padm1, fast,
                                tabs + i * CP1) == -2) {
#pragma omp critical
            if (!bad || bad > 1 + i) bad = 1 + i;  // lowest index wins
        }
    }
    return bad;
}

// Fill + transpose fused: rows are built 64 symbols at a time in an
// L1-resident block buffer and written straight into the device layout
// dst[t, plane, lane] (lane = the symbol's index within its grid step of
// `rows` lanes) -- the [n, CP1] intermediate of ctpu_exact_tables_packed
// never exists, which on a single-core host saves ~2x the fill cost in
// allocation faults and a full read+write pass.  Same bad/overflow
// contract as ctpu_exact_tables_packed.
int64_t ctpu_exact_tables_packed_t(
    int32_t kind, int32_t min_sym, int32_t max_sym, int32_t precision,
    const double* pa, const double* pb, int64_t nsteps, int64_t rows,
    int32_t cmax, uint32_t* dst, int32_t* ncore_max_out)
{
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));
    const uint32_t freeu = (uint32_t)free_weight;
    const uint32_t padm1 = (1u << precision) - 1;
    const int64_t G = (cmax + 3) / 4;
    const int64_t CP1 = 1 + 3 * G;
    if (precision <= 16 || cmax > 255) return -1;
    const bool fast = qm_fast_enabled() && kind != DIST_BINOMIAL
        && precision <= 24;  // the surrogate error bound covers free <= 2^24
    const int64_t B = 64;
    int64_t bad = 0;
    int32_t ncore_max = 0;
#pragma omp parallel for schedule(static) collapse(1)
    for (int64_t t = 0; t < nsteps; t++) {
        int64_t bad_seen;
#pragma omp atomic read
        bad_seen = bad;
        if (bad_seen) continue;
        uint32_t blk[64 * 256 + 64];  // B rows x CP1 (CP1 <= 1+3*64 = 193)
        uint32_t* step_dst = dst + t * CP1 * rows;
        const double* sa = pa + t * rows;
        const double* sb = pb + t * rows;
        for (int64_t r0 = 0; r0 < rows; r0 += B) {
            const int64_t r1 = r0 + B < rows ? r0 + B : rows;
            for (int64_t r = r0; r < r1; r++) {
                uint32_t* row = blk + (r - r0) * CP1;
                int64_t nc = qm_build_packed_row(
                    kind, sa[r], sb[r], free_weight, freeu, min_sym,
                    max_sym, cmax, G, padm1, fast, row);
                if (nc == -2) {
#pragma omp critical
                    {
                        int64_t i = t * rows + r;
                        if (!bad || bad > 1 + i) bad = 1 + i;
                    }
                    // keep the block well-defined; result unused
                    for (int64_t c = 0; c < CP1; c++) row[c] = 0;
                } else if ((int32_t)nc > ncore_max) {
#pragma omp critical
                    if ((int32_t)nc > ncore_max) ncore_max = (int32_t)nc;
                }
            }
            // scatter the block transposed: plane-contiguous runs of B
            for (int64_t c = 0; c < CP1; c++) {
                uint32_t* out = step_dst + c * rows + r0;
                for (int64_t r = r0; r < r1; r++)
                    out[r - r0] = blk[(r - r0) * CP1 + c];
            }
        }
    }
    if (ncore_max_out) *ncore_max_out = ncore_max;
    return bad;
}

// Exact trunc values at explicit (symbol, s) pairs -- the patch oracle for
// the on-device table builder (ops/exact_tables_jax.py): the device flags
// the margin-ambiguous window entries, the host resolves exactly them.
void ctpu_exact_tv_at(
    int32_t kind, int32_t min_sym, int32_t max_sym, int32_t precision,
    const double* pa, const double* pb,
    const int64_t* sym_idx, const int32_t* svals, int64_t k, uint32_t* out)
{
    (void)min_sym;
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < k; i++) {
        int64_t j = sym_idx[i];
        out[i] = qm_tv(kind, pa[j], pb[j], free_weight, (int64_t)svals[i]);
    }
}

// Blocked u32 transpose: src[t, r, c] -> dst[t, c, r] (the device table
// layout moves the plane axis in front of the lane axes; numpy's strided
// transpose + ascontiguousarray walks one element at a time).
void ctpu_transpose_u32(
    const uint32_t* src, uint32_t* dst,
    int64_t nsteps, int64_t rows, int64_t cols)
{
    const int64_t B = 64;
    for (int64_t t = 0; t < nsteps; t++) {
        const uint32_t* s = src + t * rows * cols;
        uint32_t* d = dst + t * rows * cols;
#pragma omp parallel for schedule(static)
        for (int64_t r0 = 0; r0 < rows; r0 += B) {
            const int64_t r1 = r0 + B < rows ? r0 + B : rows;
            for (int64_t c0 = 0; c0 < cols; c0 += B) {
                const int64_t c1 = c0 + B < cols ? c0 + B : cols;
                for (int64_t r = r0; r < r1; r++)
                    for (int64_t c = c0; c < c1; c++)
                        d[c * rows + r] = s[r * cols + c];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Decode-side quantile inversion for quantized families.
//
// Binary search on the monotone boundary b(s) = left-cumulative(s); finds the
// unique s with b(s) <= q < b(s+1).  Identical result to the reference's
// guess+search (quantize.rs:580-779).
// ---------------------------------------------------------------------------

struct QuantizedModel {
    int32_t kind;
    int32_t min_sym, max_sym, precision;
    double a, b;
    double free_weight;
};

static inline uint32_t qm_left(const QuantizedModel& m, int64_t s) {
    if (s <= m.min_sym) return 0;
    if (s > m.max_sym) return (uint32_t)(1ull << m.precision);
    return trunc_u32(m.free_weight * dist_cdf(m.kind, (double)s - 0.5, m.a, m.b))
         + (uint32_t)(s - m.min_sym);
}

// Approximate inverse CDFs -- only decode-time initial guesses; they never
// affect the bitstream (the boundary search below is exact).
static inline double erfinv_approx(double y) {
    // Giles (2010)-style rational approximation; adequate as a guess.
    y = fmin(fmax(y, -1.0 + 1e-12), 1.0 - 1e-12);
    double w = -log((1.0 - y) * (1.0 + y));
    double p;
    if (w < 5.0) {
        w -= 2.5;
        p = 2.81022636e-08;
        p = 3.43273939e-07 + p * w;
        p = -3.5233877e-06 + p * w;
        p = -4.39150654e-06 + p * w;
        p = 0.00021858087 + p * w;
        p = -0.00125372503 + p * w;
        p = -0.00417768164 + p * w;
        p = 0.246640727 + p * w;
        p = 1.50140941 + p * w;
    } else {
        w = sqrt(w) - 3.0;
        p = -0.000200214257;
        p = 0.000100950558 + p * w;
        p = 0.00134934322 + p * w;
        p = -0.00367342844 + p * w;
        p = 0.00573950773 + p * w;
        p = -0.0076224613 + p * w;
        p = 0.00943887047 + p * w;
        p = 1.00167406 + p * w;
        p = 2.83297682 + p * w;
    }
    return p * y;
}

static inline double dist_ppf(int32_t kind, double xi, double a, double b) {
    xi = fmin(fmax(xi, 1e-12), 1.0 - 1e-12);
    switch (kind) {
        case DIST_GAUSSIAN: return a + b * SQRT_2 * erfinv_approx(2.0 * xi - 1.0);
        case DIST_LAPLACE:
            return xi < 0.5 ? a + b * log(2.0 * xi) : a - b * log(2.0 - 2.0 * xi);
        case DIST_BINOMIAL: {
            // normal approximation of Binomial(n=a, p=b) -- only a GUESS;
            // the callers' bracketing search restores exactness
            double mean = a * b, sd = sqrt(fmax(a * b * (1.0 - b), 0.0));
            return mean + sd * SQRT_2 * erfinv_approx(2.0 * xi - 1.0);
        }
        default: return a + b * tan(M_PI * (xi - 0.5));
    }
}

static inline void qm_qf(const QuantizedModel& m, uint32_t q,
                         int32_t* sym, uint32_t* cum, uint32_t* prob) {
    // Initial guess from the approximate PPF, then exponential bracketing and
    // binary search on the exact fixed-point boundary function.  Boundary
    // values are CARRIED through the search (like the Pallas bisection), so
    // the final (cum, prob) need no extra CDF evaluations: the common case
    // (correct guess) costs exactly two evals -- measured 2.6x faster than
    // the re-evaluating form (the same answer is produced regardless of the
    // search path: the boundary function is monotone).
    const double denom = (double)(1ull << m.precision);
    double guess_f = dist_ppf(m.kind, ((double)q + 0.5) / denom, m.a, m.b);
    int64_t guess;
    if (guess_f <= (double)m.min_sym) guess = m.min_sym;
    else if (guess_f >= (double)m.max_sym) guess = m.max_sym;
    else guess = (int64_t)floor(guess_f);

    const uint32_t top = (uint32_t)(1ull << m.precision);
    int64_t lo, hi;
    uint32_t lov, hiv;
    uint32_t gv = qm_left(m, guess);
    if (gv <= q) {
        lo = guess; lov = gv;
        hi = (int64_t)m.max_sym + 1; hiv = top;
        int64_t step = 1;
        for (;;) {
            int64_t nxt = lo + step;
            if (nxt > m.max_sym) break;
            uint32_t v = qm_left(m, nxt);
            if (v <= q) { lo = nxt; lov = v; step <<= 1; }
            else { hi = nxt; hiv = v; break; }
        }
    } else {
        hi = guess; hiv = gv;
        lo = m.min_sym; lov = 0;  // qm_left(min) is pinned to 0
        int64_t step = 1;
        for (;;) {
            int64_t nxt = hi - step;
            if (nxt <= m.min_sym) break;
            uint32_t v = qm_left(m, nxt);
            if (v > q) { hi = nxt; hiv = v; step <<= 1; }
            else { lo = nxt; lov = v; break; }
        }
    }
    while (hi - lo > 1) {
        int64_t mid = lo + ((hi - lo) >> 1);
        uint32_t v = qm_left(m, mid);
        if (v <= q) { lo = mid; lov = v; } else { hi = mid; hiv = v; }
    }
    // hi == lo + 1, so hiv IS the right boundary of lo (or the pinned 2^P)
    *sym = (int32_t)lo;
    *cum = lov;
    *prob = hiv - lov;
}

// ---------------------------------------------------------------------------
// Scalar rANS (stack) coder -- bit-exact with stack.rs:1014-1100.
// Generic over (word_bits W, state_bits S <= 64, precision P).
// ---------------------------------------------------------------------------

struct AnsState {
    uint64_t state;
    int64_t num_words;  // words in `words` buffer (bulk)
};

// Encode per-symbol tables in reverse order.  `words` must have capacity for
// n + S/W words.  Returns new word count.
int64_t ctpu_ans_encode_reverse(
    uint64_t* state_io, uint32_t* words, int64_t num_words,
    const uint32_t* cums, const uint32_t* probs, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t state = *state_io;
    const uint64_t word_mask = (word_bits == 64) ? ~0ull : ((1ull << word_bits) - 1);
    const int32_t shift = state_bits - precision;
    for (int64_t i = n - 1; i >= 0; i--) {
        uint64_t prob = probs[i];
        if ((state >> shift) >= prob) {
            words[num_words++] = (uint32_t)(state & word_mask);
            state >>= word_bits;
        }
        state = ((state / prob) << precision) | ((uint64_t)cums[i] + state % prob);
    }
    *state_io = state;
    return num_words;
}

// Decode with an O(1) lookup model: lookup[q] -> symbol, cdf[] -> (cum,prob).
int64_t ctpu_ans_decode_lookup(
    uint64_t* state_io, const uint32_t* words, int64_t num_words,
    const uint32_t* lookup, const uint32_t* cdf,
    int32_t* out, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t state = *state_io;
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t lower = 1ull << (state_bits - word_bits);
    for (int64_t i = 0; i < n; i++) {
        uint64_t q = state & qmask;
        uint32_t s = lookup[q];
        uint64_t cum = cdf[s], prob = (uint64_t)cdf[s + 1] - cum;
        state = (state >> precision) * prob + (q - cum);
        if (state < lower && num_words > 0) {
            state = (state << word_bits) | words[--num_words];
        }
        out[i] = (int32_t)s;
    }
    *state_io = state;
    return num_words;
}

// Decode i.i.d. with a CDF table (binary search; for precision > lookup size).
int64_t ctpu_ans_decode_cdf(
    uint64_t* state_io, const uint32_t* words, int64_t num_words,
    const uint32_t* cdf, int64_t alphabet,
    int32_t* out, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t state = *state_io;
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t lower = 1ull << (state_bits - word_bits);
    for (int64_t i = 0; i < n; i++) {
        uint32_t q = (uint32_t)(state & qmask);
        // upper_bound(cdf, q) - 1
        int64_t lo = 0, hi = alphabet;
        while (hi - lo > 1) {
            int64_t mid = (lo + hi) >> 1;
            if (cdf[mid] <= q) lo = mid; else hi = mid;
        }
        uint64_t cum = cdf[lo], prob = (uint64_t)cdf[lo + 1] - cum;
        state = (state >> precision) * prob + (q - cum);
        if (state < lower && num_words > 0) {
            state = (state << word_bits) | words[--num_words];
        }
        out[i] = (int32_t)lo;
    }
    *state_io = state;
    return num_words;
}

// Decode with a per-symbol-parameterized quantized family.
int64_t ctpu_ans_decode_quantized(
    uint64_t* state_io, const uint32_t* words, int64_t num_words,
    int32_t kind, int32_t min_sym, int32_t max_sym,
    const double* pa, const double* pb,
    int32_t* out, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t state = *state_io;
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t lower = 1ull << (state_bits - word_bits);
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));
    for (int64_t i = 0; i < n; i++) {
        QuantizedModel m{kind, min_sym, max_sym, precision, pa[i], pb[i], free_weight};
        uint32_t q = (uint32_t)(state & qmask);
        int32_t sym; uint32_t cum, prob;
        qm_qf(m, q, &sym, &cum, &prob);
        state = (state >> precision) * (uint64_t)prob + (q - cum);
        if (state < lower && num_words > 0) {
            state = (state << word_bits) | words[--num_words];
        }
        out[i] = sym;
    }
    *state_io = state;
    return num_words;
}

// ---------------------------------------------------------------------------
// Scalar range coder -- bit-exact with queue.rs:602-710 / 957-1040.
// ---------------------------------------------------------------------------

struct RangeEnc {
    uint64_t lower, range;
    uint64_t num_inverted;    // 0 => Normal situation
    uint32_t first_inverted;
};

int64_t ctpu_range_encode(
    RangeEnc* enc, uint32_t* words, int64_t num_words,
    const uint32_t* cums, const uint32_t* probs, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t lower = enc->lower, range = enc->range;
    uint64_t num_inverted = enc->num_inverted;
    uint32_t first_inverted = enc->first_inverted;
    const uint64_t word_mask = (word_bits == 64) ? ~0ull : ((1ull << word_bits) - 1);
    const int32_t top_shift = state_bits - word_bits;
    const uint64_t state_mask = (state_bits == 64) ? ~0ull : ((1ull << state_bits) - 1);
    const uint64_t lower_bound = 1ull << top_shift;

    for (int64_t i = 0; i < n; i++) {
        range_encode_step(
            lower, range, num_inverted, first_inverted,
            cums[i], probs[i], word_mask, top_shift, state_mask,
            lower_bound, word_bits, precision,
            [&](uint32_t w) { words[num_words++] = w; });
    }
    enc->lower = lower; enc->range = range;
    enc->num_inverted = num_inverted; enc->first_inverted = first_inverted;
    return num_words;
}

struct RangeDec {
    uint64_t lower, range, point;
    int64_t cursor;
};

int64_t ctpu_range_decode_lookup(
    RangeDec* dec, const uint32_t* words, int64_t total_words,
    const uint32_t* lookup, const uint32_t* cdf,
    int32_t* out, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t lower = dec->lower, range = dec->range, point = dec->point;
    int64_t cursor = dec->cursor;
    const uint64_t state_mask = (state_bits == 64) ? ~0ull : ((1ull << state_bits) - 1);
    const uint64_t lower_bound = 1ull << (state_bits - word_bits);
    const uint64_t total = 1ull << precision;

    for (int64_t i = 0; i < n; i++) {
        uint64_t scale = range >> precision;
        uint64_t q = ((point - lower) & state_mask) / scale;
        if (q >= total) {
            // InvalidData: write back the partial state (the scalar path
            // advances per symbol before raising; callers detect the error
            // by the short return count)
            dec->lower = lower; dec->range = range; dec->point = point;
            dec->cursor = cursor;
            return i;
        }
        uint32_t s = lookup[q];
        uint64_t cum = cdf[s], prob = (uint64_t)cdf[s + 1] - cum;
        lower = (lower + scale * cum) & state_mask;
        range = scale * prob;
        if (range < lower_bound) {
            lower = (lower << word_bits) & state_mask;
            range = range << word_bits;
            point = (point << word_bits) & state_mask;
            if (cursor < total_words) point |= words[cursor++];
        }
        out[i] = (int32_t)s;
    }
    dec->lower = lower; dec->range = range; dec->point = point; dec->cursor = cursor;
    return n;
}

int64_t ctpu_range_decode_quantized(
    RangeDec* dec, const uint32_t* words, int64_t total_words,
    int32_t kind, int32_t min_sym, int32_t max_sym,
    const double* pa, const double* pb,
    int32_t* out, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t lower = dec->lower, range = dec->range, point = dec->point;
    int64_t cursor = dec->cursor;
    const uint64_t state_mask = (state_bits == 64) ? ~0ull : ((1ull << state_bits) - 1);
    const uint64_t lower_bound = 1ull << (state_bits - word_bits);
    const uint64_t total = 1ull << precision;
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));

    for (int64_t i = 0; i < n; i++) {
        uint64_t scale = range >> precision;
        uint64_t q = ((point - lower) & state_mask) / scale;
        if (q >= total) {
            dec->lower = lower; dec->range = range; dec->point = point;
            dec->cursor = cursor;
            return i;
        }
        QuantizedModel m{kind, min_sym, max_sym, precision, pa[i], pb[i], free_weight};
        int32_t sym; uint32_t cum, prob;
        qm_qf(m, (uint32_t)q, &sym, &cum, &prob);
        lower = (lower + scale * cum) & state_mask;
        range = scale * (uint64_t)prob;
        if (range < lower_bound) {
            lower = (lower << word_bits) & state_mask;
            range = range << word_bits;
            point = (point << word_bits) & state_mask;
            if (cursor < total_words) point |= words[cursor++];
        }
        out[i] = sym;
    }
    dec->lower = lower; dec->range = range; dec->point = point; dec->cursor = cursor;
    return n;
}

// ---------------------------------------------------------------------------
// ILANS v2: shared-stream interleaved rANS (see ops/interleaved2.py).
// States are seeded at 2^(S-W); the stream is written in decode-consumption
// order (per step, refilling lanes ascending).
// ---------------------------------------------------------------------------

// Returns the stream length; the stream occupies buf[cap - len .. cap).
// `states` receives the initial decoder states.  `seeds` (may be null for
// the standard 2^(S-W) floor) carries per-lane encoder start states in the
// same layout as `states` (L u32 words, or 2L (lo, hi) pairs for S > 32);
// each seed must lie in [2^(S-W), 2^S).  The decoder's lane states return
// to exactly these seeds after consuming the full stream, so seeds in
// [2^(S-W), 2^(S-W+1)) carry (S-W) recoverable payload bits per lane
// (the v2 container framing, ops/framing.py).
int64_t ctpu_ilans2_encode_seeded(
    const uint32_t* cums, const uint32_t* probs,
    int64_t num_symbols, int32_t L, int32_t num_steps,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    const uint32_t* seeds, uint32_t* states, uint32_t* buf, int64_t cap)
{
    const uint64_t word_mask = (1ull << word_bits) - 1;
    const int32_t shift = state_bits - precision;
    const uint64_t seed = 1ull << (state_bits - word_bits);

    uint64_t* st = new uint64_t[L];
    uint32_t* chunk = new uint32_t[L];
    if (seeds == nullptr) {
        for (int32_t l = 0; l < L; l++) st[l] = seed;
    } else if (state_bits > 32) {
        for (int32_t l = 0; l < L; l++)
            st[l] = (uint64_t)seeds[2 * l] | ((uint64_t)seeds[2 * l + 1] << 32);
    } else {
        for (int32_t l = 0; l < L; l++) st[l] = seeds[l];
    }

    // Round-up magic reciprocals (Granlund-Montgomery): for d <= 2^16 and
    // dividends < 2^32, m = ceil(2^48 / d) satisfies 2^48 <= m*d < 2^48 + d
    // <= 2^48 + 2^16, so floor(s*m >> 48) == s/d exactly.  One 128-bit
    // multiply replaces the hardware divide in the hot loop; the table
    // build (one divide per possible prob value) amortizes over the
    // message.  Only used when states are 64-bit-safe (state_bits <= 32
    // keeps dividends < 2^32) and the message is long enough to amortize.
    uint64_t* magic = nullptr;
    const int64_t tab = (1ll << precision) + 1;
    if (state_bits <= 32 && precision <= 16 && num_symbols >= tab) {
        magic = new uint64_t[tab];
        magic[0] = 0;
        for (int64_t d = 1; d < tab; d++)
            magic[d] = (uint64_t)((((__uint128_t)1 << 48) + d - 1) / d);
    }

    int64_t end = cap;
    for (int64_t t = num_steps - 1; t >= 0; t--) {
        const int64_t base = t * L;
        const int32_t lmax =
            (int32_t)(base + L <= num_symbols ? L : (num_symbols > base ? num_symbols - base : 0));
        int32_t k = 0;
        if (magic) {
            for (int32_t l = 0; l < lmax; l++) {
                uint64_t prob = probs[base + l];
                uint64_t s = st[l];
                // branchless renormalization (emission is data-dependent
                // ~50/50 at high entropy; a mispredicting branch costs more
                // than the always-executed store)
                uint64_t c = (s >> shift) >= prob;
                chunk[k] = (uint32_t)(s & word_mask);
                k += (int32_t)c;
                s >>= (word_bits & (-(int32_t)c));
                uint64_t q = (uint64_t)(((__uint128_t)s * magic[prob]) >> 48);
                st[l] = (q << precision) | ((uint64_t)cums[base + l] + (s - q * prob));
            }
        } else {
            for (int32_t l = 0; l < lmax; l++) {
                uint64_t prob = probs[base + l];
                uint64_t s = st[l];
                if ((s >> shift) >= prob) {
                    chunk[k++] = (uint32_t)(s & word_mask);
                    s >>= word_bits;
                }
                st[l] = ((s / prob) << precision) | ((uint64_t)cums[base + l] + s % prob);
            }
        }
        end -= k;
        for (int32_t j = 0; j < k; j++) buf[end + j] = chunk[j];
    }
    // S > 32 lane states do not fit one u32: write (lo, hi) pairs (the
    // caller passes a 2*L array), mirroring the range encoder's points.
    if (state_bits > 32) {
        for (int32_t l = 0; l < L; l++) {
            states[2 * l] = (uint32_t)(st[l] & 0xFFFFFFFFull);
            states[2 * l + 1] = (uint32_t)(st[l] >> 32);
        }
    } else {
        for (int32_t l = 0; l < L; l++) states[l] = (uint32_t)st[l];
    }
    int64_t len = cap - end;
    delete[] st;
    delete[] chunk;
    delete[] magic;
    return len;
}

int64_t ctpu_ilans2_encode(
    const uint32_t* cums, const uint32_t* probs,
    int64_t num_symbols, int32_t L, int32_t num_steps,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    uint32_t* states, uint32_t* buf, int64_t cap)
{
    return ctpu_ilans2_encode_seeded(
        cums, probs, num_symbols, L, num_steps, word_bits, state_bits,
        precision, nullptr, states, buf, cap);
}

// Shared-stream interleaved rANS decode for S > 32 (u64 lane states as
// (lo, hi) u32 pairs) with a CDF binary search instead of the 2^P lookup
// table (default-preset P = 24 would need a 64 MB table).  Same schedule
// as ctpu_ilans2_decode_lookup.
void ctpu_ilans2_decode_cdf64(
    uint32_t* init_states_pairs, const uint32_t* stream,
    int64_t stream_len, int64_t num_symbols, int32_t L, int32_t num_steps,
    const uint32_t* cdf, int32_t num_boundaries,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    int32_t* out)
{
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t lower = 1ull << (state_bits - word_bits);
    uint64_t* st = new uint64_t[L];
    for (int32_t l = 0; l < L; l++) {
        st[l] = (uint64_t)init_states_pairs[2 * l]
              | ((uint64_t)init_states_pairs[2 * l + 1] << 32);
    }
    int64_t base = 0;
    const int32_t K = num_boundaries - 1;

    for (int64_t t = 0; t < num_steps; t++) {
        const int64_t b0 = t * L;
        const int32_t lmax =
            (int32_t)(b0 + L <= num_symbols ? L : (num_symbols > b0 ? num_symbols - b0 : 0));
        for (int32_t l = 0; l < lmax; l++) {
            uint64_t s = st[l];
            uint64_t q = s & qmask;
            // branchless binary search: largest sym with cdf[sym] <= q
            int32_t lo = 0, span = K;
            while (span > 1) {
                int32_t half = span >> 1;
                lo += (cdf[lo + half] <= q) ? half : 0;
                span -= half;
            }
            uint32_t sym = (uint32_t)lo;
            uint64_t cum = cdf[sym], prob = (uint64_t)cdf[sym + 1] - cum;
            s = (s >> precision) * prob + (q - cum);
            if (s < lower && base < stream_len) {
                s = (s << word_bits) | stream[base++];
            }
            st[l] = s;
            out[b0 + l] = (int32_t)sym;
        }
    }
    // final lane states back into the caller's array: after a full decode
    // these equal the encoder's seeds, whose low S-W bits are recoverable
    // payload under the v2 container framing (ops/framing.py)
    for (int32_t l = 0; l < L; l++) {
        init_states_pairs[2 * l] = (uint32_t)(st[l] & 0xFFFFFFFFull);
        init_states_pairs[2 * l + 1] = (uint32_t)(st[l] >> 32);
    }
    delete[] st;
}

// Two-level variant of ctpu_ilans2_decode_cdf64: `l1` has (1 << l1_bits) + 1
// entries; l1[i] is the largest symbol whose left cumulative is
// <= (i << (precision - l1_bits)).  The per-symbol search is confined to the
// bucket's symbol span [l1[b], l1[b+1]] -- for alphabets much smaller than
// the bucket count the span is almost always 1 and the while loop never
// runs, replacing the log2(K)-deep branchless search with one table read.
// (The reference's O(1) lookup decoder, lookup_contiguous.rs:564-595, needs
// a 2^P-entry table -- 64 MB at the default precision 24; the l1 table at
// l1_bits = 16 is 256 KB and cache-resident.)
void ctpu_ilans2_decode_cdf64_l1(
    uint32_t* init_states_pairs, const uint32_t* stream,
    int64_t stream_len, int64_t num_symbols, int32_t L, int32_t num_steps,
    const uint32_t* cdf, int32_t num_boundaries,
    const uint32_t* l1, int32_t l1_bits,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    int32_t* out)
{
    (void)num_boundaries;
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t lower = 1ull << (state_bits - word_bits);
    const int32_t shift = precision - l1_bits;
    uint64_t* st = new uint64_t[L];
    for (int32_t l = 0; l < L; l++) {
        st[l] = (uint64_t)init_states_pairs[2 * l]
              | ((uint64_t)init_states_pairs[2 * l + 1] << 32);
    }
    int64_t base = 0;

    for (int64_t t = 0; t < num_steps; t++) {
        const int64_t b0 = t * L;
        const int32_t lmax =
            (int32_t)(b0 + L <= num_symbols ? L : (num_symbols > b0 ? num_symbols - b0 : 0));
        for (int32_t l = 0; l < lmax; l++) {
            uint64_t s = st[l];
            uint64_t q = s & qmask;
            uint32_t b = (uint32_t)(q >> shift);
            int32_t lo = (int32_t)l1[b];
            int32_t span = (int32_t)l1[b + 1] - lo + 1;
            while (span > 1) {
                int32_t half = span >> 1;
                lo += (cdf[lo + half] <= q) ? half : 0;
                span -= half;
            }
            uint32_t sym = (uint32_t)lo;
            uint64_t cum = cdf[sym], prob = (uint64_t)cdf[sym + 1] - cum;
            s = (s >> precision) * prob + (q - cum);
            if (s < lower && base < stream_len) {
                s = (s << word_bits) | stream[base++];
            }
            st[l] = s;
            out[b0 + l] = (int32_t)sym;
        }
    }
    // final lane states back into the caller's array: after a full decode
    // these equal the encoder's seeds, whose low S-W bits are recoverable
    // payload under the v2 container framing (ops/framing.py)
    for (int32_t l = 0; l < L; l++) {
        init_states_pairs[2 * l] = (uint32_t)(st[l] & 0xFFFFFFFFull);
        init_states_pairs[2 * l + 1] = (uint32_t)(st[l] >> 32);
    }
    delete[] st;
}

void ctpu_ilans2_decode_lookup(
    uint32_t* init_states, const uint32_t* stream, int64_t stream_len,
    int64_t num_symbols, int32_t L, int32_t num_steps,
    const uint32_t* lookup, const uint32_t* cdf,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    int32_t* out)
{
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t lower = 1ull << (state_bits - word_bits);
    uint64_t* st = new uint64_t[L];
    for (int32_t l = 0; l < L; l++) st[l] = init_states[l];
    int64_t base = 0;

    // NOTE: the refill stays a branch on purpose -- speculation breaks the
    // serial dependency on `base` across lanes; a branchless cmov chain
    // measured 20% slower.
    for (int64_t t = 0; t < num_steps; t++) {
        const int64_t b0 = t * L;
        const int32_t lmax =
            (int32_t)(b0 + L <= num_symbols ? L : (num_symbols > b0 ? num_symbols - b0 : 0));
        for (int32_t l = 0; l < lmax; l++) {
            uint64_t s = st[l];
            uint64_t q = s & qmask;
            uint32_t sym = lookup[q];
            uint64_t cum = cdf[sym], prob = (uint64_t)cdf[sym + 1] - cum;
            s = (s >> precision) * prob + (q - cum);
            if (s < lower && base < stream_len) {
                s = (s << word_bits) | stream[base++];
            }
            st[l] = s;
            out[b0 + l] = (int32_t)sym;
        }
    }
    // final lane states back into the caller's array (v2 framing payload
    // recovery; see ctpu_ilans2_decode_cdf64)
    for (int32_t l = 0; l < L; l++) init_states[l] = (uint32_t)st[l];
    delete[] st;
}

// Checkpoint-capturing twin of ctpu_ilans2_decode_lookup: every `interval`
// steps, the decoder snapshot (stream word offset, all L lane states) is
// recorded BEFORE the step runs -- snapshot c covers decoding from symbol
// c * interval * L on.  A snapshot is a complete coder state: seeding a
// fresh decode with (states, stream[offset:]) reproduces the suffix
// bit-exactly (host or Pallas).  This is the interleaved analog of the
// reference's Pos/Seek jump tables (stack.rs:643-700, lib.rs:425-580).
void ctpu_ilans2_decode_ckpt(
    const uint32_t* init_states, const uint32_t* stream, int64_t stream_len,
    int64_t num_symbols, int32_t L, int32_t num_steps,
    const uint32_t* lookup, const uint32_t* cdf,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    int32_t* out,
    int64_t interval, int64_t* ckpt_base, uint32_t* ckpt_states)
{
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t lower = 1ull << (state_bits - word_bits);
    uint64_t* st = new uint64_t[L];
    for (int32_t l = 0; l < L; l++) st[l] = init_states[l];
    int64_t base = 0;
    int64_t c = 0;

    for (int64_t t = 0; t < num_steps; t++) {
        if (interval > 0 && t > 0 && t % interval == 0) {
            ckpt_base[c] = base;
            for (int32_t l = 0; l < L; l++)
                ckpt_states[c * L + l] = (uint32_t)st[l];
            c++;
        }
        const int64_t b0 = t * L;
        const int32_t lmax =
            (int32_t)(b0 + L <= num_symbols ? L : (num_symbols > b0 ? num_symbols - b0 : 0));
        for (int32_t l = 0; l < lmax; l++) {
            uint64_t s = st[l];
            uint64_t q = s & qmask;
            uint32_t sym = lookup[q];
            uint64_t cum = cdf[sym], prob = (uint64_t)cdf[sym + 1] - cum;
            s = (s >> precision) * prob + (q - cum);
            if (s < lower && base < stream_len) {
                s = (s << word_bits) | stream[base++];
            }
            st[l] = s;
            out[b0 + l] = (int32_t)sym;
        }
    }
    delete[] st;
}

// Shared-stream decode with a per-symbol-parameterized quantized family.
void ctpu_ilans2_decode_quantized(
    const uint32_t* init_states, const uint32_t* stream, int64_t stream_len,
    int64_t num_symbols, int32_t L, int32_t num_steps,
    int32_t kind, int32_t min_sym, int32_t max_sym,
    const double* pa, const double* pb,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    int32_t* out)
{
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t lower = 1ull << (state_bits - word_bits);
    const double free_weight =
        (double)(((1ull << precision) - 1) - (uint64_t)((int64_t)max_sym - min_sym));
    uint64_t* st = new uint64_t[L];
    for (int32_t l = 0; l < L; l++) st[l] = init_states[l];
    int64_t base = 0;

    for (int64_t t = 0; t < num_steps; t++) {
        for (int32_t l = 0; l < L; l++) {
            int64_t idx = t * L + l;
            if (idx >= num_symbols) continue;
            uint64_t s = st[l];
            uint64_t q = s & qmask;
            QuantizedModel m{kind, min_sym, max_sym, precision, pa[idx], pb[idx], free_weight};
            int32_t sym; uint32_t cum, prob;
            qm_qf(m, (uint32_t)q, &sym, &cum, &prob);
            s = (s >> precision) * (uint64_t)prob + (q - cum);
            if (s < lower && base < stream_len) {
                s = (s << word_bits) | stream[base++];
            }
            st[l] = s;
            out[idx] = sym;
        }
    }
    delete[] st;
}

// ---------------------------------------------------------------------------
// ILANS2-R: shared-stream interleaved RANGE coding.
//
// Per-lane range coders (queue.rs algebra) with one shared word stream in
// decode-consumption order.  The decoder's refill condition
// (range < 2^(S-W)) mirrors the encoder's renormalization schedule exactly
// (range evolves identically on both sides), so slots can be assigned by
// (step, lane).  Carry resolution (the Inverted situation) only changes WHEN
// word values become known, not the schedule; the encoder resolves carries
// into its per-lane word list and then fills slots.  Initial decoder points
// (S bits per lane) are stored in a header; unfilled tail slots are zeros,
// matching the reference decoder's read-past-EOF behavior (queue.rs:1030).
// ---------------------------------------------------------------------------

// Returns stream length (= total renorm events).  `points` gets the per-lane
// initial decoder points.  `stream` must have capacity >= num_steps * L.
int64_t ctpu_ilans2_range_encode(
    const uint32_t* cums, const uint32_t* probs,
    int64_t num_symbols, int32_t L, int32_t num_steps,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    uint32_t* points, uint32_t* stream)
{
    const uint64_t word_mask = (word_bits == 64) ? ~0ull : ((1ull << word_bits) - 1);
    const int32_t top_shift = state_bits - word_bits;
    const uint64_t state_mask = (state_bits == 64) ? ~0ull : ((1ull << state_bits) - 1);
    const uint64_t lower_bound = 1ull << top_shift;
    const int32_t point_words = state_bits / word_bits;

    // Per-lane encode, collecting each lane's resolved word list and the
    // step index of every renorm event.
    struct Lane {
        std::vector<uint32_t> words;
        std::vector<int64_t> renorm_steps;
    };
    std::vector<Lane> lanes((size_t)L);
    std::vector<int64_t> events_per_step((size_t)num_steps, 0);

    for (int32_t l = 0; l < L; l++) {
        uint64_t lower = 0, range = state_mask;
        uint64_t num_inverted = 0;
        uint32_t first_inverted = 0;
        Lane& ln = lanes[l];
        for (int64_t t = 0; t < num_steps; t++) {
            int64_t idx = t * L + l;
            if (idx >= num_symbols) continue;
            bool renormed = range_encode_step(
                lower, range, num_inverted, first_inverted,
                cums[idx], probs[idx], word_mask, top_shift, state_mask,
                lower_bound, word_bits, precision,
                [&](uint32_t w) { ln.words.push_back(w); });
            if (renormed) {
                ln.renorm_steps.push_back(t);
                events_per_step[t]++;
            }
        }
        // Seal (queue.rs:458-523): resolves any pending Inverted run and
        // appends the point word (+ zero if ambiguous).
        if (range != state_mask) {
            uint64_t point = (lower + (lower_bound - 1)) & state_mask;
            if (num_inverted != 0) {
                uint32_t first, consecutive;
                if (point >= lower) {
                    first = first_inverted;
                    consecutive = (uint32_t)word_mask;
                } else {
                    first = (uint32_t)((first_inverted + 1) & word_mask);
                    consecutive = 0;
                }
                ln.words.push_back(first);
                for (uint64_t j = 1; j < num_inverted; j++) ln.words.push_back(consecutive);
            }
            uint32_t point_word = (uint32_t)(point >> top_shift);
            ln.words.push_back(point_word);
            uint64_t upper_word = ((lower + range) & state_mask) >> top_shift;
            if ((uint32_t)upper_word == point_word) ln.words.push_back(0);
        }
    }

    // Initial decoder points: the first S/W words of each lane's list,
    // left-aligned with zero fill (queue.rs:847-868 read_point).  For
    // state_bits > 32 the point does not fit one u32: the caller passes a
    // 2*L array and lane l's point is written as (lo, hi) at [2l, 2l+1].
    for (int32_t l = 0; l < L; l++) {
        uint64_t point = 0;
        int32_t nread = 0;
        for (; nread < point_words && nread < (int32_t)lanes[l].words.size(); nread++) {
            point = (point << word_bits) | lanes[l].words[nread];
        }
        if (nread < point_words && nread != 0) {
            point <<= (state_bits - nread * word_bits);
        }
        if (state_bits > 32) {
            points[2 * l] = (uint32_t)(point & 0xFFFFFFFFull);
            points[2 * l + 1] = (uint32_t)(point >> 32);
        } else {
            points[l] = (uint32_t)point;
        }
    }

    // Slot assembly: the r-th renorm of lane l consumes the lane's word at
    // index point_words + r (zeros past the end of the lane's word list).
    std::vector<int64_t> step_base((size_t)num_steps + 1, 0);
    for (int64_t t = 0; t < num_steps; t++) step_base[t + 1] = step_base[t] + events_per_step[t];
    std::vector<int64_t> cursor = step_base;  // per-step fill cursor
    for (int32_t l = 0; l < L; l++) {
        Lane& ln = lanes[l];
        for (size_t r = 0; r < ln.renorm_steps.size(); r++) {
            int64_t t = ln.renorm_steps[r];
            size_t widx = (size_t)point_words + r;
            uint32_t w = widx < ln.words.size() ? ln.words[widx] : 0;
            stream[cursor[t]++] = w;
        }
    }
    return step_base[num_steps];
}

// Returns -1 on success or the index of the first symbol whose quantile is
// >= 2^precision (InvalidData, queue.rs:991-993) -- corrupt input must not
// index past the 2^P-entry lookup table.
int64_t ctpu_ilans2_range_decode_lookup(
    const uint32_t* points, const uint32_t* stream, int64_t stream_len,
    int64_t num_symbols, int32_t L, int32_t num_steps,
    const uint32_t* lookup, const uint32_t* cdf,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    int32_t* out)
{
    const uint64_t state_mask = (state_bits == 64) ? ~0ull : ((1ull << state_bits) - 1);
    const uint64_t lower_bound = 1ull << (state_bits - word_bits);
    std::vector<uint64_t> lows((size_t)L, 0), rngs((size_t)L, state_mask), pts((size_t)L);
    for (int32_t l = 0; l < L; l++) pts[l] = points[l];
    int64_t base = 0;

    for (int64_t t = 0; t < num_steps; t++) {
        for (int32_t l = 0; l < L; l++) {
            int64_t idx = t * L + l;
            if (idx >= num_symbols) continue;
            uint64_t scale = rngs[l] >> precision;
            uint64_t q = ((pts[l] - lows[l]) & state_mask) / scale;
            if ((q >> precision) != 0) return idx;
            uint32_t sym = lookup[q];
            uint64_t cum = cdf[sym], prob = (uint64_t)cdf[sym + 1] - cum;
            lows[l] = (lows[l] + scale * cum) & state_mask;
            rngs[l] = scale * prob;
            if (rngs[l] < lower_bound) {
                lows[l] = (lows[l] << word_bits) & state_mask;
                rngs[l] = rngs[l] << word_bits;
                pts[l] = (pts[l] << word_bits) & state_mask;
                if (base < stream_len) pts[l] |= stream[base++];
            }
            out[idx] = (int32_t)sym;
        }
    }
    return -1;
}

// Width-generic shared-stream range decode (ILANS2-R / -R64) with the
// two-level CDF search (see ctpu_ilans2_decode_cdf64_l1).  Points arrive as
// (lo, hi) u32 pairs per lane (hi = 0 for state_bits <= 32).  For
// precision <= l1_bits the bucket table IS the quantile lookup (span is 1
// or 2).  Returns -1 on success or the index of the first symbol whose
// quantile is >= 2^precision -- the reference's InvalidData condition
// (queue.rs:991-993).
int64_t ctpu_ilans2_range_decode_cdf_l1(
    const uint32_t* points_pairs, const uint32_t* stream, int64_t stream_len,
    int64_t num_symbols, int32_t L, int32_t num_steps,
    const uint32_t* cdf, int32_t num_boundaries,
    const uint32_t* l1, int32_t l1_bits,
    int32_t word_bits, int32_t state_bits, int32_t precision,
    int32_t* out)
{
    (void)num_boundaries;
    const uint64_t state_mask =
        (state_bits == 64) ? ~0ull : ((1ull << state_bits) - 1);
    const uint64_t lower_bound = 1ull << (state_bits - word_bits);
    const int32_t shift = precision - l1_bits;
    std::vector<uint64_t> lows((size_t)L, 0), rngs((size_t)L, state_mask),
        pts((size_t)L);
    for (int32_t l = 0; l < L; l++) {
        pts[l] = (uint64_t)points_pairs[2 * l]
               | ((uint64_t)points_pairs[2 * l + 1] << 32);
    }
    int64_t base = 0;

    for (int64_t t = 0; t < num_steps; t++) {
        const int64_t b0 = t * L;
        const int32_t lmax =
            (int32_t)(b0 + L <= num_symbols ? L : (num_symbols > b0 ? num_symbols - b0 : 0));
        for (int32_t l = 0; l < lmax; l++) {
            uint64_t scale = rngs[l] >> precision;
            uint64_t q = ((pts[l] - lows[l]) & state_mask) / scale;
            if (q >> precision) return b0 + l;  // InvalidData
            int32_t lo = (int32_t)l1[q >> shift];
            int32_t span = (int32_t)l1[(q >> shift) + 1] - lo + 1;
            while (span > 1) {
                int32_t half = span >> 1;
                lo += (cdf[lo + half] <= q) ? half : 0;
                span -= half;
            }
            uint32_t sym = (uint32_t)lo;
            uint64_t cum = cdf[sym], prob = (uint64_t)cdf[sym + 1] - cum;
            lows[l] = (lows[l] + scale * cum) & state_mask;
            rngs[l] = scale * prob;
            if (rngs[l] < lower_bound) {
                lows[l] = (lows[l] << word_bits) & state_mask;
                rngs[l] = rngs[l] << word_bits;
                pts[l] = (pts[l] << word_bits) & state_mask;
                if (base < stream_len) pts[l] |= stream[base++];
            }
            out[b0 + l] = (int32_t)sym;
        }
    }
    return -1;
}

// ---------------------------------------------------------------------------
// Chain coder loops (bit-exact with chain.rs:1044-1206).
// ---------------------------------------------------------------------------

struct ChainState {
    uint64_t head_compressed;   // Word-sized, nonzero
    uint64_t head_remainders;   // State-sized
    int64_t compressed_len;     // words in compressed buffer
    int64_t remainders_len;     // words in remainders buffer
};

// Decode n symbols with a lookup model; compressed words are POPPED from the
// end of `compressed`; decoded remainders words are APPENDED to `remainders`.
// Returns number decoded (< n if out of compressed data).
int64_t ctpu_chain_decode_lookup(
    ChainState* st, uint32_t* compressed, uint32_t* remainders, int64_t rem_cap,
    const uint32_t* lookup, const uint32_t* cdf,
    int32_t* out, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t hc = st->head_compressed, hr = st->head_remainders;
    int64_t clen = st->compressed_len, rlen = st->remainders_len;
    const uint64_t word_mask = (word_bits == 64) ? ~0ull : ((1ull << word_bits) - 1);
    const uint64_t qmask = (1ull << precision) - 1;
    const uint64_t flush_bound = 1ull << (state_bits - precision);

    for (int64_t i = 0; i < n; i++) {
        if (rlen >= rem_cap) {  // worst case: one flushed word per symbol
            st->head_compressed = hc; st->head_remainders = hr;
            st->compressed_len = clen; st->remainders_len = rlen; return i;
        }
        uint64_t word;
        if (precision == word_bits || hc < (1ull << precision)) {
            if (clen == 0) { st->head_compressed = hc; st->head_remainders = hr;
                             st->compressed_len = clen; st->remainders_len = rlen; return i; }
            word = compressed[--clen];
            if (precision != word_bits) {
                hc = ((hc << (word_bits - precision)) | (word >> precision)) & word_mask;
            }
        } else {
            word = hc;
            hc >>= precision;
        }
        uint64_t q = (precision == word_bits) ? word : (word & qmask);
        uint32_t s = lookup[q];
        uint64_t cum = cdf[s], prob = (uint64_t)cdf[s + 1] - cum;
        hr = hr * prob + (q - cum);
        if (hr >= flush_bound) {
            remainders[rlen++] = (uint32_t)(hr & word_mask);
            hr >>= word_bits;
        }
        out[i] = (int32_t)s;
    }
    st->head_compressed = hc; st->head_remainders = hr;
    st->compressed_len = clen; st->remainders_len = rlen;
    return n;
}

// Encode n symbols (reverse order) given tables; remainders words POPPED from
// end; compressed words APPENDED.  Returns number encoded (< n if out of
// remainders).
int64_t ctpu_chain_encode_reverse(
    ChainState* st, uint32_t* compressed, int64_t comp_cap, uint32_t* remainders,
    const uint32_t* cums, const uint32_t* probs, int64_t n,
    int32_t word_bits, int32_t state_bits, int32_t precision)
{
    uint64_t hc = st->head_compressed, hr = st->head_remainders;
    int64_t clen = st->compressed_len, rlen = st->remainders_len;
    const uint64_t word_mask = (word_bits == 64) ? ~0ull : ((1ull << word_bits) - 1);

    for (int64_t i = n - 1; i >= 0; i--) {
        if (clen >= comp_cap) {  // worst case: one emitted word per symbol
            st->head_compressed = hc; st->head_remainders = hr;
            st->compressed_len = clen; st->remainders_len = rlen;
            return n - 1 - i;
        }
        uint64_t prob = probs[i];
        if (hr < (prob << (state_bits - word_bits - precision))) {
            if (rlen == 0) { st->head_compressed = hc; st->head_remainders = hr;
                             st->compressed_len = clen; st->remainders_len = rlen; return n - 1 - i; }
            hr = (hr << word_bits) | remainders[--rlen];
        }
        uint64_t remainder = hr % prob;
        uint64_t quantile = cums[i] + remainder;
        hr /= prob;
        if (precision != word_bits && hc < (1ull << (word_bits - precision))) {
            hc = (hc << precision) | quantile;
        } else {
            uint64_t word;
            if (precision == word_bits) {
                word = quantile;
            } else {
                word = ((hc << precision) | quantile) & word_mask;
                hc >>= (word_bits - precision);
            }
            compressed[clen++] = (uint32_t)word;
        }
    }
    st->head_compressed = hc; st->head_remainders = hr;
    st->compressed_len = clen; st->remainders_len = rlen;
    return n;
}

}  // extern "C"
