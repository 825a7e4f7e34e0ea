// Surrogate evaluation of A ~ free * CDF for the exact-table fast path.
//
// THIS TRANSLATION UNIT IS COMPILED WITH RELAXED FP FLAGS (-ffast-math,
// see build.py) so g++ if-converts the float selects and vectorizes the
// window loops 4-wide AVX2 -- scalar Horner latency (~15 fma deep) would
// otherwise lose to glibc's own ~35 ns erf.  That is sound here and ONLY
// here: the surrogate's single contract is an ERROR BOUND (|A - exact| far
// below the trunc-ambiguity margin, validated by the surrogate-bound test
// in the JAX package's tests/test_exact_family.py); every integer decision taken from A is
// re-derived with exact glibc evaluations whenever A is margin-close to a
// boundary (codec.cpp qm_tv_margined / qm_ge), so the OUTPUT is
// bit-identical to the pure path no matter what value A takes.  codec.cpp
// itself keeps strict flags (-ffp-contract=off).
//
// Surrogate accuracy (Chebyshev fits, coefficients generated with scipy):
// erf <= ~4e-15 abs, erfc branch <= ~4e-12 abs, atan <= ~3e-14 abs,
// exp <= ~1e-14 rel; free <= 2^24 puts |A - Y| <= ~6e-5 -- a >8000x
// safety factor under the 2^-9 margin.

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

static const double SQRT_2S = 1.41421356237309504880168872420969808;

static const double C_ERF[13] = {
    1.12837916709551456e+00, -3.76126389032917119e-01, 1.12837916756339349e-01,
    -2.68661713833858451e-02, 5.22398368496215272e-03, -8.54862547085402224e-04,
    1.20648117470194637e-04, -1.51269071388316866e-05, 1.93514562377730892e-06,
    -4.40843970696300705e-07, 1.85114372069329434e-07, -6.18344640042375854e-08,
    9.58439555071015393e-09,
};
static const double C_ERFC_G[15] = {
    5.64185754490934221e-01, 1.58037007709310381e-04, -2.85051816944363767e-01,
    3.32108286928615923e-02, 1.73763316271747986e-01, 1.31525511993783395e+00,
    -6.00726102275856455e+00, 1.30591954849878462e+01, -1.86885438275975169e+01,
    1.90648631741469714e+01, -1.40957221367313412e+01, 7.42929053165331332e+00,
    -2.65628245666613250e+00, 5.78508774119375624e-01, -5.79861844447834632e-02,
};
static const double C_ATAN[17] = {
    9.99999999999994449e-01, -3.33333333330076309e-01, 1.99999999678049267e-01,
    -1.42857130096936707e-01, 1.11110842527539055e-01, -9.09056325307180807e-02,
    7.68934343987882213e-02, -6.64879398355174567e-02, 5.80358527801216884e-02,
    -5.00219591990031173e-02, 4.09747564554019533e-02, -3.02209514526401990e-02,
    1.88308640764455158e-02, -9.23774738272707327e-03, 3.27528064858460723e-03,
    -7.36310963610188173e-04, 7.81376237794734283e-05,
};

#define SURR_LOG2E 1.4426950408889634074
#define SURR_LN2_HI 6.93147180369123816490e-01
#define SURR_LN2_LO 1.90821492927058770002e-10
#define SURR_MAGIC 0x1.8p52

// e^r for |r| <= 0.3467 times 2^k, with (k, r) from the magic-number
// reduction of x; ~1e-14 relative.  Expanded inline in the loops below.
#define SURR_EXP_BODY(x, out)                                              \
    do {                                                                   \
        double zf_ = __builtin_fma((x), SURR_LOG2E, SURR_MAGIC);           \
        double kf_ = zf_ - SURR_MAGIC;                                     \
        double r_ = __builtin_fma(-kf_, SURR_LN2_HI, (x));                 \
        r_ = __builtin_fma(-kf_, SURR_LN2_LO, r_);                         \
        double q_ = 1.0 / 39916800;                                        \
        q_ = __builtin_fma(q_, r_, 1.0 / 3628800);                         \
        q_ = __builtin_fma(q_, r_, 1.0 / 362880);                          \
        q_ = __builtin_fma(q_, r_, 1.0 / 40320);                           \
        q_ = __builtin_fma(q_, r_, 1.0 / 5040);                            \
        q_ = __builtin_fma(q_, r_, 1.0 / 720);                             \
        q_ = __builtin_fma(q_, r_, 1.0 / 120);                             \
        q_ = __builtin_fma(q_, r_, 1.0 / 24);                              \
        q_ = __builtin_fma(q_, r_, 1.0 / 6);                               \
        q_ = __builtin_fma(q_, r_, 0.5);                                   \
        q_ = __builtin_fma(q_, r_, 1.0);                                   \
        q_ = __builtin_fma(q_, r_, 1.0);                                   \
        uint64_t zb_;                                                      \
        std::memcpy(&zb_, &zf_, 8);                                        \
        uint64_t bits_ = (((zb_ & 0xFFFull) + 1023ull) & 0x7FFull) << 52;  \
        double sc_;                                                        \
        std::memcpy(&sc_, &bits_, 8);                                      \
        (out) = q_ * sc_;                                                  \
    } while (0)

// Family CDF bodies from the STANDARDIZED argument t (one definition,
// expanded inline in both the same-(a,b) window loop and the per-lane
// batch loop so the two entry points can never diverge; plain macros keep
// the `omp simd` loops branch-free and vectorizable).
#define SURR_CDF_GAUSS(t, cdf_out)                                         \
    do {                                                                   \
        double at_ = __builtin_fabs(t);                                    \
        double t1_ = at_ <= 1.0 ? at_ : 1.0;                               \
        double s_ = t1_ * t1_;                                             \
        double p_ = C_ERF[12];                                             \
        p_ = __builtin_fma(p_, s_, C_ERF[11]);                             \
        p_ = __builtin_fma(p_, s_, C_ERF[10]);                             \
        p_ = __builtin_fma(p_, s_, C_ERF[9]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[8]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[7]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[6]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[5]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[4]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[3]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[2]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[1]);                              \
        p_ = __builtin_fma(p_, s_, C_ERF[0]);                              \
        double e1_ = t1_ * p_;                                             \
        double tc_ = at_ < 1.0 ? 1.0 : (at_ > 6.75 ? 6.75 : at_);          \
        double u_ = 1.0 / tc_;                                             \
        double gg_ = C_ERFC_G[14];                                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[13]);                        \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[12]);                        \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[11]);                        \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[10]);                        \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[9]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[8]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[7]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[6]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[5]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[4]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[3]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[2]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[1]);                         \
        gg_ = __builtin_fma(gg_, u_, C_ERFC_G[0]);                         \
        double xx_ = -tc_ * tc_;                                           \
        double ex_;                                                        \
        SURR_EXP_BODY(xx_, ex_);                                           \
        double erfc2_ = gg_ * ex_ * u_;                                    \
        double e_ = at_ <= 1.0 ? e1_ : 1.0 - erfc2_;                       \
        e_ = at_ > 6.75 ? 1.0 : e_;                                        \
        e_ = (t) < 0.0 ? -e_ : e_;                                         \
        (cdf_out) = 0.5 * (1.0 + e_);                                      \
    } while (0)

#define SURR_CDF_LAPLACE(t, cdf_out)                                       \
    do {                                                                   \
        double x_ = -__builtin_fabs(t);                                    \
        /* clamp far above f64 underflow: e^-40 ~ 4e-18 puts A ~ 1e-10, */ \
        /* orders below the ambiguity margin, and keeps the exponent    */ \
        /* bit-assembly inside the normal range                         */ \
        x_ = x_ < -40.0 ? -40.0 : x_;                                      \
        double e_;                                                         \
        SURR_EXP_BODY(x_, e_);                                             \
        (cdf_out) = (t) < 0.0 ? 0.5 * e_ : 1.0 - 0.5 * e_;                 \
    } while (0)

#define SURR_CDF_CAUCHY(t, cdf_out)                                        \
    do {                                                                   \
        double av_ = __builtin_fabs(t);                                    \
        double vin_ = av_ <= 1.0 ? av_ : 1.0 / av_;                        \
        double w_ = vin_ * vin_;                                           \
        double p_ = C_ATAN[16];                                            \
        p_ = __builtin_fma(p_, w_, C_ATAN[15]);                            \
        p_ = __builtin_fma(p_, w_, C_ATAN[14]);                            \
        p_ = __builtin_fma(p_, w_, C_ATAN[13]);                            \
        p_ = __builtin_fma(p_, w_, C_ATAN[12]);                            \
        p_ = __builtin_fma(p_, w_, C_ATAN[11]);                            \
        p_ = __builtin_fma(p_, w_, C_ATAN[10]);                            \
        p_ = __builtin_fma(p_, w_, C_ATAN[9]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[8]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[7]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[6]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[5]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[4]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[3]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[2]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[1]);                             \
        p_ = __builtin_fma(p_, w_, C_ATAN[0]);                             \
        double r_ = vin_ * p_;                                             \
        double ab_ = av_ <= 1.0 ? r_ : 1.5707963267948966 - r_;            \
        double at2_ = (t) < 0.0 ? -ab_ : ab_;                              \
        (cdf_out) = 0.5 + at2_ * 0.31830988618379067154;                   \
    } while (0)


// A[j] ~ free * CDF at s = s0 + j for j in [0, m); kinds match codec.cpp's
// DistKind (0 gaussian, 1 laplace, 2 cauchy).
void ctpu_surrogate_window(
    int32_t kind, double a, double b, double free_weight,
    int64_t s0, int64_t m, double* A)
{
    const int mm = (int)m;
    if (kind == 0) {  // gaussian
        const double inv = 1.0 / (b * SQRT_2S);
        const double off = ((double)s0 - 0.5 - a) * inv;
#pragma omp simd
        for (int j = 0; j < mm; j++) {
            double t = __builtin_fma((double)j, inv, off);
            double cdf;
            SURR_CDF_GAUSS(t, cdf);
            A[j] = free_weight * cdf;
        }
    } else if (kind == 1) {  // laplace
        const double inv = 1.0 / b;
        const double off = ((double)s0 - 0.5 - a) * inv;
#pragma omp simd
        for (int j = 0; j < mm; j++) {
            double t = __builtin_fma((double)j, inv, off);
            double cdf;
            SURR_CDF_LAPLACE(t, cdf);
            A[j] = free_weight * cdf;
        }
    } else {  // cauchy
        const double inv = 1.0 / b;
        const double off = ((double)s0 - 0.5 - a) * inv;
#pragma omp simd
        for (int j = 0; j < mm; j++) {
            double t = __builtin_fma((double)j, inv, off);
            double cdf;
            SURR_CDF_CAUCHY(t, cdf);
            A[j] = free_weight * cdf;
        }
    }
}

// Per-lane batch evaluation: A[i] ~ free * CDF(x[i]) with PER-LANE
// (a[i], b[i]) parameters -- the block-synchronous ncore bisection
// (codec.cpp) evaluates a different symbol position per lane each
// iteration, so the window form above does not apply.
void ctpu_surrogate_eval_batch(
    int32_t kind, const double* a, const double* b, double free_weight,
    const double* x, int64_t n, double* A)
{
    const int nn = (int)n;
    if (kind == 0) {  // gaussian
#pragma omp simd
        for (int i = 0; i < nn; i++) {
            double t = (x[i] - a[i]) / (b[i] * SQRT_2S);
            double cdf;
            SURR_CDF_GAUSS(t, cdf);
            A[i] = free_weight * cdf;
        }
    } else if (kind == 1) {  // laplace
#pragma omp simd
        for (int i = 0; i < nn; i++) {
            double t = (x[i] - a[i]) / b[i];
            double cdf;
            SURR_CDF_LAPLACE(t, cdf);
            A[i] = free_weight * cdf;
        }
    } else {  // cauchy
#pragma omp simd
        for (int i = 0; i < nn; i++) {
            double t = (x[i] - a[i]) / b[i];
            double cdf;
            SURR_CDF_CAUCHY(t, cdf);
            A[i] = free_weight * cdf;
        }
    }
}

}  // extern "C"
