// The device families' integer CDF on Hopper (sm_90a): the leaky-quantized
// cumulative of a per-symbol continuous model (gaussian, laplace, logistic,
// cauchy; mean and scale per symbol), and its inversion by bisection.
// Shared by ilans2_family.cu (rANS; its decode inverts a thread's lanes in
// lock step, FamilyModel) and tchain.cu (bits-back, through invert).
//
// Replaces the in-kernel helpers of constriction_tpu/ops/pallas_family.py
// (_t_fixed, _exp2_neg, _mag, _floor_div_small, _atan_fix, _ctrunc,
// _left_fn, _invert_family) and must give the same integers as their numpy
// forms, because the values are the wire format.  Two rules keep it so:
//
// - the float part (the standardized argument and the small floor
//   division) uses the round-to-nearest intrinsics __fsub_rn, __fmul_rn,
//   __fdiv_rn, which the compiler never contracts into fused
//   multiply-adds, and the truncating __float2int_rz;
// - the integer part is plain `int`: every product stays below 2^31 and
//   `>>` on a negative value is arithmetic, as in numpy.
//
// The family is a template parameter (0 gaussian, 1 laplace, 2 logistic,
// 3 cauchy: the order of ops/family.py's FAMILIES).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace family {

constexpr int kFx = 12;  // fixed-point fraction bits = the coder's precision
constexpr int kOne = 1 << kFx;
constexpr int kP0 = 261640, kP1 = 174919, kP2 = 44856;  // 2^(-x) quadratic
constexpr int kPg = 6;
constexpr int kLog2e = 5909;
constexpr int kGa = 6536, kGb = 292;  // gaussian: sigma(a t + b t^3)
constexpr int kCa = 1147;             // cauchy: atan(x) ~ x / (1 + .28 x^2)
constexpr int kPi2Eff = 6398, kPiEff = 12796;

enum Family { kGaussian = 0, kLaplace = 1, kLogistic = 2, kCauchy = 3 };

// The model of one lane at one step.
struct Model {
  float mean;
  float inv_scale;  // 1 / scale, correctly rounded
};

__device__ __forceinline__ Model load_model(const float* __restrict__ means,
                                            const float* __restrict__ scales,
                                            int64_t i) {
  return Model{means[i], __fdiv_rn(1.0f, scales[i])};
}

// Fixed-point standardized argument, clamped to [-8, 8) scales.
__device__ __forceinline__ int t_fixed(int x, Model m) {
  float tf = __fmul_rn(
      __fsub_rn(__fsub_rn(__int2float_rn(x), 0.5f), m.mean), m.inv_scale);
  tf = __fmul_rn(tf, 4096.0f);
  tf = fminf(fmaxf(tf, -32768.0f), 32767.0f);
  return __float2int_rz(tf);
}

// ~ 4096 * e^-(mag / 4096), non-increasing in mag >= 0.
__device__ __forceinline__ int exp2_neg(int mag) {
  const int m = (mag * kLog2e) >> kFx;
  const int xi = min(m >> kFx, 25);
  const int xfr = m & (kOne - 1);
  const int poly = kP0 - ((kP1 * xfr) >> kFx) +
                   ((kP2 * ((xfr * xfr) >> kFx)) >> kFx);
  return poly >> (kPg + xi);
}

template <int F>
__device__ __forceinline__ int mag(int u) {
  if (F == kGaussian) {
    const int u2 = (u * u) >> kFx;
    const int u3 = ((u2 >> 4) * u) >> (kFx - 4);
    return ((kGa * u) >> kFx) + ((kGb * u3) >> kFx);
  }
  return u;
}

// floor(num / den) as the numpy form computes it: a correctly rounded
// float32 divide and one integer correction.
__device__ __forceinline__ int floor_div_small(int num, int den) {
  int qh = __float2int_rz(__fdiv_rn(__int2float_rn(num), __int2float_rn(den)));
  const int r = num - qh * den;
  qh += r >= den;
  qh -= r < 0;
  return qh;
}

__device__ __forceinline__ int atan_small(int v) {
  const int v2 = (v * v) >> kFx;
  return floor_div_small(v << kFx, kOne + ((kCa * v2) >> kFx));
}

// atan(u / 4096) in units of 1/4096 rad, u >= 0: atan_small(u) up to 4096,
// pi/2 - atan_small(2^24 / u) above.  Both arguments are computed and one
// is selected, as the numpy form does, so no branch depends on u and a
// thread's lanes in lock step (FamilyModel) issue together.
__device__ __forceinline__ int atan_fix(int u) {
  const bool small = u <= kOne;
  const int inv = floor_div_small(1 << (2 * kFx), max(u, 1));
  const int a = atan_small(small ? u : min(inv, kOne));
  return small ? a : kPi2Eff - a;
}

// trunc(free * CDF(t)), monotone in t_fix.
template <int F>
__device__ __forceinline__ int ctrunc(int t_fix, int free) {
  const bool neg = t_fix < 0;
  const int u = neg ? -t_fix : t_fix;
  if (F == kCauchy) {
    const int corr = floor_div_small((free * atan_fix(u)) >> 2, kPiEff >> 2);
    const int half = free >> 1;
    return neg ? half - corr : half + corr;
  }
  const int e = exp2_neg(mag<F>(u));
  if (F == kLaplace) {
    const int v = free * e;
    return neg ? v >> (kFx + 1) : free - ((v + 8191) >> (kFx + 1));
  }
  return floor_div_small(neg ? free * e : free << kFx, kOne + e);
}

// The support of a message: symbols in [min_sym, max_sym].
struct Support {
  int min_sym;
  int max_sym;
  int free;   // 2^P - 1 - (max_sym - min_sym)
  int iters;  // bisection steps: bit_length(max_sym - min_sym)
};

inline Support make_support(int min_sym, int max_sym) {
  int iters = 0;
  for (int d = max_sym - min_sym; d > 0; d >>= 1) ++iters;
  return Support{min_sym, max_sym, kOne - 1 - (max_sym - min_sym),
                 iters > 0 ? iters : 1};
}

// Supports the kernels take: at least two symbols, and enough free weight
// to cover one unit of leakiness per symbol.
inline bool valid_support(int min_sym, int max_sym) {
  const long long d = static_cast<long long>(max_sym) - min_sym;
  return d >= 1 && kOne - 1 - d >= d + 1;
}

// left(x) for interior x in (min_sym, max_sym].
template <int F>
__device__ __forceinline__ int left(int x, Model m, int min_sym, int free) {
  return (x - min_sym) + ctrunc<F>(t_fixed(x, m), free);
}

// (cum, prob) of symbol sym, with the pinned endpoints left(min_sym) = 0
// and left(max_sym + 1) = 2^P.
template <int F>
__device__ __forceinline__ void tables(int sym, Model m, Support s,
                                       uint32_t* cum, uint32_t* prob) {
  const int lo = sym == s.min_sym ? 0 : left<F>(sym, m, s.min_sym, s.free);
  const int hi =
      sym == s.max_sym ? kOne : left<F>(sym + 1, m, s.min_sym, s.free);
  *cum = static_cast<uint32_t>(lo);
  *prob = static_cast<uint32_t>(hi - lo);
}

// Quantile q -> sym = max{x : left(x) <= q} with its (cum, prob).  The
// bisection never evaluates left(min_sym) and carries the surviving
// endpoints' values, so nothing is evaluated afterwards.
template <int F>
__device__ __forceinline__ int invert(int q, Model m, Support s,
                                      uint32_t* cum, uint32_t* prob) {
  int lo = s.min_sym, hi = s.max_sym + 1;
  int c = 0, right = kOne;
  for (int it = 0; it < s.iters; ++it) {
    const int mid = max((lo + hi) >> 1, s.min_sym + 1);
    const int lmid = left<F>(mid, m, s.min_sym, s.free);
    if (lmid <= q) {
      lo = mid;
      c = lmid;
    } else {
      hi = mid;
      right = lmid;
    }
  }
  *cum = static_cast<uint32_t>(c);
  *prob = static_cast<uint32_t>(right - c);
  return lo;
}

// Calls fn<F>(args...) for the runtime family index `fam`; an unknown index
// gives cudaErrorInvalidValue.  fn returns the launch's error code.
#define CTT_DISPATCH_FAMILY(fam, fn, ...)                              \
  ((fam) == family::kGaussian   ? fn<family::kGaussian>(__VA_ARGS__)   \
   : (fam) == family::kLaplace  ? fn<family::kLaplace>(__VA_ARGS__)    \
   : (fam) == family::kLogistic ? fn<family::kLogistic>(__VA_ARGS__)   \
   : (fam) == family::kCauchy   ? fn<family::kCauchy>(__VA_ARGS__)     \
                                : static_cast<int>(cudaErrorInvalidValue))

}  // namespace family
