"""LeakyQuantizer: exactly-invertible fixed-point quantization of float CDFs.

Reproduces the reference's quantization contract
(the reference's src/stream/model/quantize.rs:284-308, 525-568) verbatim:

- ``free_weight = (2**P - 1) - (max - min)`` as f64,
- for symbol ``s`` in ``[min, max]`` with ``slack = s - min``::

    left(s)  = 0                                   if s == min
             = trunc(free * CDF(s - 0.5)) + slack  otherwise
    right(s) = 2**P                                if s == max
             = trunc(free * CDF(s + 0.5)) + slack + 1 otherwise
    prob(s)  = right(s) - left(s)

  where ``trunc`` is the truncating f64 -> uint cast and the CDF is evaluated
  in f64.

Decoding inverts the quantile via binary search on the monotone boundary
function ``b(s) = left(s)`` (``b(max+1) = 2**P``); leakiness guarantees
``prob >= 1`` so the containing interval is unique.  The reference's
exponential-search-from-PPF-guess (quantize.rs:580-779) finds the same unique
symbol; only speed differs, never the bitstream.

:meth:`QuantizedFamily.ecp_all` runs the host codec's
``ctpu_quantized_ecp`` for 64 or more symbols (a failed build raises
RuntimeError), :meth:`QuantizedFamily.ecp_all_plain` the numpy formulas
above; where the codec reports an error on its input, the numpy formulas
answer, as in the JAX package.

JAX counterpart: ``constriction_tpu/models/quantized.py``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np

from ..utils import special
from .base import EntropyModel, ImpossibleSymbol, ModelFamily


# ---------------------------------------------------------------------------
# Float distributions (CDF in f64, vectorized; PPF is only a decode guess)
# ---------------------------------------------------------------------------


class Distribution:
    """A float distribution with a vectorized f64 CDF and an approximate PPF."""

    def cdf(self, x) -> np.ndarray:
        raise NotImplementedError

    def ppf(self, xi) -> np.ndarray:
        raise NotImplementedError


class Gaussian(Distribution):
    def __init__(self, mean: float, std: float):
        if not std > 0.0 or not math.isfinite(mean):
            raise ValueError("Invalid model parameter: `std` must be positive.")
        self.mean = float(mean)
        self.std = float(std)

    def cdf(self, x):
        return special.gaussian_cdf(x, self.mean, self.std)

    def ppf(self, xi):
        return special.gaussian_ppf(xi, self.mean, self.std)


class Laplace(Distribution):
    def __init__(self, mean: float, scale: float):
        if not scale > 0.0 or not math.isfinite(mean):
            raise ValueError("Invalid model parameter: `scale` must be positive.")
        self.mean = float(mean)
        self.scale = float(scale)

    def cdf(self, x):
        return special.laplace_cdf(x, self.mean, self.scale)

    def ppf(self, xi):
        return special.laplace_ppf(xi, self.mean, self.scale)


class Cauchy(Distribution):
    def __init__(self, loc: float, scale: float):
        if not scale > 0.0 or not math.isfinite(loc):
            raise ValueError("Invalid model parameter: `scale` must be positive.")
        self.loc = float(loc)
        self.scale = float(scale)

    def cdf(self, x):
        return special.cauchy_cdf(x, self.loc, self.scale)

    def ppf(self, xi):
        return special.cauchy_ppf(xi, self.loc, self.scale)


class Binomial(Distribution):
    def __init__(self, n: int, p: float):
        if n < 1 or not 0.0 <= p <= 1.0:
            raise ValueError("Invalid Binomial parameters.")
        self.n = int(n)
        self.p = float(p)

    def cdf(self, x):
        return special.binomial_cdf(x, self.n, self.p)

    def ppf(self, xi):
        return special.binomial_ppf(xi, self.n, self.p)


class CallbackDistribution(Distribution):
    """Wraps Python callables ``cdf(x, *params)`` / ``ppf(xi, *params)``.

    Mirrors the reference's GIL-calling SpecializedPythonDistribution
    (the reference's src/pybindings/stream/model/internals.rs:357-396): the
    callbacks receive scalar f64 arguments and must return a number.
    """

    def __init__(self, cdf_fn: Callable, ppf_fn: Callable, params: Sequence[float] = ()):
        self._cdf = cdf_fn
        self._ppf = ppf_fn
        self._params = tuple(float(p) for p in params)

    def cdf(self, x):
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 0:
            return np.float64(self._cdf(float(x), *self._params))
        # try ONE vectorized callback invocation (scipy / numpy callbacks);
        # verify against the scalar contract on a probe, else fall back
        try:
            out = np.asarray(self._cdf(x, *self._params), dtype=np.float64)
            if out.shape == x.shape and x.size:
                i0 = x.size // 2
                probe = float(self._cdf(float(x.ravel()[i0]), *self._params))
                pv = out.ravel()[i0]
                if probe == pv or (np.isnan(probe) and np.isnan(pv)):
                    return out
        except Exception:
            pass
        return np.array(
            [float(self._cdf(float(v), *self._params)) for v in x.ravel()],
            dtype=np.float64,
        ).reshape(x.shape)

    def ppf(self, xi):
        xi = np.asarray(xi, dtype=np.float64)
        if xi.ndim == 0:
            return np.float64(self._ppf(float(xi), *self._params))
        return np.array(
            [float(self._ppf(float(v), *self._params)) for v in xi.ravel()],
            dtype=np.float64,
        ).reshape(xi.shape)


# ---------------------------------------------------------------------------
# The quantizer
# ---------------------------------------------------------------------------


def _trunc_to_uint(x: np.ndarray, bits: int = 32) -> np.ndarray:
    """Truncating f64 -> uint cast with Rust `as` semantics: truncate toward
    zero, saturate to [0, 2**bits - 1], and map NaN to 0."""
    x = np.asarray(x, dtype=np.float64)
    hi = float((1 << bits) - 1)
    with np.errstate(invalid="ignore"):
        clipped = np.clip(x, 0.0, hi)
        clipped = np.where(np.isnan(x), 0.0, clipped)
    return np.trunc(clipped).astype(np.uint64)


def _trunc_to_uint_scalar(x: float, bits: int = 32) -> int:
    xf = float(x)
    if math.isnan(xf) or xf <= 0.0:
        return 0
    hi = (1 << bits) - 1
    if xf >= float(hi):
        return hi
    return int(xf)


class LeakyQuantizer:
    """Quantizer over an inclusive symbol range (quantize.rs:284-308)."""

    def __init__(self, min_symbol_inclusive: int, max_symbol_inclusive: int, precision: int = 24):
        if max_symbol_inclusive <= min_symbol_inclusive:
            raise ValueError("support must contain at least two symbols")
        support_size_minus_one = max_symbol_inclusive - min_symbol_inclusive
        max_probability = (1 << precision) - 1
        if support_size_minus_one > max_probability:
            raise ValueError(
                "The support is too large to assign a nonzero probability to each element."
            )
        self.min = int(min_symbol_inclusive)
        self.max = int(max_symbol_inclusive)
        self.precision = int(precision)
        self.free_weight = float(max_probability - support_size_minus_one)

    def quantize(self, distribution: Distribution) -> "LeakilyQuantizedDistribution":
        return LeakilyQuantizedDistribution(self, distribution)


class LeakilyQuantizedDistribution(EntropyModel):
    """A quantized float distribution (quantize.rs:391-779)."""

    def __init__(self, quantizer: LeakyQuantizer, distribution: Distribution):
        self.quantizer = quantizer
        self.inner = distribution
        self.precision = quantizer.precision

    # -- encode ---------------------------------------------------------------

    def ecp(self, symbol: int) -> Tuple[int, int]:
        q = self.quantizer
        if symbol < q.min or symbol > q.max:
            raise ImpossibleSymbol(symbol)
        slack = symbol - q.min
        if symbol == q.min:
            left = 0
        else:
            left = _trunc_to_uint_scalar(q.free_weight * float(self.inner.cdf(symbol - 0.5))) + slack
        if symbol == q.max:
            right = 1 << self.precision
        else:
            right = _trunc_to_uint_scalar(q.free_weight * float(self.inner.cdf(symbol + 0.5))) + slack + 1
        prob = right - left
        if prob <= 0:
            raise ValueError("Invalid underlying continuous probability distribution.")
        return left, prob

    def ecp_array(self, symbols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        q = self.quantizer
        symbols = np.asarray(symbols)
        if np.any((symbols < q.min) | (symbols > q.max)):
            bad = symbols[(symbols < q.min) | (symbols > q.max)][0]
            raise ImpossibleSymbol(int(bad))
        s = symbols.astype(np.float64)
        slack = (symbols.astype(np.int64) - q.min).astype(np.uint64)
        left = _trunc_to_uint(q.free_weight * self.inner.cdf(s - 0.5)) + slack
        left = np.where(symbols == q.min, np.uint64(0), left)
        right = _trunc_to_uint(q.free_weight * self.inner.cdf(s + 0.5)) + slack + np.uint64(1)
        right = np.where(symbols == q.max, np.uint64(1 << self.precision), right)
        return left, right - left

    # -- decode ---------------------------------------------------------------

    def _left_boundary(self, symbol: int) -> int:
        """b(s) = left cumulative of s; b(max+1) = 2**P."""
        q = self.quantizer
        if symbol <= q.min:
            return 0
        if symbol > q.max:
            return 1 << self.precision
        return _trunc_to_uint_scalar(q.free_weight * float(self.inner.cdf(symbol - 0.5))) + (symbol - q.min)

    def qf(self, quantile: int) -> Tuple[int, int, int]:
        q = self.quantizer
        assert 0 <= quantile < (1 << self.precision)
        # Initial guess from the approximate PPF, then bracket + binary search
        # on the exact boundary function.
        denom = float(1 << self.precision)
        guess = self.inner.ppf((quantile + 0.5) / denom)
        if not math.isfinite(float(guess)):
            guess = (q.min + q.max) // 2
        s = min(max(math.floor(float(guess)), q.min), q.max)

        lo, hi = q.min, q.max + 1  # invariant: b(lo) <= quantile < b(hi+? )
        # Establish bracket around the guess by exponential search.
        if self._left_boundary(s) <= quantile:
            lo = s
            step = 1
            while True:
                nxt = min(lo + step, q.max + 1)
                if self._left_boundary(nxt) <= quantile and nxt <= q.max:
                    lo = nxt
                    step <<= 1
                else:
                    hi = nxt
                    break
        else:
            hi = s
            step = 1
            while True:
                nxt = max(hi - step, q.min)
                if self._left_boundary(nxt) > quantile:
                    hi = nxt
                    step <<= 1
                else:
                    lo = nxt
                    break
        # Binary search: find largest s in [lo, hi] with b(s) <= quantile.
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self._left_boundary(mid) <= quantile:
                lo = mid
            else:
                hi = mid
        left = self._left_boundary(lo)
        right = self._left_boundary(lo + 1) if lo < q.max else (1 << self.precision)
        prob = right - left
        if prob <= 0:
            raise ValueError("Invalid underlying probability distribution.")
        return lo, left, prob

    # -- iteration -------------------------------------------------------------

    def symbol_table(self):
        q = self.quantizer
        symbols = np.arange(q.min, q.max + 1, dtype=np.int64)
        cums, probs = self.ecp_array(symbols)
        for s, c, p in zip(symbols, cums, probs):
            yield int(s), int(c), int(p)

    def support(self) -> Tuple[int, int]:
        return self.quantizer.min, self.quantizer.max


# ---------------------------------------------------------------------------
# Parameterized families (vectorized over per-symbol parameters)
# ---------------------------------------------------------------------------

_DIST_BY_KIND = {
    "gaussian": (Gaussian, special.gaussian_cdf, special.gaussian_ppf),
    "laplace": (Laplace, special.laplace_cdf, special.laplace_ppf),
    "cauchy": (Cauchy, special.cauchy_cdf, special.cauchy_ppf),
}


class QuantizedFamily(ModelFamily):
    """Family of leakily quantized two-parameter distributions.

    `kind` in {gaussian, laplace, cauchy}; `param_a`/`param_b` are per-symbol
    f64 arrays (mean/std, mean/scale, loc/scale respectively).
    """

    def __init__(self, kind: str, min_sym: int, max_sym: int, param_a, param_b, precision: int = 24):
        self.kind = kind
        self.quantizer = LeakyQuantizer(min_sym, max_sym, precision)
        self.param_a = np.asarray(param_a, dtype=np.float64)
        self.param_b = np.asarray(param_b, dtype=np.float64)
        if self.param_a.shape != self.param_b.shape or self.param_a.ndim != 1:
            raise ValueError("Model parameters have unequal shape")
        self.size = len(self.param_a)
        self._cls, self._cdf, self._ppf = _DIST_BY_KIND[kind]

    def concrete(self, i: int) -> LeakilyQuantizedDistribution:
        return self.quantizer.quantize(
            self._cls(float(self.param_a[i]), float(self.param_b[i]))
        )

    def _check_symbols(self, symbols: np.ndarray) -> None:
        q = self.quantizer
        if len(symbols) != self.size:
            raise ValueError("`symbols` argument has wrong length.")
        if np.any((symbols < q.min) | (symbols > q.max)):
            bad = symbols[(symbols < q.min) | (symbols > q.max)][0]
            raise ImpossibleSymbol(int(bad))
        if np.any(~(self.param_b > 0.0)) or np.any(~np.isfinite(self.param_a)):
            # the scalar path errors at encode time for NaN/inf means too
            # (the concrete-distribution constructors); a NaN mean would
            # otherwise encode garbage silently (CDF(NaN) -> NaN -> 0)
            raise ValueError("Invalid model parameter: scale must be positive.")

    def ecp_all(self, symbols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(cum, prob)`` u64 of each symbol under its model: the host
        codec's ``ctpu_quantized_ecp`` for 64 or more symbols, else (or
        where the codec reports an error) :meth:`ecp_all_plain`."""
        q = self.quantizer
        symbols = np.asarray(symbols)
        if len(symbols) >= 64:
            from .. import native

            self._check_symbols(symbols)
            cums = np.empty(len(symbols), dtype=np.uint32)
            probs = np.empty(len(symbols), dtype=np.uint32)
            err = native.library().ctpu_quantized_ecp(
                native.DIST_KIND[self.kind], q.min, q.max, q.precision,
                np.ascontiguousarray(symbols, dtype=np.int32),
                np.ascontiguousarray(self.param_a),
                np.ascontiguousarray(self.param_b),
                len(symbols), cums, probs,
            )
            if err == 0:
                return cums.astype(np.uint64), probs.astype(np.uint64)
        return self.ecp_all_plain(symbols)

    def ecp_all_plain(self, symbols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`ecp_all` in numpy alone."""
        q = self.quantizer
        symbols = np.asarray(symbols)
        self._check_symbols(symbols)
        s = symbols.astype(np.float64)
        slack = (symbols.astype(np.int64) - q.min).astype(np.uint64)
        left = _trunc_to_uint(q.free_weight * self._cdf(s - 0.5, self.param_a, self.param_b)) + slack
        left = np.where(symbols == q.min, np.uint64(0), left)
        right = (
            _trunc_to_uint(q.free_weight * self._cdf(s + 0.5, self.param_a, self.param_b))
            + slack
            + np.uint64(1)
        )
        right = np.where(symbols == q.max, np.uint64(1 << q.precision), right)
        return left, right - left


class BinomialFamily(ModelFamily):
    """Family of quantized Binomial(n_i, p_i) models with support 0..=n_i."""

    def __init__(self, ns, ps, precision: int = 24):
        self.ns = np.asarray(ns, dtype=np.int64)
        self.ps = np.asarray(ps, dtype=np.float64)
        if self.ns.shape != self.ps.shape or self.ns.ndim != 1:
            raise ValueError("Model parameters have unequal shape")
        self.size = len(self.ns)
        self.precision = precision

    def concrete(self, i: int) -> LeakilyQuantizedDistribution:
        n = int(self.ns[i])
        quantizer = LeakyQuantizer(0, n, self.precision)
        return quantizer.quantize(Binomial(n, float(self.ps[i])))


class CallbackFamily(ModelFamily):
    """Family of quantized CustomModel callbacks with per-symbol parameters."""

    def __init__(self, cdf_fn, ppf_fn, min_sym, max_sym, param_arrays, precision: int = 24):
        self.cdf_fn = cdf_fn
        self.ppf_fn = ppf_fn
        self.quantizer = LeakyQuantizer(min_sym, max_sym, precision)
        self.params = [np.asarray(p, dtype=np.float64) for p in param_arrays]
        sizes = {len(p) for p in self.params}
        if len(sizes) != 1:
            raise ValueError("Model parameters have unequal lengths.")
        self.size = sizes.pop()

    def concrete(self, i: int) -> LeakilyQuantizedDistribution:
        params = tuple(float(p[i]) for p in self.params)
        return self.quantizer.quantize(
            CallbackDistribution(self.cdf_fn, self.ppf_fn, params)
        )

    def ecp_all(self, symbols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized encode tables: ONE callback invocation per boundary
        side for the whole message, instead of the reference's one GIL
        callback per symbol (internals.rs:357-396) -- numpy-vectorized
        callbacks (scipy distributions, numpy lambdas) amortize to native
        speed.  Falls back to the exact per-symbol loop if the callback is
        not vectorizable or disagrees with scalar evaluation on a probe.
        """
        q = self.quantizer
        symbols = np.asarray(symbols)
        if len(symbols) != self.size:
            raise ValueError("`symbols` argument has wrong length.")
        if np.any((symbols < q.min) | (symbols > q.max)):
            bad = symbols[(symbols < q.min) | (symbols > q.max)][0]
            raise ImpossibleSymbol(int(bad))
        try:
            s = symbols.astype(np.float64)
            lo = np.asarray(
                self.cdf_fn(s - 0.5, *self.params), dtype=np.float64
            )
            hi = np.asarray(
                self.cdf_fn(s + 0.5, *self.params), dtype=np.float64
            )
            if lo.shape != s.shape or hi.shape != s.shape:
                raise TypeError("callback did not broadcast")
            # probe: vectorized evaluation must agree with the scalar
            # contract on a sample (bit-exactness gate)
            i0 = int(len(symbols) // 2)
            probe = float(
                self.cdf_fn(
                    float(s[i0] - 0.5), *(float(p[i0]) for p in self.params)
                )
            )
            if not (np.isnan(probe) and np.isnan(lo[i0])) and probe != lo[i0]:
                raise TypeError("vectorized callback mismatch")
        except Exception:
            return super().ecp_all(symbols)
        slack = (symbols.astype(np.int64) - q.min).astype(np.uint64)
        left = _trunc_to_uint(q.free_weight * lo) + slack
        left = np.where(symbols == q.min, np.uint64(0), left)
        right = _trunc_to_uint(q.free_weight * hi) + slack + np.uint64(1)
        right = np.where(
            symbols == q.max, np.uint64(1 << q.precision), right
        )
        prob = right - left
        if np.any(prob.astype(np.int64) <= 0):
            raise ValueError(
                "Invalid underlying continuous probability distribution."
            )
        return left, prob
