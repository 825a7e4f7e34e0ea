"""Exact f64 special functions of the reference-exact family models.

The bitstream of the reference-exact families depends on the exact f64
values of a handful of special functions: the reference evaluates float
CDFs in f64 and truncates ``free_weight * cdf`` to fixed point (the
reference's src/stream/model/quantize.rs:525-568).  The reference takes
them from the Rust ``probability`` / ``special`` / ``libm`` crates, whose
``erf`` / ``exp`` / ``atan`` are fdlibm-derived: the same lineage as
glibc's libm, which backs CPython's ``math`` module on Linux.  The bits of
these functions are the wire format, so each vectorized ufunc (scipy's
``erf``, numpy's ``exp`` and ``arctan``) is used only where it equals the
``math`` function bit for bit on a probe grid.  Where scipy's erf is
not, :func:`erf` / :func:`erfc` run the host codec's array loops
(``ctpu_erf_array`` / ``ctpu_erfc_array``: the same glibc functions
``math`` binds, checked against ``math`` on the probe grid at their first
call, which raises RuntimeError on a difference).  :func:`erf_plain` /
:func:`erfc_plain` take a ``frompyfunc`` wrapper around ``math`` there
instead; exp and atan take one where numpy's ufuncs differ.
:data:`PICKED` records what the plain versions resolved to, and
:data:`ERF` what :func:`erf` runs (``"scipy"`` or ``"native"``).

JAX counterpart: ``constriction_tpu/utils/special.py`` (its native erf
branch and its approximate inverse CDFs included, the latter the host
models' decode guesses); ``tests/test_torch_exact_family.py``,
``tests/test_torch_native.py`` and ``tests/test_torch_models.py`` hold the
two equal bit for bit.  Everything here is vectorized over numpy
arrays in float64.
"""

from __future__ import annotations

import functools
import math

import numpy as np

_SQRT2 = math.sqrt(2.0)

# ---------------------------------------------------------------------------
# erf / erfc
# ---------------------------------------------------------------------------

# scipy's erf where it matches glibc's bit for bit (vectorized and fast),
# else the host codec's loop over glibc's (erf) or a frompyfunc'd math.erf
# (erf_plain).  The scipy check runs once at import time over a
# deterministic sample grid.


def _scalar_erf_vec(x: np.ndarray) -> np.ndarray:
    return np.asarray(np.frompyfunc(math.erf, 1, 1)(np.asarray(x)), dtype=np.float64)


def _scalar_erfc_vec(x: np.ndarray) -> np.ndarray:
    return np.asarray(np.frompyfunc(math.erfc, 1, 1)(np.asarray(x)), dtype=np.float64)


def _erf_grid() -> np.ndarray:
    rng = np.random.RandomState(0)
    return np.concatenate(
        [
            rng.uniform(-6.5, 6.5, size=4096),
            rng.uniform(-0.9, 0.9, size=1024),
            np.linspace(-30.0, 30.0, 257),
            np.array([0.0, -0.0, 1e-300, -1e-300, 0.84375, 1.25, 2.857, 6.0]),
        ]
    )


def _pick_erf():
    grid = _erf_grid()
    try:
        from scipy.special import erf as _scipy_erf, erfc as _scipy_erfc

        if (np.array_equal(_scipy_erf(grid), _scalar_erf_vec(grid))
                and np.array_equal(_scipy_erfc(grid), _scalar_erfc_vec(grid))):
            return _scipy_erf, _scipy_erfc
    except ImportError:  # pragma: no cover
        pass
    return None


def _native_loop(name: str, x) -> np.ndarray:
    from .. import native

    x = np.asarray(x, dtype=np.float64)
    flat = np.ascontiguousarray(x).reshape(-1)
    out = np.empty_like(flat)
    getattr(native.library(), name)(flat, out, flat.size)
    return out.reshape(x.shape)


@functools.cache
def _check_native() -> None:
    """Holds the host codec's erf and erfc against ``math`` on the probe
    grid, once a process (a failure raises on every call)."""
    grid = _erf_grid()
    for fn, ref in (("ctpu_erf_array", _scalar_erf_vec),
                    ("ctpu_erfc_array", _scalar_erfc_vec)):
        if not np.array_equal(_native_loop(fn, grid), ref(grid)):
            raise RuntimeError(
                f"the host codec's {fn} differs from math on the probe grid")


def erf_native(x) -> np.ndarray:
    """erf through the host codec (glibc)."""
    _check_native()
    return _native_loop("ctpu_erf_array", x)


def erfc_native(x) -> np.ndarray:
    """erfc through the host codec (glibc)."""
    _check_native()
    return _native_loop("ctpu_erfc_array", x)


_SCIPY = _pick_erf()
if _SCIPY is not None:
    erf, erfc = _SCIPY
    erf_plain, erfc_plain = _SCIPY
else:
    erf, erfc = erf_native, erfc_native
    erf_plain, erfc_plain = _scalar_erf_vec, _scalar_erfc_vec
# what erf runs
ERF = "scipy" if _SCIPY is not None else "native"


def _pick_ufunc(np_fn, math_fn):
    """Same verified-bit-identity selection as _pick_erf for exp/atan: use
    the fast numpy ufunc only if it matches CPython's glibc-backed math
    module bit-for-bit on a probe grid (numpy may use SIMD polynomials with
    different rounding); otherwise fall back to a frompyfunc wrapper.  The
    Laplace/Cauchy fixed-point models depend on the exact f64 values."""
    rng = np.random.RandomState(1)
    grid = np.concatenate(
        [
            rng.uniform(-700.0, 700.0, size=2048),
            rng.uniform(-3.0, 3.0, size=2048),
            np.array([0.0, -0.0, 1e-300, -1e-300, 1.0, -1.0, 709.7, -745.0]),
        ]
    )
    def one(x):
        # C libm semantics: overflow saturates to +/-inf instead of the
        # Python-level OverflowError (the codec evaluates both Laplace
        # branches, one of which may overflow harmlessly)
        try:
            return math_fn(x)
        except OverflowError:
            return math.copysign(math.inf, x)

    scalar = np.frompyfunc(one, 1, 1)

    def scalar_vec(x):
        return np.asarray(scalar(np.asarray(x)), dtype=np.float64)

    with np.errstate(over="ignore", under="ignore"):
        if np.array_equal(np_fn(grid), scalar_vec(grid)):
            return np_fn
    return scalar_vec


_exp = _pick_ufunc(np.exp, math.exp)
_atan = _pick_ufunc(np.arctan, math.atan)

# which implementation each plain function resolved to on this host
PICKED = {
    "erf": "math" if erf_plain is _scalar_erf_vec else "scipy",
    "exp": "numpy" if _exp is np.exp else "math",
    "atan": "numpy" if _atan is np.arctan else "math",
}


# ---------------------------------------------------------------------------
# Distribution CDFs (matching the `probability` crate's formulas)
# ---------------------------------------------------------------------------


def gaussian_cdf(x, mean, std):
    """CDF of a Gaussian, as the reference computes it.

    `probability::distribution::Gaussian::distribution` evaluates
    `(1 + erf((x - mu) / (sigma * sqrt(2)))) / 2` in f64.
    """
    x = np.asarray(x, dtype=np.float64)
    z = (x - mean) / (std * _SQRT2)
    return (1.0 + erf(z)) * 0.5


def laplace_cdf(x, mean, b):
    """CDF of a Laplace distribution (`probability` crate formula).

    `0.5 * exp((x - mu)/b)` for `x < mu`, else `1 - 0.5 * exp((mu - x)/b)`.
    """
    x = np.asarray(x, dtype=np.float64)
    # the branch not selected by the where may overflow to inf harmlessly
    with np.errstate(over="ignore"):
        lo = 0.5 * _exp((x - mean) / b)
        hi = 1.0 - 0.5 * _exp((mean - x) / b)
    return np.where(x < mean, lo, hi)


def cauchy_cdf(x, loc, scale):
    """CDF of a Cauchy distribution (`probability` crate formula).

    `0.5 + atan((x - x0) / gamma) / pi`.
    """
    x = np.asarray(x, dtype=np.float64)
    return 0.5 + _atan((x - loc) / scale) / math.pi


# ---------------------------------------------------------------------------
# Incomplete beta function (for the Binomial CDF)
# ---------------------------------------------------------------------------
#
# The `special` crate's `inc_beta` is a port of Algorithm AS 63 (Majumder &
# Bhattacharjee 1973).  We implement the same algorithm so that rounding
# matches the reference as closely as possible.

_AS63_ACU = 0.1e-14


def _inc_beta_scalar(x: float, p: float, q: float, log_beta: float) -> float:
    """Regularized incomplete beta function I_x(p, q), Algorithm AS 63."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0

    psq = p + q
    # Tail swap for faster convergence.
    flip = p < psq * x
    if flip:
        xx = 1.0 - x
        cx = x
        pp = q
        qq = p
    else:
        xx = x
        cx = 1.0 - x
        pp = p
        qq = q

    term = 1.0
    ai = 1.0
    alpha = 1.0

    ns = int(qq + cx * psq)

    # Soper's reduction formula.
    rx = xx / cx
    temp = qq - ai
    if ns == 0:
        rx = xx

    while True:
        term = term * temp * rx / (pp + ai)
        alpha = alpha + term
        temp = abs(term)
        if temp <= _AS63_ACU and temp <= _AS63_ACU * alpha:
            break
        ai += 1.0
        ns -= 1
        if ns >= 0:
            temp = qq - ai
            if ns == 0:
                rx = xx
        else:
            temp = psq
            psq += 1.0

    alpha = (
        alpha
        * math.exp(pp * math.log(xx) + (qq - 1.0) * math.log(cx) - log_beta)
        / pp
    )
    return 1.0 - alpha if flip else alpha


def inc_beta(x, p, q, log_beta):
    fn = np.frompyfunc(_inc_beta_scalar, 4, 1)
    out = fn(
        np.asarray(x, dtype=np.float64),
        np.asarray(p, dtype=np.float64),
        np.asarray(q, dtype=np.float64),
        np.asarray(log_beta, dtype=np.float64),
    )
    return np.asarray(out, dtype=np.float64)


def ln_beta(p, q):
    """ln B(p, q) via lgamma, matching `special::Beta::ln_beta`."""
    lgamma = np.frompyfunc(math.lgamma, 1, 1)
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    return np.asarray(lgamma(p) + lgamma(q) - lgamma(p + q), dtype=np.float64)


def binomial_cdf(x, n, p):
    """CDF of a Binomial(n, p), matching `probability::distribution::Binomial`.

    P(X <= floor(x)) computed via the regularized incomplete beta function:
    I_{1-p}(n - k, k + 1) with k = floor(x), cf. probability-0.20.3
    src/distribution/binomial.rs.
    """
    x = np.asarray(x, dtype=np.float64)
    n_f = np.asarray(n, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)

    k = np.floor(x)
    below = x < 0.0
    above = k >= n_f

    # Clamp for safe evaluation; the result is overwritten for the clamped
    # entries anyway.
    k_safe = np.clip(k, 0.0, np.maximum(n_f - 1.0, 0.0))
    a = n_f - k_safe
    b = k_safe + 1.0

    with np.errstate(all="ignore"):
        body = inc_beta(1.0 - p, a, b, ln_beta(a, b))
        # Degenerate success probabilities.
        body = np.where(p <= 0.0, 1.0, body)
        body = np.where(p >= 1.0, np.where(k_safe >= n_f, 1.0, 0.0), body)

    result = np.where(below, 0.0, np.where(above, 1.0, body))
    return result


# ---------------------------------------------------------------------------
# Approximate inverse CDFs (decode-time initial guesses only).
#
# These do NOT affect the bitstream: the decoder's quantile search always
# converges to the unique symbol whose fixed-point interval contains the
# quantile (quantize.rs:580-779).  Accuracy only affects speed.
# ---------------------------------------------------------------------------


def gaussian_ppf(xi, mean, std):
    xi = np.asarray(xi, dtype=np.float64)
    return mean + std * _SQRT2 * _erfinv(2.0 * xi - 1.0)


def _erfinv(y):
    """Vectorized approximate inverse error function (Winitzki-style + one
    Newton refinement).  Only used for decode initial guesses."""
    y = np.clip(np.asarray(y, dtype=np.float64), -1.0 + 1e-16, 1.0 - 1e-16)
    w = -np.log((1.0 - y) * (1.0 + y))
    # Rational approximation (Giles 2010 style).
    small = w < 5.0
    ws = w - 2.5
    wl = np.sqrt(np.where(small, 5.0, w)) - 3.0
    ps = (
        2.81022636e-08
        + ws
        * (
            3.43273939e-07
            + ws
            * (
                -3.5233877e-06
                + ws
                * (
                    -4.39150654e-06
                    + ws
                    * (
                        0.00021858087
                        + ws
                        * (
                            -0.00125372503
                            + ws * (-0.00417768164 + ws * (0.246640727 + ws * 1.50140941))
                        )
                    )
                )
            )
        )
    )
    pl = (
        -0.000200214257
        + wl
        * (
            0.000100950558
            + wl
            * (
                0.00134934322
                + wl
                * (
                    -0.00367342844
                    + wl
                    * (
                        0.00573950773
                        + wl * (-0.0076224613 + wl * (0.00943887047 + wl * (1.00167406 + wl * 2.83297682)))
                    )
                )
            )
        )
    )
    x = np.where(small, ps, pl) * y
    # One Newton step: f(x) = erf(x) - y.
    with np.errstate(over="ignore", invalid="ignore"):
        err = erf(x) - y
        step = err * (math.sqrt(math.pi) / 2.0) * np.exp(np.minimum(x * x, 700.0))
    x = x - np.where(np.isfinite(step), step, 0.0)
    return x


def laplace_ppf(xi, mean, b):
    xi = np.clip(np.asarray(xi, dtype=np.float64), 1e-300, 1.0 - 1e-16)
    return np.where(
        xi < 0.5,
        mean + b * np.log(2.0 * xi),
        mean - b * np.log(2.0 - 2.0 * xi),
    )


def cauchy_ppf(xi, loc, scale):
    xi = np.clip(np.asarray(xi, dtype=np.float64), 1e-300, 1.0 - 1e-16)
    return loc + scale * np.tan(math.pi * (xi - 0.5))


def binomial_ppf(xi, n, p):
    # Normal approximation; only a guess.
    n_f = np.asarray(n, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    mu = n_f * p
    sigma = np.sqrt(np.maximum(n_f * p * (1.0 - p), 1e-12))
    return np.clip(np.rint(gaussian_ppf(xi, mu, sigma)), 0.0, n_f)
