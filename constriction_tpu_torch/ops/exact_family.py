"""Reference-exact per-symbol families on the GPU, at the DEFAULT preset
(W=32, S=64, 16 < P <= 24, "wide" tables) and at the small preset (W=16,
S=32, P <= 16, "narrow" tables).

The device families of ``ops/family.py`` use an exact INTEGER CDF.  This
module is the path whose tables are bit-identical to the reference's f64
``LeakyQuantizer`` (the reference's quantize.rs:525-568) over per-symbol
gaussian, laplace, cauchy or binomial models, so a stream the reference
produces can be re-coded here with zero rate change:

- encode: the host evaluates two f64 CDFs per symbol into ``(cum, prob)``
  planes (:func:`exact_ecp`), and kernel 17 (S=64) or kernel 14 (S=32)
  codes them (:func:`encode_tables`): a lane pass over the planes
  (:func:`encode_lanes_plain` in plain PyTorch, either preset) and the
  encoders' row-major compaction;
- decode: per symbol, a compact exact description of the quantile
  partition.  The leaky-quantized table is linear in both tails, so only
  the core boundaries (at most ``cmax``) are stored behind an aux plane
  (:func:`pack_decode_tables`): wide tables pack four 24-bit ``(b - 1)``
  fields to three u32 planes, narrow tables two 16-bit fields to one.
  Kernel 15 (wide) or kernel 13 (narrow) inverts the quantiles against
  them (:func:`decode_tables`); kernel 16 does the same for one segment of
  a core-size-grouped message at S=64, carrying the stream offset from
  launch to launch (:func:`decode_tables_seg`).  Kernels 15, 16 and 13 run
  ``csrc/ilans2_wide.cuh``'s cluster decode (:func:`geometry`; at most
  :data:`coder.MAX_DECODE_LANES` lanes on a card), their binary search
  over the R lanes of a thread in lock step (:func:`invert_tables_bisect`
  is that probe order in plain PyTorch, for wide and narrow tables);
- grouping (S=64 only, as in the JAX package): :func:`group_plan`
  stable-sorts the symbols by a deterministic core-size bound computed
  from (means, scales) alone, so each decode segment runs at its own tight
  table width.

Wide tables come from the host builder here (numpy) or from the on-card
builder of ``ops/exact_tables.py`` (kernel 18 evaluates the windows);
narrow tables from the host builder (:func:`narrow_tables`), as in the JAX
package.

JAX counterpart: ``constriction_tpu/ops/exact_family.py``.  The host part
(the model helpers, :func:`exact_ncore`, :func:`exact_ecp`,
:func:`exact_boundary_tables`, :func:`pack_decode_tables`,
:func:`packed_tables_device`, the host decode oracle and the grouping
plan) is a copy of its host code: :func:`exact_ncore`, :func:`exact_ecp`,
:func:`exact_boundary_tables`, :func:`_packed_table_rows` and
:func:`packed_tables_device` run the host codec (``native/``, C++ over
glibc's libm) under the JAX package's conditions, as its C++ branches do,
and each numpy branch survives as a ``*_plain`` version that no card path
calls (``tests/test_torch_native.py`` holds the two bit-identical).  The
device part replaces the Pallas kernels ``_build_exact_decoder64``,
``_build_exact_decoder64_seg``, ``_build_exact_encoder64``,
``_build_exact_decoder`` and ``_build_exact_encoder`` with the
hand-written kernels of ``csrc/exact_family.cu``.

Tensor layout (constriction_tpu_torch/convert.py): lane states int64 (u64
bits) at S=64 and int32 (u32 bits) at S=32, stream words int32 (u32 bits),
(cum, prob) planes int32 ``[T, L]`` (padded past n with (0, 1)), packed
decode tables int32 ``[T, CP1, L]``, symbols int32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import convert, native
from ..utils import special
from . import _build
from .coder import (MAX_DECODE_LANES, _check, _check_seeds, _num_steps,
                    _on_cuda, _refill_words, compaction_scratch,
                    encode32_steps, lanes32_steps)
from .coder64 import _M32, encode64_steps, lanes64_steps
from .interleaved import LaneConfig

LANES = 128
EXACT_FAMILIES = ("gaussian", "laplace", "cauchy", "binomial")
# the families the on-card builder evaluates (kernel 18)
DEVICE_FAMILIES = ("gaussian", "laplace", "cauchy")

# kernel launches made by this module's wrappers and by ops/exact_tables.py
# (never by the twins)
LAUNCHES = {"encode64": 0, "decode64": 0, "decode64_seg": 0,
            "eval_window": 0, "encode32": 0, "decode32": 0}

# rows of a packed_tables_device call built at a time (bounds the numpy
# window arrays; rows are independent)
_ROW_CHUNK = 1 << 16


# ---------------------------------------------------------------------------
# model helpers (numpy f64)
# ---------------------------------------------------------------------------


def _cdf(family: str, x, mean, scale):
    """For the continuous families (mean, scale) are location/scale; for
    "binomial" the pair is (n_trials, p).  JAX counterpart:
    ``exact_family._cdf``."""
    if family == "gaussian":
        return special.gaussian_cdf(x, mean, scale)
    if family == "laplace":
        return special.laplace_cdf(x, mean, scale)
    if family == "cauchy":
        return special.cauchy_cdf(x, mean, scale)
    if family == "binomial":
        return special.binomial_cdf(x, mean, scale)
    raise ValueError(f"unknown family {family!r}")


def _ppf_guess(family: str, p: float, mean, scale):
    """Approximate inverse CDF -- only a WINDOW GUESS; exactness comes from
    verifying the trunc values at the window edges.  JAX counterpart:
    ``exact_family._ppf_guess``."""
    mean = np.asarray(mean, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    if family == "gaussian":
        from scipy.special import ndtri

        return mean + scale * ndtri(p)
    if family == "laplace":
        if p < 0.5:
            return mean + scale * np.log(2.0 * p)
        return mean - scale * np.log(2.0 * (1.0 - p))
    if family == "cauchy":
        return mean + scale * np.tan(np.pi * (p - 0.5))
    if family == "binomial":
        from scipy.special import ndtri

        mu = mean * scale  # n * p
        sd = np.sqrt(np.maximum(mean * scale * (1.0 - scale), 0.0))
        return mu + sd * ndtri(p)
    raise ValueError(family)


def _dedup_probe(mean, scale):
    """(unique_pairs, inverse) when a full exact-pair dedup is likely to
    pay, else None.  A 4096-point sample gates the O(n log n) np.unique --
    fully-continuous parameter batches (sampled unique fraction > 1/2)
    skip it entirely.  JAX counterpart: ``exact_family._dedup_probe``."""
    n = len(mean)
    if n >= 4096:
        step = max(n // 4096, 1)
        zs = mean[::step] + 1j * scale[::step]
        if len(np.unique(zs)) > len(zs) // 2:
            return None
    z = mean + 1j * scale
    uz, inv = np.unique(z, return_inverse=True)
    return (uz, inv) if len(uz) <= n // 2 else None


def _trunc(x: np.ndarray) -> np.ndarray:
    """Truncating f64 -> u32 cast with Rust `as` semantics (saturating,
    NaN -> 0).  JAX counterpart: ``exact_family._trunc``."""
    hi = float((1 << 32) - 1)
    with np.errstate(invalid="ignore"):
        clipped = np.clip(x, 0.0, hi)
        clipped = np.where(np.isnan(x), 0.0, clipped)
    return np.trunc(clipped).astype(np.int64)


def _free(min_sym: int, max_sym: int, precision: int) -> float:
    return float((1 << precision) - 1 - (max_sym - min_sym))


# ---------------------------------------------------------------------------
# per-symbol tables (host, numpy)
# ---------------------------------------------------------------------------


def _check_exact_family(family: str) -> None:
    """The families of the host codec; the same error as :func:`_cdf`."""
    if family not in EXACT_FAMILIES:
        raise ValueError(f"unknown family {family!r}")


def _unique_pairs(mean, scale):
    """``(means, scales, inverse)`` of the distinct (mean, scale) pairs
    where :func:`_dedup_probe` finds deduplication worth it, else the
    inputs and None."""
    dd = _dedup_probe(mean, scale)
    if dd is None:
        return mean, scale, None
    uz, inv = dd
    return np.ascontiguousarray(uz.real), np.ascontiguousarray(uz.imag), inv


def _raise_overflow(bad: int, cmax: int) -> None:
    """The codec's table fills return 1 + the index of a symbol whose core
    exceeds cmax, or 0."""
    if bad:
        raise ValueError(
            f"core of symbol {int(bad) - 1} needs more than cmax={cmax} "
            "boundaries; increase cmax (flat distributions make the whole "
            "support non-linear)")


def _params(means, scales):
    mean = np.ascontiguousarray(np.asarray(means, np.float64).reshape(-1))
    scale = np.ascontiguousarray(np.asarray(scales, np.float64).reshape(-1))
    if len(mean) != len(scale):
        raise ValueError(
            f"means and scales differ in length: {len(mean)} vs {len(scale)}")
    return mean, scale


def exact_ncore(means, scales, family: str, min_sym: int, max_sym: int,
                precision: int) -> np.ndarray:
    """Per-symbol core sizes (number of non-linear boundaries), u32: the
    host codec's bisection (``ctpu_exact_ncore``), over the unique (mean,
    scale) pairs where :func:`_dedup_probe` finds them worth it (a core
    size depends on its pair alone).  JAX counterpart:
    ``exact_family.exact_ncore``; plain version :func:`exact_ncore_plain`."""
    _check_exact_family(family)
    um, us, inv = _unique_pairs(*_params(means, scales))
    out = np.empty(len(um), dtype=np.uint32)
    native.library().ctpu_exact_ncore(native.DIST_KIND[family], min_sym,
                                      max_sym, precision, um, us, len(um),
                                      out)
    return out if inv is None else out[inv]


def exact_ncore_plain(means, scales, family: str, min_sym: int,
                      max_sym: int, precision: int) -> np.ndarray:
    """:func:`exact_ncore` in numpy: a batch bisection on the monotone
    trunc value.  JAX counterpart: the numpy branch of
    ``exact_family.exact_ncore``."""
    mean = np.asarray(means, dtype=np.float64).reshape(-1)
    scale = np.asarray(scales, dtype=np.float64).reshape(-1)
    n = len(mean)
    free = _free(min_sym, max_sym, precision)
    freeu = int(free)

    def tv(s):
        return _trunc(free * _cdf(family, s.astype(np.float64) - 0.5,
                                  mean, scale))

    def bisect(lo, hi, threshold):
        # lanes stop updating once hi - lo == 1
        while np.any(hi - lo > 1):
            active = (hi - lo) > 1
            mid = lo + ((hi - lo) >> 1)
            pred = tv(mid) >= threshold
            hi = np.where(active & pred, mid, hi)
            lo = np.where(active & ~pred, mid, lo)
        return hi

    tv_max = tv(np.full(n, max_sym, np.int64))
    # core_lo: first s in (min, max] with tv >= 1 (max_sym when none)
    hi = bisect(np.full(n, min_sym, np.int64),
                np.full(n, max_sym, np.int64), 1)
    core_lo = np.where(tv_max < 1, max_sym, hi)
    # core_hi: last s with tv <= free-1 == (first s with tv >= free) - 1
    hi = bisect(np.full(n, min_sym + 1, np.int64),
                np.full(n, max_sym, np.int64), freeu)
    tv_lo1 = tv(np.full(n, min_sym + 1, np.int64))
    core_hi = np.where(
        tv_max <= freeu - 1, max_sym,
        np.where(tv_lo1 >= freeu, min_sym, hi - 1),
    )
    core_hi = np.maximum(core_hi, core_lo)
    return (core_hi - core_lo + 1).astype(np.uint32)


def exact_ecp(symbols, means, scales, family: str, min_sym: int,
              max_sym: int, precision: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-symbol (cum, prob) u32 with the exact reference formulas
    (quantize.rs:525-568), vectorized over per-symbol (mean, scale): the
    host codec's ``ctpu_quantized_ecp`` for one-dimensional batches of at
    least 64 symbols with one (mean, scale) each, as in the JAX package,
    and :func:`exact_ecp_plain` below that.  JAX counterpart:
    ``exact_family.exact_ecp``."""
    s = np.asarray(symbols, dtype=np.int64)
    mean = np.asarray(means, dtype=np.float64)
    scale = np.asarray(scales, dtype=np.float64)
    if not (family in EXACT_FAMILIES and s.ndim == 1 and mean.ndim == 1
            and len(s) == len(mean) and scale.shape == mean.shape
            and len(s) >= 64):
        return exact_ecp_plain(s, mean, scale, family, min_sym, max_sym,
                               precision)
    if np.any((s < min_sym) | (s > max_sym)):
        raise ValueError("symbol outside support")
    if _free(min_sym, max_sym, precision) < 1.0:
        raise ValueError("support too large for precision")
    cums = np.empty(len(s), dtype=np.uint32)
    probs = np.empty(len(s), dtype=np.uint32)
    err = native.library().ctpu_quantized_ecp(
        native.DIST_KIND[family], min_sym, max_sym, precision,
        np.ascontiguousarray(s, dtype=np.int32), np.ascontiguousarray(mean),
        np.ascontiguousarray(scale), len(s), cums, probs)
    # the plain path's prob <= 0 check: a wrapped right - left is a huge u32
    if err != 0 or np.any((probs - 1) >= np.uint32(1 << precision)):
        raise ValueError("invalid underlying continuous distribution")
    return cums, probs


def exact_ecp_plain(symbols, means, scales, family: str, min_sym: int,
                    max_sym: int, precision: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`exact_ecp` in numpy.  JAX counterpart: the numpy branch of
    ``exact_family.exact_ecp``."""
    s = np.asarray(symbols, dtype=np.int64)
    if np.any((s < min_sym) | (s > max_sym)):
        raise ValueError("symbol outside support")
    mean = np.asarray(means, dtype=np.float64)
    scale = np.asarray(scales, dtype=np.float64)
    free = _free(min_sym, max_sym, precision)
    if free < 1.0:
        raise ValueError("support too large for precision")
    slack = s - min_sym
    sf = s.astype(np.float64)
    left = _trunc(free * _cdf(family, sf - 0.5, mean, scale)) + slack
    left = np.where(s == min_sym, 0, left)
    right = _trunc(free * _cdf(family, sf + 0.5, mean, scale)) + slack + 1
    right = np.where(s == max_sym, 1 << precision, right)
    prob = right - left
    if np.any(prob <= 0):
        raise ValueError("invalid underlying continuous distribution")
    return left.astype(np.uint32), prob.astype(np.uint32)


def _table_args(means, scales, family: str, min_sym: int, max_sym: int,
                precision: int, cmax: int | None, ncore_fn):
    """The checks and the cmax sizing of the boundary-table builders:
    ``(mean, scale, cmax)``; ``ncore_fn`` is :func:`exact_ncore` or its
    plain version."""
    mean = np.asarray(means, dtype=np.float64).reshape(-1)
    scale = np.asarray(scales, dtype=np.float64).reshape(-1)
    n = len(mean)
    P = precision
    if P > 24:
        raise ValueError("exact tables support precisions up to 24")
    wide = P > 16
    aux_shift = 24 if wide else 16
    if cmax is None:
        # auto-size to the tight max: table bytes and the kernel's scan
        # both cost O(cmax)
        ncore = ncore_fn(mean, scale, family, min_sym, max_sym, P)
        cmax = max(int(ncore.max()) if n else 1, 1)
        if not wide:
            cmax += cmax & 1  # narrow tables pack boundary PAIRS
        if cmax >= (1 << (32 - aux_shift)):
            raise ValueError(
                f"core needs {cmax} boundaries; the {'wide' if wide else 'narrow'}"
                f" table format caps ncore at {(1 << (32 - aux_shift)) - 1}"
                " (use the host decode path for this model)"
            )
    if cmax >= (1 << (32 - aux_shift)):
        raise ValueError(
            f"cmax={cmax} exceeds the table format's ncore cap "
            f"{(1 << (32 - aux_shift)) - 1}")
    if _free(min_sym, max_sym, P) < 2.0:
        raise ValueError("support too large for precision")
    return mean, scale, cmax


def exact_boundary_tables(means, scales, family: str, min_sym: int,
                          max_sym: int, precision: int,
                          cmax: int | None = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Compact exact decode tables: per symbol position, the core boundary
    values ``b(s) = trunc(free * CDF(s - 1/2)) + (s - min)`` for s in
    [core_lo, core_hi], where the core is the maximal range outside which
    the trunc value is exactly 0 (left tail) or saturated (right tail).

    Returns ``(aux u32[n], core u32[n, cmax])``.  For P <= 16 ("narrow")
    ``aux = (core_lo - min) | ncore << 16`` and pads are 0xFFFF; for
    16 < P <= 24 ("wide") ``aux = (core_lo - min) | ncore << 24`` and pads
    are ``1 << P``, a value no real boundary takes that doubles as the
    no-next-boundary sentinel.  ``cmax=None`` sizes the width to the
    batch's largest core (rounded up to even for narrow tables).  Raises
    ValueError if a symbol's core exceeds ``cmax``.  The host codec's
    ``ctpu_exact_boundaries`` (a guess-seeded search for each left edge,
    then a forward fill).  JAX counterpart:
    ``exact_family.exact_boundary_tables``; plain version
    :func:`exact_boundary_tables_plain`."""
    _check_exact_family(family)
    mean, scale, cmax = _table_args(means, scales, family, min_sym, max_sym,
                                    precision, cmax, exact_ncore)
    n = len(mean)
    aux = np.empty(n, dtype=np.uint32)
    core = np.empty((n, cmax), dtype=np.uint32)
    bad = native.library().ctpu_exact_boundaries(
        native.DIST_KIND[family], min_sym, max_sym, precision,
        np.ascontiguousarray(mean), np.ascontiguousarray(scale), n, cmax,
        aux, core.reshape(-1))
    _raise_overflow(bad, cmax)
    return aux, core


def exact_boundary_tables_plain(means, scales, family: str, min_sym: int,
                                max_sym: int, precision: int,
                                cmax: int | None = None
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`exact_boundary_tables` in numpy: every boundary of a window
    placed by the approximate inverse CDF, its edges then verified.  JAX
    counterpart: the numpy window branch of
    ``exact_family.exact_boundary_tables``."""
    mean, scale, cmax = _table_args(means, scales, family, min_sym, max_sym,
                                    precision, cmax, exact_ncore_plain)
    n = len(mean)
    P = precision
    wide = P > 16
    padv = (1 << P) if wide else 0xFFFF
    aux_shift = 24 if wide else 16
    free = _free(min_sym, max_sym, P)
    span = max_sym - min_sym

    # window guess from the approximate PPF, with margin; exactness is then
    # verified on the evaluated trunc values at the window edges
    margin = 4
    wwin = min(cmax + 2 * margin, span + 1)
    lo_g = np.floor(_ppf_guess(family, 1.0 / free, mean, scale))
    lo_g = np.where(np.isfinite(lo_g), lo_g, float(min_sym))
    a = np.clip(
        lo_g.astype(np.int64) - margin, min_sym + 1,
        max(min_sym + 1, max_sym - wwin + 1)
    )
    grid = a[:, None] + np.arange(wwin)[None, :]  # [n, wwin] symbol values
    valid = grid <= max_sym
    gridc = np.minimum(grid, max_sym)
    tv = _trunc(
        free * _cdf(family, gridc.astype(np.float64) - 0.5,
                    mean[:, None], scale[:, None])
    )
    # cdf rounds to exactly 1.0 in f64 well inside heavy right tails, so
    # trunc(free * cdf) takes the value free there (NOT free-1); the single
    # right-linear regime is b(s) = free + s - min, and everything below
    # saturation (including the trunc == free-1 stretch) belongs to the core
    pos = (tv >= 1) & valid
    nonsat = (tv <= int(free) - 1) & valid

    any_pos = pos.any(axis=1)
    lo_w = np.where(any_pos, pos.argmax(axis=1), wwin - 1)
    # the first positive trunc must be INSIDE the window (edge value 0)
    # unless the window starts at the support edge
    edge_ok = (~any_pos) | (lo_w > 0) | (a == min_sym + 1)
    if not np.all(edge_ok):
        raise ValueError(
            "core window missed the left edge (distribution wider than "
            f"cmax={cmax}? increase cmax)"
        )
    any_ns = nonsat.any(axis=1)
    hi_w = np.where(any_ns, wwin - 1 - nonsat[:, ::-1].argmax(axis=1), lo_w)
    # the right edge is covered when the last non-saturated value is inside
    # the window OR the window already reaches the end of the support
    hi_ok = (hi_w < wwin - 1) | (grid[:, wwin - 1] >= max_sym)
    if not np.all(hi_ok):
        raise ValueError(
            "core window missed the right edge (distribution wider than "
            f"cmax={cmax}? increase cmax)"
        )
    # clamp to a non-empty core (all-linear / sharp-step cases)
    lo_w = np.where(any_pos, lo_w, np.minimum(max_sym - a, wwin - 1))
    hi_w = np.maximum(hi_w, lo_w)
    ncore = hi_w - lo_w + 1
    if np.any(ncore > cmax):
        raise ValueError(
            f"core needs {int(ncore.max())} boundaries > cmax={cmax}; "
            "increase cmax (flat distributions make the whole support "
            "non-linear)"
        )

    b = tv + (gridc - min_sym)  # boundary values on the window grid
    idx = lo_w[:, None] + np.arange(cmax)[None, :]
    take = np.take_along_axis(
        np.concatenate([b, np.full((n, cmax), padv, np.int64)], axis=1),
        np.minimum(idx, wwin + cmax - 1),
        axis=1,
    )
    core = np.where(np.arange(cmax)[None, :] < ncore[:, None], take, padv)
    core_lo_rel = (np.take_along_axis(grid, lo_w[:, None], 1)[:, 0] - min_sym)
    aux = (core_lo_rel.astype(np.uint32)
           | (ncore.astype(np.uint32) << aux_shift))
    return aux, core.astype(np.uint32)


def pack_decode_tables(aux: np.ndarray, core: np.ndarray,
                       precision: int) -> Tuple[np.ndarray, int]:
    """(aux, core) -> table rows ``[n, CP1] u32`` in the decode kernels'
    packed (b - 1) layout, plus the effective (rounded) cmax.

    Plane 0 is aux.  Wide (16 < P <= 24): 24-bit (b - 1) quads, four
    boundaries per three planes; raw wide pads are 2^P, so ``core - 1``
    maps them to 2^P - 1, which no quantile exceeds.  Narrow (P <= 16):
    u16 (b - 1) pairs with pads forced to 0xFFFF.  JAX counterpart:
    ``exact_family.pack_decode_tables``."""
    n, cmax = core.shape
    if precision > 16:
        G = -(-cmax // 4)
        bm1 = np.full((n, 4 * G), (1 << precision) - 1, np.uint32)
        bm1[:, :cmax] = core - 1
        grp = bm1.reshape(n, G, 4)
        tabs = np.empty((n, 1 + 3 * G), np.uint32)
        tabs[:, 0] = aux
        w = np.empty((n, G, 3), np.uint32)
        w[..., 0] = grp[..., 0] | (grp[..., 1] << 24)
        w[..., 1] = (grp[..., 1] >> 8) | (grp[..., 2] << 16)
        w[..., 2] = (grp[..., 2] >> 16) | (grp[..., 3] << 8)
        tabs[:, 1:] = w.reshape(n, 3 * G)
        return tabs, 4 * G
    if cmax % 2:
        raise ValueError("narrow tables need an even cmax")
    ncore = (aux >> 16).astype(np.int64)
    bm1 = np.where(
        np.arange(cmax)[None, :] < ncore[:, None], core - 1, 0xFFFF
    ).astype(np.uint32)
    tabs = np.empty((n, cmax // 2 + 1), np.uint32)
    tabs[:, 0] = aux
    tabs[:, 1:] = bm1[:, 0::2] | (bm1[:, 1::2] << 16)
    return tabs, cmax


def _check_wide_precision(precision: int) -> None:
    if not 16 < precision <= 24:
        raise ValueError(f"wide tables need 16 < P <= 24, got {precision}")


def _packed_table_rows(mean, scale, family: str, min_sym: int, max_sym: int,
                       precision: int, cmax: int) -> Tuple[np.ndarray, int]:
    """Packed wide-table rows ``[n, 1 + 3*ceil(cmax/4)] u32`` (plane 0 is
    aux) for any parameter vectors, plus the rounded cmax: the host codec's
    fused fill and pack (``ctpu_exact_tables_packed``) for ``cmax <= 255``,
    else :func:`exact_boundary_tables` and :func:`pack_decode_tables`.  JAX
    counterpart: ``exact_family._packed_table_rows``; plain version
    :func:`_packed_table_rows_plain`."""
    _check_exact_family(family)
    _check_wide_precision(precision)
    mean, scale = _params(mean, scale)
    if cmax > 255:
        aux, core = exact_boundary_tables(mean, scale, family, min_sym,
                                          max_sym, precision, cmax)
        return pack_decode_tables(aux, core, precision)
    G = -(-cmax // 4)
    tabs = np.empty((len(mean), 1 + 3 * G), dtype=np.uint32)
    bad = native.library().ctpu_exact_tables_packed(
        native.DIST_KIND[family], min_sym, max_sym, precision, mean, scale,
        len(mean), cmax, tabs.reshape(-1))
    _raise_overflow(bad, cmax)
    return tabs, 4 * G


def _packed_table_rows_plain(mean, scale, family: str, min_sym: int,
                             max_sym: int, precision: int,
                             cmax: int) -> Tuple[np.ndarray, int]:
    """:func:`_packed_table_rows` in numpy, built ``_ROW_CHUNK`` rows at a
    time (each row depends on its own (mean, scale) only).  JAX
    counterpart: the numpy branch of ``exact_family._packed_table_rows``."""
    mean = np.asarray(mean, np.float64).reshape(-1)
    scale = np.asarray(scale, np.float64).reshape(-1)
    n = len(mean)
    G = -(-cmax // 4)
    tabs = np.empty((n, 1 + 3 * G), np.uint32)
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, n)
        aux, core = exact_boundary_tables_plain(
            mean[r0:r1], scale[r0:r1], family, min_sym, max_sym, precision,
            cmax)
        tabs[r0:r1], _ = pack_decode_tables(aux, core, precision)
    return tabs, 4 * G


def _tight(ncore_max: int) -> int:
    """The table width, a multiple of 4, that a batch whose largest core
    is ``ncore_max`` needs."""
    return max(4, -(-max(ncore_max, 1) // 4) * 4)


def _rows_tight(mean, scale, family, min_sym, max_sym, precision, cmax,
                rows_fn):
    """Rows at the caller's cmax, refilled at the tight width when that is
    at least one quad narrower (the caller's cmax is an upper bound; the
    kernels' scan and the table bytes cost O(width))."""
    tabs, cmax_r = rows_fn(mean, scale, family, min_sym, max_sym, precision,
                           cmax)
    tight = _tight(int((tabs[:, 0] >> 24).max()))
    if tight < cmax_r:
        tabs, cmax_r = rows_fn(mean, scale, family, min_sym, max_sym,
                               precision, tight)
    return tabs, cmax_r


def _device_args(means, scales, precision: int, nsteps: int, R: int):
    mean = np.ascontiguousarray(np.asarray(means, np.float64).reshape(-1))
    scale = np.ascontiguousarray(np.asarray(scales, np.float64).reshape(-1))
    n = nsteps * R * LANES
    if len(mean) != n or len(scale) != n:
        raise ValueError(
            f"means and scales must have nsteps * R * 128 = {n} entries")
    _check_wide_precision(precision)
    return mean, scale


def _unique_rows(pairs, family, min_sym, max_sym, precision, cmax,
                 rows_fn):
    """Rows of every symbol at the tight width, each distinct (mean,
    scale) pair of :func:`_unique_pairs` built once and gathered back."""
    um, us, inv = pairs
    tabs, cmax_r = _rows_tight(um, us, family, min_sym, max_sym, precision,
                               cmax, rows_fn)
    return (tabs if inv is None else tabs[inv]), cmax_r


def packed_tables_device(means, scales, family: str, min_sym: int,
                         max_sym: int, precision: int, cmax: int,
                         nsteps: int, R: int) -> Tuple[np.ndarray, int]:
    """Wide decode tables in the JAX package's device layout ``[nsteps,
    CP1, R, 128]`` u32 (plane axis in front of the lane axes), plus the
    rounded cmax; :func:`convert.exact_tables_to_torch` gives the port's
    ``[nsteps, CP1, L]``.  The caller's cmax is an upper bound, and the
    rows are refilled at the tight width when that is at least one quad
    narrower.  A batch without repeated (mean, scale) pairs and with
    ``cmax <= 255`` takes the host codec's fill, pack and transpose in one
    pass (``ctpu_exact_tables_packed_t``); otherwise repeated pairs are
    built once (:func:`_packed_table_rows`) and gathered back, and the
    codec transposes (``ctpu_transpose_u32``).  JAX counterpart:
    ``exact_family.packed_tables_device``; plain version
    :func:`packed_tables_device_plain`."""
    _check_exact_family(family)
    pairs = _unique_pairs(*_device_args(means, scales, precision, nsteps, R))
    mean, scale, inv = pairs
    lib = native.library()
    rows = R * LANES
    if cmax <= 255 and inv is None:

        def fused(cm):
            G = -(-cm // 4)
            tabs4 = np.empty((nsteps, 1 + 3 * G, rows), dtype=np.uint32)
            ncm = np.zeros(1, np.int32)
            bad = lib.ctpu_exact_tables_packed_t(
                native.DIST_KIND[family], min_sym, max_sym, precision, mean,
                scale, nsteps, rows, cm, tabs4.reshape(-1), ncm)
            _raise_overflow(bad, cm)
            return tabs4, 4 * G, int(ncm[0])

        tabs4, cmax_r, ncore_max = fused(cmax)
        if _tight(ncore_max) < cmax_r:
            tabs4, cmax_r, _ = fused(_tight(ncore_max))
        return tabs4.reshape(nsteps, -1, R, LANES), cmax_r
    tabs, cmax_r = _unique_rows(pairs, family, min_sym, max_sym, precision,
                                cmax, _packed_table_rows)
    CP1 = tabs.shape[1]
    tabs4 = np.empty((nsteps, CP1, rows), dtype=np.uint32)
    lib.ctpu_transpose_u32(np.ascontiguousarray(tabs).reshape(-1),
                           tabs4.reshape(-1), nsteps, rows, CP1)
    return tabs4.reshape(nsteps, CP1, R, LANES), cmax_r


def packed_tables_device_plain(means, scales, family: str, min_sym: int,
                               max_sym: int, precision: int, cmax: int,
                               nsteps: int, R: int
                               ) -> Tuple[np.ndarray, int]:
    """:func:`packed_tables_device` in numpy.  JAX counterpart: the numpy
    branch of ``exact_family.packed_tables_device``."""
    pairs = _unique_pairs(*_device_args(means, scales, precision, nsteps, R))
    tabs, cmax_r = _unique_rows(pairs, family, min_sym, max_sym, precision,
                                cmax, _packed_table_rows_plain)
    CP1 = tabs.shape[1]
    tabs4 = np.ascontiguousarray(
        tabs.reshape(nsteps, R, LANES, CP1).transpose(0, 3, 1, 2)
    )
    return tabs4, cmax_r


def narrow_tables(means, scales, family: str, min_sym: int, max_sym: int,
                  precision: int, cmax: int | None, nsteps: int,
                  R: int) -> Tuple[np.ndarray, int]:
    """Narrow (P <= 16) decode tables in the JAX package's device layout
    ``[nsteps, CP1, R, 128]`` u32 with ``CP1 = cmax / 2 + 1``, plus the
    cmax.  ``cmax=None`` sizes it to the batch's largest core, rounded up
    to even, as :func:`exact_boundary_tables` does; the rows are then built
    ``_ROW_CHUNK`` at a time at that width (each row depends on its own
    (mean, scale) only), which bounds the numpy window arrays.  JAX
    counterpart: the S=32 branch of ``exact_family.decode_family_exact``
    (``exact_boundary_tables``, ``pack_decode_tables``, transpose)."""
    mean = np.asarray(means, np.float64).reshape(-1)
    scale = np.asarray(scales, np.float64).reshape(-1)
    n = nsteps * R * LANES
    if len(mean) != n or len(scale) != n:
        raise ValueError(
            f"means and scales must have nsteps * R * 128 = {n} entries")
    if not 0 < precision <= 16:
        raise ValueError(f"narrow tables need P <= 16, got {precision}")
    if cmax is None:
        nc = exact_ncore(mean, scale, family, min_sym, max_sym, precision)
        cmax = max(int(nc.max()) if n else 1, 1)
        cmax += cmax & 1
    tabs = np.empty((n, cmax // 2 + 1), np.uint32)
    for r0 in range(0, n, _ROW_CHUNK):
        r1 = min(r0 + _ROW_CHUNK, n)
        aux, core = exact_boundary_tables(mean[r0:r1], scale[r0:r1], family,
                                          min_sym, max_sym, precision, cmax)
        tabs[r0:r1], _ = pack_decode_tables(aux, core, precision)
    tabs4 = np.ascontiguousarray(
        tabs.reshape(nsteps, R, LANES, -1).transpose(0, 3, 1, 2))
    return tabs4, cmax


# ---------------------------------------------------------------------------
# host decode oracle (numpy)
# ---------------------------------------------------------------------------


def _invert_with_tables(q, aux, core, min_sym, max_sym, precision):
    """Vectorized quantile inversion from (aux, core) tables; the kernels'
    region logic.  q, aux: [L]; core: [L, cmax].  JAX counterpart:
    ``exact_family._invert_with_tables``."""
    P = precision
    free = (1 << P) - 1 - (max_sym - min_sym)
    span = max_sym - min_sym
    wide = P > 16
    aux_shift = 24 if wide else 16
    q = q.astype(np.int64)
    cl = (aux & ((1 << aux_shift) - 1)).astype(np.int64)
    nc = (aux >> aux_shift).astype(np.int64)
    c = core.astype(np.int64)  # pads: 0xFFFF (narrow) / 2^P (wide)
    # entry j is real iff j < ncore; the no-next sentinel is 2^P
    real = np.arange(core.shape[1])[None, :] < nc[:, None]
    le = (c <= q[:, None]) & real
    cnt = le.sum(axis=1)
    cumc = np.where(le, c, 0).max(axis=1)
    nxtc = np.where(le | ~real, 1 << P, c).min(axis=1)
    core_hi_rel = cl + nc - 1
    rstart = np.where(
        core_hi_rel >= span, 1 << P, free + core_hi_rel + 1
    )
    # left-linear region
    s_rel_l = np.minimum(q, cl - 1)
    next_l = np.where(s_rel_l >= cl - 1, nxtc, s_rel_l + 1)
    # core region
    sym_c = cl + cnt - 1
    next_c = np.minimum(nxtc, rstart)
    # right-linear region (saturated: b(s) = free + s - min)
    s_rel_r = np.minimum(q - free, span)
    cum_r = free + s_rel_r
    next_r = np.where(s_rel_r >= span, 1 << P, cum_r + 1)

    right = q >= rstart
    leftr = cnt == 0
    s_rel = np.where(right, s_rel_r, np.where(leftr, s_rel_l, sym_c))
    cum = np.where(right, cum_r, np.where(leftr, s_rel_l, cumc))
    nxt = np.where(right, next_r, np.where(leftr, next_l, next_c))
    return (
        (s_rel + min_sym).astype(np.int64),
        cum.astype(np.uint64),
        (nxt - cum).astype(np.uint64),
    )


def _pad_to(arr, n, fill=0.0):
    arr = np.asarray(arr, dtype=np.float64).reshape(-1)
    if len(arr) >= n:
        return arr[:n]
    out = np.full(n, fill, np.float64)
    out[: len(arr)] = arr
    return out


def _pad_params(means, scales, n, family, max_sym):
    """Pad (mean, scale) slots for inactive tail lanes: a unit model at the
    origin for the continuous families, (max_sym trials, p = 1/2) for
    binomial.  JAX counterpart: ``exact_family._pad_params``."""
    if family == "binomial":
        return (_pad_to(means, n, float(max_sym)), _pad_to(scales, n, 0.5))
    return _pad_to(means, n), _pad_to(scales, n, 1.0)


def decode_family_exact_host(init_states, stream, means, scales, family: str,
                             min_sym: int, max_sym: int, cfg: LaneConfig,
                             num_symbols: int,
                             cmax: int | None = None) -> np.ndarray:
    """Numpy oracle of the exact-family decoder (the schedule of
    ``interleaved2.decode_shared_cdf`` over per-symbol tables); any lane
    count.  Reads past the end of the stream give zero words.  JAX
    counterpart: ``exact_family.decode_family_exact_host``."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-num_symbols // L) if num_symbols else 0
    lower = np.uint64(1 << (S - W))
    aux_all, core_all = exact_boundary_tables(
        *_pad_params(means, scales, T * L, family, max_sym), family,
        min_sym, max_sym, P, cmax,
    )
    states = np.asarray(init_states).astype(np.uint64)
    base = 0
    out = np.empty(T * L, dtype=np.int64)
    lanes = np.arange(L)
    stream = np.asarray(stream)
    for t in range(T):
        idx = t * L + lanes
        active = idx < num_symbols
        q = states & np.uint64((1 << P) - 1)
        sym, cum, prob = _invert_with_tables(
            q.astype(np.int64), aux_all[idx], core_all[idx],
            min_sym, max_sym, P,
        )
        new_states = (states >> np.uint64(P)) * prob + (q - cum)
        states = np.where(active, new_states, states)
        m = states < lower
        k = int(m.sum())
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base : base + k]
            words[: len(avail)] = avail
            states[m] = (states[m] << np.uint64(W)) | words
            base += k
        out[idx] = sym
    return out[:num_symbols]


# ---------------------------------------------------------------------------
# core-size grouping (numpy f64: both sides compute the same permutation
# from (means, scales) alone)
# ---------------------------------------------------------------------------


def _segment_dp(stepw: np.ndarray, max_segments: int):
    """Partition the non-decreasing per-step width sequence into at most
    ``max_segments`` contiguous segments minimizing sum(len * max); the
    candidate boundaries are the distinct-width run edges.  Returns
    [(t0, nsteps, cmax)].  JAX counterpart: ``exact_family._segment_dp``."""
    T = len(stepw)
    vals, starts = [], []
    for t in range(T):
        if not vals or stepw[t] != vals[-1]:
            vals.append(int(stepw[t]))
            starts.append(t)
    starts.append(T)
    m = len(vals)
    if m <= max_segments:
        return [
            (starts[i], starts[i + 1] - starts[i], vals[i]) for i in range(m)
        ]
    # dp[k][j]: min cost of runs 0..j with k+1 segments; cost of a segment
    # of runs i..j is (#steps) * vals[j] (widths ascend)
    INF = float("inf")

    def nsteps(i, j):
        return starts[j + 1] - starts[i]

    dp = [[INF] * m for _ in range(max_segments)]
    choice = [[0] * m for _ in range(max_segments)]
    for j in range(m):
        dp[0][j] = nsteps(0, j) * vals[j]
    for k in range(1, max_segments):
        for j in range(k, m):
            best, bi = INF, k
            for i in range(k, j + 1):
                c = dp[k - 1][i - 1] + nsteps(i, j) * vals[j]
                if c < best:
                    best, bi = c, i
            dp[k][j] = best
            choice[k][j] = bi
    segs = []
    j = m - 1
    k = max_segments - 1
    while k > 0:
        i = choice[k][j]
        segs.append((starts[i], starts[j + 1] - starts[i], vals[j]))
        j = i - 1
        k -= 1
    segs.append((0, starts[j + 1], vals[j]))
    return segs[::-1]


# Per-family tail constants of the core-interval OVERESTIMATE below:
# LEFT edge: the first s with CDF >= 1/free (t >= -5.37 gaussian, -16.64
# laplace at free <= 2^24); RIGHT edge: the f64 CDF rounds to exactly 1.0
# (t ~ 8.38 gaussian, 36.74 laplace; cauchy effectively never).  Binomial
# slots hold (a, b) of the half-width a*sd + b around the mean.  Generous
# fixed literals, so the estimate needs no transcendentals.  JAX
# counterpart: ``exact_family._EST_C``.
_EST_C = {
    "gaussian": (5.5, 8.6),
    "laplace": (16.8, 37.2),
    "cauchy": (np.inf, np.inf),
    "binomial": (10.0, 6.0),
}


def _ncore_estimate(means, scales, family, min_sym, max_sym):
    """Deterministic per-symbol upper bound on the core size, computed with
    IEEE +, -, *, sqrt, ceil/floor/clip only, so every platform agrees bit
    for bit (a libm difference could flip a sort key and desynchronize
    encoder and decoder).  JAX counterpart:
    ``exact_family._ncore_estimate``."""
    m = np.asarray(means, np.float64)
    s = np.asarray(scales, np.float64)
    if family == "binomial":
        a, b = _EST_C[family]
        pp = np.clip(s, 0.0, 1.0)
        mu = m * pp
        half = a * np.sqrt(m * pp * (1.0 - pp)) + b
        lo = np.clip(np.ceil(mu - half) - 1.0, min_sym + 1, max_sym)
        hi = np.clip(np.floor(mu + half) + 1.0, lo, max_sym)
        return (hi - lo).astype(np.int64) + 1
    CL, CR = _EST_C[family]
    lo = np.clip(np.ceil(m - CL * s) - 1.0, min_sym + 1, max_sym)
    hi = np.clip(np.floor(m + CR * s) + 1.0, lo, max_sym)
    return (hi - lo).astype(np.int64) + 1


def group_plan(means, scales, family: str, min_sym: int, max_sym: int,
               precision: int, L: int, num_symbols: int,
               max_segments: int = 10):
    """Deterministic core-size grouping shared by encoder and decoder.

    Returns ``(perm, segments)``: ``perm`` (i64[n]) is the stable symbol
    order (sorted by the per-symbol core-size bound); ``segments`` is
    ``[(t0, nsteps, cmax)]`` over the permuted message's steps, each cmax
    a multiple of 4.  JAX counterpart: ``exact_family.group_plan``."""
    n = num_symbols
    T = -(-n // L) if n else 0
    ncore = _ncore_estimate(
        np.asarray(means, np.float64).reshape(-1)[:n],
        np.asarray(scales, np.float64).reshape(-1)[:n],
        family, min_sym, max_sym,
    )
    # u16 key => numpy's stable sort runs its O(n) radix path
    perm = np.argsort(
        np.minimum(ncore, 0xFFFF).astype(np.uint16), kind="stable"
    )
    # inactive tail lanes get the _pad_params model: size the final
    # segment for it too
    if family == "binomial":
        pad_core = int(_ncore_estimate(
            np.full(1, float(max_sym)), np.full(1, 0.5), family,
            min_sym, max_sym)[0])
    else:
        pad_core = int(_ncore_estimate(
            np.zeros(1), np.ones(1), family, min_sym, max_sym)[0])
    padded = np.full(T * L, pad_core, np.int64)
    padded[:n] = ncore[perm]
    stepmax = padded.reshape(T, L).max(axis=1)
    stepw = np.minimum((stepmax + 3) & ~3, np.int64(255 & ~3) + 4)
    if int(stepw.max(initial=0)) >= (1 << 8):
        raise ValueError(
            f"core needs {int(stepmax.max())} boundaries; the wide table "
            "format caps ncore at 255 (use the host decode path)"
        )
    return perm, _segment_dp(stepw, max_segments)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


def check_cfg(cfg: LaneConfig, lane_multiple: int = LANES) -> None:
    """The configs of this path: W=32, S=64, 16 < P <= 24 (wide tables) or
    W=16, S=32, P <= 16 (narrow tables), lanes a positive multiple of
    ``lane_multiple`` (128)."""
    ws = (cfg.word_bits, cfg.state_bits)
    if not ((ws == (32, 64) and 16 < cfg.precision <= 24)
            or (ws == (16, 32) and 0 < cfg.precision <= 16)):
        raise ValueError(
            "the exact-family coders take W=32, S=64, 16 < P <= 24 or W=16, "
            f"S=32, P <= 16; got W={cfg.word_bits}, S={cfg.state_bits}, "
            f"P={cfg.precision}")
    if cfg.num_lanes <= 0 or cfg.num_lanes % lane_multiple:
        raise ValueError(
            f"num_lanes must be a positive multiple of {lane_multiple}, got "
            f"{cfg.num_lanes}")


def _wide(cfg: LaneConfig) -> bool:
    return cfg.state_bits == 64


def check_grouped_cfg(cfg: LaneConfig) -> None:
    """Grouped coding (kernel 16) exists at S=64 only, as in the JAX
    package (its grouped decoder asserts S=64)."""
    check_cfg(cfg)
    if not _wide(cfg):
        raise ValueError(
            "grouped exact coding takes a W=32, S=64, 16 < P <= 24 config "
            "(the facade's grouped=True default); got W=16, S=32")


def _check_support(min_sym: int, max_sym: int, precision: int) -> None:
    """The support must leave free >= 2, as the table builders demand."""
    if max_sym <= min_sym or _free(min_sym, max_sym, precision) < 2:
        raise ValueError(
            f"support [{min_sym}, {max_sym}] does not fit precision "
            f"{precision}")


def _check_core_cap(means, scales, family: str, min_sym: int, max_sym: int,
                    cfg: LaneConfig) -> None:
    """Raises the table builders' ValueError when a model's core (the
    padded tail model's too, when the last step is partial) exceeds the
    table format's ncore cap, so no decoder could read the stream.  The
    deterministic bound :func:`_ncore_estimate` (which is at least the
    core size) picks the symbols worth the exact :func:`exact_ncore`."""
    wide = _wide(cfg)
    cap = (1 << (8 if wide else 16)) - 1
    mean = np.asarray(means, np.float64).reshape(-1)
    scale = np.asarray(scales, np.float64).reshape(-1)
    if len(mean) % cfg.num_lanes:
        pm, ps = _pad_params([], [], 1, family, max_sym)
        mean, scale = np.append(mean, pm), np.append(scale, ps)

    def need(nc):  # narrow tables hold boundary pairs
        return nc if wide else nc + (nc & 1)

    est = _ncore_estimate(mean, scale, family, min_sym, max_sym)
    big = need(est) > cap
    if not big.any():
        return
    worst = int(need(exact_ncore(mean[big], scale[big], family, min_sym,
                                 max_sym, cfg.precision).astype(np.int64)
                     ).max())
    if worst > cap:
        raise ValueError(
            f"core needs {worst} boundaries; the "
            f"{'wide' if wide else 'narrow'} table format caps ncore at "
            f"{cap}, so no decoder could read this stream")


def check_family(family: str, allowed=EXACT_FAMILIES) -> None:
    if family not in allowed:
        raise ValueError(f"family must be one of {allowed}, got {family!r}")


def _check_steps(name: str, t, device, shape: tuple) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous tensor of shape {shape}, got "
            f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_tables(tabs, device, T: int, L: int, wide: bool) -> int:
    """Packed decode tables int32 [T, CP1, L]: wide CP1 = 1 + 3G, G >= 1;
    narrow CP1 = cmax / 2 + 1 >= 2.  Returns CP1."""
    if not isinstance(tabs, torch.Tensor) or tabs.dim() != 3:
        raise ValueError("tabs must be a 3-D tensor [T, CP1, L]")
    CP1 = tabs.shape[1]
    if wide and (CP1 < 4 or (CP1 - 1) % 3):
        raise ValueError(f"tabs has {CP1} planes; expected 1 + 3G, G >= 1")
    if not wide and CP1 < 2:
        raise ValueError(f"tabs has {CP1} planes; expected cmax / 2 + 1 >= 2")
    _check_steps("tabs", tabs, device, (T, CP1, L))
    return CP1


# ---------------------------------------------------------------------------
# kernels 17 (S=64) and 14 (S=32): encode over (cum, prob) planes
# ---------------------------------------------------------------------------


def encode_tables(cums, probs, cfg: LaneConfig, seeds=None,
                  num_symbols: int | None = None):
    """ILANS2 encode of explicit per-symbol (cum, prob) planes: kernel 17
    at W=32/S=64, kernel 14 at W=16/S=32.  JAX counterpart:
    ``exact_family.encode_tables_pallas`` (``_build_exact_encoder64`` /
    ``_build_exact_encoder``); unlike it, this takes seeds.

    ``cums``, ``probs`` int32 ``[T, L]`` (u32 bits; symbol ``t * L + l``,
    padded past ``num_symbols`` -- default ``T * L`` -- with anything);
    ``seeds`` (optional) start states in [2^(S-W), 2^S): int64[L] (u64
    bits) at S=64, int32[L] (u32 bits) at S=32.  Returns ``(states[L],
    stream int32[num_words])``, the states in the seeds' type,
    bit-identical to ``interleaved2.encode_shared``.  CUDA tensors launch
    the kernel's two passes in one C call (their scratch the dense words,
    the ballots and the compaction's block offsets), reading the stream's
    start back (one sync); CPU tensors run :func:`encode_tables_plain`."""
    check_cfg(cfg)
    wide = _wide(cfg)
    state_dtype = torch.int64 if wide else torch.int32
    if not isinstance(cums, torch.Tensor):
        raise TypeError("cums must be a torch.Tensor")
    device = cums.device
    L = cfg.num_lanes
    T = cums.shape[0] if cums.dim() == 2 else -1
    _check_steps("cums", cums, device, (T, L))
    _check_steps("probs", probs, device, (T, L))
    n = T * L if num_symbols is None else int(num_symbols)
    if not (T - 1) * L < n <= T * L and not (n == 0 and T == 0):
        raise ValueError(
            f"num_symbols={n} does not fill the {T} steps of the planes")
    if seeds is not None:
        _check_seeds(seeds, cfg, state_dtype, device)
    if not _on_cuda(device):
        return encode_tables_plain(cums, probs, cfg, seeds, n)
    states = (seeds.clone() if seeds is not None else torch.full(
        (L,), cfg.lower_bound, dtype=state_dtype, device=device))
    if n == 0:
        return states, torch.zeros(0, dtype=torch.int32, device=device)
    buf = torch.empty(n, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int64, device=device)
    tag = "encode64" if wide else "encode32"
    LAUNCHES[tag] += 1
    _build.call(f"ctt_exact_{tag}", device, states, cums, probs, n, buf, n,
                end, *compaction_scratch(T, L, device), L, cfg.precision)
    return states, buf[int(end.item()):]


def encode_tables_plain(cums, probs, cfg: LaneConfig, seeds=None,
                        num_symbols: int | None = None):
    """Plain PyTorch twin of :func:`encode_tables` (any device, no checks):
    the step loop of ``coder64.encode_iid64_plain`` (S=64) or
    ``coder.encode_iid_plain`` (S=32) over the planes.  Numpy oracle:
    ``interleaved2.encode_shared``."""
    n = cums.numel() if num_symbols is None else int(num_symbols)
    steps = encode64_steps if _wide(cfg) else encode32_steps
    return steps(_plane_tables(cums, probs), n, cfg, seeds, cums.device)


def _plane_tables(cums, probs):
    """``tables_at(i)`` of the step loops over the planes: the (cum, prob)
    int64 of flat symbol indices ``i``."""
    flat_c = convert.u32_values(cums.reshape(-1))
    flat_p = convert.u32_values(probs.reshape(-1))

    def tables_at(i):
        return flat_c[i], flat_p[i]

    return tables_at


_M64 = (1 << 64) - 1


def plane_correct(q: int, x: int, prob: int) -> int:
    """Kernel 17's correction of a quotient estimate ``q`` of x / prob
    (``csrc/exact_family.cu``, ``PlaneInterval::divide`` at S=64): the
    remainder x - q prob in u64 arithmetic, read as a signed 64-bit value,
    then one step down or up.  floor(x / prob) for every estimate within
    one of it, given 1 <= prob <= 2^P and x < prob * 2^(64 - P), 16 < P <=
    24 (so that the true remainder lies in (-prob, 2 prob)).  Kernel 14
    (S=32) divides natively."""
    rem = (x - q * prob) & _M64
    if rem >= 1 << 63:
        return q - 1
    return q + 1 if rem >= prob else q


def plane_quotient(x: int, prob: int) -> int:
    """floor(x / prob) as kernel 17 takes it for x < prob * 2^(64 - P): an
    estimate truncated to an integer, then :func:`plane_correct`.  The
    kernel's estimate is x times an approximate reciprocal refined by two
    Newton steps, within 2^-50 of x / prob relatively; here it is the
    correctly rounded float64 quotient, within 2^-52 (Python's int ->
    float conversion and float division round to nearest even).  Both are
    off by at most one, where the correction makes them equal."""
    return plane_correct(int(float(x) / float(prob)), x, prob)


def encode_lanes_plain(cums, probs, cfg: LaneConfig, seeds=None,
                       num_symbols: int | None = None):
    """Pass A of kernel 17 (W=32/S=64) or kernel 14 (W=16/S=32) in plain
    PyTorch (any device, no checks): every lane runs steps T-1 .. 0 over
    its column of the planes on its own (``coder64.lanes64_steps`` /
    ``coder.lanes32_steps``).  Returns ``(words int32[T, L], flags bool[T,
    L], states[L])``, the states int64 at S=64 and int32 at S=32:
    ``flags[t, l]`` is set where lane l renorms before coding symbol t * L
    + l, and ``words[t, l]`` is then the word it emits (0 elsewhere).
    ``coder.compact_pass_plain`` of words and flags is
    :func:`encode_tables_plain`'s stream.  The kernels
    (``csrc/ilans2_wide.cuh``, ``encode_lanes_kernel`` over
    ``csrc/exact_family.cu``'s ``PlaneLanesModel``) keep ``flags`` as one
    ballot per 32 lanes (``coder.flag_ballots``)."""
    n = cums.numel() if num_symbols is None else int(num_symbols)
    steps = lanes64_steps if _wide(cfg) else lanes32_steps
    return steps(_plane_tables(cums, probs), n, cfg, seeds, cums.device)


# ---------------------------------------------------------------------------
# kernels 15 and 16 (wide tables) and 13 (narrow tables): decode
# ---------------------------------------------------------------------------


def _decode_args(states, stream, tabs, cfg: LaneConfig, min_sym: int,
                 max_sym: int, n: int,
                 lane_multiple: int = LANES) -> torch.device:
    check_cfg(cfg, lane_multiple)
    if not isinstance(states, torch.Tensor):
        raise TypeError("states must be a torch.Tensor")
    device = states.device
    wide = _wide(cfg)
    _check("states", states, torch.int64 if wide else torch.int32, device,
           cfg.num_lanes)
    _check("stream", stream, torch.int32, device)
    _check_tables(tabs, device, _num_steps(n, cfg.num_lanes), cfg.num_lanes,
                  wide)
    _check_support(min_sym, max_sym, cfg.precision)
    return device


# planes per lane (CP1 = 1 + 3G) from which kernels 15 and 16 (the cluster
# decode, whole message and segment) binary-search the packed fields
# instead of scanning them all: measured on an NVIDIA H100 80GB HBM3 at 700
# W by chip_smoke.py's search sweep (exact_times), where the lock-step
# binary search was faster at every width it met, kernel 16 from 16 planes
# (0.116 against 0.144 ms, 589824 symbols) through 19 (0.111 / 0.158), 37
# (0.112 / 0.248) and 58 (0.044 / 0.088) to 139 (1.117 / 6.304 ms at 2^22
# symbols), kernel 15 alike; narrower tables were not met and keep the scan
BISECT_FROM_PLANES = 16
# the same for kernel 13's narrow tables (CP1 = cmax / 2 + 1, two fields a
# plane) on the cluster step: measured on an NVIDIA H100 80GB HBM3 at 700 W
# by chip_smoke.py's narrow search sweep (exact32_times, 2^20 symbols,
# L=32768), where the lock-step binary search was faster at every width it
# met, from 3 planes (0.121 against 0.126 ms) through 7 (0.139 / 0.208),
# 17 (0.163 / 0.363) and 75 (0.233 / 1.250) to 128 (0.214 / 1.998);
# narrower tables were not met and keep the scan
BISECT_FROM_PLANES_NARROW = 3


def bisect_tables(CP1: int, narrow: bool = False) -> bool:
    """Whether kernels 15 and 16 (with ``narrow``, kernel 13)
    binary-search tables of ``CP1`` planes."""
    if narrow:
        return CP1 >= BISECT_FROM_PLANES_NARROW
    return CP1 >= BISECT_FROM_PLANES


def decode_tables(states, stream, tabs, cfg: LaneConfig, min_sym: int,
                  max_sym: int, num_symbols: int,
                  return_final_states: bool = False):
    """Decode ``num_symbols`` symbols of an exact-family stream: against
    packed wide tables at W=32/S=64 (kernel 15), against narrow tables at
    W=16/S=32 (kernel 13).  JAX counterpart:
    ``exact_family.decode_family_exact``'s kernels
    (``_build_exact_decoder64`` / ``_build_exact_decoder``).

    ``states`` int64[L] (u64 bits) at S=64 or int32[L] (u32 bits) at S=32,
    ``stream`` int32 words, ``tabs`` int32 ``[T, CP1, L]``
    (``convert.exact_tables_to_torch``), one device.  Returns symbols
    int32[n], and with ``return_final_states`` also the final states.
    CUDA tensors launch the kernel (ValueError for L above
    :data:`MAX_DECODE_LANES`), CPU tensors run :func:`decode_tables_plain`
    at any L."""
    device = _decode_args(states, stream, tabs, cfg, min_sym, max_sym,
                          num_symbols)
    if not _on_cuda(device):
        syms, fin, _ = decode_tables_plain(states, stream, tabs, cfg,
                                           min_sym, max_sym, num_symbols)
        return (syms, fin) if return_final_states else syms
    _check_reach(cfg)
    fin = states.clone()
    syms = torch.empty(num_symbols, dtype=torch.int32, device=device)
    if num_symbols:
        tag = "decode64" if _wide(cfg) else "decode32"
        _build.call(f"ctt_exact_{tag}", device, fin, stream, stream.numel(),
                    tabs, tabs.shape[1], syms, num_symbols, cfg.num_lanes,
                    cfg.precision, min_sym, max_sym,
                    int(bisect_tables(tabs.shape[1], not _wide(cfg))), None)
        LAUNCHES[tag] += 1
    return (syms, fin) if return_final_states else syms


def _check_reach(cfg: LaneConfig) -> None:
    """The table decodes (kernels 15 and 16 at S=64, 13 at S=32) run on a
    cluster of at most 16 CTAs: L past :data:`MAX_DECODE_LANES` raises
    before a launch."""
    if cfg.num_lanes > MAX_DECODE_LANES:
        raise ValueError(
            f"the exact table decode kernel takes at most {MAX_DECODE_LANES} "
            f"lanes (16 CTAs x 1024 threads x 32 lanes a thread), got "
            f"{cfg.num_lanes}")


def geometry(L: int, device=None, seg: bool = False,
             narrow: bool = False) -> dict:
    """Kernel 15's (with ``seg``, kernel 16's; with ``narrow``, kernel
    13's) launch geometry for L lanes on ``device`` (a CUDA device; the
    current one by default): its cluster, the CTAs' groups, lanes per
    thread and threads, and the card's maximum of such active clusters."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.zeros(5, dtype=torch.int64)
    if narrow:
        _build.call("ctt_exact_geometry32", device, L, out)
    else:
        _build.call("ctt_exact_geometry64", device, L, int(seg), out)
    keys = ("cluster", "groups_per_cta", "lanes_per_thread",
            "threads_per_cta", "max_active_clusters")
    geo = dict(zip(keys, (int(v) for v in out)))
    geo["ctas"] = geo["cluster"]
    return geo


def decode_tables_seg(states, stream, tabs, base, cfg: LaneConfig,
                      min_sym: int, max_sym: int, num_symbols: int):
    """One segment of a grouped decode (kernel 16, S=64, the cluster decode
    from stream word ``base`` on): as :func:`decode_tables` from that word.
    JAX counterpart: ``exact_family._build_exact_decoder64_seg``.

    ``base`` int64[1] on the states' device.  Returns ``(symbols int32[n],
    final states int64[L], next base int64[1])``; the next segment starts
    from those states and that base, with no host round trip.  CUDA
    tensors launch the kernel (ValueError for L above
    :data:`MAX_DECODE_LANES`), CPU tensors run :func:`decode_tables_plain`."""
    check_grouped_cfg(cfg)
    device = _decode_args(states, stream, tabs, cfg, min_sym, max_sym,
                          num_symbols)
    _check("base", base, torch.int64, device, 1)
    if not _on_cuda(device):
        return decode_tables_plain(states, stream, tabs, cfg, min_sym,
                                   max_sym, num_symbols, base)
    return _launch_seg(states, stream, tabs, base, cfg, min_sym, max_sym,
                       num_symbols)


def _launch_seg(states, stream, tabs, base, cfg: LaneConfig, min_sym: int,
                max_sym: int, num_symbols: int, cluster: int = 0):
    """One launch of kernel 16 (``cluster`` CTAs, or the size it picks from
    L when 0), counted after it returns."""
    _check_reach(cfg)
    fin = states.clone()
    nxt = base.clone()
    syms = torch.empty(num_symbols, dtype=torch.int32, device=states.device)
    if num_symbols:
        entry, extra = (("ctt_exact_decode64_seg_cluster", (cluster,))
                        if cluster else ("ctt_exact_decode64_seg", ()))
        _build.call(entry, states.device, fin, stream, stream.numel(), tabs,
                    tabs.shape[1], syms, num_symbols, cfg.num_lanes,
                    cfg.precision, min_sym, max_sym,
                    int(bisect_tables(tabs.shape[1])), nxt, *extra)
        LAUNCHES["decode64_seg"] += 1
    return syms, fin, nxt


def decode_tables_seg_cluster(states, stream, tabs, base, cfg: LaneConfig,
                              min_sym: int, max_sym: int, num_symbols: int,
                              cluster: int):
    """:func:`decode_tables_seg` on a cluster of ``cluster`` CTAs (1 .. 16)
    in place of the size it picks from L (CUDA tensors): how the card tests
    reach uneven partitions and CTAs with no lanes."""
    check_grouped_cfg(cfg)
    device = _decode_args(states, stream, tabs, cfg, min_sym, max_sym,
                          num_symbols)
    _check("base", base, torch.int64, device, 1)
    if not _on_cuda(device):
        raise ValueError("a forced cluster size needs CUDA tensors")
    if not 1 <= cluster <= 16:
        raise ValueError(f"cluster must be in 1 .. 16, got {cluster}")
    return _launch_seg(states, stream, tabs, base, cfg, min_sym, max_sym,
                       num_symbols, cluster)


def decode_tables32_cluster(states, stream, tabs, cfg: LaneConfig,
                            min_sym: int, max_sym: int, num_symbols: int,
                            cluster: int = 0, bisect: bool | None = None):
    """Kernel 13 (W=16, S=32, narrow tables) on a cluster of ``cluster``
    CTAs (1 .. 16; 0: the size it picks from L) and with its search forced
    (``bisect`` True or False; None: by table width, as
    :func:`decode_tables` picks), for any L that is a multiple of 32 (CUDA
    tensors): how the card tests reach small lane counts, uneven
    partitions and both searches.  Returns ``(symbols int32[n], final
    states int32[L])``."""
    if _wide(cfg):
        raise ValueError("kernel 13 decodes S=32 narrow tables; got S=64")
    device = _decode_args(states, stream, tabs, cfg, min_sym, max_sym,
                          num_symbols, lane_multiple=32)
    if not _on_cuda(device):
        raise ValueError("a forced cluster size needs CUDA tensors")
    if not 0 <= cluster <= 16:
        raise ValueError(f"cluster must be in 0 .. 16, got {cluster}")
    _check_reach(cfg)
    if bisect is None:
        bisect = bisect_tables(tabs.shape[1], True)
    fin = states.clone()
    syms = torch.empty(num_symbols, dtype=torch.int32, device=device)
    if num_symbols:
        entry, extra = (("ctt_exact_decode32_cluster", (cluster,)) if cluster
                        else ("ctt_exact_decode32", ()))
        _build.call(entry, device, fin, stream, stream.numel(), tabs,
                    tabs.shape[1], syms, num_symbols, cfg.num_lanes,
                    cfg.precision, min_sym, max_sym, int(bisect), None,
                    *extra)
        LAUNCHES["decode32"] += 1
    return syms, fin


def _table_fields(tab):
    """The (b - 1) fields of one step's wide table planes ``[CP1, L]`` (u32
    values in int64), in order: ``[4G, L]``."""
    w0, w1, w2 = tab[1::3], tab[2::3], tab[3::3]
    b0 = w0 & 0xFFFFFF
    b1 = (w0 >> 24) | ((w1 & 0xFFFF) << 8)
    b2 = (w1 >> 16) | ((w2 & 0xFF) << 16)
    b3 = w2 >> 8
    return torch.stack([b0, b1, b2, b3], dim=1).reshape(-1, tab.shape[1])


def _narrow_fields(tab):
    """The (b - 1) fields of one step's narrow table planes ``[CP1, L]``
    (u32 values in int64), in order, the low half of a plane first:
    ``[2 (CP1 - 1), L]``."""
    w = tab[1:]
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(-1, tab.shape[1])


def invert_tables(q, tab, min_sym: int, max_sym: int, P: int):
    """Quantiles int64[L] -> ``(sym, cum, prob)`` int64 against one step's
    packed table planes (u32 values in int64, ``[CP1, L]``; wide for P >
    16, narrow otherwise): the kernels' scan with select semantics (``cnt``
    counts the fields below q, the last selected field is ``cumc``, its
    successor ``nxtc``; past the last field the pad value, 2^P - 1 wide and
    0xFFFF narrow, stands in) and the left-tail / core / right-tail regions
    of ``_invert_with_tables``."""
    wide = P > 16
    fields = _table_fields(tab) if wide else _narrow_fields(tab)
    nf = fields.shape[0]
    le = fields < q
    cnt = le.sum(0)
    pos = torch.arange(1, nf + 1, device=q.device)[:, None]
    last = (le * pos).max(0).values - 1  # -1 when nothing is selected
    cumc = fields.gather(0, last.clamp(min=0)[None])[0] + 1
    succ = fields.gather(0, (last + 1).clamp(max=nf - 1)[None])[0]
    nxtc = torch.where(last + 1 >= nf, (1 << P) - 1 if wide else 0xFFFF,
                       succ) + 1
    return _table_regions(q, tab[0], cnt, cumc, nxtc, min_sym, max_sym, P)


def invert_tables_bisect(q, tab, min_sym: int, max_sym: int, P: int):
    """:func:`invert_tables` by the kernels' lock-step binary search
    (``csrc/exact_family.cu``: ``TableModel::invert_lanes`` for wide
    tables, P > 16, kernels 15 and 16; ``NarrowTableModel::invert_lanes``
    for narrow ones, kernel 13), in their probe order: a branchless lower
    bound over the N fields (4G wide, 2 (CP1 - 1) narrow; every lane probes
    ``base + half`` at each of the ceil(log2 N) levels and moves ``base``
    up where that field is below q), then one level reading the fields at
    and after ``base`` (kernel 15 also reads the one before, which is never
    used: ``base`` moves past 0 only onto a field below q).  Equal to
    :func:`invert_tables` on tables whose fields ascend (pads last: 2^P - 1
    wide, 0xFFFF narrow), as the builders write them."""
    wide = P > 16
    fields = _table_fields(tab) if wide else _narrow_fields(tab)
    N = fields.shape[0]
    lanes = torch.arange(fields.shape[1], device=q.device)
    base = torch.zeros_like(q)
    length = N
    while length > 1:
        half = length >> 1
        base = torch.where(fields[base + half, lanes] < q, base + half, base)
        length -= half
    fb = fields[base, lanes]
    fn = fields[(base + 1).clamp(max=N - 1), lanes]
    below = fb < q
    cnt = base + below.to(torch.int64)
    cumc = torch.where(below, fb, _M32)
    pad = (1 << P) - 1 if wide else 0xFFFF
    nxtc = torch.where(below, torch.where(base + 1 < N, fn, pad), fb)
    return _table_regions(q, tab[0], cnt, cumc + 1, nxtc + 1, min_sym,
                          max_sym, P)


def _table_regions(q, aux, cnt, cum_c, nxt_c, min_sym: int, max_sym: int,
                   P: int):
    """The regions of ``_invert_with_tables`` once the core search has
    given ``cnt`` (fields below q), ``cum_c`` (b of the last of them) and
    ``nxt_c`` (b of its successor): the left tail, the core or the
    saturated right tail decide ``(sym, cum, prob)``."""
    free = (1 << P) - 1 - (max_sym - min_sym)
    span = max_sym - min_sym
    shift = 24 if P > 16 else 16
    cl = aux & ((1 << shift) - 1)
    nc = aux >> shift
    core_hi_rel = cl + nc - 1
    rstart = torch.where(core_hi_rel >= span, 1 << P,
                         free + 1 + core_hi_rel)
    s_rel_l = torch.minimum(q, cl - 1)
    next_l = torch.where(s_rel_l >= cl - 1, nxt_c, s_rel_l + 1)
    sym_c = cl + cnt - 1
    next_c = torch.minimum(nxt_c, rstart)
    s_rel_r = (q - free).clamp(max=span)
    cum_r = free + s_rel_r
    next_r = torch.where(s_rel_r >= span, 1 << P, cum_r + 1)
    right = q >= rstart
    leftr = cnt == 0
    s_rel = torch.where(right, s_rel_r, torch.where(leftr, s_rel_l, sym_c))
    cum = torch.where(right, cum_r, torch.where(leftr, s_rel_l, cum_c))
    nxt = torch.where(right, next_r, torch.where(leftr, next_l, next_c))
    return s_rel + min_sym, cum, (nxt - cum) & _M32


def decode_tables_plain(states, stream, tabs, cfg: LaneConfig, min_sym: int,
                        max_sym: int, num_symbols: int, base=None,
                        bisect: bool = False):
    """Plain PyTorch twin of kernels 15, 16 and 13 (any device, no checks).
    Returns ``(symbols int32[n], final states, next base int64[1])``, the
    states in the type of ``states``, decoding from stream word ``base``
    (int64[1], default 0).  ``bisect`` inverts by the kernels' binary search
    (:func:`invert_tables_bisect`) in place of their scan
    (:func:`invert_tables`).  Numpy oracle: :func:`decode_family_exact_host`."""
    invert = invert_tables_bisect if bisect else invert_tables
    L, P = cfg.num_lanes, cfg.precision
    device = states.device
    words = convert.u32_values(stream)
    T = _num_steps(num_symbols, L)
    lanes = torch.arange(L, device=device)
    out = torch.empty(T * L, dtype=torch.int32, device=device)
    pos = (torch.zeros((), dtype=torch.int64, device=device) if base is None
           else base.reshape(()).clone())
    if not _wide(cfg):
        # S=32: the state algebra fits int64 whole
        x = convert.u32_values(states)
        for t in range(T):
            active = t * L + lanes < num_symbols
            q = x & ((1 << P) - 1)
            sym, cum, prob = invert(q, convert.u32_values(tabs[t]),
                                           min_sym, max_sym, P)
            x = torch.where(active, (x >> P) * prob + (q - cum), x)
            m = x < cfg.lower_bound
            w, pos = _refill_words(m, words, pos)
            x = torch.where(m, (x << cfg.word_bits) | (w & cfg.word_mask), x)
            out[t * L:(t + 1) * L] = sym.to(torch.int32)
        return out[:num_symbols], convert.u32_bits(x), pos.reshape(1)
    hi, lo = convert.u64_halves(states)
    for t in range(T):
        active = t * L + lanes < num_symbols
        q = lo & ((1 << P) - 1)
        sym, cum, prob = invert(q, convert.u32_values(tabs[t]),
                                       min_sym, max_sym, P)
        # (state >> P) * prob + (q - cum), the product split at 2^32
        sh_hi = hi >> P
        sh_lo = ((hi << (32 - P)) & _M32) | (lo >> P)
        low = sh_lo * prob + ((q - cum) & _M32)  # < 2^57
        hi = torch.where(active, (sh_hi * prob + (low >> 32)) & _M32, hi)
        lo = torch.where(active, low & _M32, lo)
        m = hi == 0
        w, pos = _refill_words(m, words, pos)
        hi, lo = torch.where(m, lo, hi), torch.where(m, w, lo)
        out[t * L:(t + 1) * L] = sym.to(torch.int32)
    return out[:num_symbols], convert.u64_join(hi, lo), pos.reshape(1)


# ---------------------------------------------------------------------------
# the coders over (means, scales)
# ---------------------------------------------------------------------------


def encode_family_exact(symbols, means, scales, family: str, min_sym: int,
                        max_sym: int, cfg: LaneConfig, device, seeds=None):
    """Reference-exact family encode: host f64 (cum, prob) planes, kernel
    17 (S=64) or kernel 14 (S=32) on ``device`` (the twin on the CPU).
    ``symbols``, ``means``, ``scales`` numpy; ``seeds`` optional numpy [L]
    (u64 at S=64, u32 at S=32).  Returns ``(states[L], stream int32)``
    tensors on ``device``, the states int64 (u64 bits) at S=64 and int32
    (u32 bits) at S=32.

    Before it codes, it makes the decoders' checks of the model: the
    support leaves free >= 2 and no core exceeds the table format's cap;
    otherwise it raises ValueError, where the JAX package writes a stream
    that no decoder reads.  JAX counterpart:
    ``exact_family.encode_family_exact``."""
    check_cfg(cfg)
    check_family(family)
    _check_support(min_sym, max_sym, cfg.precision)
    _check_core_cap(means, scales, family, min_sym, max_sym, cfg)
    cums, probs = exact_ecp(symbols, means, scales, family, min_sym, max_sym,
                            cfg.precision)
    c_t, p_t = convert.ecp_to_torch(cums, probs, cfg.num_lanes, device)
    seeds_t = (None if seeds is None
               else convert.states_to_torch(seeds, cfg, device))
    return encode_tables(c_t, p_t, cfg, seeds_t, len(cums))


def encode_family_exact_grouped(symbols, means, scales, family: str,
                                min_sym: int, max_sym: int, cfg: LaneConfig,
                                device, max_segments: int = 10):
    """Core-size-grouped reference-exact encode: :func:`encode_family_exact`
    of the symbols in :func:`group_plan` order.  JAX counterpart:
    ``exact_family.encode_family_exact_grouped``."""
    check_family(family, tuple(_EST_C))
    symbols = np.asarray(symbols).reshape(-1)
    means = np.asarray(means, np.float64).reshape(-1)
    scales = np.asarray(scales, np.float64).reshape(-1)
    check_grouped_cfg(cfg)
    perm, _ = group_plan(means, scales, family, min_sym, max_sym,
                         cfg.precision, cfg.num_lanes, len(symbols),
                         max_segments)
    return encode_family_exact(symbols[perm], means[perm], scales[perm],
                               family, min_sym, max_sym, cfg, device)


def _device_tables_default(family: str, min_sym: int, max_sym: int,
                           device) -> bool:
    """The on-card builder for the continuous families on a CUDA device,
    within the JAX package's support bound (2^22); the host builder
    otherwise (binomial always)."""
    return (torch.device(device).type == "cuda"
            and family in DEVICE_FAMILIES
            and max(abs(int(min_sym)), abs(int(max_sym))) <= (1 << 22))


def _segment_tables(pm, ps, segs, family, min_sym, max_sym, cfg, device,
                    device_tables: bool):
    """[(tabs int32 [nsteps, CP1, L], cmax)] of each segment ``(t0,
    nsteps, cmax)`` over the padded parameters ``pm``, ``ps``."""
    L = cfg.num_lanes
    if device_tables:
        from . import exact_tables

        return exact_tables.packed_tables_on_device_batch(
            [(pm[t0 * L:(t0 + ns) * L], ps[t0 * L:(t0 + ns) * L], cm, ns)
             for t0, ns, cm in segs],
            family, min_sym, max_sym, cfg.precision, L, device)
    out = []
    for t0, ns, cm in segs:
        tabs4, cmax_r = packed_tables_device(
            pm[t0 * L:(t0 + ns) * L], ps[t0 * L:(t0 + ns) * L], family,
            min_sym, max_sym, cfg.precision, cm, ns, L // LANES)
        out.append((convert.exact_tables_to_torch(tabs4, device), cmax_r))
    return out


def decode_family_exact(init_states, stream, means, scales, family: str,
                        min_sym: int, max_sym: int, cfg: LaneConfig,
                        num_symbols: int, cmax: int | None = None,
                        device_tables: bool | None = None):
    """Reference-exact family decode: tables for every step, then one
    launch of kernel 15 (S=64) or kernel 13 (S=32).  ``init_states``
    (int64[L] at S=64, int32[L] at S=32) and ``stream`` int32 on one
    device; ``means``, ``scales`` numpy.

    S=64: ``device_tables`` (default: on a CUDA device for gaussian,
    laplace and cauchy, as :func:`decode_family_exact_grouped`) builds the
    tables on the card (kernel 18), else the host builder runs; both give
    the same tables bit for bit.  ``cmax=None`` sizes the table width to
    this batch's largest core: :func:`exact_ncore` for the host builder;
    the on-card builder starts from the deterministic bound
    :func:`_ncore_estimate` (at most 255) and cuts its tables to the
    tight width itself.  S=32: narrow tables from the host builder
    (:func:`narrow_tables`; ``cmax``, when given, even), as in the JAX
    package, which has no on-device narrow builder; ``device_tables=True``
    raises.  Returns symbols int32[n].  JAX counterpart:
    ``exact_family.decode_family_exact``."""
    check_cfg(cfg)
    check_family(family)
    device = init_states.device
    wide = _wide(cfg)
    if device_tables is None:
        device_tables = wide and _device_tables_default(family, min_sym,
                                                        max_sym, device)
    elif device_tables:
        if not wide:
            raise ValueError(
                "narrow (S=32) tables are built on the host: pass "
                "device_tables=False or None")
        check_family(family, DEVICE_FAMILIES)
    n = int(num_symbols)
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=device)
    L = cfg.num_lanes
    T = _num_steps(n, L)
    pm, ps = _pad_params(means, scales, T * L, family, max_sym)
    if not wide:
        tabs4, _ = narrow_tables(pm, ps, family, min_sym, max_sym,
                                 cfg.precision, cmax, T, L // LANES)
        tabs = convert.exact_tables_to_torch(tabs4, device)
    else:
        if cmax is None and device_tables:
            est = int(_ncore_estimate(pm, ps, family, min_sym, max_sym).max())
            cmax = min(255, -(-est // 4) * 4)
        elif cmax is None:
            nc = exact_ncore(pm, ps, family, min_sym, max_sym, cfg.precision)
            cmax = max(int(nc.max()) if len(nc) else 1, 1)
        (tabs, _), = _segment_tables(pm, ps, [(0, T, cmax)], family,
                                     min_sym, max_sym, cfg, device,
                                     device_tables)
    return decode_tables(init_states, stream, tabs, cfg, int(min_sym),
                         int(max_sym), n)


def decode_segments(init_states, stream, pm, ps, segs, family: str,
                    min_sym: int, max_sym: int, cfg: LaneConfig,
                    num_symbols: int, device_tables: bool):
    """Grouped decode of the first ``num_symbols`` symbols of a permuted
    message: one kernel-16 launch per segment ``(t0, nsteps, cmax)`` (the
    segments cover the message's steps in order), lane states and the
    stream offset chained from launch to launch.  Returns ``(symbols
    int32[n] in wire order, final states int64[L])``."""
    device = init_states.device
    L = cfg.num_lanes
    built = _segment_tables(pm, ps, segs, family, min_sym, max_sym, cfg,
                            device, device_tables)
    base = torch.zeros(1, dtype=torch.int64, device=device)
    states = init_states
    outs = []
    for (t0, nsteps, _), (tabs, _) in zip(segs, built):
        n_seg = min(nsteps * L, num_symbols - t0 * L)
        syms, states, base = decode_tables_seg(
            states, stream, tabs, base, cfg, int(min_sym), int(max_sym),
            n_seg)
        outs.append(syms)
    syms = (torch.cat(outs) if outs
            else torch.zeros(0, dtype=torch.int32, device=device))
    return syms, states


def decode_family_exact_grouped(init_states, stream, means, scales,
                                family: str, min_sym: int, max_sym: int,
                                cfg: LaneConfig, num_symbols: int,
                                max_segments: int = 10,
                                device_tables: bool | None = None):
    """Decode a :func:`encode_family_exact_grouped` stream: the core-size
    order from (means, scales), one tight-width kernel-16 launch per
    segment, symbols scattered back to their positions.  ``device_tables``
    (default: on a CUDA device for gaussian, laplace and cauchy) builds the
    tables on the card (kernel 18); otherwise the host builder runs.
    Returns symbols int32[n] on the states' device.  JAX counterpart:
    ``exact_family.decode_family_exact_grouped``."""
    check_family(family, tuple(_EST_C))
    check_grouped_cfg(cfg)
    device = init_states.device
    n = int(num_symbols)
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=device)
    if device_tables is None:
        device_tables = _device_tables_default(family, min_sym, max_sym,
                                               device)
    elif device_tables:
        check_family(family, DEVICE_FAMILIES)
    means = np.asarray(means, np.float64).reshape(-1)
    scales = np.asarray(scales, np.float64).reshape(-1)
    L = cfg.num_lanes
    perm, segments = group_plan(means, scales, family, min_sym, max_sym,
                                cfg.precision, L, n, max_segments)
    T = _num_steps(n, L)
    pm, ps = _pad_params(means[perm], scales[perm], T * L, family, max_sym)
    syms, _ = decode_segments(init_states, stream, pm, ps, segments, family,
                              min_sym, max_sym, cfg, n, device_tables)
    out = torch.empty_like(syms)
    out[torch.from_numpy(perm).to(device)] = syms
    return out
