"""On-card construction of the reference-exact wide decode tables.

A table row is a pure function of (mean, scale): ``tv(s) =
trunc_u32(free * CDF_f64(s - 1/2))`` over the symbol's core, evaluated
with glibc's libm on the host (``exact_family.packed_tables_device``).
This module builds the same rows on the card:

1. window evaluation (:func:`eval_window`, kernel 18 of
   ``csrc/exact_family.cu``): per symbol and window position, ``A =
   free * CDF(t)`` in native float64 with CUDA's ``erf`` / ``exp`` /
   ``atan``, for the entries before each row's live end
   (:func:`live_ends_plain`); the entries from there on are known
   without a CDF.  An entry's trunc value is taken from A only where A is
   farther than ``MARGIN`` (2^-6) from an integer; the margin is about
   2^22 times the float64 error of A at P = 24 (|A| < 2^24, error below
   2^-28), so no accepted entry can carry a wrong value.  The others are
   flagged ambiguous.  Saturation (the right core edge: trunc >= free
   needs the f64 CDF to round to exactly 1.0) is decided by a per-family
   threshold on the standardized argument, found once on the host by
   bisection over f64 bit patterns (:func:`sat_threshold`); a band of
   ``|t*| 2^-30 + 2^-30`` around it stays ambiguous;
2. host patches: the ambiguous entries are re-evaluated exactly on the
   host (:func:`exact_tv_at`, the host codec over glibc's libm);
3. :func:`derive_pack`: torch operations on the card derive each row's
   (core_lo, ncore) and pack the planes;
4. rows whose window was inconclusive or overflowed, and whole segments
   with too many ambiguous entries, are built by the host builder; these
   depend on the data, are part of the algorithm and are counted
   (``HOST_ROWS``, ``HOST_SEGMENTS``).

Exactness rests on the margin, the host patches and two canaries run once
per device before the builder is trusted (:func:`eval_window_canary`,
:func:`builder_canary`); a failed canary raises RuntimeError.  Nothing
switches the path off quietly.

JAX counterpart: ``constriction_tpu/ops/exact_tables_jax.py`` (XLA f64)
with ``exact_family.packed_tables_on_device_batch`` and
``_device_builder_canary``, and ``df32_pallas.py`` (the double-f32 Pallas
window evaluator and ``df32_eval_canary``).  The Chebyshev surrogates and
the df32 arithmetic are the TPU's stand-ins for native f64 and are not
carried over; ``CTPU_DF32_EVAL`` is not read.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

from .. import convert, native
from . import _build
from . import exact_family as ef
from .coder import _on_cuda

MARGIN = 2.0 ** -6
_SQRT2 = math.sqrt(2.0)

# rows and segments the host builder made inside the on-card builder
HOST_ROWS = {"count": 0}
HOST_SEGMENTS = {"count": 0}

_CANARY_OK: dict = {}


# ---------------------------------------------------------------------------
# saturation thresholds (host, once per family)
# ---------------------------------------------------------------------------


def _bits(x: float) -> int:
    return np.float64(x).view(np.int64).item()


def _from_bits(b: int) -> float:
    return np.int64(b).view(np.float64).item()


def _cdf_std(family: str, t: float) -> float:
    """Host CDF in the standardized argument the evaluator produces
    (gaussian: the erf argument ``(x - mean) / (scale * sqrt2)``).  JAX
    counterpart: ``exact_tables_jax._cdf_std``."""
    if family == "gaussian":
        return (1.0 + math.erf(t)) / 2.0
    if family == "laplace":
        if t < 0:
            return 0.5 * math.exp(t)
        return 1.0 - 0.5 * math.exp(-t)
    return 0.5 + math.atan(t) / math.pi


@functools.lru_cache(maxsize=None)
def sat_threshold(family: str) -> float:
    """Smallest f64 t with ``_cdf_std(t) == 1.0`` (bisection over bit
    patterns against the host libm), +inf when none below 1e18.  JAX
    counterpart: ``exact_tables_jax.sat_threshold``."""
    hi = 1e18
    if _cdf_std(family, hi) < 1.0:
        return math.inf
    lo = 0.0
    blo, bhi = _bits(lo), _bits(hi)
    while bhi - blo > 1:
        mid = (blo + bhi) // 2
        if _cdf_std(family, _from_bits(mid)) >= 1.0:
            bhi = mid
        else:
            blo = mid
    return _from_bits(bhi)


def _band(family: str):
    """(t_star, eps, has_star) of the saturation rule."""
    t_star = sat_threshold(family)
    if math.isinf(t_star):
        return 0.0, 0.0, False
    return t_star, abs(t_star) * 2.0 ** -30 + 2.0 ** -30, True


# ---------------------------------------------------------------------------
# window evaluation: kernel 18 and its twin
# ---------------------------------------------------------------------------


def _check_window_args(means, scales, ws, family, min_sym, max_sym,
                       precision, W):
    ef.check_family(family, ef.DEVICE_FAMILIES)
    if not isinstance(means, torch.Tensor):
        raise TypeError("means must be a torch.Tensor")
    device = means.device
    n = means.numel()
    for name, t, dtype in (("means", means, torch.float64),
                           ("scales", scales, torch.float64),
                           ("ws", ws, torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"{name} must be a {dtype} tensor")
        if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor of "
                             f"{n} entries")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if W < 1:
        raise ValueError(f"W must be positive, got {W}")
    if not 16 < precision <= 24 or ef._free(min_sym, max_sym, precision) < 2:
        raise ValueError(
            f"precision {precision} and support [{min_sym}, {max_sym}] "
            "do not give a wide-table free weight")
    if max(abs(int(min_sym)), abs(int(max_sym))) > (1 << 30):
        raise ValueError("the window evaluator takes supports within 2^30")
    return device


def eval_window(means, scales, ws, family: str, min_sym: int, max_sym: int,
                precision: int, W: int):
    """``tv`` and ambiguity over the per-symbol windows ``s = ws[i] + j``,
    j in [0, W).  ``means``, ``scales`` float64[n], ``ws`` int32[n] on one
    device.  Returns ``(tv int32 [n, W], ambig bool [n, W])``: unambiguous
    entries carry their exact trunc value; out-of-support entries (s >
    max_sym) carry the sentinel ``free`` and are unambiguous.  CUDA
    tensors launch kernel 18, CPU tensors run :func:`eval_window_plain`.
    JAX counterpart: ``exact_tables_jax.eval_window`` /
    ``df32_pallas.eval_window_family_pallas``."""
    device = _check_window_args(means, scales, ws, family, min_sym, max_sym,
                                precision, W)
    if not _on_cuda(device):
        return eval_window_plain(means, scales, ws, family, min_sym, max_sym,
                                 precision, W)
    n = means.numel()
    tv = torch.empty((n, W), dtype=torch.int32, device=device)
    ambig = torch.empty((n, W), dtype=torch.bool, device=device)
    if n:
        t_star, eps, has_star = _band(family)
        ef.LAUNCHES["eval_window"] += 1
        _build.call("ctt_exact_eval_window", device, means, scales, ws, n, W,
                    ef.DEVICE_FAMILIES.index(family), int(min_sym),
                    int(max_sym), int(precision), t_star, eps, int(has_star),
                    tv, ambig)
    return tv, ambig


def eval_window_plain(means, scales, ws, family: str, min_sym: int,
                      max_sym: int, precision: int, W: int):
    """Plain PyTorch twin of :func:`eval_window` (any device, no checks):
    one float64 torch operation per step of ``_eval_window64``, in the
    kernel's order.  JAX counterpart: ``exact_tables_jax._eval_window64``
    without its Chebyshev surrogates."""
    free = ef._free(min_sym, max_sym, precision)
    freei = int(free)
    m = MARGIN
    s, t = window_t(means, scales, ws, family, W)
    if family == "gaussian":
        cdf = 0.5 * (1.0 + torch.special.erf(t))
    elif family == "laplace":
        cdf = torch.where(t < 0, 0.5 * torch.exp(t), 1.0 - 0.5 * torch.exp(-t))
    else:
        # a tensor divisor: torch multiplies by a rounded reciprocal when a
        # CUDA tensor is divided by a Python scalar
        cdf = 0.5 + torch.atan(t) / torch.full_like(t, math.pi)
    A = free * cdf
    I = torch.round(A)
    f = A - I
    fl = torch.floor(f)
    u = I.to(torch.int32) + fl.to(torch.int32)
    fr = f - fl
    unamb_frac = (fr > m) & (fr < 1.0 - m)
    # A + margin < 1 pins trunc to 0 regardless of sign wobble near 0
    unamb_zero = (u <= 0) & (A < 1.0 - m)
    t_star, eps, has_star = _band(family)
    if has_star:
        d = t - t_star
        certain_sat = d > eps
        band = d.abs() <= eps
    else:
        certain_sat = torch.zeros_like(unamb_frac)
        band = torch.zeros_like(unamb_frac)
    # below the threshold the CDF is certainly < 1.0: A margin-close to
    # free from below pins the value to free - 1
    unamb_top = (~certain_sat) & (~band) & (A > free - 1.0 + m)
    tv = u.clamp(min=0)
    tv = torch.where(unamb_zero, 0, tv)
    tv = torch.where(unamb_top, freei - 1, tv)
    tv = torch.where(certain_sat, freei, tv)
    unamb = unamb_frac | unamb_zero | unamb_top | certain_sat
    ambig = (~unamb) | band
    oos = s > max_sym
    tv = torch.where(oos, freei, tv).to(torch.int32)
    ambig = ambig & ~oos
    return tv, ambig


def window_t(means, scales, ws, family: str, W: int):
    """The window's symbol values ``s = ws[i] + j`` int64 [n, W] and their
    standardized arguments ``t = ((s - 1/2) - mean) / den`` float64 [n,
    W], den the scale (gaussian: times sqrt 2), as kernel 18 rounds
    them."""
    j = torch.arange(W, dtype=torch.int64, device=means.device)
    s = ws.to(torch.int64)[:, None] + j[None, :]
    return s, _std_arg(s, means[:, None], _den(scales, family)[:, None])


def _den(scales, family: str):
    """The kernel's den: the scale, times sqrt 2 for gaussian (the erf
    argument)."""
    return scales * _SQRT2 if family == "gaussian" else scales


def _std_arg(s, mean, den):
    """((s - 1/2) - mean) / den in float64 torch operations."""
    return ((s.to(torch.float64) - 0.5) - mean) / den


def live_ends_plain(means, scales, ws, family: str, max_sym: int, W: int):
    """Each row's live end as kernel 18 finds it (any device, no checks):
    the first window position j whose entry is out of the support (s >
    max_sym) or certainly saturated (t - t* > eps), else W; int64 [n].
    Every entry at and past it is ``(free, False)`` in
    :func:`eval_window_plain`, whatever its CDF.  Both tests are monotone
    in j where den > 0 (a subtraction and a division by a positive number
    round monotonically), so the saturation end is a search over [0,
    support end) with the entry's own arithmetic: a binary search here, for
    all rows in lock step; the kernel probes eight positions a round, the
    eight lanes of a row at once, and finds the same first position.  Rows
    with den not above 0 (or a family without t*) end at the support
    end."""
    ws64 = ws.to(torch.int64)
    end = (max_sym - ws64 + 1).clamp(0, W)
    t_star, eps, has_star = _band(family)
    if not has_star:
        return end
    den = _den(scales, family)
    lo = torch.zeros_like(end)
    hi = torch.where(den > 0, end, 0)
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        sat = (_std_arg(ws64 + mid, means, den) - t_star) > eps
        live = lo < hi
        hi = torch.where(live & sat, mid, hi)
        lo = torch.where(live & ~sat, mid + 1, lo)
    return torch.where(den > 0, lo, end)


def ambig_count(ambig) -> torch.Tensor:
    """Number of ambiguous entries (a 0-d tensor).  JAX counterpart:
    ``exact_tables_jax.ambig_count``."""
    return torch.count_nonzero(ambig)


def ambig_indices(ambig) -> torch.Tensor:
    """Flat indices (int64) of the ambiguous entries, ascending.  JAX
    counterpart: ``exact_tables_jax.ambig_indices`` (which pads to a
    bucket size)."""
    return torch.nonzero(ambig.reshape(-1)).reshape(-1)


def exact_tv_at(family: str, min_sym: int, max_sym: int, precision: int,
                means, scales, sym_i, svals) -> np.ndarray:
    """Host patch oracle: ``trunc_u32(free * CDF(s - 1/2))`` at ``s =
    svals[k]`` under the model of symbol ``sym_i[k]``, exact (the host
    codec's ``ctpu_exact_tv_at``, glibc's libm).  Returns u32 numpy.  JAX
    counterpart: ``native.LIB.ctpu_exact_tv_at``; plain version
    :func:`exact_tv_at_plain`."""
    ef._check_exact_family(family)
    mean, scale = ef._params(means, scales)
    sym_i = np.ascontiguousarray(np.asarray(sym_i, np.int64).reshape(-1))
    svals = np.ascontiguousarray(np.asarray(svals, np.int32).reshape(-1))
    if len(sym_i) != len(svals):
        raise ValueError("sym_i and svals differ in length")
    if len(sym_i) and (sym_i.min() < 0 or sym_i.max() >= len(mean)):
        raise ValueError("sym_i indexes past the models")
    out = np.empty(len(sym_i), dtype=np.uint32)
    native.library().ctpu_exact_tv_at(
        native.DIST_KIND[family], min_sym, max_sym, precision, mean, scale,
        sym_i, svals, len(sym_i), out)
    return out


def exact_tv_at_plain(family: str, min_sym: int, max_sym: int,
                      precision: int, means, scales, sym_i,
                      svals) -> np.ndarray:
    """:func:`exact_tv_at` in numpy through ``utils/special.py``."""
    mean = np.asarray(means, np.float64).reshape(-1)
    scale = np.asarray(scales, np.float64).reshape(-1)
    sym_i = np.asarray(sym_i, np.int64)
    s = np.asarray(svals, np.int64).astype(np.float64)
    free = ef._free(min_sym, max_sym, precision)
    return ef._trunc(free * ef._cdf(family, s - 0.5, mean[sym_i],
                                    scale[sym_i])).astype(np.uint32)


# ---------------------------------------------------------------------------
# derive + pack (torch operations on the tables' device)
# ---------------------------------------------------------------------------


# rows of derive_pack's [rows, cmax] int64 intermediates at a time
_DERIVE_ELEMS = 1 << 26


def derive_pack(tv, ws, patch_idx, patch_vals, min_sym: int, max_sym: int,
                precision: int, cmax: int, nsteps: int, L: int):
    """Patch the ambiguous entries, derive each row's (core_lo, ncore) and
    emit the packed planes ``[nsteps, CP1, L]`` int32; the rules of the
    host row fill (``exact_family.exact_boundary_tables`` +
    ``pack_decode_tables``).

    ``tv`` int32 [n, W] (patched IN PLACE, which saves a copy of the
    largest tensor of the build), ``ws`` int32 [n], ``patch_idx`` int64
    flat indices into tv (indices >= n * W are ignored: the JAX package
    pads its list with that scratch slot), ``patch_vals`` int32.  Rows are
    derived a whole number of steps at a time, so the [rows, cmax]
    intermediates stay near ``_DERIVE_ELEMS`` entries.  Returns ``(tabs,
    incon bool [n], overflow bool [n], ncore_max int)``; inconclusive or
    overflowing rows must be replaced by host rows.  JAX counterpart:
    ``exact_tables_jax.derive_pack``."""
    n, W = tv.shape
    device = tv.device
    live = patch_idx < n * W
    tv.view(-1)[patch_idx[live]] = patch_vals[live].to(tv.dtype)
    G = -(-cmax // 4)
    CP1 = 1 + 3 * G
    tabs = torch.empty((nsteps, CP1, L), dtype=torch.int32, device=device)
    incon = torch.empty(n, dtype=torch.bool, device=device)
    overflow = torch.empty(n, dtype=torch.bool, device=device)
    ncore_max = 0
    step_chunk = max(1, _DERIVE_ELEMS // (L * max(4 * G, W)))
    for t0 in range(0, nsteps, step_chunk):
        t1 = min(t0 + step_chunk, nsteps)
        r0, r1 = t0 * L, t1 * L
        rows, incon[r0:r1], overflow[r0:r1], ncm = _derive_rows(
            tv[r0:r1], ws[r0:r1], min_sym, max_sym, precision, cmax)
        tabs[t0:t1] = convert.u32_bits(rows).reshape(t1 - t0, L, CP1) \
            .transpose(1, 2)
        ncore_max = max(ncore_max, ncm)
    return tabs, incon, overflow, ncore_max


def _derive_rows(tv, ws, min_sym, max_sym, precision, cmax):
    """derive_pack on a block of rows: ``(rows [k, CP1] u32 values in
    int64, incon, overflow, ncore_max)``."""
    n, W = tv.shape
    device = tv.device
    i64 = torch.int64
    free = (1 << precision) - 1 - (max_sym - min_sym)
    padm1 = (1 << precision) - 1
    tv = tv.to(i64)
    ws = ws.to(i64)

    j = torch.arange(W, dtype=i64, device=device)
    n_eval = (max_sym - ws + 1).clamp(max=W)
    in_support = j[None, :] < n_eval[:, None]
    # pos excludes the out-of-support sentinels (tv = free there); sat
    # includes them: they end the core like the host's run-off rule
    pos = (tv >= 1) & in_support
    sat = tv > free - 1
    has_pos = pos.any(dim=1)
    has_sat = sat.any(dim=1)
    j0 = pos.to(torch.int32).argmax(dim=1).to(i64)
    first_sat = sat.to(torch.int32).argmax(dim=1).to(i64)

    window_covers_end = ws + W - 1 >= max_sym
    # all-zero-trunc rows (conclusive only at the support end): core_lo
    # clamps to max_sym, one entry
    allzero = (~has_pos) & window_covers_end
    j0 = torch.where(allzero, n_eval - 1, j0)
    # ncore >= 1 even when tv(core_lo) is already saturated
    ncore = torch.where(allzero, 1, (first_sat - j0).clamp(min=1))

    incon = ((~has_pos) & (~window_covers_end)) \
        | (has_pos & (j0 == 0) & (ws != min_sym + 1)) \
        | (~has_sat)
    overflow = (~incon) & (ncore > cmax)

    k = torch.arange(cmax, dtype=i64, device=device)[None, :]
    idx = j0[:, None] + k
    vals = tv.gather(1, idx.clamp(0, W - 1))
    b = (vals + (ws[:, None] + idx - min_sym) - 1) & convert._M32
    G = -(-cmax // 4)
    bm1 = torch.where(k < ncore[:, None], b, padm1)
    if 4 * G > cmax:
        bm1 = torch.cat([bm1, torch.full((n, 4 * G - cmax), padm1,
                                         dtype=i64, device=device)], dim=1)
    core_lo = ws + j0
    aux = ((core_lo - min_sym) | (ncore << 24)) & convert._M32
    q = bm1.reshape(n, G, 4)
    w0 = (q[..., 0] | (q[..., 1] << 24)) & convert._M32
    w1 = ((q[..., 1] >> 8) | (q[..., 2] << 16)) & convert._M32
    w2 = ((q[..., 2] >> 16) | (q[..., 3] << 8)) & convert._M32
    planes = torch.stack([w0, w1, w2], dim=2).reshape(n, 3 * G)
    rows = torch.cat([aux[:, None], planes], dim=1)
    ncore_max = int(torch.where(incon | overflow, 0, ncore).max()) if n else 0
    return rows, incon, overflow, ncore_max


# ---------------------------------------------------------------------------
# the pipelined batch builder
# ---------------------------------------------------------------------------


def _host_segment_tables(p, family, min_sym, max_sym, precision, L, device):
    """A whole segment from the host builder (its planes moved to the
    device)."""
    HOST_SEGMENTS["count"] += 1
    tabs4, cmax_r = ef.packed_tables_device(
        p["mean"], p["scale"], family, min_sym, max_sym, precision,
        p["cmax"], p["nsteps"], L // ef.LANES)
    return convert.exact_tables_to_torch(tabs4, device), cmax_r


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def packed_tables_on_device_batch(segs, family: str, min_sym: int,
                                  max_sym: int, precision: int, L: int,
                                  device, timings: dict | None = None,
                                  canary: bool = True):
    """Build the packed wide tables of a LIST of segments on ``device``.

    ``segs`` is ``[(means, scales, cmax, nsteps), ...]`` (numpy f64, one
    entry per grouped-decode segment, ``nsteps * L`` models each).  The
    build runs in phases: (1) every segment's window evaluation (kernel 18
    on a CUDA device; launches queue back to back); (2) per segment, the
    ambiguous count and indices come back and the host patches them; (3)
    every :func:`derive_pack`; (4) host rows for the inconclusive or
    overflowing windows, and the planes cut to the tight width (a column
    slice: packing is plane 0 aux + 3 u32 per ascending 4-boundary group).
    A segment with more than ``max(4096, n W / 16)`` ambiguous entries goes
    to the host builder whole.  Returns ``[(tabs int32 [nsteps, CP1, L],
    cmax)]``, bit-identical to ``exact_family.packed_tables_device``.

    ``timings`` (optional dict) receives the seconds of each phase (with a
    synchronize at each phase boundary) and the ambiguous count.  The two
    canaries run first, once per device (``canary=False`` is for the
    canaries themselves).  JAX counterpart:
    ``exact_family.packed_tables_on_device_batch``."""
    ef.check_family(family, ef.DEVICE_FAMILIES)
    if not 16 < precision <= 24:
        raise ValueError(f"wide tables need 16 < P <= 24, got {precision}")
    if L <= 0 or L % ef.LANES:
        raise ValueError(f"L must be a positive multiple of 128, got {L}")
    device = torch.device(device)
    if canary:
        run_canaries(device)
    clock = time.perf_counter
    t0 = clock()
    CL = ef._EST_C[family][0]
    ph = []
    # phase 1: window evaluations, all segments
    for means, scales, cmax, nsteps in segs:
        mean = np.ascontiguousarray(np.asarray(means, np.float64).reshape(-1))
        scale = np.ascontiguousarray(
            np.asarray(scales, np.float64).reshape(-1))
        n = nsteps * L
        if len(mean) != n or len(scale) != n or not 0 < cmax <= 255:
            raise ValueError(
                f"a segment needs nsteps * L = {n} models and 0 < cmax <= "
                f"255, got {len(mean)} models and cmax={cmax}")
        # windows start from the deterministic core lower bound (coarse is
        # fine: inconclusive windows get host rows)
        if np.isinf(CL):
            ws = np.full(n, min_sym + 1, np.int64)
        else:
            ws = np.clip(np.ceil(mean - CL * scale) - 3.0, min_sym + 1,
                         max_sym).astype(np.int64)
        W = min(cmax + 16, max_sym - min_sym + 1 + 16)
        mean_t, scale_t = convert.params64_to_torch(mean, scale, device)
        ws_t = torch.from_numpy(ws.astype(np.int32)).to(device)
        tv, ambig = eval_window(mean_t, scale_t, ws_t, family, int(min_sym),
                                int(max_sym), int(precision), int(W))
        ph.append(dict(mean=mean, scale=scale, ws=ws, ws_t=ws_t, n=n, W=W,
                       cmax=int(cmax), nsteps=int(nsteps), tv=tv,
                       ambig=ambig, cnt=ambig_count(ambig)))
    if timings is not None:
        _sync(device)
        t1 = clock()
        timings["eval_s"] = t1 - t0
        t0 = t1

    # phase 2: counts, indices, host patches
    total_ambig = 0
    for p in ph:
        count = int(p["cnt"])
        total_ambig += count
        if count > max(4096, (p["n"] * p["W"]) // 16):
            p["host"] = True
            continue
        idx = ambig_indices(p["ambig"])
        idx_h = idx.cpu().numpy()
        sym_i = idx_h // p["W"]
        svals = p["ws"][sym_i] + idx_h % p["W"]
        vals = exact_tv_at(family, min_sym, max_sym, precision, p["mean"],
                           p["scale"], sym_i, svals)
        p["idx"] = idx
        p["patch_vals"] = torch.from_numpy(vals.astype(np.int32)).to(device)
        del p["ambig"]
    if timings is not None:
        t1 = clock()
        timings["patch_s"] = t1 - t0
        timings["ambiguous"] = total_ambig
        t0 = t1

    # phase 3: derive + pack, all segments
    for p in ph:
        if p.get("host"):
            continue
        p["tabs"], p["incon"], p["overflow"], p["ncm"] = derive_pack(
            p.pop("tv"), p["ws_t"], p.pop("idx"), p.pop("patch_vals"),
            int(min_sym), int(max_sym), int(precision), p["cmax"],
            p["nsteps"], L)

    # phase 4: host rows, tighten, finish
    results = []
    for p in ph:
        if p.get("host"):
            results.append(_host_segment_tables(p, family, min_sym, max_sym,
                                                precision, L, device))
            continue
        G = -(-p["cmax"] // 4)
        # host rows for the inconclusive / overflowing windows are built at
        # the caller's cmax BEFORE tightening, so their true ncore folds
        # into the tight bound; a row that needs more than cmax sends the
        # segment to the host builder
        bad_idx = torch.nonzero(p["incon"] | p["overflow"]).reshape(-1) \
            .cpu().numpy()
        rows = None
        rows_nc = 0
        if len(bad_idx):
            try:
                rows, cmax_r = ef._packed_table_rows(
                    p["mean"][bad_idx], p["scale"][bad_idx], family,
                    min_sym, max_sym, precision, p["cmax"])
            except ValueError:
                results.append(_host_segment_tables(
                    p, family, min_sym, max_sym, precision, L, device))
                continue
            HOST_ROWS["count"] += len(bad_idx)
            rows_nc = int((rows[:, 0] >> np.uint32(24)).max())
        tight = max(4, -(-max(int(p["ncm"]), rows_nc, 1) // 4) * 4)
        tabs = p["tabs"]
        if tight < 4 * G:
            G = tight // 4
            tabs = tabs[:, :1 + 3 * G].contiguous()
            if rows is not None:
                rows = rows[:, :1 + 3 * G]
        if rows is not None:
            t_i = torch.from_numpy(bad_idx // L).to(device)
            l_i = torch.from_numpy(bad_idx % L).to(device)
            tabs[t_i, :, l_i] = convert.u32_to_torch(
                np.ascontiguousarray(rows), device).reshape(len(bad_idx), -1)
        results.append((tabs, 4 * G))
    if timings is not None:
        _sync(device)
        timings["derive_pack_s"] = clock() - t0
    return results


# ---------------------------------------------------------------------------
# canaries (once per device; a failure raises)
# ---------------------------------------------------------------------------


def eval_window_canary(device) -> None:
    """The window evaluator's ACCEPTED entries must carry the exact trunc
    values (against :func:`exact_tv_at`) on a random batch of all three
    families, and the ambiguous share must stay below 0.2.  Raises
    RuntimeError otherwise.  JAX counterpart: ``df32_pallas.
    df32_eval_canary`` (same inputs and rules; it returns False)."""
    rng = np.random.RandomState(0xDF32)
    n, W = 1024, 40
    MIN, MAX, P = -100, 100, 24
    device = torch.device(device)
    for family in ef.DEVICE_FAMILIES:
        means = rng.uniform(-110, 110, n)
        scales = np.exp(rng.uniform(np.log(0.05), np.log(8.0), n))
        CL = ef._EST_C[family][0]
        if np.isinf(CL):
            ws = np.full(n, MIN + 1, np.int64)
            Wf = MAX - MIN + 1 + 8
        else:
            ws = np.clip(np.ceil(means - CL * scales) - 3.0, MIN + 1, MAX
                         ).astype(np.int64)
            Wf = W
        mean_t, scale_t = convert.params64_to_torch(means, scales, device)
        tv, amb = eval_window(
            mean_t, scale_t, torch.from_numpy(ws.astype(np.int32)).to(device),
            family, MIN, MAX, P, Wf)
        tv = tv.cpu().numpy().reshape(-1).astype(np.int64)
        amb = amb.cpu().numpy().reshape(-1)
        sym_i = np.repeat(np.arange(n), Wf)
        svals = (ws[:, None] + np.arange(Wf)[None, :]).reshape(-1)
        live = svals <= MAX
        exact = np.full(n * Wf, (1 << P) - 1 - (MAX - MIN), np.int64)
        exact[live] = exact_tv_at(family, MIN, MAX, P, means, scales,
                                  sym_i[live], svals[live])
        wrong = int(np.count_nonzero(~amb & (tv != exact)))
        if wrong:
            raise RuntimeError(
                f"window evaluator canary failed on {device}: {wrong} "
                f"accepted {family} entries differ from the host oracle")
        share = float(amb.mean())
        if share >= 0.2:
            raise RuntimeError(
                f"window evaluator canary failed on {device}: {family} "
                f"ambiguous share {share:.3f} >= 0.2")


def builder_canary(device) -> None:
    """Tables built by :func:`packed_tables_on_device_batch` must equal the
    host builder's bit for bit on a random parameter batch of all three
    families.  Raises RuntimeError otherwise.  JAX counterpart:
    ``exact_family._device_builder_canary`` (same inputs and rule; it
    switches the device path off instead)."""
    rng = np.random.RandomState(0xC0FFEE)
    n = 4 * 128
    means = rng.randn(n) * 40.0
    scales = np.exp(rng.normal(0.3, 1.0, n))
    device = torch.device(device)
    for fam in ef.DEVICE_FAMILIES:
        nc = ef.exact_ncore(means, scales, fam, -100, 100, 24)
        cmax = min(max(int(nc.max()), 1), 255)
        host, ch = ef.packed_tables_device(means, scales, fam, -100, 100,
                                           24, cmax, 2, 2)
        (dev, cd), = packed_tables_on_device_batch(
            [(means, scales, cmax, 2)], fam, -100, 100, 24, 256, device,
            canary=False)
        if ch != cd or not np.array_equal(
                host, convert.exact_tables_from_torch(dev)):
            raise RuntimeError(
                f"table builder canary failed on {device}: {fam} tables "
                "differ from the host builder's")


def run_canaries(device) -> None:
    """Both canaries, once per device (a pass is remembered; a failure
    raises every time)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    if _CANARY_OK.get(key):
        return
    eval_window_canary(device)
    builder_canary(device)
    _CANARY_OK[key] = True
