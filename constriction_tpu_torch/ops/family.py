"""Device-family ILANS2 coding on the GPU: every symbol has its own
continuous model (mean, scale) of one family (gaussian, laplace, logistic,
cauchy), and the leaky-quantized CDF is evaluated *inside the kernel* in
exact integer arithmetic.

The counterpart of ``constriction_tpu/ops/pallas_family.py``: the rANS pair
at the small preset (W=16, S=32, P=12) with the model inverted by bisection
over ``left(x) = (x - min_sym) + trunc(free * CDF(t))``.  The wrappers
launch the hand-written kernels of ``csrc/ilans2_family.cu`` for CUDA
tensors (the decode on ``csrc/ilans2_wide.cuh``'s cluster of up to 16 CTAs,
at most :data:`coder.MAX_DECODE_LANES` lanes; the encode as three launches
over the whole grid: a tables pass of one thread per symbol writing each
symbol's division record, a lane pass and the encoders' row-major
compaction) and run the plain PyTorch twins for CPU tensors; any other
device raises.  :func:`family_tables_pass_plain`,
:func:`family_lanes_pass_plain` and ``coder.compact_pass_plain`` are the
encode's three steps in plain PyTorch (:func:`encode_family_lanes_plain`
composes them); the kernels' index math mirrors them.

Float rounding is part of the wire format.  The standardized argument is
``t = ((float(x) - 0.5) - mean) * (1 / scale)``, then ``* 4096``, a clamp
to [-32768, 32767] and a truncating cast: five separately, correctly
rounded float32 operations, never fused.  Everything after that is int32.
The arithmetic below is written once for numpy (the host oracles) and torch
(the twins): ``xp`` is the ``numpy`` or the ``torch`` module, integer
arguments are int32 arrays, float arguments float32 arrays.  Python scalars
keep those types in both libraries; no tensor is ever divided by a Python
scalar (torch would multiply by the rounded reciprocal on a CUDA tensor).

Tensor layout (constriction_tpu_torch/convert.py): symbols int32[n]
(absolute symbol values), lane states and stream words int32 holding u32
bits, means and scales float32[T * L], padded past n with mean 0 and scale
1 (``convert.params_to_torch``; T = ceil(n / L)).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from . import _build
from .coder import (MAX_DECODE_LANES, _check, _emit_words, _num_steps,
                    _on_cuda, _refill_words, compact_pass_plain,
                    compaction_scratch, flag_ballots)
from .interleaved import LaneConfig

FAMILIES = ("gaussian", "laplace", "logistic", "cauchy")

# kernel launches made by this module's wrappers (never by the twins); the
# encode's tables pass and lane pass launched alone (family_tables_pass,
# family_lanes_pass) count under their own keys
LAUNCHES = {"encode": 0, "decode": 0, "tables": 0, "encode_lanes": 0}
_M32 = (1 << 32) - 1

FX = 12  # fixed-point fraction bits (the coder's precision)
T_CLAMP = 8 << FX  # |t| <= 8 scales; beyond is leak-level mass
# integer quadratic for 2^(-xf/4096) * 2^18, non-increasing in xf
P0, P1, P2 = 261640, 174919, 44856
PG = 6  # guard bits of the quadratic
LOG2E = 5909  # round(log2(e) * 4096)
GA = 6536  # round(1.5958 * 4096): sigma(1.5958 (t + c t^3)) ~ Phi(t)
GB = 292  # round(1.5958 * 0.044715 * 4096)
CA = 1147  # round(0.28 * 4096): atan(x) ~ x / (1 + 0.28 x^2) on [0, 1]
PI2EFF = 6398  # 2 * atan_fix(4096): the approximation's own pi/2
PIEFF = 12796


# ---------------------------------------------------------------------------
# the integer CDF, one rule for numpy and torch
# ---------------------------------------------------------------------------


def _f32(a):
    return a.to(torch.float32) if isinstance(a, torch.Tensor) \
        else a.astype(np.float32)


def _i32(a):
    """Truncating cast (toward zero) in both libraries."""
    return a.to(torch.int32) if isinstance(a, torch.Tensor) \
        else a.astype(np.int32)


def t_fixed(xp, x, mean, inv_scale):
    """Fixed-point standardized argument of int32 ``x``; monotone in x.
    JAX counterpart: ``pallas_family._t_fixed``."""
    tf = ((_f32(x) - 0.5) - mean) * inv_scale
    tf = tf * float(1 << FX)
    tf = xp.clip(tf, float(-T_CLAMP), float(T_CLAMP - 1))
    return _i32(tf)


def exp2_neg(xp, mag):
    """~ 4096 * e^-(mag / 4096) for int32 mag >= 0; non-increasing in mag.
    JAX counterpart: ``pallas_family._exp2_neg``."""
    m = (mag * LOG2E) >> FX
    # clamped at 25 so the total shift stays below 32; every shift >= 18
    # already gives the intended 0
    xi = xp.clip(m >> FX, None, 25)
    xfr = m & ((1 << FX) - 1)
    poly = P0 - ((xfr * P1) >> FX) + ((((xfr * xfr) >> FX) * P2) >> FX)
    return poly >> (xi + PG)


def mag(xp, family: str, u):
    """Positive sigmoid argument from |t_fix|.  JAX counterpart:
    ``pallas_family._mag``."""
    if family == "gaussian":
        u2 = (u * u) >> FX
        u3 = ((u2 >> 4) * u) >> (FX - 4)
        return ((u * GA) >> FX) + ((u3 * GB) >> FX)
    return u  # laplace, logistic


def floor_div_small(xp, num, den):
    """floor(num / den) for 0 <= num <= 2^24 and 0 < den < 2^20 (int32
    arrays of one shape): a correctly rounded float32 divide and one
    integer correction.  JAX counterpart:
    ``pallas_family._floor_div_small``."""
    qh = _i32(_f32(num) / _f32(den))
    r = num - qh * den
    qh = qh + _i32(r >= den)
    return qh - _i32(r < 0)


def atan_fix(xp, u):
    """atan(u / 4096) in units of 1/4096 rad for int32 u >= 0; monotone.
    JAX counterpart: ``pallas_family._atan_fix``."""
    one = 1 << FX

    def a_small(v):
        v2 = (v * v) >> FX
        return floor_div_small(xp, v << FX, ((v2 * CA) >> FX) + one)

    inv = floor_div_small(xp, xp.zeros_like(u) + (1 << (2 * FX)),
                          xp.clip(u, 1, None))
    return xp.where(u <= one, a_small(xp.clip(u, None, one)),
                    PI2EFF - a_small(xp.clip(inv, None, one)))


def ctrunc(xp, family: str, t_fix, free: int):
    """trunc(free * CDF(t)) for int32 ``t_fix``, monotone in it.  JAX
    counterpart: ``pallas_family._ctrunc``."""
    neg = t_fix < 0
    u = xp.where(neg, -t_fix, t_fix)
    if family == "cauchy":
        # C(t) = 1/2 + atan(t)/pi, the numerator kept below 2^24
        corr = floor_div_small(xp, (atan_fix(xp, u) * free) >> 2,
                               xp.zeros_like(u) + (PIEFF >> 2))
        half = free >> 1
        return xp.where(neg, half - corr, half + corr)
    e = exp2_neg(xp, mag(xp, family, u))
    if family == "laplace":
        v = e * free
        return xp.where(neg, v >> (FX + 1),
                        free - ((v + 8191) >> (FX + 1)))
    num = xp.where(neg, e * free, xp.zeros_like(e) + (free << FX))
    return floor_div_small(xp, num, e + (1 << FX))


def free_weight(min_sym: int, max_sym: int) -> int:
    """The part of 2^P left after one unit of leakiness per symbol."""
    return (1 << FX) - 1 - (max_sym - min_sym)


def left(xp, family: str, min_sym: int, max_sym: int, x, mean, inv_scale):
    """left(x) for interior int32 x in (min_sym, max_sym]: the leaky
    quantizer's left-sided cumulative, (x - min_sym) + trunc(free * CDF).
    left(min_sym) is 0 and left(max_sym + 1) is 2^P by definition, never
    by this formula.  JAX counterpart: ``pallas_family._left_fn``."""
    t = t_fixed(xp, x, mean, inv_scale)
    return (x - min_sym) + ctrunc(xp, family, t, free_weight(min_sym, max_sym))


def tables(xp, family: str, min_sym: int, max_sym: int, sym, mean,
           inv_scale):
    """``(cum, prob)`` int32 of the symbols ``sym`` under their models, with
    the pinned endpoints.  JAX counterpart: the head of
    ``pallas_family._family_encode_kernel_body``."""
    lo = left(xp, family, min_sym, max_sym, sym, mean, inv_scale)
    hi = left(xp, family, min_sym, max_sym, sym + 1, mean, inv_scale)
    cum = xp.where(sym == min_sym, xp.zeros_like(lo), lo)
    right = xp.where(sym == max_sym, xp.zeros_like(hi) + (1 << FX), hi)
    return cum, right - cum


def bisection_steps(min_sym: int, max_sym: int) -> int:
    return max(max_sym - min_sym, 1).bit_length()


def invert_family(xp, family: str, min_sym: int, max_sym: int, q, mean,
                  inv_scale):
    """Quantile int32 ``q`` -> ``(sym, cum, prob)`` int32: bisection for
    max{x : left(x) <= q} that never evaluates left(min_sym) and carries
    the surviving endpoints' values along.  JAX counterpart:
    ``pallas_family._invert_family``."""
    lo = xp.zeros_like(q) + min_sym
    hi = xp.zeros_like(q) + (max_sym + 1)
    cum = xp.zeros_like(q)
    right = xp.zeros_like(q) + (1 << FX)
    for _ in range(bisection_steps(min_sym, max_sym)):
        mid = xp.clip((lo + hi) >> 1, min_sym + 1, None)
        lmid = left(xp, family, min_sym, max_sym, mid, mean, inv_scale)
        take = lmid <= q
        lo = xp.where(take, mid, lo)
        hi = xp.where(take, hi, mid)
        cum = xp.where(take, lmid, cum)
        right = xp.where(take, right, lmid)
    return lo, cum, right - cum


# ---------------------------------------------------------------------------
# host oracles (numpy)
# ---------------------------------------------------------------------------


def family_tables_host(symbols, means, scales, family: str, min_sym: int,
                       max_sym: int, precision: int = FX):
    """``(cum, prob)`` u64 arrays of the symbols under their models, for
    ``interleaved2.encode_shared``.  JAX counterpart:
    ``pallas_family.family_tables_host``."""
    _check_precision(precision)
    sym = np.asarray(symbols, dtype=np.int32)
    mean = np.asarray(means, dtype=np.float32)
    inv_scale = np.float32(1.0) / np.asarray(scales, dtype=np.float32)
    cum, prob = tables(np, family, min_sym, max_sym, sym, mean, inv_scale)
    return cum.astype(np.uint64), prob.astype(np.uint64)


def decode_family_host(init_states, stream, means, scales, family: str,
                       min_sym: int, max_sym: int, cfg: LaneConfig,
                       num_symbols: int):
    """Numpy oracle decoder for device-family ILANS2 streams; reads past
    the end of the stream give zero words.  Its bisection evaluates
    ``left`` at whatever midpoint it reaches (no pin at min_sym) and lands
    on the same symbols as :func:`invert_family`.  JAX counterpart:
    ``pallas_family.decode_family_host``."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    _check_precision(P)
    T = _num_steps(num_symbols, L)
    lower = np.uint64(1 << (S - W))
    means = np.asarray(means, dtype=np.float32)
    scales = np.asarray(scales, dtype=np.float32)

    states = np.asarray(init_states).astype(np.uint64)
    stream = np.asarray(stream)
    base = 0
    out = np.empty(T * L, dtype=np.int32)
    lanes = np.arange(L)
    for t in range(T):
        idx = t * L + lanes
        active = idx < num_symbols
        at = np.minimum(idx, num_symbols - 1)
        mean = np.where(active, means[at], 0.0).astype(np.float32)
        inv_scale = np.float32(1.0) / np.where(
            active, scales[at], 1.0).astype(np.float32)
        q = (states & np.uint64((1 << P) - 1)).astype(np.int32)
        lo = np.full(L, min_sym, np.int32)
        hi = np.full(L, max_sym + 1, np.int32)
        for _ in range(bisection_steps(min_sym, max_sym)):
            mid = (lo + hi) >> 1
            take = left(np, family, min_sym, max_sym, mid, mean,
                        inv_scale) <= q
            lo = np.where(take, mid, lo)
            hi = np.where(take, hi, mid)
        cum, prob = tables(np, family, min_sym, max_sym, lo, mean, inv_scale)
        new_states = (states >> np.uint64(P)) * prob.astype(np.uint64) + (
            q.astype(np.uint64) - cum.astype(np.uint64))
        states = np.where(active, new_states, states)
        m = states < lower
        k = int(m.sum())
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base:base + k]
            words[:len(avail)] = avail
            states[m] = (states[m] << np.uint64(W)) | words
            base += k
        out[idx] = lo
    return out[:num_symbols]


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------


def _check_precision(precision: int) -> None:
    if precision != FX:
        raise ValueError(
            f"precision must be {FX} (the device families' fixed point), "
            f"got {precision}")


def check_cfg(cfg: LaneConfig, lane_multiple: int = 128) -> None:
    """The configs the family coders take: W=16, S=32, P=12 and lanes a
    positive multiple of ``lane_multiple``."""
    if (cfg.word_bits, cfg.state_bits) != (16, 32):
        raise ValueError(
            f"cfg must have word_bits=16 and state_bits=32, got W="
            f"{cfg.word_bits}, S={cfg.state_bits}")
    _check_precision(cfg.precision)
    if cfg.num_lanes <= 0 or cfg.num_lanes % lane_multiple:
        raise ValueError(
            f"num_lanes must be a positive multiple of {lane_multiple}, "
            f"got {cfg.num_lanes}")


def check_model(cfg: LaneConfig, family: str, min_sym: int, max_sym: int,
                lane_multiple: int = 128) -> None:
    """The configs and supports the family coders take; each failure names
    its argument.  The JAX package asserts the same conditions
    (``pallas_family.encode_family_pallas``)."""
    check_cfg(cfg, lane_multiple)
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    if max_sym <= min_sym:
        raise ValueError(
            f"max_sym must exceed min_sym (a single-symbol support needs no "
            f"bits), got [{min_sym}, {max_sym}]")
    if free_weight(min_sym, max_sym) < max_sym - min_sym + 1:
        raise ValueError(
            f"support [min_sym, max_sym] = [{min_sym}, {max_sym}] is too "
            f"wide for precision {FX}: the free weight must cover one unit "
            f"of leakiness per symbol")


def check_params(means, scales, count: int, device: torch.device,
                 values: bool = True) -> None:
    """Means must be finite and every scale's float32 reciprocal finite and
    positive: anything else makes the truncating cast depend on the
    backend.  (The JAX package does not check.)  Without ``values`` only
    the tensors' types and sizes are checked, with no read-back."""
    _check("means", means, torch.float32, device, count)
    _check("scales", scales, torch.float32, device, count)
    if not values:
        return
    if not bool(torch.isfinite(means).all()):
        raise ValueError("means must be finite")
    inv = 1.0 / scales
    if not bool((torch.isfinite(inv) & (inv > 0)).all()):
        raise ValueError(
            "scales must be positive float32 values with a finite "
            "reciprocal")


def check_symbols(symbols, min_sym: int, max_sym: int) -> None:
    """Symbols outside the support would be coded as garbage.  (The JAX
    package does not check.)"""
    if symbols.numel() and bool(
            ((symbols < min_sym) | (symbols > max_sym)).any()):
        raise ValueError(
            f"symbols must be in [min_sym, max_sym] = [{min_sym}, "
            f"{max_sym}], got range [{int(symbols.min())}, "
            f"{int(symbols.max())}]")


# ---------------------------------------------------------------------------
# the coders
# ---------------------------------------------------------------------------


def encode_family(symbols, means, scales, family: str, min_sym: int,
                  max_sym: int, cfg: LaneConfig):
    """Encode symbols under per-symbol (mean, scale) models into the ILANS2
    format (W=16, S=32, P=12), lanes seeded at 2^16.  JAX counterpart:
    ``pallas_family.encode_family_pallas``.

    ``symbols`` int32[n]; ``means``, ``scales`` float32[T * L] in the
    padded layout of the module docstring, on the same device.  Returns
    ``(states int32[L], stream int32[num_words])``.  CUDA tensors launch
    the kernel's three steps in one C call (their scratch: a division
    record a symbol, then ``coder.compaction_scratch``) and read the
    stream's start back (one sync); CPU tensors run
    :func:`encode_family_plain`."""
    check_model(cfg, family, min_sym, max_sym)
    if not isinstance(symbols, torch.Tensor):
        raise TypeError("symbols must be a torch.Tensor")
    device = symbols.device
    _check("symbols", symbols, torch.int32, device)
    L, n = cfg.num_lanes, symbols.numel()
    check_params(means, scales, _num_steps(n, L) * L, device)
    check_symbols(symbols, min_sym, max_sym)
    if not _on_cuda(device):
        return encode_family_plain(symbols, means, scales, family, min_sym,
                                   max_sym, cfg)
    states = torch.full((L,), 1 << 16, dtype=torch.int32, device=device)
    if n == 0:
        return states, torch.zeros(0, dtype=torch.int32, device=device)
    buf = torch.empty(n, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int64, device=device)
    recs = torch.empty(n, dtype=torch.int64, device=device)
    _build.call("ctt_family_encode", device, states, symbols, n, means,
                scales, recs, buf, n, end,
                *compaction_scratch(_num_steps(n, L), L, device), L,
                FAMILIES.index(family), min_sym, max_sym)
    LAUNCHES["encode"] += 1
    return states, buf[int(end.item()):]


def encode_family_plain(symbols, means, scales, family: str, min_sym: int,
                        max_sym: int, cfg: LaneConfig):
    """Plain PyTorch twin of :func:`encode_family` (any device, no checks).
    JAX counterpart: ``pallas_family.encode_family_pallas``; numpy oracle
    :func:`family_tables_host` -> ``interleaved2.encode_shared``."""
    L, S, W, P = cfg.num_lanes, cfg.state_bits, cfg.word_bits, cfg.precision
    device = symbols.device
    n = symbols.numel()
    T = _num_steps(n, L)
    sym = torch.full((T * L,), min_sym, dtype=torch.int32, device=device)
    sym[:n] = symbols
    cums, probs = tables(torch, family, min_sym, max_sym, sym, means,
                         1.0 / scales)
    cums, probs = cums.to(torch.int64), probs.to(torch.int64)
    x = torch.full((L,), 1 << (S - W), dtype=torch.int64, device=device)
    lanes = torch.arange(L, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(T - 1, -1, -1):
        active = t * L + lanes < n
        cum, prob = cums[t * L:(t + 1) * L], probs[t * L:(t + 1) * L]
        renorm = active & ((x >> (S - P)) >= prob)
        e = _emit_words(buf, renorm, x & cfg.word_mask, e, n)
        x = torch.where(renorm, x >> W, x)
        x = torch.where(active, ((x // prob) << P) | (cum + x % prob), x)
    return convert.u32_bits(x), convert.u32_bits(buf[int(e):n])


def _ceil_log2(prob):
    """ceil(log2 prob) of int64 ``prob`` in 1 .. 2^16, elementwise."""
    log = torch.zeros_like(prob)
    for k in range(16):
        log += prob > 1 << k
    return log


def record_magic(prob):
    """The multiply-high reciprocal of int64 ``prob`` in 1 .. 2^16 as the
    tables pass builds it (``csrc/ilans2_wide.cuh``,
    ``DivisionRecord32::build``): one division, ((2^l - prob) << 32) //
    prob + 1 with l = ceil(log2 prob), the numerator below 2^48.  Equal to
    ``coder.division_magic32(prob)[0]``."""
    return ((1 << _ceil_log2(prob)) - prob << 32) // prob + 1


def family_tables_pass_plain(symbols, means, scales, family: str,
                             min_sym: int, max_sym: int):
    """The encodes' tables pass in plain PyTorch (kernel 12's step (a), and
    kernel 22's; any device, no checks), over the n symbols of
    ``symbols``: each symbol, clamped into the support as the kernel
    clamps it, its (cum, prob) under its model (:func:`tables`; ``means``
    and ``scales`` may run past n) and its division record ``magic | (cum
    | (prob - 1) << 16) << 32`` (:func:`record_magic`).  Returns records
    int64[n]."""
    n = symbols.numel()
    sym = symbols.clamp(min_sym, max_sym)
    cum, prob = tables(torch, family, min_sym, max_sym, sym, means[:n],
                       1.0 / scales[:n])
    cum, prob = cum.to(torch.int64), prob.to(torch.int64)
    return record_magic(prob) | (cum | (prob - 1) << 16) << 32


def record_divide(x, magic, prob):
    """x // prob for int64 x below 2^32 as the lane pass divides it, from
    the record's ``magic`` (:func:`record_magic`): t = (magic x) >> 32
    (``__umulhi``, here with no product past 2^48), then (t + ((x - t) >>
    min(l, 1))) >> max(l - 1, 0), l = ceil(log2 prob)."""
    t = (magic * (x >> 16) + ((magic * (x & 0xFFFF)) >> 16)) >> 16
    up = (prob > 1).to(torch.int64)  # min(l, 1); l - up is max(l - 1, 0)
    return (t + ((x - t) >> up)) >> (_ceil_log2(prob) - up)


def family_lanes_pass_plain(recs, n: int, cfg: LaneConfig):
    """Kernel 12's pass A in plain PyTorch (any device, no checks): every
    lane runs steps T-1 .. 0 on its own over the records of symbols 0 ..
    n - 1 (:func:`family_tables_pass_plain`), its state divided by a
    record's probability as the kernel divides it (:func:`record_divide`).
    Returns ``(words int32[T, L], flags bool[T, L], states int32[L])``:
    ``flags[t, l]`` is set where lane l renorms before coding symbol t * L
    + l, and ``words[t, l]`` is then its 16-bit word (0 elsewhere); the
    states are the final ones.  Lanes of a partial last step neither code
    nor flag.  ``coder.compact_pass_plain`` of words and flags is the
    stream."""
    L, S, W, P = cfg.num_lanes, cfg.state_bits, cfg.word_bits, cfg.precision
    device = recs.device
    T = _num_steps(n, L)
    flat = torch.ones(T * L, dtype=torch.int64, device=device)  # unit
    flat[:n] = recs[:n]
    magic = flat & _M32
    cum = (flat >> 32) & 0xFFFF
    prob = (flat >> 48) + 1
    x = torch.full((L,), 1 << (S - W), dtype=torch.int64, device=device)
    lanes = torch.arange(L, device=device)
    words = torch.zeros(T, L, dtype=torch.int64, device=device)
    flags = torch.zeros(T, L, dtype=torch.bool, device=device)
    for t in range(T - 1, -1, -1):
        active = t * L + lanes < n
        at = slice(t * L, (t + 1) * L)
        p = prob[at]
        renorm = active & ((x >> (S - P)) >= p)
        words[t] = torch.where(renorm, x & cfg.word_mask, 0)
        flags[t] = renorm
        x = torch.where(renorm, x >> W, x)
        q = record_divide(x, magic[at], p)
        x = torch.where(active, (q << P) | (cum[at] + (x - q * p)), x)
    return convert.u32_bits(words), flags, convert.u32_bits(x)


def encode_family_lanes_plain(symbols, means, scales, family: str,
                              min_sym: int, max_sym: int, cfg: LaneConfig):
    """Kernel 12's three steps composed in plain PyTorch (any device, no
    checks): :func:`family_tables_pass_plain`, :func:`family_lanes_pass_plain`
    and ``coder.compact_pass_plain``.  Returns ``(states int32[L], stream
    int32[num_words])``, equal to :func:`encode_family_plain`'s."""
    n = symbols.numel()
    recs = family_tables_pass_plain(symbols, means, scales, family, min_sym,
                                    max_sym)
    words, flags, states = family_lanes_pass_plain(recs, n, cfg)
    return states, compact_pass_plain(words, flags)


def _pass_args(symbols, means, scales, family: str, min_sym: int,
               max_sym: int, cfg: LaneConfig) -> torch.device:
    check_model(cfg, family, min_sym, max_sym)
    if not isinstance(symbols, torch.Tensor):
        raise TypeError("symbols must be a torch.Tensor")
    device = symbols.device
    _check("symbols", symbols, torch.int32, device)
    check_params(means, scales, _num_steps(symbols.numel(), cfg.num_lanes)
                 * cfg.num_lanes, device)
    check_symbols(symbols, min_sym, max_sym)
    return device


def family_tables_pass(symbols, means, scales, family: str, min_sym: int,
                       max_sym: int, cfg: LaneConfig):
    """Kernel 12's tables pass alone (its arguments as
    :func:`encode_family`'s): records int64[n].  CUDA tensors launch it,
    CPU tensors run :func:`family_tables_pass_plain`."""
    device = _pass_args(symbols, means, scales, family, min_sym, max_sym,
                        cfg)
    if not _on_cuda(device):
        return family_tables_pass_plain(symbols, means, scales, family,
                                        min_sym, max_sym)
    n = symbols.numel()
    recs = torch.empty(n, dtype=torch.int64, device=device)
    if n:
        _build.call("ctt_family_tables_pass", device, symbols, means, scales,
                    recs, n, FAMILIES.index(family), min_sym, max_sym)
        LAUNCHES["tables"] += 1
    return recs


def family_lanes_pass(recs, cfg: LaneConfig):
    """Kernel 12's pass A alone over the records of its tables pass (n > 0):
    ``(words int32[T, L], ballots int32[T, L / 32], states int32[L])``.  On
    the card the words of lanes that emit nothing are left unwritten; a CPU
    tensor runs :func:`family_lanes_pass_plain` and packs its flags with
    ``coder.flag_ballots``."""
    check_cfg(cfg)
    if not isinstance(recs, torch.Tensor):
        raise TypeError("recs must be a torch.Tensor")
    device = recs.device
    _check("recs", recs, torch.int64, device)
    n, L = recs.numel(), cfg.num_lanes
    if n == 0:
        raise ValueError("recs must hold at least one symbol's record")
    if not _on_cuda(device):
        words, flags, states = family_lanes_pass_plain(recs, n, cfg)
        return words, flag_ballots(flags), states
    T = _num_steps(n, L)
    states = torch.full((L,), 1 << 16, dtype=torch.int32, device=device)
    words = torch.empty(T, L, dtype=torch.int32, device=device)
    ballots = torch.empty(T, L // 32, dtype=torch.int32, device=device)
    _build.call("ctt_family_encode_lanes", device, states, recs, n, words,
                ballots, L)
    LAUNCHES["encode_lanes"] += 1
    return words, ballots, states


def _decode_args(states, stream, means, scales, cfg: LaneConfig,
                 n: int, param_values: bool = True) -> None:
    if not isinstance(states, torch.Tensor):
        raise TypeError("states must be a torch.Tensor")
    device = states.device
    _check("states", states, torch.int32, device, cfg.num_lanes)
    _check("stream", stream, torch.int32, device)
    check_params(means, scales, _num_steps(n, cfg.num_lanes) * cfg.num_lanes,
                 device, param_values)


def decode_family(states, stream, means, scales, family: str, min_sym: int,
                  max_sym: int, cfg: LaneConfig, n: int,
                  return_final_states: bool = False):
    """Decode n symbols of a device-family ILANS2 stream.  JAX counterpart:
    ``pallas_family.decode_family_pallas``.

    ``states`` int32[L] (u32 bits), ``stream`` int32 words, ``means`` and
    ``scales`` float32[T * L] (padded layout), all on one device.  Returns
    symbols int32[n], and with ``return_final_states`` also the final
    states int32[L] (after a full decode, 2^16 each).  CUDA tensors launch
    the kernel (ValueError for L above :data:`coder.MAX_DECODE_LANES`),
    CPU tensors run :func:`decode_family_plain`."""
    syms, fin = _decode_family(states, stream, means, scales, family,
                               min_sym, max_sym, cfg, n, True)
    return (syms, fin) if return_final_states else syms


def launch_decode_family(states, stream, means, scales, family: str,
                         min_sym: int, max_sym: int, cfg: LaneConfig, n: int):
    """:func:`decode_family` as a launch form: ``(symbols int32[n], final
    states)``, nothing read back, so the parameters' values are the
    caller's to check (:func:`check_params` on the host)."""
    return _decode_family(states, stream, means, scales, family, min_sym,
                          max_sym, cfg, n, False)


def _decode_family(states, stream, means, scales, family: str, min_sym: int,
                   max_sym: int, cfg: LaneConfig, n: int,
                   param_values: bool):
    check_model(cfg, family, min_sym, max_sym)
    _decode_args(states, stream, means, scales, cfg, n, param_values)
    if not _on_cuda(states.device):
        return decode_family_plain(states, stream, means, scales, family,
                                   min_sym, max_sym, cfg, n, True)
    return _launch_decode(states, stream, means, scales, family, min_sym,
                          max_sym, cfg, n)


def _launch_decode(states, stream, means, scales, family: str, min_sym: int,
                   max_sym: int, cfg: LaneConfig, n: int, cluster: int = 0):
    """One launch of the cluster decode (``cluster`` CTAs, or the size it
    picks from L when 0), counted after it returns; returns (symbols
    int32[n], final states).  Raises for an L past the cluster's reach."""
    L = cfg.num_lanes
    if L > MAX_DECODE_LANES:
        raise ValueError(
            f"the family decode kernel takes at most {MAX_DECODE_LANES} lanes "
            f"(16 CTAs x 1024 threads x 32 lanes a thread), got {L}")
    device = states.device
    fin = states.clone()
    syms = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        entry, extra = (("ctt_family_decode_cluster", (cluster,)) if cluster
                        else ("ctt_family_decode", ()))
        _build.call(entry, device, fin, stream, stream.numel(), means, scales,
                    syms, n, L, FAMILIES.index(family), min_sym, max_sym,
                    *extra)
        LAUNCHES["decode"] += 1
    return syms, fin


def decode_family_cluster(states, stream, means, scales, family: str,
                          min_sym: int, max_sym: int, cfg: LaneConfig, n: int,
                          cluster: int):
    """The decode kernel on a cluster of ``cluster`` CTAs (1 .. 16) in place
    of the size it picks from L, for any L that is a multiple of 32 (CUDA
    tensors): how the card tests reach uneven partitions and CTAs with no
    lanes.  Returns (symbols int32[n], final states)."""
    check_model(cfg, family, min_sym, max_sym, lane_multiple=32)
    _decode_args(states, stream, means, scales, cfg, n)
    if not _on_cuda(states.device):
        raise ValueError("a forced cluster size needs CUDA tensors")
    if not 1 <= cluster <= 16:
        raise ValueError(f"cluster must be in 1 .. 16, got {cluster}")
    return _launch_decode(states, stream, means, scales, family, min_sym,
                          max_sym, cfg, n, cluster)


def geometry(L: int, family: str = "gaussian", device=None,
             cluster: int = 0) -> dict:
    """The decode kernel's launch geometry for L lanes and ``family`` on
    ``device`` (a CUDA device; the current one by default): its cluster
    (``cluster`` 0: the size it picks from L, stepped down while the card
    cannot co-schedule it), the CTAs' groups, lanes per thread and threads,
    and the card's maximum of such active clusters."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.zeros(5, dtype=torch.int64)
    _build.call("ctt_family_geometry", device, L, FAMILIES.index(family),
                cluster, out)
    keys = ("cluster", "groups_per_cta", "lanes_per_thread",
            "threads_per_cta", "max_active_clusters")
    geo = dict(zip(keys, (int(v) for v in out)))
    geo["ctas"] = geo["cluster"]
    return geo


def decode_family_plain(states, stream, means, scales, family: str,
                        min_sym: int, max_sym: int, cfg: LaneConfig, n: int,
                        return_final_states: bool = False):
    """Plain PyTorch twin of :func:`decode_family` (any device, no checks).
    JAX counterpart: ``pallas_family.decode_family_pallas``; numpy oracle
    :func:`decode_family_host`."""
    L, S, W, P = cfg.num_lanes, cfg.state_bits, cfg.word_bits, cfg.precision
    device = states.device
    x = convert.u32_values(states)
    words = convert.u32_values(stream)
    T = _num_steps(n, L)
    inv_scales = 1.0 / scales
    lanes = torch.arange(L, device=device)
    out = torch.empty(T * L, dtype=torch.int32, device=device)
    base = torch.zeros((), dtype=torch.int64, device=device)
    for t in range(T):
        active = t * L + lanes < n
        q = x & ((1 << P) - 1)
        sym, cum, prob = invert_family(
            torch, family, min_sym, max_sym, q.to(torch.int32),
            means[t * L:(t + 1) * L], inv_scales[t * L:(t + 1) * L])
        x = torch.where(active, (x >> P) * prob + (q - cum), x)
        m = x < 1 << (S - W)
        w, base = _refill_words(m, words, base)
        x = torch.where(m, (x << W) | (w & cfg.word_mask), x)
        out[t * L:(t + 1) * L] = sym
    syms = out[:n]
    return (syms, convert.u32_bits(x)) if return_final_states else syms


def family_left(x, means, scales, family: str, min_sym: int, max_sym: int):
    """``left(x)`` elementwise on int32 ``x`` and float32 ``means`` /
    ``scales`` of one shape: the kernels' integer CDF through the test
    entry point ``ctt_family_left`` for CUDA tensors, :func:`left` for CPU
    tensors.  Not a coder: what holds the CUDA arithmetic against the plain
    arithmetic value by value."""
    device = x.device
    _check("x", x, torch.int32, device)
    check_params(means, scales, x.numel(), device)
    if not _on_cuda(device):
        return left(torch, family, min_sym, max_sym, x, means, 1.0 / scales)
    out = torch.empty_like(x)
    if x.numel():
        _build.call("ctt_family_left", device, x, means, scales, out,
                    x.numel(), FAMILIES.index(family), min_sym,
                    free_weight(min_sym, max_sym))
    return out
