"""ILANS2 rANS and ILANS2-R range decoding at the reference's DEFAULT
preset (W=32, S=64, P <= 24).

The counterpart of ``constriction_tpu/ops/pallas_coder64.py``'s rANS pair
and range decoder.
The TPU kernels hold a 64-bit lane state as two u32 tiles and need
``_mul40x25`` and ``_div64`` for the state update; the CUDA kernel
(``csrc/ilans2.cu``, instantiated at W=32, S=64) uses native ``uint64_t``,
so neither is ported.  The plain twins hold a state as a (hi, lo) pair of
u32 values in int64 tensors, because int64 cannot hold states >= 2^63: the
decoder's product ``(state >> P) * prob`` is split at the 32-bit boundary,
and the encoder's ``state // prob`` is a two-digit long division in base
2^32 (each partial dividend < 2^56).  The range decoder's twin does all its
u64 arithmetic on such halves (the helpers below), its quotient from a
float64 estimate corrected against the exact product; the range kernel
(``csrc/ilans2_range.cu``) divides in native u64 in place of
``_div64_by_scale``.

Lane states and range planes travel as int64 tensors holding u64 bits
(constriction_tpu_torch/convert.py); stream words as int32 holding u32 bits.
"""

from __future__ import annotations

import torch

from .. import convert
from .coder import (
    _check_cfg,
    _decode_args,
    _emit_words,
    _encode_args,
    _find_symbols,
    _launch_decode,
    _launch_encode,
    _launch_range_decode,
    _num_steps,
    _on_cuda,
    _raise_if_invalid,
    _range_decode_args,
    _refill_words,
    _symbol_tables,
)
from .interleaved import LaneConfig

# kernel launches made by this module's wrappers (never by the twins)
LAUNCHES = {"encode": 0, "decode": 0, "range_decode": 0}

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# u64 arithmetic on (hi, lo) u32 halves held in int64 tensors (twins only)
# ---------------------------------------------------------------------------


def _shr64(hi, lo, k: int):
    """(hi, lo) >> k for 0 < k < 32."""
    return hi >> k, ((hi << (32 - k)) & _M32) | (lo >> k)


def _mul_small(hi, lo, k):
    """(hi, lo) * k mod 2^64 for 0 <= k < 2^31 (each partial < 2^63)."""
    low = lo * k
    return (hi * k + (low >> 32)) & _M32, low & _M32


def _add64(a_hi, a_lo, b_hi, b_lo):
    """(a + b) mod 2^64 and the carry out of bit 63 (0 or 1)."""
    lo = a_lo + b_lo
    hi = a_hi + b_hi + (lo >> 32)
    return hi & _M32, lo & _M32, hi >> 32


def _sub64(a_hi, a_lo, b_hi, b_lo):
    """(a - b) mod 2^64."""
    lo = a_lo - b_lo
    borrow = (lo < 0).to(torch.int64)
    return (a_hi - b_hi - borrow) & _M32, lo & _M32


def _gt64(a_hi, a_lo, b_hi, b_lo):
    return (a_hi > b_hi) | ((a_hi == b_hi) & (a_lo > b_lo))


def _div_scale(d_hi, d_lo, s_hi, s_lo, P: int):
    """d // s for u64 d and s, exact whenever the quotient is below 2^P
    (otherwise some value >= 2^P); 0 where s == 0, as numpy's u64 floor
    division gives.  A float64 estimate clamped to 2^P is off by at most one
    below 2^P (relative error under 2^-50), and one step down and one up
    against the exact limb product fix it."""
    zero = (s_hi == 0) & (s_lo == 0)
    d_f = d_hi.double() * 4294967296.0 + d_lo.double()
    s_f = torch.where(zero, 1.0, s_hi.double() * 4294967296.0 + s_lo.double())
    q = torch.floor(d_f / s_f).clamp(max=float(1 << P)).to(torch.int64)
    p_hi, p_lo = _mul_small(s_hi, s_lo, q)  # q * s <= 2^P * s < 2^64
    down = _gt64(p_hi, p_lo, d_hi, d_lo)
    q = q - down.to(torch.int64)
    r_hi, r_lo = _sub64(d_hi, d_lo, p_hi, p_lo)  # d - q * s, before the step
    a_hi, a_lo, _ = _add64(r_hi, r_lo, s_hi, s_lo)
    r_hi = torch.where(down, a_hi, r_hi)
    r_lo = torch.where(down, a_lo, r_lo)
    up = ~_gt64(s_hi, s_lo, r_hi, r_lo)  # remainder >= s
    return torch.where(zero, 0, q + up.to(torch.int64))


def encode_iid64(symbols, cdf, cfg: LaneConfig, seeds=None):
    """Encode i.i.d. categorical symbols into the DEFAULT-preset ILANS2-64
    format (W=32, S=64, P <= 24).  JAX counterpart:
    ``constriction_tpu.ops.pallas_coder64.encode_iid64_pallas``.

    ``symbols`` int32[n] and ``cdf`` int64[K+1] on one device; ``seeds``
    (optional, int64[L] holding u64 start states in [2^32, 2^64)).  Returns
    ``(states int64[L], stream int32[num_words])``.  CUDA tensors launch the
    kernel, CPU tensors run :func:`encode_iid64_plain`."""
    _check_cfg(cfg, 32, 64, 24)
    states = _encode_args(symbols, cdf, cfg, seeds, torch.int64)
    if not _on_cuda(symbols.device):
        return encode_iid64_plain(symbols, cdf, cfg, seeds)
    if symbols.numel() == 0:
        return states, torch.zeros(0, dtype=torch.int32,
                                   device=symbols.device)
    LAUNCHES["encode"] += 1
    return _launch_encode("w32s64", symbols, cdf, cfg, states)


def encode_iid64_plain(symbols, cdf, cfg: LaneConfig, seeds=None):
    """Plain PyTorch twin of :func:`encode_iid64` (any device, no checks).
    JAX counterpart:
    ``constriction_tpu.ops.pallas_coder64.encode_iid64_pallas``; numpy
    oracle ``interleaved2.encode_shared``."""
    n = symbols.numel()
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1

    def tables_at(i):
        return _symbol_tables(symbols, cdf64, i, n, K)

    return encode64_steps(tables_at, n, cfg, seeds, symbols.device)


def encode64_steps(tables_at, n: int, cfg: LaneConfig, seeds, device):
    """The S=64 encoder's step loop on (hi, lo) halves, steps T-1 .. 0:
    ``tables_at(i)`` gives the (cum, prob) int64 of the flat symbol indices
    ``i`` (one step's lanes; indices past n are masked).  Shared by the
    categorical twin above and the exact-family planes twin
    (``exact_family.encode_tables_plain``), as the kernels share
    ``csrc/ilans2.cuh``'s encode loop.  Returns ``(states int64[L], stream
    int32)``."""
    L, P = cfg.num_lanes, cfg.precision
    if seeds is not None:
        hi, lo = convert.u64_halves(seeds)
    else:  # the floor 2^32
        hi = torch.ones(L, dtype=torch.int64, device=device)
        lo = torch.zeros(L, dtype=torch.int64, device=device)
    lanes = torch.arange(L, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(_num_steps(n, L) - 1, -1, -1):
        i = t * L + lanes
        active = i < n
        cum, prob = tables_at(i)
        prob = torch.where(active, prob, 1)
        # state >> (64 - P) >= prob; 64 - P >= 32, so only hi matters
        renorm = active & ((hi >> (32 - P)) >= prob)
        e = _emit_words(buf, renorm, lo, e, n)
        hi, lo = torch.where(renorm, 0, hi), torch.where(renorm, hi, lo)
        # state // prob and state % prob, two base-2^32 digits
        q_hi, r = hi // prob, hi % prob
        part = (r << 32) | lo
        q_lo, rem = part // prob, part % prob
        # (q << P) | (cum + rem)
        new_hi = (q_hi << P) | (q_lo >> (32 - P))
        new_lo = ((q_lo << P) & _M32) | (cum + rem)
        hi = torch.where(active, new_hi, hi)
        lo = torch.where(active, new_lo, lo)
    return convert.u64_join(hi, lo), convert.u32_bits(buf[int(e):n])


def decode_shared64(states, stream, cdf, cfg: LaneConfig, n: int,
                    return_final_states: bool = False):
    """Decode n symbols of a DEFAULT-preset ILANS2-64 stream.  JAX
    counterpart: ``constriction_tpu.ops.pallas_coder64.decode_shared64_pallas``.

    ``states`` int64[L] (u64 bits), ``stream`` int32 words, ``cdf``
    int64[K+1], all on one device.  Returns symbols int32[n], and with
    ``return_final_states`` also the final states int64[L].  CUDA tensors
    launch the kernel, CPU tensors run :func:`decode_shared64_plain`."""
    _check_cfg(cfg, 32, 64, 24)
    _decode_args(states, stream, cdf, cfg, torch.int64)
    if not _on_cuda(states.device):
        return decode_shared64_plain(states, stream, cdf, cfg, n,
                                     return_final_states)
    if n == 0:
        syms, fin = torch.zeros(0, dtype=torch.int32,
                                device=states.device), states.clone()
    else:
        LAUNCHES["decode"] += 1
        syms, fin = _launch_decode("w32s64", states, stream, cdf, cfg, n)
    return (syms, fin) if return_final_states else syms


def decode_shared64_plain(states, stream, cdf, cfg: LaneConfig, n: int,
                          return_final_states: bool = False):
    """Plain PyTorch twin of :func:`decode_shared64` (any device, no
    checks).  JAX counterpart:
    ``constriction_tpu.ops.pallas_coder64.decode_shared64_pallas``; numpy
    oracle ``interleaved2.decode_shared_cdf``."""
    L, P = cfg.num_lanes, cfg.precision
    device = states.device
    hi, lo = convert.u64_halves(states)
    words = convert.u32_values(stream)
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1
    T = _num_steps(n, L)
    lanes = torch.arange(L, device=device)
    out = torch.empty(T * L, dtype=torch.int32, device=device)
    base = torch.zeros((), dtype=torch.int64, device=device)
    for t in range(T):
        active = t * L + lanes < n
        q = lo & ((1 << P) - 1)
        sym = _find_symbols(cdf64, q, K)
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        # (state >> P) * prob + (q - cum), the product split at 2^32
        sh_hi = hi >> P
        sh_lo = ((hi << (32 - P)) & _M32) | (lo >> P)
        low = sh_lo * prob + (q - cum)  # < 2^57
        hi = torch.where(active, sh_hi * prob + (low >> 32), hi)
        lo = torch.where(active, low & _M32, lo)
        # renorm: state < 2^32 <=> hi == 0; state = state << 32 | word
        m = hi == 0
        w, base = _refill_words(m, words, base)
        hi, lo = torch.where(m, lo, hi), torch.where(m, w, lo)
        out[t * L:(t + 1) * L] = sym.to(torch.int32)
    syms = out[:n]
    return (syms, convert.u64_join(hi, lo)) if return_final_states else syms


def decode_shared_range64(points, stream, cdf, cfg: LaneConfig, n: int,
                          lows=None, rngs=None,
                          return_final_states: bool = False):
    """Decode n symbols of a DEFAULT-preset ILANS2-R64 range stream (W=32,
    S=64, P <= 24).  JAX counterpart:
    ``constriction_tpu.ops.pallas_coder64.decode_shared_range64_pallas``
    (``_build_range_decoder64``, ``seeded=True`` when ``lows``/``rngs`` are
    given).

    ``points`` int64[L] (u64 bits), ``stream`` int32 words, ``cdf``
    int64[K+1], all on one device; ``lows``, ``rngs`` (optional, int64[L]):
    a checkpoint's lower and range planes.  Returns symbols int32[n], and
    with ``return_final_states`` also the final ``(lows, rngs, pts)``
    planes.  Raises the host oracle's ValueError on data inconsistent with
    the model (a quantile >= 2^P, which includes one >= 2^32).  CUDA
    tensors launch the kernel, CPU tensors run
    :func:`decode_shared_range64_plain`."""
    _check_cfg(cfg, 32, 64, 24)
    planes = _range_decode_args(points, stream, cdf, cfg, lows, rngs,
                                torch.int64)
    if not _on_cuda(points.device):
        return decode_shared_range64_plain(points, stream, cdf, cfg, n, lows,
                                           rngs, return_final_states)
    if n == 0:
        syms = torch.zeros(0, dtype=torch.int32, device=points.device)
    else:
        LAUNCHES["range_decode"] += 1
        syms = _launch_range_decode("w32s64", planes, stream, cdf, cfg, n)
    return (syms, planes) if return_final_states else syms


def decode_shared_range64_plain(points, stream, cdf, cfg: LaneConfig, n: int,
                                lows=None, rngs=None,
                                return_final_states: bool = False):
    """Plain PyTorch twin of :func:`decode_shared_range64` (any device, no
    argument checks), on (hi, lo) halves.  JAX counterpart:
    ``constriction_tpu.ops.pallas_coder64.decode_shared_range64_pallas``;
    numpy oracle ``interleaved2.decode_shared_range_cdf``."""
    L, P = cfg.num_lanes, cfg.precision
    device = points.device
    zeros = torch.zeros(L, dtype=torch.int64, device=device)
    ones = torch.full((L,), _M32, dtype=torch.int64, device=device)
    p_hi, p_lo = convert.u64_halves(points)
    l_hi, l_lo = (zeros, zeros) if lows is None else convert.u64_halves(lows)
    r_hi, r_lo = (ones, ones) if rngs is None else convert.u64_halves(rngs)
    words = convert.u32_values(stream)
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1
    T = _num_steps(n, L)
    lanes = torch.arange(L, device=device)
    out = torch.empty(T * L, dtype=torch.int32, device=device)
    base = torch.zeros((), dtype=torch.int64, device=device)
    first_bad = torch.full((), n, dtype=torch.int64, device=device)
    for t in range(T):
        i = t * L + lanes
        active = i < n
        s_hi, s_lo = _shr64(r_hi, r_lo, P)  # scale = range >> P
        q = _div_scale(*_sub64(p_hi, p_lo, l_hi, l_lo), s_hi, s_lo, P)
        bad = active & (q >= 1 << P)
        first_bad = torch.minimum(first_bad, torch.where(bad, i, n).min())
        sym = _find_symbols(cdf64, q.clamp(max=(1 << P) - 1), K)
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        n_hi, n_lo, _ = _add64(l_hi, l_lo, *_mul_small(s_hi, s_lo, cum))
        g_hi, g_lo = _mul_small(s_hi, s_lo, prob)
        l_hi = torch.where(active, n_hi, l_hi)
        l_lo = torch.where(active, n_lo, l_lo)
        r_hi = torch.where(active, g_hi, r_hi)
        r_lo = torch.where(active, g_lo, r_lo)
        # renorm: range < 2^32 <=> hi == 0; all three shift left by W=32
        m = active & (r_hi == 0)
        w, base = _refill_words(m, words, base)
        l_hi, l_lo = torch.where(m, l_lo, l_hi), torch.where(m, 0, l_lo)
        r_hi, r_lo = torch.where(m, r_lo, r_hi), torch.where(m, 0, r_lo)
        p_hi, p_lo = torch.where(m, p_lo, p_hi), torch.where(m, w, p_lo)
        out[t * L:(t + 1) * L] = sym.to(torch.int32)
    _raise_if_invalid(int(first_bad), n)
    syms = out[:n]
    if return_final_states:
        return syms, tuple(convert.u64_join(h, lo) for h, lo in (
            (l_hi, l_lo), (r_hi, r_lo), (p_hi, p_lo)))
    return syms
