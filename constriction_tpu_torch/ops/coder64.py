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
(``csrc/ilans2_wide.cuh``, ``cluster_range_decode_kernel``, instantiated
in ``csrc/ilans2_range.cu``) takes the same route in place of
``_div64_by_scale``: a float64 quotient estimate of the two u64 values
and one correcting product (:func:`range_quotient` is that arithmetic in
Python integers, :func:`range_quantile` the lane's whole quantile; the
estimate comes from an approximate reciprocal, and
``coder.range_correct`` is the correction from any estimate within
one).

The rANS pair runs ``csrc/ilans2_wide.cuh``'s design, as the S=32 pair
does: the decode on a cluster of CTAs with the lane states in registers
(:func:`geometry` says which cluster the card runs for L lanes), the
encode as a lane-parallel pass and a row-major compaction.  The range
decode runs on the same cluster step (:func:`range_geometry`).
:func:`lanes_pass64_plain` and :func:`compact_pass_plain` (shared with the
S=32 pair, from :mod:`constriction_tpu_torch.ops.coder`) are those two
passes in plain PyTorch; the kernels' index math mirrors them, and their
composition is :func:`encode_iid64_plain`'s stream.

Lane states and range planes travel as int64 tensors holding u64 bits
(constriction_tpu_torch/convert.py); stream words as int32 holding u32 bits.
"""

from __future__ import annotations

import torch

from .. import convert
from . import _build
from .coder import (  # noqa: F401 (pass B and its helpers, re-exported)
    SCAN_BLOCKS,
    _check_cfg,
    _check_cluster_args,
    _decode_args,
    _emit_words,
    _encode,
    _encode_args,
    _find_symbols,
    _geometry,
    _launch_decode,
    _launch_lanes,
    _num_steps,
    _on_cuda,
    _raise_if_invalid,
    _range_cluster,
    _range_decode,
    _refill_words,
    _symbol_tables,
    ballot_flags,
    compact_pass,
    compact_pass_plain,
    flag_ballots,
    trim,
)
from .coder import range_quantile as coder_range_quantile
from .coder import range_quotient as coder_range_quotient
from .interleaved import LaneConfig

# kernel launches made by this module's wrappers (never by the twins); the
# encode's pass A launched alone (lanes_pass64) counts under its own key,
# pass B alone (compact_pass) under coder.LAUNCHES["compact"]
LAUNCHES = {"encode": 0, "decode": 0, "range_decode": 0, "encode_lanes": 0}

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
    states, buf, end = _encode("w32s64", symbols, cdf, cfg, seeds,
                               torch.int64, True, encode_iid64_plain,
                               LAUNCHES)
    return states, trim(buf, end)


def launch_encode_iid64(symbols, cdf, cfg: LaneConfig, seeds=None):
    """:func:`encode_iid64` as a launch form: ``(states int64[L], buf, end
    int64[1])``, the stream ``buf[end:]``, nothing read back (the seeds'
    range is the caller's to check), as ``coder.launch_encode_iid``.  CPU
    tensors run :func:`encode_iid64_plain`, with end 0."""
    _check_cfg(cfg, 32, 64, 24)
    return _encode("w32s64", symbols, cdf, cfg, seeds, torch.int64, False,
                   encode_iid64_plain, LAUNCHES)


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
    (``exact_family.encode_tables_plain``).  Returns ``(states int64[L],
    stream int32)``."""
    L, P = cfg.num_lanes, cfg.precision
    hi, lo = _start_halves64(seeds, L, device)
    lanes = torch.arange(L, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(_num_steps(n, L) - 1, -1, -1):
        i = t * L + lanes
        active = i < n
        cum, prob = tables_at(i)
        prob = torch.where(active, prob, 1)
        renorm = _renorms64(hi, prob, active, P)
        e = _emit_words(buf, renorm, lo, e, n)
        hi, lo = _code64(hi, lo, cum, prob, active, renorm, P)
    return convert.u64_join(hi, lo), convert.u32_bits(buf[int(e):n])


def _start_halves64(seeds, L: int, device):
    """(hi, lo) of the encoder's start states: the seeds, or the floor
    2^32."""
    if seeds is not None:
        return convert.u64_halves(seeds)
    return (torch.ones(L, dtype=torch.int64, device=device),
            torch.zeros(L, dtype=torch.int64, device=device))


def _renorms64(hi, prob, active, P: int):
    """The lanes that emit a word before coding: state >> (64 - P) >= prob;
    64 - P >= 32, so only hi matters."""
    return active & ((hi >> (32 - P)) >= prob)


def _code64(hi, lo, cum, prob, active, renorm, P: int):
    """One encode step on (hi, lo) halves: renorming lanes drop their low
    word (state >>= 32), then active lanes take (state // prob) << P |
    (cum + state % prob), the division in two base-2^32 digits."""
    hi, lo = torch.where(renorm, 0, hi), torch.where(renorm, hi, lo)
    q_hi, r = hi // prob, hi % prob
    part = (r << 32) | lo
    q_lo, rem = part // prob, part % prob
    new_hi = (q_hi << P) | (q_lo >> (32 - P))
    new_lo = ((q_lo << P) & _M32) | (cum + rem)
    return torch.where(active, new_hi, hi), torch.where(active, new_lo, lo)


def division_magic(prob: int) -> tuple[int, int]:
    """The encode kernel's multiply-high reciprocal of a probability 1 <=
    prob <= 2^24 (``csrc/ilans2_wide.cuh``, ``DivisionRecord``; Granlund
    and Montgomery 1994, fig. 4.1): ``(magic, l)`` with l = ceil(log2 prob)
    and magic = floor(2^64 (2^l - prob) / prob) + 1, in Python integers."""
    l = (prob - 1).bit_length()
    return ((1 << 64) * ((1 << l) - prob)) // prob + 1, l


def divide_by_magic(x: int, magic: int, l: int) -> int:
    """x // prob for a 64-bit x as the kernel computes it from
    ``division_magic(prob)``: t = (magic x) >> 64, then (t + ((x - t) >>
    min(l, 1))) >> max(l - 1, 0)."""
    t = (magic * x) >> 64
    return (t + ((x - t) >> min(l, 1))) >> max(l - 1, 0)


def lanes_pass64_plain(symbols, cdf, cfg: LaneConfig, seeds=None):
    """Pass A of the S=64 encoder in plain PyTorch (any device, no checks):
    every lane runs steps T-1 .. 0 on its own.  Returns ``(words int32[T,
    L], flags bool[T, L], states int64[L])``: ``flags[t, l]`` is set where
    lane l renorms at step t, before coding symbol t * L + l, and
    ``words[t, l]`` is then the word it emits (0 elsewhere); ``states`` are
    the final states.  Lanes of a partial last step neither code nor flag.
    The kernel (``csrc/ilans2_wide.cuh``, ``encode_lanes_kernel``) keeps
    ``flags`` as one ballot per 32 lanes (:func:`flag_ballots`)."""
    n = symbols.numel()
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1

    def tables_at(i):
        return _symbol_tables(symbols, cdf64, i, n, K)

    return lanes64_steps(tables_at, n, cfg, seeds, symbols.device)


def lanes64_steps(tables_at, n: int, cfg: LaneConfig, seeds, device):
    """Pass A's step loop on (hi, lo) halves, ``tables_at`` as in
    :func:`encode64_steps`.  Shared by :func:`lanes_pass64_plain` and the
    exact-family planes pass (``exact_family.encode_lanes_plain``, kernel
    17's pass A).  Returns ``(words int32[T, L], flags bool[T, L], states
    int64[L])`` as :func:`lanes_pass64_plain` does."""
    L, P = cfg.num_lanes, cfg.precision
    T = _num_steps(n, L)
    hi, lo = _start_halves64(seeds, L, device)
    lanes = torch.arange(L, device=device)
    words = torch.zeros(T, L, dtype=torch.int64, device=device)
    flags = torch.zeros(T, L, dtype=torch.bool, device=device)
    for t in range(T - 1, -1, -1):
        i = t * L + lanes
        active = i < n
        cum, prob = tables_at(i)
        prob = torch.where(active, prob, 1)
        renorm = _renorms64(hi, prob, active, P)
        words[t] = torch.where(renorm, lo, 0)
        flags[t] = renorm
        hi, lo = _code64(hi, lo, cum, prob, active, renorm, P)
    return convert.u32_bits(words), flags, convert.u64_join(hi, lo)


def decode_shared64(states, stream, cdf, cfg: LaneConfig, n: int,
                    return_final_states: bool = False):
    """Decode n symbols of a DEFAULT-preset ILANS2-64 stream.  JAX
    counterpart: ``constriction_tpu.ops.pallas_coder64.decode_shared64_pallas``.

    ``states`` int64[L] (u64 bits), ``stream`` int32 words, ``cdf``
    int64[K+1], all on one device.  Returns symbols int32[n], and with
    ``return_final_states`` also the final states int64[L].  CUDA tensors
    launch the kernel (a ValueError for L above
    ``coder.MAX_DECODE_LANES``), CPU tensors run
    :func:`decode_shared64_plain`."""
    _check_cfg(cfg, 32, 64, 24)
    _decode_args(states, stream, cdf, cfg, torch.int64)
    if not _on_cuda(states.device):
        return decode_shared64_plain(states, stream, cdf, cfg, n,
                                     return_final_states)
    if n == 0:
        syms, fin = torch.zeros(0, dtype=torch.int32,
                                device=states.device), states.clone()
    else:
        syms, fin = _launch_decode("w32s64", states, stream, cdf, cfg, n)
        LAUNCHES["decode"] += 1
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


# ---------------------------------------------------------------------------
# launches of the rANS pair's kernels (csrc/ilans2.cu, ilans2_wide.cuh)
# ---------------------------------------------------------------------------


def lanes_pass64(symbols, cdf, cfg: LaneConfig, seeds=None):
    """Pass A of :func:`encode_iid64` alone (n > 0): ``(words int32[T, L],
    ballots int32[T, L / 32], states int64[L])``.  On the card the words of
    lanes that emit nothing are left unwritten; a CPU tensor runs
    :func:`lanes_pass64_plain` and packs its flags with
    :func:`flag_ballots`."""
    states = _encode_args(symbols, cdf, cfg, seeds, torch.int64)
    if not _on_cuda(symbols.device):
        words, flags, fin = lanes_pass64_plain(symbols, cdf, cfg, seeds)
        return words, flag_ballots(flags), fin
    LAUNCHES["encode_lanes"] += 1
    words, ballots = _launch_lanes("w32s64", symbols, cdf, cfg, states)
    return words, ballots, states


def decode_shared64_cluster(states, stream, cdf, cfg: LaneConfig, n: int,
                            cluster: int):
    """The decode kernel on a cluster of ``cluster`` CTAs (1 .. 16) in
    place of the size it picks from L, for any L that is a multiple of 32
    (n > 0, CUDA tensors): how the card tests reach uneven partitions and
    CTAs with no lanes.  Returns (symbols int32[n], final states)."""
    _check_cluster_args(states, stream, cdf, cfg, cluster, torch.int64)
    out = _launch_decode("w32s64", states, stream, cdf, cfg, n, cluster)
    LAUNCHES["decode"] += 1
    return out


def geometry(L: int, K: int, device=None, cluster: int = 0) -> dict:
    """The launch geometry of the rANS pair for L lanes and K symbols at
    P=24 on ``device`` (a CUDA device; the current one by default), as
    :func:`constriction_tpu_torch.ops.coder.geometry` reports it."""
    return _geometry("w32s64", L, K, 24, device, cluster)


def range_quotient(num: int, scale: int) -> int:
    """floor(num / scale) as the S=64 range kernel takes it
    (:func:`constriction_tpu_torch.ops.coder.range_quotient` at 64 bits)."""
    return coder_range_quotient(num, scale, 64)


def range_quantile(point: int, lower: int, rng: int, P: int):
    """A range lane's quantile as the S=64 kernel computes it
    (:func:`constriction_tpu_torch.ops.coder.range_quantile` at 64 bits):
    ``(q, over)`` with q = (point - lower) // (rng >> P) clamped to 2^P - 1
    and over = the unclamped quotient was >= 2^P; (0, False) where the
    scale is 0."""
    return coder_range_quantile(point, lower, rng, P, 64)


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
    syms, bad, planes = _range_decode("w32s64", points, stream, cdf, cfg, n,
                                      lows, rngs, torch.int64, _range_steps64,
                                      LAUNCHES)
    _raise_if_invalid(int(bad.item()), n)
    return (syms, planes) if return_final_states else syms


def launch_decode_shared_range64(points, stream, cdf, cfg: LaneConfig, n: int,
                                 lows=None, rngs=None):
    """:func:`decode_shared_range64` as a launch form: ``(symbols
    int32[n], flag int64[1])``, nothing read back, as
    ``coder.launch_decode_shared_range``."""
    _check_cfg(cfg, 32, 64, 24)
    return _range_decode("w32s64", points, stream, cdf, cfg, n, lows, rngs,
                         torch.int64, _range_steps64, LAUNCHES)[:2]


def decode_shared_range64_cluster(points, stream, cdf, cfg: LaneConfig,
                                  n: int, cluster: int, lows=None, rngs=None):
    """The range decode kernel on a cluster of ``cluster`` CTAs (1 .. 16)
    in place of the size it picks from L, for any L that is a multiple of
    32 (n > 0, CUDA tensors): how the card tests reach uneven partitions
    and CTAs with no lanes.  Returns (symbols int32[n], final (lows, rngs,
    pts))."""
    return _range_cluster("w32s64", points, stream, cdf, cfg, n, cluster,
                          lows, rngs, torch.int64, LAUNCHES)


def range_geometry(L: int, K: int, P: int = 24, device=None,
                   cluster: int = 0) -> dict:
    """The launch geometry of the range decode for L lanes, K symbols and
    precision P on ``device`` (a CUDA device; the current one by default):
    the keys of :func:`constriction_tpu_torch.ops.coder.geometry` but the
    encode's grid."""
    return _geometry("w32s64", L, K, P, device, cluster,
                     entry="ilans2_range_geometry", size=8)


def decode_shared_range64_plain(points, stream, cdf, cfg: LaneConfig, n: int,
                                lows=None, rngs=None,
                                return_final_states: bool = False):
    """Plain PyTorch twin of :func:`decode_shared_range64` (any device, no
    argument checks), on (hi, lo) halves.  JAX counterpart:
    ``constriction_tpu.ops.pallas_coder64.decode_shared_range64_pallas``;
    numpy oracle ``interleaved2.decode_shared_range_cdf``."""
    syms, planes, first_bad = _range_steps64(points, stream, cdf, cfg, n,
                                             lows, rngs)
    _raise_if_invalid(int(first_bad), n)
    return (syms, planes) if return_final_states else syms


def _range_steps64(points, stream, cdf, cfg: LaneConfig, n: int, lows,
                   rngs):
    """The step loop of :func:`decode_shared_range64_plain`: (symbols
    int32[n], final (lows, rngs, pts), the first bad symbol or n as an
    int64 tensor)."""
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
    return out[:n], tuple(convert.u64_join(h, lo) for h, lo in (
        (l_hi, l_lo), (r_hi, r_lo), (p_hi, p_lo))), first_bad
