"""ILANS2 shared-stream interleaved rANS: the host coder and v1 containers.

All L lanes share one word stream in decode-consumption order: at decode
step t, the lanes whose state fell below 2^(S-W) take the next words, in
ascending lane order.  The encoder walks t = T-1 .. 0 and emits each step's
renorming lanes' words in ascending lane order; the stream is those chunks
in step order 0 .. T-1.  Lanes start at 2^(S-W) or at given seeds.

v1 container layout (u32 words):

    [0] magic 0x494C4E32 ("ILN2")  [1] version = 1
    [2] word_bits | precision << 8 | state_bits << 16
    [3] num_symbols lo   [4] num_symbols hi   [5] num_lanes L
    [6] stream length (in W-bit words)
    [7 .. 7+L)   initial decoder states (u32) for S <= 32; for S = 64 two
                 u32 planes [7 .. 7+2L), all low words then all high words
    then         the stream, W-bit words packed into u32 (little-endian)

ILANS2-R (range coding) shares the stream layout: each lane is a range
coder (lower, range, point), refilling lanes take the next words in
ascending lane order, and a lane's first S/W words form its initial point,
which travels beside the stream as ``points``.

JAX counterpart: ``constriction_tpu.ops.interleaved2``.  The host functions
here (``encode_shared``, ``decode_shared_cdf``, the packers, the range
coder, the rANS and range checkpoints) are copies of its host code, so
that the port imports nothing of the JAX package.  :func:`encode_shared`,
:func:`decode_shared_cdf`, :func:`build_checkpoints`,
:func:`encode_shared_range` and :func:`decode_shared_range_cdf` run the
host codec (``native/``, C++) under the JAX package's conditions, and each
numpy branch survives as a ``*_plain`` version that no card path calls;
:func:`decode_shared_quantized` (the per-symbol family decode that the
JAX package's neural-latents example calls in C++) always runs the codec,
with ``exact_family.decode_family_exact_host`` as its plain version;
``tests/test_torch_native.py``, ``tests/test_torch_host.py``,
``tests/test_torch_range.py`` and ``tests/test_torch_checkpoints.py`` hold
them byte for byte against each other and the JAX package.
Lane coding runs on the port's coder: the kernels for a CUDA device, the
plain twins for the CPU.  Configs the kernels do not take are coded by the
host coder, exactly as the JAX package does: the same semantics, not a
fallback.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import convert, native
from ..models.quantized import BinomialFamily
from . import coder, coder64
from .interleaved import LaneConfig, state_dtype

MAGIC2 = 0x494C4E32


def kernel_eligible(cfg: LaneConfig) -> bool:
    """The configs the port's coder takes: W=16/S=32 up to P=16 and
    W=32/S=64 up to P=24, with lanes a multiple of 128.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2._pallas_eligible``; both packages
    must pick the same coder for every config, which
    ``tests/test_torch_host.py`` checks over a grid of configs."""
    if cfg.num_lanes % 128 != 0:
        return False
    if cfg.state_bits == 32 and cfg.word_bits == 16:
        return cfg.precision <= 16
    if cfg.state_bits == 64 and cfg.word_bits == 32:
        return cfg.precision <= 24
    return False


# ---------------------------------------------------------------------------
# host coder (the host codec, C++; numpy plain versions; any W/S/P and lane
# count)
# ---------------------------------------------------------------------------

# the host codec takes messages of at least this many symbols (below it,
# the numpy versions), as in the JAX package
NATIVE_MIN_SYMBOLS = 256
L1_BITS = 16


@lru_cache(maxsize=16)
def _lookup_table(cdf_bytes: bytes, precision: int) -> np.ndarray:
    """quantile -> symbol table u32[2^P] of the host codec's lookup decoders,
    memoized per model.  JAX counterpart:
    ``interleaved2._lookup_table_cached``."""
    cdf = np.frombuffer(cdf_bytes, dtype=np.uint32).astype(np.uint64)
    qs = np.arange(1 << precision, dtype=np.uint64)
    return (np.searchsorted(cdf, qs, side="right") - 1).astype(np.uint32)


@lru_cache(maxsize=16)
def _l1_table(cdf_bytes: bytes, precision: int, l1_bits: int) -> np.ndarray:
    """Bucket table of the host codec's two-level CDF search: entry i is the
    largest symbol whose left cumulative is <= (i << (P - l1_bits));
    ``(1 << l1_bits) + 1`` u32 entries, memoized per model.  JAX
    counterpart: ``interleaved2._l1_table_cached``."""
    cdf = np.frombuffer(cdf_bytes, dtype=np.uint32).astype(np.uint64)
    bases = np.arange((1 << l1_bits) + 1, dtype=np.uint64) << np.uint64(
        precision - l1_bits)
    return (np.searchsorted(cdf, bases, side="right") - 1).astype(np.uint32)


def _pairs(x) -> np.ndarray:
    """u64[L] -> (lo, hi) u32 pairs u32[2L], the codec's wide-state layout."""
    x = np.asarray(x, dtype=np.uint64)
    out = np.empty(2 * len(x), dtype=np.uint32)
    out[0::2] = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[1::2] = (x >> np.uint64(32)).astype(np.uint32)
    return out


def _unpairs(p: np.ndarray) -> np.ndarray:
    return p[0::2].astype(np.uint64) | (p[1::2].astype(np.uint64)
                                        << np.uint64(32))


def _encode_args(cums, probs, cfg: LaneConfig, seeds):
    n = len(cums)
    if len(probs) != n:
        raise ValueError(
            f"cums and probs must have equal length, got {n} vs {len(probs)}"
        )
    return None if seeds is None else check_seeds(seeds, cfg)


def check_seeds(seeds, cfg: LaneConfig) -> np.ndarray:
    """Encoder start states ``[L]`` on the host: each in [2^(S-W), 2^S),
    else ValueError.  Returns them as uint64."""
    S, W = cfg.state_bits, cfg.word_bits
    seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1)
    if len(seeds) != cfg.num_lanes:
        raise ValueError(
            f"seeds must have num_lanes={cfg.num_lanes} entries")
    if np.any(seeds >> np.uint64(S - W) == 0) or (
        S < 64 and np.any(seeds >> np.uint64(S))
    ):
        raise ValueError("seeds must lie in [2^(S-W), 2^S)")
    return seeds


def _zero_padded(stream, T: int, L: int) -> np.ndarray:
    """The stream as u32, zero-padded to the T * L words a decode can read
    at most (one a lane a step): the codec's rANS decoders stop refilling
    at the end of their input, and the padding makes reads past the end
    give zero words, as the plain versions and the kernels do.  The pad is
    zeroed lazily by the allocator and touched only by such reads."""
    stream = np.asarray(stream)
    out = np.zeros(max(T * L, len(stream)), dtype=np.uint32)
    out[:len(stream)] = stream
    return out


def _check_cdf(cdf, P: int) -> None:
    if int(np.asarray(cdf)[-1]) != 1 << P:
        raise ValueError(
            f"cdf[-1] must equal 2**precision = {1 << P}, got "
            f"{int(np.asarray(cdf)[-1])}"
        )


def encode_shared(cums, probs, cfg: LaneConfig, seeds=None):
    """Host ILANS2 encoder over per-symbol (cum, prob) tables.  Returns
    ``(initial decoder states, stream u32[num_words])``: u64 states for
    S > 32, u32 otherwise; stream entries are W-bit words.  ``seeds``
    (optional, [L]) are the encoder's start states, each in
    [2^(S-W), 2^S); a full decode's final states equal them.  The host
    codec (``ctpu_ilans2_encode[_seeded]``) from
    :data:`NATIVE_MIN_SYMBOLS` symbols on, :func:`encode_shared_plain`
    below.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.encode_shared``."""
    seeds = _encode_args(cums, probs, cfg, seeds)
    n = len(cums)
    if n < NATIVE_MIN_SYMBOLS:
        return encode_shared_plain(cums, probs, cfg, seeds)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-n // L)
    cums32 = np.ascontiguousarray(cums, dtype=np.uint32)
    probs32 = np.ascontiguousarray(probs, dtype=np.uint32)
    if not probs32.all():  # the codec divides by each prob
        raise ValueError("probs must be positive")
    wide = S > 32
    cap = T * L + 8
    buf = np.empty(cap, dtype=np.uint32)
    states = np.empty(2 * L if wide else L, dtype=np.uint32)
    lib = native.library()
    if seeds is None:
        slen = lib.ctpu_ilans2_encode(cums32, probs32, n, L, T, W, S, P,
                                      states, buf, cap)
    else:
        seeds32 = _pairs(seeds) if wide else seeds.astype(np.uint32)
        slen = lib.ctpu_ilans2_encode_seeded(cums32, probs32, n, L, T, W, S,
                                             P, seeds32, states, buf, cap)
    return (_unpairs(states) if wide else states), buf[cap - slen:].copy()


def encode_shared_plain(cums, probs, cfg: LaneConfig, seeds=None):
    """:func:`encode_shared` in numpy.  JAX counterpart: the numpy branch of
    ``constriction_tpu.ops.interleaved2.encode_shared``."""
    seeds = _encode_args(cums, probs, cfg, seeds)
    n = len(cums)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-n // L) if n else 0
    cums64 = np.zeros(T * L, dtype=np.uint64)
    probs64 = np.ones(T * L, dtype=np.uint64)
    cums64[:n] = cums
    probs64[:n] = probs
    states = (seeds.copy() if seeds is not None
              else np.full(L, 1 << (S - W), dtype=np.uint64))
    chunks = []  # per-step emitted words, t = T-1 .. 0
    lanes = np.arange(L)
    wmask = np.uint64(cfg.word_mask)
    for t in range(T - 1, -1, -1):
        idx = t * L + lanes
        active = idx < n
        cp = cums64[idx]
        pp = probs64[idx]
        renorm = active & ((states >> np.uint64(S - P)) >= pp)
        chunks.append((states[renorm] & wmask).astype(np.uint32))
        states = np.where(renorm, states >> np.uint64(W), states)
        new_states = ((states // pp) << np.uint64(P)) | (cp + states % pp)
        states = np.where(active, new_states, states)
    stream = (np.concatenate(chunks[::-1]) if chunks
              else np.zeros(0, dtype=np.uint32))
    return states.astype(state_dtype(cfg)), stream


def _decode_args(init_states, cdf, cfg: LaneConfig) -> None:
    L = cfg.num_lanes
    if len(init_states) != L:
        raise ValueError(
            f"init_states must have num_lanes={L} entries, got "
            f"{len(init_states)}"
        )
    _check_cdf(cdf, cfg.precision)


def decode_shared_cdf(init_states, stream, num_symbols: int, cdf,
                      cfg: LaneConfig, return_final_states: bool = False):
    """Host ILANS2 decoder with a CDF-table model; reads past the end of
    the stream give zero words.  Returns symbols int32[num_symbols], and
    with ``return_final_states`` also the final lane states.  The host
    codec from :data:`NATIVE_MIN_SYMBOLS` symbols on: a 2^P lookup table
    at S <= 32 and P <= 20 (``ctpu_ilans2_decode_lookup``), a CDF search
    at 32 < S <= 64 (``ctpu_ilans2_decode_cdf64``, two-level with a
    2^16-bucket table above P = 16); :func:`decode_shared_cdf_plain`
    otherwise.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.decode_shared_cdf``."""
    _decode_args(init_states, cdf, cfg)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    lookup = S <= 32 and P <= 20
    if num_symbols < NATIVE_MIN_SYMBOLS or not (lookup or 32 < S <= 64):
        return decode_shared_cdf_plain(init_states, stream, num_symbols,
                                       cdf, cfg, return_final_states)
    T = -(-num_symbols // L)
    cdf32 = np.ascontiguousarray(np.asarray(cdf), dtype=np.uint32)
    stream32 = _zero_padded(stream, T, L)
    out = np.empty(num_symbols, dtype=np.int32)
    lib = native.library()
    if lookup:
        # a copy: the codec writes the final states back into it
        states = np.array(init_states, dtype=np.uint32, copy=True)
        lib.ctpu_ilans2_decode_lookup(
            states, stream32, len(stream32), num_symbols, L, T,
            _lookup_table(cdf32.tobytes(), P), cdf32, W, S, P, out)
        fin = states
    else:
        states = _pairs(init_states)
        if P > L1_BITS:
            lib.ctpu_ilans2_decode_cdf64_l1(
                states, stream32, len(stream32), num_symbols, L, T, cdf32,
                len(cdf32), _l1_table(cdf32.tobytes(), P, L1_BITS), L1_BITS,
                W, S, P, out)
        else:
            lib.ctpu_ilans2_decode_cdf64(
                states, stream32, len(stream32), num_symbols, L, T, cdf32,
                len(cdf32), W, S, P, out)
        fin = _unpairs(states)
    if return_final_states:
        return out, fin
    return out


def decode_shared_cdf_plain(init_states, stream, num_symbols: int, cdf,
                            cfg: LaneConfig,
                            return_final_states: bool = False):
    """:func:`decode_shared_cdf` in numpy.  JAX counterpart: the numpy
    branch of ``constriction_tpu.ops.interleaved2.decode_shared_cdf``."""
    _decode_args(init_states, cdf, cfg)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-num_symbols // L) if num_symbols else 0
    lower = np.uint64(1 << (S - W))
    states = np.asarray(init_states).astype(np.uint64)
    stream = np.asarray(stream)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    base = 0
    out = np.empty(T * L, dtype=np.int32)
    lanes = np.arange(L)
    for t in range(T):
        idx = t * L + lanes
        active = idx < num_symbols
        q = states & np.uint64((1 << P) - 1)
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        states = np.where(active, (states >> np.uint64(P)) * prob + (q - cum),
                          states)
        m = states < lower
        k = int(m.sum())
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base:base + k]
            words[:len(avail)] = avail
            states[m] = (states[m] << np.uint64(W)) | words
            base += k
        out[idx] = sym
    if return_final_states:
        return out[:num_symbols], states.astype(state_dtype(cfg))
    return out[:num_symbols]


def _quantized_args(init_states, num_symbols: int, family, cfg: LaneConfig):
    """``(kind, min_sym, max_sym, param_a, param_b)`` of a
    :class:`~constriction_tpu_torch.models.QuantizedFamily` (gaussian,
    laplace, cauchy) or a ``BinomialFamily`` of one trial count (support
    [0, n], params (n, p)), after the checks of the host codec's
    per-symbol family decode: u32 lane states (S=32), one model a
    symbol, the family's precision the config's."""
    if isinstance(family, BinomialFamily):
        trials = np.unique(family.ns)
        if len(trials) != 1:
            raise ValueError("a binomial family must have one trial count, "
                             f"got {len(trials)}")
        kind, min_sym, max_sym = "binomial", 0, int(trials[0])
        precision = family.precision
        param_a, param_b = family.ns.astype(np.float64), family.ps
    else:
        kind, q = family.kind, family.quantizer
        min_sym, max_sym, precision = q.min, q.max, q.precision
        param_a, param_b = family.param_a, family.param_b
    if cfg.state_bits != 32:
        raise ValueError("the per-symbol family decode takes u32 lane states "
                         f"(S=32), got S={cfg.state_bits}")
    if precision != cfg.precision:
        raise ValueError(f"the family's precision {precision} is not the "
                         f"config's {cfg.precision}")
    if len(init_states) != cfg.num_lanes:
        raise ValueError(
            f"init_states must have num_lanes={cfg.num_lanes} entries, got "
            f"{len(init_states)}")
    if len(param_a) != num_symbols:
        raise ValueError(f"the family has {len(param_a)} models for "
                         f"{num_symbols} symbols")
    return (kind, min_sym, max_sym, np.ascontiguousarray(param_a),
            np.ascontiguousarray(param_b, dtype=np.float64))


def decode_shared_quantized(init_states, stream, num_symbols: int, family,
                            cfg: LaneConfig) -> np.ndarray:
    """Host ILANS2 decode of a stream that :func:`encode_shared` wrote over
    a family's exact ``(cum, prob)`` (``family.ecp_all``): per symbol the
    leakily quantized model of its own parameters, inverted by the host
    codec (``ctpu_ilans2_decode_quantized``).  ``family`` is a
    ``QuantizedFamily`` or a ``BinomialFamily`` of one trial count (see
    :func:`_quantized_args`); S=32 only.  Reads past the end of the
    stream give zero words, as in :func:`decode_shared_cdf`.  Returns int32
    symbols.  JAX counterpart: the C++ call of
    ``examples/neural_latents.py``'s ``_host_decode_family``; plain version
    ``exact_family.decode_family_exact_host`` over the family's
    ``(param_a, param_b)`` (``(ns, ps)`` for a binomial family), which
    decodes the same stream through the exact boundary tables."""
    kind, min_sym, max_sym, pa, pb = _quantized_args(init_states,
                                                     num_symbols, family, cfg)
    L = cfg.num_lanes
    T = -(-num_symbols // L)
    stream32 = _zero_padded(stream, T, L)
    out = np.empty(num_symbols, dtype=np.int32)
    native.library().ctpu_ilans2_decode_quantized(
        np.ascontiguousarray(init_states, dtype=np.uint32), stream32,
        len(stream32), num_symbols, L, T,
        native.DIST_KIND[kind], min_sym, max_sym, pa, pb, cfg.word_bits,
        cfg.state_bits, cfg.precision, out)
    return out


# ---------------------------------------------------------------------------
# ILANS2-R: the host range coder (numpy)
# ---------------------------------------------------------------------------


def _state_mask(S: int) -> np.uint64:
    return np.uint64((1 << S) - 1)


def encode_shared_range(cums, probs, cfg: LaneConfig):
    """Host ILANS2-R encoder over per-symbol (cum, prob) tables: L range
    coders sharing one word stream in decode-consumption order.  Returns
    ``(points, stream u32[num_words])``: u32 points for S <= 32, u64
    above.  The host codec's ``ctpu_ilans2_range_encode`` (per-lane
    Inverted-run bookkeeping), at any (W, S) with S <= 64.  JAX
    counterpart: ``constriction_tpu.ops.interleaved2.encode_shared_range``
    (the same C++); plain version :func:`encode_shared_range_plain`."""
    n = len(cums)
    if len(probs) != n:
        raise ValueError(
            f"cums and probs must have equal length, got {n} vs {len(probs)}"
        )
    L = cfg.num_lanes
    S = cfg.state_bits
    if S > 64:
        raise ValueError(f"the host range coder takes S <= 64, got {S}")
    T = -(-n // L) if n else 0
    wide = S > 32
    points = np.zeros(2 * L if wide else L, dtype=np.uint32)
    buf = np.zeros(max(T * L, 1), dtype=np.uint32)
    slen = native.library().ctpu_ilans2_range_encode(
        np.ascontiguousarray(cums, dtype=np.uint32),
        np.ascontiguousarray(probs, dtype=np.uint32),
        n, L, T, cfg.word_bits, S, cfg.precision, points, buf)
    return (_unpairs(points) if wide else points), buf[:slen].copy()


def encode_shared_range_plain(cums, probs, cfg: LaneConfig):
    """:func:`encode_shared_range` in numpy, at the two presets' (W, S) =
    (16, 32) and (32, 64), in the two-phase big-number form of
    ``pallas_range_enc.py``: a forward pass over steps, vectorised over
    lanes, records each step's provisional renorm word, renorm flag and
    carry (a wrap of the S-bit lower, i.e. +1 to the words already emitted);
    the seal (:func:`range_enc.seal32` / :func:`range_enc.seal64_limbs`)
    adds the last word and carry; a backward pass resolves the carries with
    a pending +1 per lane and places each lane's words through a 2-deep
    delay line (the r-th renorm carries the lane's word r + 2, words 0 and 1
    are the point).  Covers the two presets' (W, S) at any L and P."""
    n = len(cums)
    if len(probs) != n:
        raise ValueError(
            f"cums and probs must have equal length, got {n} vs {len(probs)}"
        )
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    if (W, S) not in ((16, 32), (32, 64)):
        raise ValueError(
            f"the host range encoder covers (W, S) = (16, 32) and (32, 64); "
            f"got ({W}, {S})"
        )
    T = -(-n // L) if n else 0
    mask = _state_mask(S)
    lower_bound = np.uint64(1 << (S - W))
    cums64 = np.zeros(T * L, dtype=np.uint64)
    probs64 = np.ones(T * L, dtype=np.uint64)
    cums64[:n] = cums
    probs64[:n] = probs
    lows = np.zeros(L, dtype=np.uint64)
    rngs = np.full(L, mask, dtype=np.uint64)
    words = np.zeros((T, L), dtype=np.uint32)
    renorm = np.zeros((T, L), dtype=bool)
    carries = np.zeros((T, L), dtype=bool)
    lanes = np.arange(L)
    for t in range(T):  # phase A
        idx = t * L + lanes
        active = idx < n
        scale = rngs >> np.uint64(P)
        add = scale * cums64[idx]
        new_lows = (lows + add) & mask
        carries[t] = active & (new_lows < add)
        lows = np.where(active, new_lows, lows)
        rngs = np.where(active, scale * probs64[idx], rngs)
        m = active & (rngs < lower_bound)
        renorm[t] = m
        words[t] = np.where(m, lows >> np.uint64(S - W), np.uint64(0))
        lows = np.where(m, (lows << np.uint64(W)) & mask, lows)
        rngs = np.where(m, rngs << np.uint64(W), rngs)

    from .range_enc import seal32, seal64_limbs

    if S == 32:
        s0, pend = seal32(np, lows, rngs, S, W)
    else:
        m32 = np.uint64(0xFFFFFFFF)
        s0, pend = seal64_limbs(np, lows >> np.uint64(32), lows & m32,
                                rngs >> np.uint64(32), rngs & m32)
    wmask = np.uint64(cfg.word_mask)
    d1, d2 = s0.astype(np.uint64), np.zeros(L, dtype=np.uint64)
    pend = pend.astype(np.uint64)
    chunks = []  # per-step placed words, t = T-1 .. 0
    for t in range(T - 1, -1, -1):  # phase B
        m = renorm[t]
        vfull = words[t].astype(np.uint64) + pend
        chunks.append(d2[m].astype(np.uint32))
        pend = np.where(m, vfull >> np.uint64(W), pend) + carries[t]
        d2 = np.where(m, d1, d2)
        d1 = np.where(m, vfull & wmask, d1)
    stream = (np.concatenate(chunks[::-1]) if chunks
              else np.zeros(0, dtype=np.uint32))
    points = (d1 << np.uint64(W)) | d2
    return points.astype(state_dtype(cfg)), stream


def _range_oracle_loop(pts, lows, rngs, stream, num_symbols, cdf64, cfg,
                       capture_interval=0):
    """Vectorised range-decode loop from an arbitrary (lows, rngs, pts)
    state (u64 arrays, updated in place).  With ``capture_interval`` > 0,
    snapshots (stream offset, lows, rngs, pts) before every
    ``capture_interval``-th step.  Returns ``(symbols, captures)``.  JAX
    counterpart: ``constriction_tpu.ops.interleaved2._range_oracle_loop``."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-num_symbols // L) if num_symbols else 0
    mask = _state_mask(S)
    lower_bound = np.uint64(1 << (S - W))
    base = 0
    out = np.empty(T * L, dtype=np.int32)
    lanes = np.arange(L)
    caps = []
    for t in range(T):
        if capture_interval > 0 and t > 0 and t % capture_interval == 0:
            caps.append((base, lows.copy(), rngs.copy(), pts.copy()))
        idx = t * L + lanes
        active = idx < num_symbols
        scale = rngs >> np.uint64(P)
        q = ((pts - lows) & mask) // scale
        bad = active & (q >= cdf64[-1])
        if bad.any():
            raise ValueError(
                "Tried to decode data that is inconsistent with the entropy "
                f"model (quantile >= 2**precision at symbol "
                f"{int(idx[bad][0])})."
            )
        q = np.where(active, q, np.uint64(0))
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        lows = np.where(active, (lows + scale * cum) & mask, lows)
        rngs = np.where(active, scale * prob, rngs)
        m = active & (rngs < lower_bound)
        k = int(m.sum())
        lows = np.where(m, (lows << np.uint64(W)) & mask, lows)
        rngs = np.where(m, rngs << np.uint64(W), rngs)
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base:base + k]
            words[:len(avail)] = avail
            pts[m] = ((pts[m] << np.uint64(W)) & mask) | words
            base += k
        out[idx] = sym
    return out[:num_symbols], caps


def _range_decode_args(points, cdf, cfg: LaneConfig) -> None:
    L = cfg.num_lanes
    if len(points) != L:
        raise ValueError(
            f"points must have num_lanes={L} entries, got {len(points)}"
        )
    _check_cdf(cdf, cfg.precision)


def decode_shared_range_cdf(points, stream, num_symbols: int, cdf,
                            cfg: LaneConfig):
    """Host ILANS2-R decoder with a CDF-table model; reads past the end of
    the stream give zero words; data inconsistent with the model raises
    ValueError.  The host codec's two-level CDF search
    (``ctpu_ilans2_range_decode_cdf_l1``) from :data:`NATIVE_MIN_SYMBOLS`
    symbols on at S <= 64, :func:`decode_shared_range_cdf_plain`
    otherwise.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.decode_shared_range_cdf``."""
    _range_decode_args(points, cdf, cfg)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    if num_symbols < NATIVE_MIN_SYMBOLS or S > 64:
        return decode_shared_range_cdf_plain(points, stream, num_symbols,
                                             cdf, cfg)
    T = -(-num_symbols // L)
    cdf32 = np.ascontiguousarray(np.asarray(cdf), dtype=np.uint32)
    l1_bits = min(P, L1_BITS)
    stream32 = np.ascontiguousarray(stream, dtype=np.uint32)
    out = np.empty(num_symbols, dtype=np.int32)
    bad = native.library().ctpu_ilans2_range_decode_cdf_l1(
        _pairs(points), stream32, len(stream32), num_symbols, L, T, cdf32,
        len(cdf32), _l1_table(cdf32.tobytes(), P, l1_bits), l1_bits, W, S,
        P, out)
    if bad >= 0:
        raise ValueError(
            "Tried to decode data that is inconsistent with the entropy "
            f"model (quantile >= 2**precision at symbol {bad}).")
    return out


def decode_shared_range_cdf_plain(points, stream, num_symbols: int, cdf,
                                  cfg: LaneConfig):
    """:func:`decode_shared_range_cdf` in numpy.  JAX counterpart: the
    numpy branch of
    ``constriction_tpu.ops.interleaved2.decode_shared_range_cdf``."""
    _range_decode_args(points, cdf, cfg)
    L = cfg.num_lanes
    out, _ = _range_oracle_loop(
        np.asarray(points).astype(np.uint64), np.zeros(L, np.uint64),
        np.full(L, _state_mask(cfg.state_bits), np.uint64),
        np.asarray(stream), num_symbols, np.asarray(cdf, dtype=np.uint64), cfg,
    )
    return out


def build_checkpoints_range(points, stream, num_symbols: int, cdf,
                            cfg: LaneConfig, interval: int):
    """Decode once (host oracle), capturing the full decoder state (stream
    offset, lows, ranges, points) every ``interval`` steps.  Snapshot c
    resumes decoding at symbol ``(c + 1) * interval * L`` through
    :func:`decode_range_from_checkpoint`.  Returns ``(offsets i64[C], lows
    [C, L], rngs [C, L], pts [C, L])`` (u32 planes for S=32, u64 for S=64)
    with ``C = ceil(T / interval) - 1``.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.build_checkpoints_range``."""
    if interval <= 0:
        raise ValueError(f"interval must be positive, got {interval}")
    L = cfg.num_lanes
    T = -(-num_symbols // L) if num_symbols else 0
    C = max(-(-T // interval) - 1, 0)
    dt = state_dtype(cfg)
    offsets = np.zeros(C, dtype=np.int64)
    lows_out = np.zeros((C, L), dtype=dt)
    rngs_out = np.zeros((C, L), dtype=dt)
    pts_out = np.zeros((C, L), dtype=dt)
    if C == 0:
        return offsets, lows_out, rngs_out, pts_out
    _, caps = _range_oracle_loop(
        np.asarray(points).astype(np.uint64), np.zeros(L, np.uint64),
        np.full(L, _state_mask(cfg.state_bits), np.uint64),
        np.asarray(stream), num_symbols, np.asarray(cdf, dtype=np.uint64),
        cfg, capture_interval=interval,
    )
    for c, (base, lo, rn, pt) in enumerate(caps):
        offsets[c] = base
        lows_out[c] = lo.astype(dt)
        rngs_out[c] = rn.astype(dt)
        pts_out[c] = pt.astype(dt)
    return offsets, lows_out, rngs_out, pts_out


# ---------------------------------------------------------------------------
# word packing and the v1 container
# ---------------------------------------------------------------------------


def pack_words(stream, word_bits: int) -> np.ndarray:
    """W-bit words (one per u32 element) -> dense u32 payload, little-endian
    within each u32.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.pack_words``."""
    stream = np.asarray(stream, dtype=np.uint32)
    if word_bits == 32:
        return stream.copy()
    per = 32 // word_bits
    pad = (-len(stream)) % per
    if pad:
        stream = np.concatenate([stream, np.zeros(pad, np.uint32)])
    out = stream[0::per].copy()
    for k in range(1, per):
        out |= stream[k::per] << np.uint32(word_bits * k)
    return out


def unpack_words(payload, word_bits: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_words`; ``count`` W-bit words.  JAX
    counterpart: ``constriction_tpu.ops.interleaved2.unpack_words``."""
    payload = np.asarray(payload, dtype=np.uint32)
    if word_bits == 32:
        return payload[:count]
    per = 32 // word_bits
    mask = np.uint32((1 << word_bits) - 1)
    out = np.empty(len(payload) * per, dtype=np.uint32)
    for k in range(per):
        out[k::per] = (payload >> np.uint32(word_bits * k)) & mask
    return out[:count]


def pack_container2(init_states, stream, num_symbols: int,
                    cfg: LaneConfig) -> np.ndarray:
    """Lane states and stream -> v1 container (u32).  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.pack_container2``."""
    if cfg.word_bits not in (8, 16, 32):
        raise ValueError(f"unsupported word size {cfg.word_bits}")
    header = np.array([
        MAGIC2, 1,
        cfg.word_bits | (cfg.precision << 8) | (cfg.state_bits << 16),
        num_symbols & 0xFFFFFFFF, (num_symbols >> 32) & 0xFFFFFFFF,
        cfg.num_lanes, len(stream),
    ], dtype=np.uint32)
    if cfg.state_bits > 32:
        st = np.asarray(init_states, dtype=np.uint64)
        states_words = np.concatenate([
            (st & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (st >> np.uint64(32)).astype(np.uint32),
        ])
    else:
        states_words = np.asarray(init_states).astype(np.uint32)
    return np.concatenate(
        [header, states_words, pack_words(stream, cfg.word_bits)]
    )


def unpack_container2(data):
    """v1 container -> ``(initial states, stream, num_symbols, cfg)``.  JAX
    counterpart: ``constriction_tpu.ops.interleaved2.unpack_container2``."""
    data = np.asarray(data, dtype=np.uint32)
    if int(data[0]) != MAGIC2 or int(data[1]) != 1:
        raise ValueError("not an ILANS2 container")
    flags = int(data[2])
    word_bits = flags & 0xFF
    precision = (flags >> 8) & 0xFF
    state_bits = (flags >> 16) & 0xFF
    num_symbols = int(data[3]) | (int(data[4]) << 32)
    L = int(data[5])
    stream_len = int(data[6])
    cfg = LaneConfig(L, word_bits, state_bits, precision)
    if state_bits > 32:
        init_states = (
            data[7:7 + L].astype(np.uint64)
            | (data[7 + L:7 + 2 * L].astype(np.uint64) << np.uint64(32))
        )
        payload = data[7 + 2 * L:]
    else:
        init_states = data[7:7 + L]
        payload = data[7 + L:]
    if word_bits not in (8, 16, 32):
        raise ValueError(f"unsupported word size {word_bits}")
    stream = unpack_words(payload, word_bits, stream_len)
    return init_states, stream, num_symbols, cfg


# ---------------------------------------------------------------------------
# lane coding on the port's coder
# ---------------------------------------------------------------------------


def launch_encode(symbols, cdf, cfg: LaneConfig, seeds=None):
    """The port's rANS encode at ``cfg``'s preset as a launch form, on
    tensors on one device: ``(states, buf, end)``, the stream ``buf[end:]``
    (``coder.launch_encode_iid`` / ``coder64.launch_encode_iid64``).
    Nothing is read back: the seeds' range is the caller's to check
    (:func:`check_seeds`)."""
    launch = (coder64.launch_encode_iid64 if cfg.state_bits == 64
              else coder.launch_encode_iid)
    return launch(symbols, cdf, cfg, seeds)


def launch_decode(states, stream, cdf, cfg: LaneConfig, n: int):
    """The port's rANS decode at ``cfg``'s preset on tensors on one device:
    ``(symbols int32[n], final states)``.  It reads nothing back (the
    decode has no flag), so the decode itself is its launch form."""
    decode = (coder64.decode_shared64 if cfg.state_bits == 64
              else coder.decode_shared)
    return decode(states, stream, cdf, cfg, n, return_final_states=True)


def launch_encode_range(symbols, cdf, cfg: LaneConfig):
    """The port's range encode at ``cfg``'s preset as a launch form:
    ``(points, buf, end)`` (``range_enc.launch_encode``); the symbols'
    range is the caller's to check."""
    from . import range_enc

    return range_enc.launch_encode(symbols, cdf, cfg)


def launch_decode_range(points, stream, cdf, cfg: LaneConfig, n: int,
                        lows=None, rngs=None):
    """The port's range decode at ``cfg``'s preset as a launch form:
    ``(symbols int32[n], flag int64[1])``
    (``coder.launch_decode_shared_range`` /
    ``coder64.launch_decode_shared_range64``)."""
    launch = (coder64.launch_decode_shared_range64 if cfg.state_bits == 64
              else coder.launch_decode_shared_range)
    return launch(points, stream, cdf, cfg, n, lows, rngs)


def _host_states(states: np.ndarray, cfg: LaneConfig) -> np.ndarray:
    """int32 / int64 bit patterns read back -> u32 / u64 states."""
    return states.view(state_dtype(cfg))


def finish_encodes(launched: list, cfg: LaneConfig) -> list:
    """Encodes launched on one device (:func:`launch_encode` /
    :func:`launch_encode_range` results, in order) read back in two
    transfers (``convert.read_back``): ``[(states or points, stream)]``
    numpy, as :func:`encode_shared` / :func:`encode_shared_range` give
    them."""
    got = convert.read_back([x for st, buf, end in launched
                             for x in (st, (buf, end))])
    return [(_host_states(st, cfg), w.view(np.uint32))
            for st, w in zip(got[::2], got[1::2])]


def finish_decodes(launched: list, cfg: LaneConfig) -> list:
    """rANS decodes launched on one device (:func:`launch_decode` results)
    read back in one transfer: ``[(symbols int32, final states)]``."""
    got = convert.read_back([x for pair in launched for x in pair])
    return [(syms, _host_states(fin, cfg))
            for syms, fin in zip(got[::2], got[1::2])]


def finish_range_decodes(launched: list) -> list:
    """Range decodes launched on one device (:func:`launch_decode_range`
    results) read back in one transfer: ``[(symbols int32, flag)]``, the
    flag the first symbol whose quantile was >= 2^P, or the symbol count
    (:func:`range_symbols` raises on it)."""
    got = convert.read_back([x for pair in launched for x in pair])
    return [(syms, int(bad[0])) for syms, bad in zip(got[::2], got[1::2])]


def range_symbols(decoded: list) -> list:
    """The symbols of finished range decodes (:func:`finish_range_decodes`,
    in block order); the first block whose flag names a symbol raises the
    host oracle's ValueError."""
    for syms, bad in decoded:
        coder._raise_if_invalid(bad, len(syms))
    return [syms for syms, _ in decoded]


def encode_lanes(symbols, cdf, cfg: LaneConfig, device, seeds=None):
    """Code numpy symbols on ``device`` with the port's coder; returns
    numpy ``(states, stream)`` as :func:`encode_shared` does (u64 states
    for S=64, u32 otherwise): one upload, the launch form, one finish.
    JAX counterpart: ``pallas_coder.encode_iid_pallas`` /
    ``pallas_coder64.encode_iid64_pallas``."""
    inputs = [torch.from_numpy(np.ascontiguousarray(symbols, dtype=np.int32)),
              convert.cdf_to_torch(cdf)]
    if seeds is not None:
        inputs.append(convert.states_to_torch(check_seeds(seeds, cfg), cfg))
    syms, cdf_t, *seeds_t = convert.upload(inputs, torch.device(device))
    return finish_encodes([launch_encode(syms, cdf_t, cfg, *seeds_t)],
                          cfg)[0]


def decode_lanes(states, stream, n: int, cdf, cfg: LaneConfig, device):
    """Decode with the port's coder on ``device``; returns numpy
    ``(symbols int32[n], final states)``.  JAX counterpart:
    ``pallas_coder.decode_shared_pallas`` /
    ``pallas_coder64.decode_shared64_pallas`` with
    ``return_final_states=True``."""
    st, sw, cdf_t = convert.upload(
        [convert.states_to_torch(states, cfg), convert.u32_to_torch(stream),
         convert.cdf_to_torch(cdf)], torch.device(device))
    return finish_decodes([launch_decode(st, sw, cdf_t, cfg, n)], cfg)[0]


def check_precision(cfg: LaneConfig) -> None:
    """The i.i.d. encoders' config check: the reference asserts PRECISION
    <= Word::BITS statically, and a config with P > W writes containers
    that may decode to wrong symbols.  ``LaneConfig`` (a copy of the JAX
    package's) checks S >= W + P only; the JAX package's i.i.d. encoders
    accept P > W, the port's raise.  Wording as ``ops/ans.py``'s
    ``_check_precision``."""
    if cfg.precision > cfg.word_bits:
        raise ValueError(
            f"model precision {cfg.precision} is incompatible with this "
            f"coder (word_bits={cfg.word_bits}, state_bits="
            f"{cfg.state_bits}): needs precision <= word_bits and "
            "state_bits >= word_bits + precision")


def encode_iid_categorical2(symbols, cdf, cfg: LaneConfig,
                            device="cuda") -> np.ndarray:
    """Encode i.i.d. categorical symbols into a v1 ILANS2 container (u32).
    JAX counterpart: ``constriction_tpu.ops.interleaved2.
    encode_iid_categorical2(..., device=True)``; unlike it, a config with
    P > W raises ValueError (:func:`check_precision`)."""
    check_precision(cfg)
    symbols = np.asarray(symbols, dtype=np.int64)
    if kernel_eligible(cfg):
        states, stream = encode_lanes(symbols, cdf, cfg, device)
    else:
        cdf64 = np.asarray(cdf, dtype=np.uint64)
        cums = cdf64[symbols]
        states, stream = encode_shared(cums, cdf64[symbols + 1] - cums, cfg)
    return pack_container2(states, stream, len(symbols), cfg)


def decode_iid_categorical2(data, cdf, device="cuda") -> np.ndarray:
    """Decode a v1 ILANS2 container.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.decode_iid_categorical2(...,
    device=True)``."""
    init_states, stream, n, cfg = unpack_container2(data)
    if kernel_eligible(cfg):
        return decode_lanes(init_states, stream, n, cdf, cfg, device)[0]
    return decode_shared_cdf(init_states, stream, n, cdf, cfg)


# ---------------------------------------------------------------------------
# random access: periodic decoder checkpoints
# ---------------------------------------------------------------------------


def _ckpt_args(num_symbols: int, cfg: LaneConfig, interval: int):
    if interval <= 0:
        raise ValueError(f"interval must be positive, got {interval}")
    L = cfg.num_lanes
    T = -(-num_symbols // L) if num_symbols else 0
    C = max(-(-T // interval) - 1, 0)
    return (T, np.zeros(C, dtype=np.int64),
            np.zeros((C, L), dtype=state_dtype(cfg)))


def build_checkpoints(init_states, stream, num_symbols: int, cdf,
                      cfg: LaneConfig, interval: int):
    """Decode once on the host, capturing a (stream offset, lane states)
    snapshot every ``interval`` steps: see :func:`build_checkpoints_plain`.
    The host codec's ``ctpu_ilans2_decode_ckpt`` at S <= 32 and P <= 20,
    the plain version otherwise.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.build_checkpoints``."""
    T, offsets, states_out = _ckpt_args(num_symbols, cfg, interval)
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    if not (S <= 32 and P <= 20):
        return build_checkpoints_plain(init_states, stream, num_symbols, cdf,
                                       cfg, interval)
    if len(offsets) == 0:
        return offsets, states_out
    _decode_args(init_states, cdf, cfg)
    cdf32 = np.ascontiguousarray(np.asarray(cdf), dtype=np.uint32)
    stream32 = _zero_padded(stream, T, cfg.num_lanes)
    native.library().ctpu_ilans2_decode_ckpt(
        np.ascontiguousarray(init_states, dtype=np.uint32), stream32,
        len(stream32), num_symbols, cfg.num_lanes, T,
        _lookup_table(cdf32.tobytes(), P), cdf32, W, S, P,
        np.empty(num_symbols, dtype=np.int32), interval, offsets,
        states_out.reshape(-1))
    return offsets, states_out


def build_checkpoints_plain(init_states, stream, num_symbols: int, cdf,
                            cfg: LaneConfig, interval: int):
    """Decode once on the host, capturing a (stream offset, lane states)
    snapshot every ``interval`` steps.  Snapshot c is a complete coder
    state for symbol ``(c + 1) * interval * L`` on: a decoder seeded with
    ``(states[c], stream[offsets[c]:])`` decodes the suffix without touching
    the prefix (:func:`decode_from_checkpoint`).  Returns ``(offsets
    i64[C], states [C, L])``, u64 states for S > 32 and u32 otherwise, with
    ``C = ceil(T / interval) - 1`` (the snapshot at step 0 is the container
    header itself).  JAX counterpart: the numpy branch of
    ``constriction_tpu.ops.interleaved2.build_checkpoints``."""
    T, offsets, states_out = _ckpt_args(num_symbols, cfg, interval)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    if len(offsets) == 0:
        return offsets, states_out
    states = np.asarray(init_states).astype(np.uint64)
    stream = np.asarray(stream)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    base = 0
    lanes = np.arange(L)
    lower = np.uint64(1 << (S - W))
    c = 0
    for t in range(T):
        if t > 0 and t % interval == 0:
            offsets[c] = base
            states_out[c] = states.astype(states_out.dtype)
            c += 1
        active = t * L + lanes < num_symbols
        q = states & np.uint64((1 << P) - 1)
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        states = np.where(active, (states >> np.uint64(P)) * prob + (q - cum),
                          states)
        m = states < lower
        k = int(m.sum())
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base:base + k]
            words[:len(avail)] = avail
            states[m] = (states[m] << np.uint64(W)) | words
            base += k
    return offsets, states_out


def decode_from_checkpoint(ckpt_index: int, offsets, ckpt_states, stream,
                           num_symbols: int, cdf, cfg: LaneConfig,
                           interval: int, device="cuda"):
    """Decode the message suffix that starts at checkpoint ``ckpt_index``
    of :func:`build_checkpoints` (symbol ``(ckpt_index + 1) * interval *
    L``).  Returns ``(start_symbol, suffix_symbols)``, equal to that slice
    of a full decode.  A checkpoint is an ordinary (states, stream suffix)
    pair: configs the kernels take decode it on the port's coder on
    ``device``, the others on the host decoder.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.decode_from_checkpoint(...,
    device=True)``."""
    L = cfg.num_lanes
    start = (ckpt_index + 1) * interval * L
    remaining = num_symbols - start
    if remaining <= 0:
        return start, np.zeros(0, dtype=np.int64)
    sub_stream = np.asarray(stream)[int(offsets[ckpt_index]):]
    if kernel_eligible(cfg):
        return start, decode_lanes(ckpt_states[ckpt_index], sub_stream,
                                   remaining, cdf, cfg, device)[0]
    return start, decode_shared_cdf(ckpt_states[ckpt_index], sub_stream,
                                    remaining, cdf, cfg)


# ---------------------------------------------------------------------------
# ILANS2-R lane coding on the port's coder
# ---------------------------------------------------------------------------


def encode_range_lanes(symbols, cdf, cfg: LaneConfig, device):
    """Range-code numpy symbols on ``device`` with the port's coder;
    returns numpy ``(points, stream)`` as :func:`encode_shared_range` does.
    Symbols outside [0, K) raise ValueError.  JAX counterpart:
    ``pallas_range_enc.encode_iid_range_pallas`` /
    ``encode_iid_range64_pallas``."""
    from ..cuda import _check_symbols

    symbols = np.ascontiguousarray(symbols, dtype=np.int32)
    _check_symbols(symbols, cdf)
    syms, cdf_t = convert.upload(
        [torch.from_numpy(symbols), convert.cdf_to_torch(cdf)],
        torch.device(device))
    return finish_encodes([launch_encode_range(syms, cdf_t, cfg)], cfg)[0]


def decode_range_lanes(points, stream, n: int, cdf, cfg: LaneConfig, device,
                       lows=None, rngs=None) -> np.ndarray:
    """Range-decode with the port's coder on ``device``, from the initial
    points or from a checkpoint's (lows, rngs, points) planes; returns numpy
    symbols int32[n].  JAX counterpart:
    ``pallas_coder.decode_shared_range_pallas`` /
    ``pallas_coder64.decode_shared_range64_pallas`` (``seeded=True`` with
    planes)."""
    inputs = [convert.states_to_torch(points, cfg),
              convert.u32_to_torch(stream), convert.cdf_to_torch(cdf)]
    if lows is not None:
        inputs += convert.planes_to_torch((lows, rngs), cfg)
    pt, sw, cdf_t, *planes = convert.upload(inputs, torch.device(device))
    return range_symbols(finish_range_decodes(
        [launch_decode_range(pt, sw, cdf_t, cfg, n, *planes)]))[0]


def encode_iid_categorical_range(symbols, cdf, cfg: LaneConfig,
                                 device="cuda"):
    """Range-code i.i.d. categorical symbols; returns ``(points, stream)``.
    Configs the kernels take run on the port's coder on ``device``; the
    others on the host encoder, as the JAX package does.  JAX counterpart:
    ``constriction_tpu.ops.interleaved2.encode_iid_categorical_range(...,
    device=True)``."""
    symbols = np.asarray(symbols, dtype=np.int64)
    if kernel_eligible(cfg):
        return encode_range_lanes(symbols, cdf, cfg, device)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    cums = cdf64[symbols]
    return encode_shared_range(cums, cdf64[symbols + 1] - cums, cfg)


def decode_range_from_checkpoint(ckpt_index: int, offsets, lows, rngs, pts,
                                 stream, num_symbols: int, cdf,
                                 cfg: LaneConfig, interval: int,
                                 device="cuda"):
    """Decode a range stream's suffix from checkpoint ``ckpt_index`` of
    :func:`build_checkpoints_range`; returns ``(start_symbol,
    suffix_symbols)``, equal to that slice of a full decode.  Configs the
    kernels take resume on the port's coder on ``device`` (the decoder
    seeded with the checkpoint's planes); the others on the host decoder.
    JAX counterpart:
    ``constriction_tpu.ops.interleaved2.decode_range_from_checkpoint(...,
    device=True)``."""
    L = cfg.num_lanes
    start = (ckpt_index + 1) * interval * L
    remaining = num_symbols - start
    if remaining <= 0:
        return start, np.zeros(0, dtype=np.int64)
    sub_stream = np.asarray(stream)[int(offsets[ckpt_index]):]
    lo = np.asarray(lows[ckpt_index], np.uint64)
    rn = np.asarray(rngs[ckpt_index], np.uint64)
    pt = np.asarray(pts[ckpt_index], np.uint64)
    if kernel_eligible(cfg):
        return start, decode_range_lanes(pt, sub_stream, remaining, cdf, cfg,
                                         device, lows=lo, rngs=rn)
    out, _ = _range_oracle_loop(pt.copy(), lo.copy(), rn.copy(), sub_stream,
                                remaining, np.asarray(cdf, dtype=np.uint64),
                                cfg)
    return start, out
