"""TChain bits-back coding on the GPU: TChain-16 and TChain-24 under one
categorical model, TChain-12 under per-symbol continuous families (neural
bits-back).

The counterpart of ``constriction_tpu/ops/tchain.py``.  A decoder reads
quantiles as if they were compressed data: each lane finds the symbol whose
interval holds its quantile, and what the quantile carried beyond the
symbol goes into the lane's remainder head, ``head = head * prob + (q -
cum)``; a head at or above 2^(S-P) flushes its low W bits into a shared
word stream (step chunks right to left, lanes ascending within a step).
The encoder runs the steps backward, refills a head below ``prob <<
(S-W-P)`` from the stream (reads past its end give zero words) and recovers
``q = cum + head % prob`` exactly; after a full reverse every head is back
at its seed.  Symbol i belongs to lane i mod L; a message is T full steps of
L lanes.  The presets:

- TChain-16: W=16, S=32, P=16, heads seeded at 1; 16-bit quantiles in
  planar u32 words (:func:`pack_quantiles`), L a multiple of 256;
- TChain-24 (the reference's default precision): W=32, S=64, P=24, u64
  heads seeded at 2^8; one 24-bit quantile per u32 word, L a multiple of
  128;
- TChain-12: W=16, S=32, P=12, heads seeded at 16, the model of each
  symbol inverted in-kernel (``family.invert_family``); 12-bit quantiles
  packed by :func:`pack_q12`, L a multiple of 1024.

Every decode's lanes meet only where their flushed words land, so on the
card each runs over the whole grid: a head pass of one thread per lane
(TChain-16 and TChain-24: each lane searches its quantiles and runs its
head; TChain-12: after an inversion pass of one thread per symbol) and
the compaction, each step with a plain twin here.  Every encode's refills
couple its lanes, so it runs on a cluster of up to 16 CTAs (the rANS
decodes' step), which caps its num_lanes on a card at
``coder.MAX_DECODE_LANES``; TChain-12's evaluates its models first, in a
tables pass of one thread per symbol with a plain twin here.

The wrappers launch the hand-written kernels of ``csrc/tchain.cu`` for CUDA
tensors and run the plain PyTorch twins for CPU tensors; any other device
raises.

Tensor layout: quantiles travel as int32 tensors of u32 words (TChain-16:
the planar words, T * L/2 of them; TChain-24: one per quantile; TChain-12:
the words of :func:`pack_q12`, T * 3L/8); symbols int32[T * L]; stream
words and TChain-12/16 heads int32 holding u32 bits; TChain-24 heads int64
holding u64 bits; CDFs int64[K+1]; means and scales float32[T * L].
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from . import _build
from . import family as fam
from .coder import (MAX_DECODE_LANES, _check, _check_cdf_arg, _emit_words,
                    _find_symbols, _on_cuda, _records, _refill_words,
                    compaction_scratch, flag_ballots, trim)
from .interleaved import LaneConfig

TCHAIN_CFG = LaneConfig(num_lanes=32768, word_bits=16, state_bits=32,
                        precision=16)
TCHAIN24_CFG = LaneConfig(num_lanes=32768, word_bits=32, state_bits=64,
                          precision=24)
TCHAIN12_CFG = LaneConfig(num_lanes=32768, word_bits=16, state_bits=32,
                          precision=12)

# kernel launches made by this module's wrappers (never by the twins)
LAUNCHES = {"decode16": 0, "encode16": 0, "decode24": 0, "encode24": 0,
            "decode12_family": 0, "encode12_family": 0,
            "invert12_family": 0, "heads12_family": 0,
            "tables12_family": 0, "heads16": 0, "heads24": 0}

_M12 = 0xFFF
_M16 = 0xFFFF
_M24 = 0xFFFFFF
_M32 = 0xFFFFFFFF
_SEED = 1 << 4  # 2^(S-W-P)
_FLUSH_AT = 1 << 20  # 2^(S-P)


# ---------------------------------------------------------------------------
# 12-bit quantile packing, row-planar: within a step, symbol rows
# [8k, 8k+8) of the [R, 128] lane grid live in word rows [3k, 3k+3)
# ---------------------------------------------------------------------------


def pack_q12(q, L: int) -> np.ndarray:
    """[T*L] 12-bit quantiles -> [T, 3R/8, 128] u32 planar words (R = L /
    128).  JAX counterpart: ``tchain.pack_q12``."""
    if L % 1024:
        raise ValueError(
            f"num_lanes must be a multiple of 1024 for 12-bit packing, got "
            f"{L}")
    q = np.asarray(q)
    T = len(q) // L
    words = _pack_q12_block(
        np, q.astype(np.uint32).reshape(T * L // 128, 128))
    return words.reshape(T, 3 * (L // 1024), 128)


def unpack_q12(w, xp=np):
    """[T, 3R/8, 128] words -> [T, R, 128] quantile values.  ``xp`` is
    numpy (u32 arrays) or torch (int64 tensors of u32 values).  JAX
    counterpart: ``tchain.unpack_q12``."""
    T, rows, _ = w.shape
    return _unpack_q12_block(xp, w.reshape(T * rows, 128)).reshape(
        T, rows // 3 * 8, 128)


def _unpack_q12_block(xp, wblk):
    """[3R/8, 128] words -> [R, 128] quantiles.  JAX counterpart:
    ``tchain._unpack_q12_block``."""
    g = wblk.reshape(wblk.shape[0] // 3, 3, 128)
    w0, w1, w2 = g[:, 0], g[:, 1], g[:, 2]
    q = xp.stack([
        w0 & _M12,
        (w0 >> 12) & _M12,
        (w0 >> 24) | ((w1 & 0xF) << 8),
        (w1 >> 4) & _M12,
        (w1 >> 16) & _M12,
        (w1 >> 28) | ((w2 & 0xFF) << 4),
        (w2 >> 8) & _M12,
        w2 >> 20,
    ], 1)  # [R/8, 8, 128]
    return q.reshape(8 * g.shape[0], 128)


def _pack_q12_block(xp, q):
    """[R, 128] quantiles -> [3R/8, 128] words (same types as
    :func:`unpack_q12`).  JAX counterpart: ``tchain._pack_q12_block``."""
    g = q.reshape(q.shape[0] // 8, 8, 128)
    q0, q1, q2, q3, q4, q5, q6, q7 = (g[:, i] for i in range(8))
    w0 = q0 | (q1 << 12) | (q2 << 24)
    w1 = (q2 >> 8) | (q3 << 4) | (q4 << 16) | (q5 << 28)
    w2 = (q5 >> 4) | (q6 << 8) | (q7 << 20)
    return (xp.stack([w0, w1, w2], 1) & _M32).reshape(3 * g.shape[0], 128)


# ---------------------------------------------------------------------------
# host oracles (numpy)
# ---------------------------------------------------------------------------


def _check_chain(cfg: LaneConfig, family: str, min_sym: int, max_sym: int,
                 n: int) -> int:
    """Checks the config, the support and the message length of a host
    oracle's call (any lane count: nothing is packed); returns T."""
    fam.check_model(cfg, family, min_sym, max_sym, lane_multiple=1)
    if n % cfg.num_lanes:
        raise ValueError(
            f"the message length must be a multiple of num_lanes="
            f"{cfg.num_lanes}, got {n}")
    return n // cfg.num_lanes


def tchain12_family_decode_host(quantiles, means, scales, family: str,
                                min_sym: int, max_sym: int,
                                cfg: LaneConfig = TCHAIN12_CFG):
    """Numpy oracle: bits-back decode with per-symbol (mean, scale) models
    at P=12.  Returns ``(symbols int32[n], stream u32, heads u32[L])``.
    JAX counterpart: ``tchain.tchain12_family_decode_host``."""
    L, W = cfg.num_lanes, cfg.word_bits
    n = len(quantiles)
    T = _check_chain(cfg, family, min_sym, max_sym, n)
    quantiles = np.asarray(quantiles)
    means = np.asarray(means, dtype=np.float32)
    scales = np.asarray(scales, dtype=np.float32)
    heads = np.full(L, _SEED, dtype=np.uint64)
    out = np.empty(n, dtype=np.int32)
    chunks = []
    lanes = np.arange(L)
    for t in range(T):
        idx = t * L + lanes
        q = quantiles[idx].astype(np.int32)
        sym, cum, prob = fam.invert_family(
            np, family, min_sym, max_sym, q, means[idx],
            np.float32(1.0) / scales[idx])
        heads = heads * prob.astype(np.uint64) + (
            q.astype(np.uint64) - cum.astype(np.uint64))
        m = heads >= np.uint64(_FLUSH_AT)
        chunks.append((heads[m] & np.uint64(0xFFFF)).astype(np.uint32))
        heads = np.where(m, heads >> np.uint64(W), heads)
        out[idx] = sym
    stream = np.concatenate(chunks[::-1]) if chunks else np.zeros(0, np.uint32)
    return out, stream, heads.astype(np.uint32)


def tchain12_family_encode_host(symbols, remainders, heads, means, scales,
                                family: str, min_sym: int, max_sym: int,
                                cfg: LaneConfig = TCHAIN12_CFG):
    """Numpy oracle of the reverse pass: ``(quantiles u16[n], heads
    u32[L])``; reads past the end of ``remainders`` give zero words.  JAX
    counterpart: ``tchain.tchain12_family_encode_host``."""
    L, S, W, P = cfg.num_lanes, cfg.state_bits, cfg.word_bits, cfg.precision
    n = len(symbols)
    T = _check_chain(cfg, family, min_sym, max_sym, n)
    symbols = np.asarray(symbols)
    remainders = np.asarray(remainders)
    means = np.asarray(means, dtype=np.float32)
    scales = np.asarray(scales, dtype=np.float32)
    h = np.asarray(heads).astype(np.uint64)
    q_out = np.empty(n, dtype=np.uint16)
    base = 0
    lanes = np.arange(L)
    for t in range(T - 1, -1, -1):
        idx = t * L + lanes
        cum, prob = fam.tables(
            np, family, min_sym, max_sym, symbols[idx].astype(np.int32),
            means[idx], np.float32(1.0) / scales[idx])
        cum, prob = cum.astype(np.uint64), prob.astype(np.uint64)
        m = h < (prob << np.uint64(S - W - P))
        k = int(m.sum())
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = remainders[base:base + k]
            words[:len(avail)] = avail
            h[m] = (h[m] << np.uint64(W)) | words
            base += k
        q_out[idx] = (cum + h % prob).astype(np.uint16)
        h = h // prob
    return q_out, h.astype(np.uint32)


# ---------------------------------------------------------------------------
# the coders
# ---------------------------------------------------------------------------


def _step_words(L: int) -> int:
    return 3 * L // 8


def _chain_args(first, name: str, cfg: LaneConfig, family: str,
                min_sym: int, max_sym: int, step: int) -> int:
    """Checks the leading tensor, the config and the support; returns T,
    the tensor holding ``step`` entries per coding step."""
    if not isinstance(first, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    _check(name, first, torch.int32, first.device)
    fam.check_model(cfg, family, min_sym, max_sym, 1024)
    if first.numel() % step:
        raise ValueError(
            f"{name} must hold whole steps of {step} entries (num_lanes="
            f"{cfg.num_lanes}), got {first.numel()}")
    return first.numel() // step


def tchain12_family_decode(qw, means, scales, family: str, min_sym: int,
                           max_sym: int, cfg: LaneConfig = TCHAIN12_CFG):
    """Bits-back decode of packed 12-bit quantiles under per-symbol
    models.  JAX counterpart: ``tchain.tchain12_family_decode_pallas``.

    ``qw`` int32[T * 3L/8] (:func:`pack_q12` words, flattened), ``means``
    and ``scales`` float32[T * L], on one device.  Returns ``(symbols
    int32[T * L], stream int32[num_words], heads int32[L])``.  CUDA
    tensors launch the decode's three steps over the whole grid
    (``csrc/tchain.cu``): (a) the inversion, one thread per symbol
    (:func:`tchain12_invert_pass`), (b) the heads, one thread per lane
    (:func:`tchain12_head_pass`), and the row-major compaction of the
    flushed words (``coder.compact_pass``; five launches, one C call).
    CPU tensors run :func:`tchain12_family_decode_plain`, which equals the
    composition of the three plain steps."""
    L = cfg.num_lanes
    T = _chain_args(qw, "qw", cfg, family, min_sym, max_sym,
                    _step_words(L))
    device = qw.device
    fam.check_params(means, scales, T * L, device)
    if not _on_cuda(device):
        return tchain12_family_decode_plain(qw, means, scales, family,
                                            min_sym, max_sym, cfg)
    n = T * L
    heads = torch.full((L,), _SEED, dtype=torch.int32, device=device)
    syms = torch.empty(n, dtype=torch.int32, device=device)
    if T == 0:
        return syms, torch.zeros(0, dtype=torch.int32, device=device), heads
    buf = torch.empty(n, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int64, device=device)
    # the passes' scratch: records, dense words, ballots, block offsets
    recs = torch.empty(n, dtype=torch.int32, device=device)
    _build.call("ctt_tchain12_family_decode", device, heads, qw, means,
                scales, syms, buf, n, end, recs,
                *compaction_scratch(T, L, device), L, T,
                fam.FAMILIES.index(family), min_sym, max_sym)
    LAUNCHES["decode12_family"] += 1
    return syms, buf[int(end.item()):], heads


def tchain12_invert_pass(qw, means, scales, family: str, min_sym: int,
                         max_sym: int, cfg: LaneConfig = TCHAIN12_CFG):
    """Step (a) of :func:`tchain12_family_decode` alone (its arguments and
    checks): ``(symbols int32[T * L], records int32[T * L])``, a record
    being ``(q - cum) | prob << 16``.  CUDA tensors launch the inversion
    kernel (``csrc/tchain.cu``, ``tchain12_invert_kernel``), CPU tensors
    run :func:`tchain12_invert_pass_plain`."""
    L = cfg.num_lanes
    T = _chain_args(qw, "qw", cfg, family, min_sym, max_sym,
                    _step_words(L))
    device = qw.device
    fam.check_params(means, scales, T * L, device)
    if not _on_cuda(device):
        return tchain12_invert_pass_plain(qw, means, scales, family, min_sym,
                                          max_sym, cfg)
    syms = torch.empty(T * L, dtype=torch.int32, device=device)
    recs = torch.empty(T * L, dtype=torch.int32, device=device)
    if T:
        _build.call("ctt_tchain12_invert_pass", device, qw, means, scales,
                    syms, recs, L, T, fam.FAMILIES.index(family), min_sym,
                    max_sym)
        LAUNCHES["invert12_family"] += 1
    return syms, recs


def tchain12_invert_pass_plain(qw, means, scales, family: str, min_sym: int,
                               max_sym: int, cfg: LaneConfig = TCHAIN12_CFG):
    """Step (a) in plain PyTorch (any device, no checks), vectorised over
    all T * L symbols: each quantile's symbol through the model's
    bisection (``family.invert_family``) and its record ``(q - cum) | prob
    << 16`` (prob <= 2^12, q - cum < prob), what step (b) needs of it.
    Returns ``(symbols int32[T * L], records int32[T * L])``."""
    L = cfg.num_lanes
    T = qw.numel() // _step_words(L)
    q = unpack_q12(
        convert.u32_values(qw).reshape(T, _step_words(L) // 128, 128),
        torch).reshape(-1)
    sym, cum, prob = fam.invert_family(torch, family, min_sym, max_sym,
                                       q.to(torch.int32), means, 1.0 / scales)
    recs = (q - cum.to(torch.int64)) | (prob.to(torch.int64) << 16)
    return sym.to(torch.int32), recs.to(torch.int32)


def tchain12_head_pass(recs, cfg: LaneConfig = TCHAIN12_CFG):
    """Step (b) of :func:`tchain12_family_decode` alone on the records of
    step (a) (``recs`` int32[T * L]): ``(words int32[T, L], ballots
    int32[T, L / 32], heads int32[L])``, row r holding step T - 1 - r.  On
    the card the words of lanes that flush nothing are left unwritten; a
    CPU tensor runs :func:`tchain12_head_pass_plain` and packs its flags
    with ``coder.flag_ballots``."""
    L = _check_preset(cfg, TCHAIN12_CFG, 1024)
    if not isinstance(recs, torch.Tensor):
        raise TypeError("recs must be a torch.Tensor")
    _check("recs", recs, torch.int32, recs.device)
    if recs.numel() % L:
        raise ValueError(
            f"recs must hold whole steps of {L} entries, got {recs.numel()}")
    device = recs.device
    if not _on_cuda(device):
        words, flags, heads = tchain12_head_pass_plain(recs, cfg)
        return words, flag_ballots(flags), heads
    T = recs.numel() // L
    heads = torch.full((L,), _SEED, dtype=torch.int32, device=device)
    words = torch.empty(T, L, dtype=torch.int32, device=device)
    ballots = torch.empty(T, L // 32, dtype=torch.int32, device=device)
    if T:
        _build.call("ctt_tchain12_head_pass", device, heads, recs, words,
                    ballots, L, T)
        LAUNCHES["heads12_family"] += 1
    return words, ballots, heads


def tchain12_head_pass_plain(recs, cfg: LaneConfig = TCHAIN12_CFG):
    """Step (b) in plain PyTorch (any device, no checks): a loop over steps
    0 .. T-1, vectorised over lanes, of head = head * prob + (q - cum) from
    the records; a head at or above 2^20 flushes its low 16 bits.  Returns
    ``(words int32[T, L], flags bool[T, L], heads int32[L])`` in reversed
    rows: row T - 1 - t holds step t's flushed words (0 elsewhere) and
    flags, so the row-major compaction (``coder.compact_pass_plain``) puts
    the step chunks right to left, lanes ascending in a step, as the
    stream is laid out."""
    L, W = cfg.num_lanes, cfg.word_bits
    T = recs.numel() // L
    r = recs.to(torch.int64).reshape(T, L)
    heads = torch.full((L,), _SEED, dtype=torch.int64, device=recs.device)
    words = torch.zeros(T, L, dtype=torch.int64, device=recs.device)
    flags = torch.zeros(T, L, dtype=torch.bool, device=recs.device)
    for t in range(T):
        heads = heads * (r[t] >> 16) + (r[t] & _M16)
        m = heads >= _FLUSH_AT
        words[T - 1 - t] = torch.where(m, heads & _M16, 0)
        flags[T - 1 - t] = m
        heads = torch.where(m, heads >> W, heads)
    return words.to(torch.int32), flags, convert.u32_bits(heads)


def tchain12_family_decode_plain(qw, means, scales, family: str,
                                 min_sym: int, max_sym: int,
                                 cfg: LaneConfig = TCHAIN12_CFG):
    """Plain PyTorch twin of :func:`tchain12_family_decode` (any device, no
    checks).  Numpy oracle: :func:`tchain12_family_decode_host`."""
    L, W = cfg.num_lanes, cfg.word_bits
    device = qw.device
    T = qw.numel() // _step_words(L)
    n = T * L
    q_all = unpack_q12(
        convert.u32_values(qw).reshape(T, _step_words(L) // 128, 128),
        torch).reshape(T, L)
    inv_scales = 1.0 / scales
    heads = torch.full((L,), _SEED, dtype=torch.int64, device=device)
    out = torch.empty(n, dtype=torch.int32, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(T):
        q = q_all[t]
        sym, cum, prob = fam.invert_family(
            torch, family, min_sym, max_sym, q.to(torch.int32),
            means[t * L:(t + 1) * L], inv_scales[t * L:(t + 1) * L])
        heads = heads * prob + (q - cum)
        m = heads >= _FLUSH_AT
        e = _emit_words(buf, m, heads & 0xFFFF, e, n)
        heads = torch.where(m, heads >> W, heads)
        out[t * L:(t + 1) * L] = sym
    return out, convert.u32_bits(buf[int(e):n]), convert.u32_bits(heads)


def tchain12_family_encode(symbols, remainders, heads, means, scales,
                           family: str, min_sym: int, max_sym: int,
                           cfg: LaneConfig = TCHAIN12_CFG):
    """The reverse pass of :func:`tchain12_family_decode`.  JAX
    counterpart: ``tchain.tchain12_family_encode_pallas``.

    ``symbols`` int32[T * L], ``remainders`` int32 words, ``heads``
    int32[L], ``means`` and ``scales`` float32[T * L], on one device.
    Returns ``(qw int32[T * 3L/8], heads int32[L])``: the packed quantiles
    and the heads before step 0.  CUDA tensors launch the encode's three
    steps (``csrc/tchain.cu``, kernel 22; one C call): the tables pass, one
    thread per symbol (:func:`tchain12_tables_pass`), the cluster step on
    its records (num_lanes up to ``coder.MAX_DECODE_LANES``, else
    ValueError) and the packing of its quantiles.  CPU tensors run
    :func:`tchain12_family_encode_plain` at any L."""
    T = _encode12_args(symbols, remainders, heads, means, scales, family,
                       min_sym, max_sym, cfg)
    if not _on_cuda(symbols.device):
        return tchain12_family_encode_plain(symbols, remainders, heads, means,
                                            scales, family, min_sym, max_sym,
                                            cfg)
    return _launch_encode12(symbols, remainders, heads, means, scales,
                            family, min_sym, max_sym, cfg, T)


def tchain12_family_encode_cluster(symbols, remainders, heads, means, scales,
                                   family: str, min_sym: int, max_sym: int,
                                   cluster: int,
                                   cfg: LaneConfig = TCHAIN12_CFG):
    """:func:`tchain12_family_encode` with its cluster step on ``cluster``
    CTAs (1 .. 16) in place of the size the kernel picks from L (CUDA
    tensors): how the card tests reach uneven partitions and CTAs with no
    lanes."""
    T = _encode12_args(symbols, remainders, heads, means, scales, family,
                       min_sym, max_sym, cfg)
    _forced_cluster(symbols, cluster)
    return _launch_encode12(symbols, remainders, heads, means, scales,
                            family, min_sym, max_sym, cfg, T, cluster)


def geometry12(L: int, device=None, cluster: int = 0) -> dict:
    """The TChain-12 encode's cluster step (kernel 22) for L lanes, as
    :func:`geometry24` reads kernel 24's (nothing is staged:
    ``smem_bytes`` and ``records_in_smem`` are 0)."""
    return _geometry("12", device, L, cluster)


def _encode12_args(symbols, remainders, heads, means, scales, family: str,
                   min_sym: int, max_sym: int, cfg: LaneConfig) -> int:
    L = cfg.num_lanes
    T = _chain_args(symbols, "symbols", cfg, family, min_sym, max_sym, L)
    device = symbols.device
    fam.check_params(means, scales, T * L, device)
    _check("remainders", remainders, torch.int32, device)
    _check("heads", heads, torch.int32, device, L)
    fam.check_symbols(symbols, min_sym, max_sym)
    return T


def _launch_encode12(symbols, remainders, heads, means, scales, family: str,
                     min_sym: int, max_sym: int, cfg: LaneConfig, T: int,
                     cluster: int = 0):
    """One C call of kernel 22 (its cluster step on ``cluster`` CTAs, or the
    size it picks from L when 0); its scratch holds each symbol's 8-byte
    division record and its u16 quantile, which the packing pass writes
    into every quantile word."""
    L = cfg.num_lanes
    if L > MAX_DECODE_LANES:
        raise ValueError(
            f"the TChain-12 encode kernel takes num_lanes up to "
            f"{MAX_DECODE_LANES} (16 CTAs x 1024 threads x 32 lanes a "
            f"thread), got num_lanes={L}")
    device = symbols.device
    out_heads = heads.clone()
    qw = torch.empty(T * _step_words(L), dtype=torch.int32, device=device)
    if T:
        recs = torch.empty(T * L, dtype=torch.int64, device=device)
        q16 = torch.empty(T * L // 2, dtype=torch.int32, device=device)
        entry, size = "ctt_tchain12_family_encode", ()
        if cluster:
            entry, size = "ctt_tchain12_family_encode_cluster", (cluster,)
        _build.call(entry, device, out_heads, symbols, means, scales,
                    remainders, remainders.numel(), recs, q16, qw, L, T,
                    fam.FAMILIES.index(family), min_sym, max_sym, *size)
        LAUNCHES["encode12_family"] += 1
    return qw, out_heads


def tchain12_tables_pass(symbols, means, scales, family: str, min_sym: int,
                         max_sym: int, cfg: LaneConfig = TCHAIN12_CFG):
    """The tables pass of :func:`tchain12_family_encode` alone (its checks
    on the symbols and models): ``records int64[T * L]``, each symbol's
    division record (``csrc/ilans2_wide.cuh``, ``DivisionRecord32``) as one
    u64, ``magic | (cum | (prob - 1) << 16) << 32``.  CUDA tensors launch
    the kernel (``csrc/family_records.cuh``, ``family_tables_kernel``), CPU
    tensors run :func:`tchain12_tables_pass_plain`."""
    L = cfg.num_lanes
    T = _chain_args(symbols, "symbols", cfg, family, min_sym, max_sym, L)
    device = symbols.device
    fam.check_params(means, scales, T * L, device)
    fam.check_symbols(symbols, min_sym, max_sym)
    if not _on_cuda(device):
        return tchain12_tables_pass_plain(symbols, means, scales, family,
                                          min_sym, max_sym, cfg)
    recs = torch.empty(T * L, dtype=torch.int64, device=device)
    if T:
        _build.call("ctt_tchain12_tables_pass", device, symbols, means,
                    scales, recs, L, T, fam.FAMILIES.index(family), min_sym,
                    max_sym)
        LAUNCHES["tables12_family"] += 1
    return recs


def tchain12_tables_pass_plain(symbols, means, scales, family: str,
                               min_sym: int, max_sym: int,
                               cfg: LaneConfig = TCHAIN12_CFG):
    """The tables pass in plain PyTorch (any device, no checks), vectorised
    over all T * L symbols: each symbol, clamped into the support as the
    kernel clamps it, its (cum, prob) under its model (``family.tables``)
    and its division record ``magic | (cum | (prob - 1) << 16) << 32``,
    magic the 32-bit multiply-high reciprocal of prob <= 2^12
    (``coder.division_magic32``): ``family.family_tables_pass_plain``, the
    pass kernel 12 shares.  Returns records int64[T * L]."""
    return fam.family_tables_pass_plain(symbols, means, scales, family,
                                        min_sym, max_sym)


def tchain12_family_encode_plain(symbols, remainders, heads, means, scales,
                                 family: str, min_sym: int, max_sym: int,
                                 cfg: LaneConfig = TCHAIN12_CFG):
    """Plain PyTorch twin of :func:`tchain12_family_encode` (any device, no
    checks).  Numpy oracle: :func:`tchain12_family_encode_host`."""
    L, S, W, P = cfg.num_lanes, cfg.state_bits, cfg.word_bits, cfg.precision
    T = symbols.numel() // L
    cums, probs = fam.tables(torch, family, min_sym, max_sym, symbols, means,
                             1.0 / scales)
    cums, probs = cums.to(torch.int64), probs.to(torch.int64)
    h = convert.u32_values(heads)
    words = convert.u32_values(remainders)
    q_out = torch.empty(T, L, dtype=torch.int64, device=symbols.device)
    base = torch.zeros((), dtype=torch.int64, device=symbols.device)
    for t in range(T - 1, -1, -1):
        cum, prob = cums[t * L:(t + 1) * L], probs[t * L:(t + 1) * L]
        m = h < (prob << (S - W - P))
        w, base = _refill_words(m, words, base)
        h = torch.where(m, (h << W) | (w & cfg.word_mask), h)
        q_out[t] = cum + h % prob
        h = h // prob
    qw = _pack_q12_block(torch, q_out.reshape(T * L // 128, 128))
    return convert.u32_bits(qw.reshape(-1)), convert.u32_bits(h)


# ---------------------------------------------------------------------------
# TChain-16 and TChain-24: categorical bits-back (one CDF for every symbol)
# ---------------------------------------------------------------------------


def _check_preset(cfg: LaneConfig, want: LaneConfig, lane_multiple: int):
    """Checks (W, S, P) against the preset ``want`` and L against
    ``lane_multiple``; returns L."""
    got = (cfg.word_bits, cfg.state_bits, cfg.precision)
    if got != (want.word_bits, want.state_bits, want.precision):
        raise ValueError(
            f"cfg must be W={want.word_bits}, S={want.state_bits}, "
            f"P={want.precision}, got W={got[0]}, S={got[1]}, P={got[2]}")
    L = cfg.num_lanes
    if L <= 0 or L % lane_multiple:
        raise ValueError(
            f"num_lanes must be a positive multiple of {lane_multiple}, got "
            f"{L}")
    return L


def _whole_steps(n: int, L: int) -> int:
    if n % L:
        raise ValueError(
            f"the message length must be a multiple of num_lanes={L}, got "
            f"{n}")
    return n // L


def pack_quantiles(q, L: int) -> np.ndarray:
    """[T*L] u16 quantiles (lane order) -> [T, R/2, 128] u32 planar words
    (R = L / 128): the word at (t, r, c) holds lane r*128 + c in its low
    half and lane (r + R/2)*128 + c in its high half.  JAX counterpart:
    ``tchain.pack_quantiles``."""
    if L % 256:
        raise ValueError(
            f"num_lanes must be a multiple of 256 for planar packing, got "
            f"{L}")
    q = np.asarray(q)
    T = len(q) // L
    return _pack_planar(q.astype(np.uint32).reshape(T, L // 128, 128))


def _pack_planar(q3):
    """[T, R, 128] quantiles -> [T, R/2, 128] planar words (numpy u32, or
    torch int64 of u32 values)."""
    R = q3.shape[1]
    return q3[:, :R // 2] | (q3[:, R // 2:] << 16)


def unpack_quantiles(w, xp=np):
    """Inverse of :func:`pack_quantiles`: [T, R/2, 128] words -> [T*L]
    quantiles, u16 for numpy words, int64 for torch int64 words of u32
    values.  JAX counterpart: ``tchain.unpack_quantiles``."""
    q = xp.concatenate([w & _M16, w >> 16], 1).reshape(-1)
    return q.astype(np.uint16) if xp is np else q


def pack_q24(q, L: int) -> np.ndarray:
    """[T*L] u32 (24-bit) quantiles -> [T, 3R/4, 128] u32 planar words: four
    128-lane rows share three word rows.  A storage helper only (a quarter
    smaller than one quantile per word); the TChain-24 coders take one
    quantile per word.  JAX counterpart: ``tchain.pack_q24``."""
    if L % 512:
        raise ValueError(
            f"num_lanes must be a multiple of 512 for 24-bit packing, got {L}")
    q = np.asarray(q)
    T = len(q) // L
    g = q.astype(np.uint32).reshape(T, L // 512, 4, 128)
    w = np.empty((T, L // 512, 3, 128), dtype=np.uint32)
    w[:, :, 0] = g[:, :, 0] | (g[:, :, 1] << 24)
    w[:, :, 1] = (g[:, :, 1] >> 8) | (g[:, :, 2] << 16)
    w[:, :, 2] = (g[:, :, 2] >> 16) | (g[:, :, 3] << 8)
    return w.reshape(T, 3 * (L // 512), 128)


def unpack_q24(w) -> np.ndarray:
    """[T, 3R/4, 128] words -> [T, R, 128] u32 quantile values.  JAX
    counterpart: ``tchain.unpack_q24``."""
    T, rows, _ = w.shape
    g = np.asarray(w).reshape(T, rows // 3, 3, 128)
    w0, w1, w2 = g[:, :, 0], g[:, :, 1], g[:, :, 2]
    q = np.stack([
        w0 & _M24,
        (w0 >> 24) | ((w1 & _M16) << 8),
        (w1 >> 16) | ((w2 & 0xFF) << 16),
        w2 >> 8,
    ], 2)
    return q.reshape(T, rows // 3 * 4, 128)


def tchain_decode_host(quantiles, cdf, cfg: LaneConfig = TCHAIN_CFG):
    """Numpy oracle of the TChain-16 decode: ``(symbols int32[n],
    remainders u32, heads u32[L])``, the remainders in the order the reverse
    pass reads them.  JAX counterpart: ``tchain.tchain_decode_host``."""
    L = _check_preset(cfg, TCHAIN_CFG, 1)
    W, S = cfg.word_bits, cfg.state_bits
    n = len(quantiles)
    T = _whole_steps(n, L)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    heads = np.ones(L, dtype=np.uint64)
    out = np.empty(n, dtype=np.int32)
    chunks = []
    lanes = np.arange(L)
    for t in range(T):
        q = quantiles[t * L:(t + 1) * L].astype(np.uint64)
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        heads = heads * prob + (q - cum)
        m = heads >= np.uint64(1 << (S - W))
        chunks.append((heads[m] & np.uint64(_M16)).astype(np.uint32))
        heads = np.where(m, heads >> np.uint64(W), heads)
        out[t * L + lanes] = sym
    stream = np.concatenate(chunks[::-1]) if chunks else np.zeros(0, np.uint32)
    return out, stream, heads.astype(np.uint32)


def tchain_encode_host(symbols, remainders, heads, cdf,
                       cfg: LaneConfig = TCHAIN_CFG):
    """Numpy oracle of the TChain-16 reverse pass: ``(quantiles u16[n],
    heads u32[L])``, the heads all 1 after a full round trip.  JAX
    counterpart: ``tchain.tchain_encode_host``."""
    L = _check_preset(cfg, TCHAIN_CFG, 1)
    W = cfg.word_bits
    n = len(symbols)
    T = _whole_steps(n, L)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    h = np.asarray(heads).astype(np.uint64)
    q_out = np.empty(n, dtype=np.uint16)
    base = 0
    lanes = np.arange(L)
    for tt in range(T - 1, -1, -1):
        sym = np.asarray(symbols[tt * L:(tt + 1) * L], dtype=np.int64)
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        m = h < prob
        k = int(m.sum())
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = remainders[base:base + k]
            words[:len(avail)] = avail
            h[m] = (h[m] << np.uint64(W)) | words
            base += k
        r = h % prob
        h = h // prob
        q_out[tt * L + lanes] = (cum + r).astype(np.uint16)
    return q_out, h.astype(np.uint32)


def tchain24_decode_host(quantiles, cdf, cfg: LaneConfig = TCHAIN24_CFG):
    """Numpy oracle of the TChain-24 decode: ``(symbols int32[n],
    remainders u32, heads u64[L])``.  Heads live in [2^(S-W-P), 2^(S-P)) =
    [2^8, 2^40), which makes the encoder's refill test (head < prob << 8)
    the exact inverse of the decoder's flush test (head >= 2^40).  JAX
    counterpart: ``tchain.tchain24_decode_host``."""
    L = _check_preset(cfg, TCHAIN24_CFG, 1)
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    n = len(quantiles)
    T = _whole_steps(n, L)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    heads = np.full(L, 1 << (S - W - P), dtype=np.uint64)
    out = np.empty(n, dtype=np.int32)
    chunks = []
    lanes = np.arange(L)
    inv = np.uint64(1) << np.uint64(S - P)
    for t in range(T):
        q = quantiles[t * L:(t + 1) * L].astype(np.uint64)
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        heads = heads * prob + (q - cum)
        m = heads >= inv
        chunks.append((heads[m] & np.uint64(_M32)).astype(np.uint32))
        heads = np.where(m, heads >> np.uint64(W), heads)
        out[t * L + lanes] = sym
    stream = np.concatenate(chunks[::-1]) if chunks else np.zeros(0, np.uint32)
    return out, stream, heads


def tchain24_encode_host(symbols, remainders, heads, cdf,
                         cfg: LaneConfig = TCHAIN24_CFG):
    """Numpy oracle of the TChain-24 reverse pass: ``(quantiles u32[n],
    heads u64[L])``, the heads all 256 after a full round trip.  JAX
    counterpart: ``tchain.tchain24_encode_host``."""
    L = _check_preset(cfg, TCHAIN24_CFG, 1)
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    n = len(symbols)
    T = _whole_steps(n, L)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    h = np.asarray(heads, dtype=np.uint64).copy()
    q_out = np.empty(n, dtype=np.uint32)
    base = 0
    lanes = np.arange(L)
    for tt in range(T - 1, -1, -1):
        sym = np.asarray(symbols[tt * L:(tt + 1) * L], dtype=np.int64)
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        m = h < (prob << np.uint64(S - W - P))
        k = int(m.sum())
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = remainders[base:base + k]
            words[:len(avail)] = avail
            h[m] = (h[m] << np.uint64(W)) | words
            base += k
        r = h % prob
        h = h // prob
        q_out[tt * L + lanes] = (cum + r).astype(np.uint32)
    return q_out, h


# --- the coders


def _check_model(cdf, device: torch.device, P: int,
                 values: bool = True) -> None:
    """A fixed-point CDF at precision P: 0 first, non-decreasing, 2^P last
    (without ``values``, only its tensor: no read-back)."""
    _check_cdf_arg(cdf, device)
    if not values:
        return
    c = cdf.cpu()
    if int(c[0]) != 0 or int(c[-1]) != 1 << P or bool((c[1:] < c[:-1]).any()):
        raise ValueError(
            f"cdf must rise from 0 to 2^{P} = {1 << P}, got cdf[0] = "
            f"{int(c[0])}, cdf[-1] = {int(c[-1])}")


def _check_cat_symbols(symbols, cdf) -> None:
    """Symbols an encoder can code: in [0, K) and of nonzero probability."""
    K = cdf.numel() - 1
    if not symbols.numel():
        return
    lo, hi = int(symbols.min()), int(symbols.max())
    if lo < 0 or hi >= K:
        raise ValueError(f"symbols must be in [0, {K}), got range [{lo}, {hi}]")
    prob = cdf[1:] - cdf[:-1]
    if bool((prob[symbols.long()] == 0).any()):
        raise ValueError("symbols of zero probability cannot be encoded")


def _cat_args(first, name: str, cfg: LaneConfig, want: LaneConfig,
              lane_multiple: int, step: int, cdf,
              cdf_values: bool = True) -> int:
    """Checks the leading tensor, the config and the CDF (its values with
    ``cdf_values``); returns T, the tensor holding ``step`` entries per
    coding step."""
    if not isinstance(first, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    _check(name, first, torch.int32, first.device)
    _check_preset(cfg, want, lane_multiple)
    _check_model(cdf, first.device, want.precision, cdf_values)
    if first.numel() % step:
        raise ValueError(
            f"{name} must hold whole steps of {step} entries (num_lanes="
            f"{cfg.num_lanes}), got {first.numel()}")
    return first.numel() // step


def _encode_args(symbols, remainders, heads, cdf, cfg: LaneConfig,
                 want: LaneConfig, lane_multiple: int, head_dtype) -> int:
    T = _cat_args(symbols, "symbols", cfg, want, lane_multiple,
                  cfg.num_lanes, cdf)
    _check("remainders", remainders, torch.int32, symbols.device)
    _check("heads", heads, head_dtype, symbols.device, cfg.num_lanes)
    _check_cat_symbols(symbols, cdf)
    return T


def _launch_decode(tag: str, q, cdf, L: int, T: int, seed: int,
                   head_dtype):
    """One decode call (kernels 19 and 23: the head pass and the
    compaction, on the compaction's scratch); returns (symbols, buf, end
    int64[1], heads), the stream ``buf[end:]`` (``coder.trim``).  Reads
    nothing back."""
    device = q.device
    n = T * L
    heads = torch.full((L,), seed, dtype=head_dtype, device=device)
    syms = torch.empty(n, dtype=torch.int32, device=device)
    end = torch.zeros(1, dtype=torch.int64, device=device)
    if T == 0:
        return (syms, torch.zeros(0, dtype=torch.int32, device=device), end,
                heads)
    buf = torch.empty(n, dtype=torch.int32, device=device)  # <= 1 word/symbol
    cdf32 = cdf.to(torch.int32)
    LAUNCHES[f"decode{tag}"] += 1
    _build.call(f"ctt_tchain{tag}_decode", device, heads, q, cdf32,
                cdf32.numel() - 1, syms, buf, n, end,
                *compaction_scratch(T, L, device), L, T)
    return syms, buf, end, heads


def _trimmed(syms, buf, end, heads):
    return syms, trim(buf, end), heads


def _launch_encode(tag: str, symbols, remainders, heads, cdf,
                   cfg: LaneConfig, T: int, q_words: int, cluster: int = 0):
    """One encode launch on a cluster of ``cluster`` CTAs, or of the size
    the kernel picks from L when 0 (kernels 20 and 24); returns (quantile
    words, heads).  The kernel writes every quantile (TChain-16 as 16-bit
    halves), so the output needs no zeroing.  It takes a scratch for the K
    division records (``coder._records``: 8 bytes each at S=32, 16 at
    S=64)."""
    L = cfg.num_lanes
    if L > MAX_DECODE_LANES:
        raise ValueError(
            f"the TChain-{cfg.precision} encode kernel takes num_lanes up to "
            f"{MAX_DECODE_LANES} (16 CTAs x 1024 threads x 32 lanes a "
            f"thread), got num_lanes={L}")
    device = symbols.device
    out_heads = heads.clone()
    q = torch.empty(T * q_words, dtype=torch.int32, device=device)
    if T:
        cdf32 = cdf.to(torch.int32)
        K = cdf32.numel() - 1
        entry, size = f"ctt_tchain{tag}_encode", ()
        if cluster:
            entry, size = f"ctt_tchain{tag}_encode_cluster", (cluster,)
        _build.call(entry, device, out_heads, symbols, cdf32, K, remainders,
                    remainders.numel(), q, _records(cdf32, cfg), L, T, *size)
        LAUNCHES[f"encode{tag}"] += 1
    return q, out_heads


def _forced_cluster(symbols, cluster: int) -> None:
    """The checks of a forced cluster size: CUDA tensors, 1 .. 16 CTAs."""
    if not _on_cuda(symbols.device):
        raise ValueError("a forced cluster size needs CUDA tensors")
    if not 1 <= cluster <= 16:
        raise ValueError(f"cluster must be in 1 .. 16, got {cluster}")


def tchain16_decode(qw, cdf, cfg: LaneConfig = TCHAIN_CFG):
    """TChain-16 bits-back decode.  JAX counterpart:
    ``tchain.tchain_decode_pallas``.

    ``qw`` int32[T * L/2] (the :func:`pack_quantiles` words, flattened),
    ``cdf`` int64[K+1] at P=16, on one device.  Returns ``(symbols
    int32[T * L], stream int32[num_words], heads int32[L])``.  CUDA tensors
    launch the decode's two steps over the whole grid (``csrc/tchain.cu``,
    kernel 19): the head pass, one thread per lane, each lane searching its
    quantiles in its block's bucket table (:func:`tchain16_head_pass`), and
    the row-major compaction of the flushed words (``coder.compact_pass``;
    four launches, one C call).  CPU tensors run
    :func:`tchain16_decode_plain`, which equals the composition of the two
    plain steps."""
    L = cfg.num_lanes
    T = _tchain16_q_args(qw, cdf, cfg)
    if not _on_cuda(qw.device):
        return tchain16_decode_plain(qw, cdf, cfg)
    return _trimmed(*_launch_decode("16", qw, cdf, L, T, 1, torch.int32))


def launch_tchain16_decode(qw, cdf, cfg: LaneConfig = TCHAIN_CFG):
    """:func:`tchain16_decode` as a launch form: ``(symbols, buf, end
    int64[1], heads)``, the stream ``buf[end:]`` (``coder.trim``), nothing
    read back, so the CDF's values are the caller's to check
    (:func:`_check_model` on the host).  CPU tensors run :func:`tchain16_decode_plain`,
    with end 0."""
    T = _tchain16_q_args(qw, cdf, cfg, cdf_values=False)
    if not _on_cuda(qw.device):
        syms, stream, heads = tchain16_decode_plain(qw, cdf, cfg)
        return syms, stream, torch.zeros(1, dtype=torch.int64), heads
    return _launch_decode("16", qw, cdf, cfg.num_lanes, T, 1, torch.int32)


def _tchain16_q_args(qw, cdf, cfg: LaneConfig,
                     cdf_values: bool = True) -> int:
    """Checks a TChain-16 decode's planar words, config and CDF; returns
    T."""
    return _cat_args(qw, "qw", cfg, TCHAIN_CFG, 256, cfg.num_lanes // 2, cdf,
                     cdf_values)


def tchain16_head_pass(qw, cdf, cfg: LaneConfig = TCHAIN_CFG):
    """The head pass of :func:`tchain16_decode` alone (its arguments and
    checks): ``(symbols int32[T * L], words int32[T, L], ballots int32[T,
    L / 32], heads int32[L])``, row r of the words and ballots holding step
    T - 1 - r.  CUDA tensors launch the kernel (``csrc/tchain.cu``,
    ``tchain_heads_kernel`` over ``QuantileSteps<32>``), which leaves the
    words of lanes that flush nothing unwritten; CPU tensors run
    :func:`tchain16_head_pass_plain` and pack its flags with
    ``coder.flag_ballots``."""
    T = _tchain16_q_args(qw, cdf, cfg)
    if not _on_cuda(qw.device):
        syms, words, flags, heads = tchain16_head_pass_plain(qw, cdf, cfg)
        return syms, words, flag_ballots(flags), heads
    return _launch_head_pass("16", qw, cdf, cfg.num_lanes, T, 1, torch.int32)


def _launch_head_pass(tag: str, q, cdf, L: int, T: int, seed: int,
                      head_dtype):
    """One launch of a categorical decode's head pass (kernels 19 and 23)
    into fresh outputs: (symbols, words, ballots, heads)."""
    device = q.device
    syms = torch.empty(T * L, dtype=torch.int32, device=device)
    heads = torch.full((L,), seed, dtype=head_dtype, device=device)
    words = torch.empty(T, L, dtype=torch.int32, device=device)
    ballots = torch.empty(T, L // 32, dtype=torch.int32, device=device)
    if T:
        cdf32 = cdf.to(torch.int32)
        _build.call(f"ctt_tchain{tag}_head_pass", device, heads, q, cdf32,
                    cdf32.numel() - 1, syms, words, ballots, L, T)
        LAUNCHES[f"heads{tag}"] += 1
    return syms, words, ballots, heads


def tchain16_head_pass_plain(qw, cdf, cfg: LaneConfig = TCHAIN_CFG):
    """The head pass in plain PyTorch (any device, no checks): every
    quantile's symbol, cum and prob at once (``searchsorted`` over the
    CDF), then a loop over steps 0 .. T-1, vectorised over lanes, of head =
    head * prob + (q - cum) (below 2^32: heads stay below 2^16 and prob <=
    2^16); a head at or above 2^16 flushes its low 16 bits.  Returns
    ``(symbols int32[T * L], words int32[T, L], flags bool[T, L], heads
    int32[L])``, the words and flags in reversed rows: row T - 1 - t holds
    step t's flushed words (0 elsewhere) and flags, so the row-major
    compaction (``coder.compact_pass_plain``) lays the stream out as the
    decode does."""
    L, W, S, P = (cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                  cfg.precision)
    device = qw.device
    T = qw.numel() // (L // 2)
    q = unpack_quantiles(
        convert.u32_values(qw).reshape(T, L // 256, 128), torch)
    cdf64 = cdf.to(torch.int64)
    sym = _find_symbols(cdf64, q, cdf64.numel() - 1)
    cum = cdf64[sym]
    probs = (cdf64[sym + 1] - cum).reshape(T, L)
    rems = (q - cum).reshape(T, L)
    heads = torch.ones(L, dtype=torch.int64, device=device)
    words = torch.zeros(T, L, dtype=torch.int64, device=device)
    flags = torch.zeros(T, L, dtype=torch.bool, device=device)
    for t in range(T):
        heads = heads * probs[t] + rems[t]
        m = heads >= 1 << (S - P)
        words[T - 1 - t] = torch.where(m, heads & _M16, 0)
        flags[T - 1 - t] = m
        heads = torch.where(m, heads >> W, heads)
    return (sym.to(torch.int32), convert.u32_bits(words), flags,
            convert.u32_bits(heads))


def tchain16_decode_plain(qw, cdf, cfg: LaneConfig = TCHAIN_CFG):
    """Plain PyTorch twin of :func:`tchain16_decode` (any device, no
    checks).  Numpy oracle: :func:`tchain_decode_host`."""
    L, W, S = cfg.num_lanes, cfg.word_bits, cfg.state_bits
    device = qw.device
    T = qw.numel() // (L // 2)
    n = T * L
    q_all = unpack_quantiles(
        convert.u32_values(qw).reshape(T, L // 256, 128), torch).reshape(T, L)
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1
    heads = torch.ones(L, dtype=torch.int64, device=device)
    out = torch.empty(n, dtype=torch.int32, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(T):
        q = q_all[t]
        sym = _find_symbols(cdf64, q, K)
        cum = cdf64[sym]
        heads = heads * (cdf64[sym + 1] - cum) + (q - cum)  # < 2^32
        m = heads >= 1 << (S - W)
        e = _emit_words(buf, m, heads & _M16, e, n)
        heads = torch.where(m, heads >> W, heads)
        out[t * L:(t + 1) * L] = sym
    return out, convert.u32_bits(buf[int(e):n]), convert.u32_bits(heads)


def tchain16_encode(symbols, remainders, heads, cdf,
                    cfg: LaneConfig = TCHAIN_CFG):
    """The reverse pass of :func:`tchain16_decode`.  JAX counterpart:
    ``tchain.tchain_encode_pallas``.

    ``symbols`` int32[T * L] in [0, K) and of nonzero probability,
    ``remainders`` int32 words, ``heads`` int32[L], ``cdf`` int64[K+1], on
    one device.  Returns ``(qw int32[T * L/2], heads int32[L])``: the
    planar quantile words and the heads before step 0.  CUDA tensors launch
    the cluster encode (``csrc/tchain.cu``, kernel 20; num_lanes up to
    ``coder.MAX_DECODE_LANES``, else ValueError), CPU tensors run
    :func:`tchain16_encode_plain` at any L."""
    L = cfg.num_lanes
    T = _encode_args(symbols, remainders, heads, cdf, cfg, TCHAIN_CFG, 256,
                     torch.int32)
    if not _on_cuda(symbols.device):
        return tchain16_encode_plain(symbols, remainders, heads, cdf, cfg)
    return _launch_encode("16", symbols, remainders, heads, cdf, cfg, T,
                          L // 2)


def tchain16_encode_cluster(symbols, remainders, heads, cdf, cluster: int,
                            cfg: LaneConfig = TCHAIN_CFG):
    """:func:`tchain16_encode` on a cluster of ``cluster`` CTAs (1 .. 16) in
    place of the size the kernel picks from L (CUDA tensors): how the card
    tests reach uneven partitions and CTAs with no lanes."""
    T = _encode_args(symbols, remainders, heads, cdf, cfg, TCHAIN_CFG, 256,
                     torch.int32)
    _forced_cluster(symbols, cluster)
    return _launch_encode("16", symbols, remainders, heads, cdf, cfg, T,
                          cfg.num_lanes // 2, cluster)


def geometry16(L: int, K: int, device=None, cluster: int = 0) -> dict:
    """The TChain-16 encode's launch geometry (kernel 20), as
    :func:`geometry24` reads kernel 24's."""
    return _geometry("16", device, L, K, cluster)


def tchain16_encode_plain(symbols, remainders, heads, cdf,
                          cfg: LaneConfig = TCHAIN_CFG):
    """Plain PyTorch twin of :func:`tchain16_encode` (any device, no
    checks).  Numpy oracle: :func:`tchain_encode_host`; a refill word keeps
    its low 16 bits, as in the Pallas kernel."""
    L, W = cfg.num_lanes, cfg.word_bits
    T = symbols.numel() // L
    cdf64 = cdf.to(torch.int64)
    syms = symbols.to(torch.int64)
    h = convert.u32_values(heads)
    words = convert.u32_values(remainders)
    q_out = torch.empty(T, L, dtype=torch.int64, device=symbols.device)
    base = torch.zeros((), dtype=torch.int64, device=symbols.device)
    for t in range(T - 1, -1, -1):
        s = syms[t * L:(t + 1) * L]
        cum = cdf64[s]
        prob = cdf64[s + 1] - cum
        m = h < prob
        w, base = _refill_words(m, words, base)
        h = torch.where(m, (h << W) | (w & _M16), h)
        q_out[t] = cum + h % prob
        h = h // prob
    qw = _pack_planar(q_out.reshape(T, L // 128, 128))
    return convert.u32_bits(qw.reshape(-1)), convert.u32_bits(h)


def tchain24_decode(q, cdf, cfg: LaneConfig = TCHAIN24_CFG):
    """TChain-24 bits-back decode.  JAX counterpart:
    ``tchain.tchain24_decode_pallas``.

    ``q`` int32[T * L] (24-bit quantiles, one per word), ``cdf``
    int64[K+1] at P=24, on one device.  Returns ``(symbols int32[T * L],
    stream int32[num_words], heads int64[L])`` (heads as u64 bits).  CUDA
    tensors launch the decode's two steps over the whole grid
    (``csrc/tchain.cu``, kernel 23): the head pass, one thread per lane,
    each lane searching its quantiles in its block's bucket table
    (:func:`tchain24_head_pass`), and the row-major compaction of the
    flushed words (``coder.compact_pass``; four launches, one C call).  CPU
    tensors run :func:`tchain24_decode_plain`, which equals the composition
    of the two plain steps."""
    L = cfg.num_lanes
    T = _tchain24_q_args(q, cdf, cfg)
    if not _on_cuda(q.device):
        return tchain24_decode_plain(q, cdf, cfg)
    return _trimmed(*_launch_decode("24", q, cdf, L, T, 1 << 8, torch.int64))


def _tchain24_q_args(q, cdf, cfg: LaneConfig) -> int:
    """Checks a TChain-24 decode's quantiles, config and CDF; returns T."""
    T = _cat_args(q, "q", cfg, TCHAIN24_CFG, 128, cfg.num_lanes, cdf)
    if T and not bool(((q >= 0) & (q <= _M24)).all()):
        raise ValueError("quantiles must be 24-bit values")
    return T


def tchain24_head_pass(q, cdf, cfg: LaneConfig = TCHAIN24_CFG):
    """The head pass of :func:`tchain24_decode` alone (its arguments and
    checks): ``(symbols int32[T * L], words int32[T, L], ballots int32[T,
    L / 32], heads int64[L])``, row r of the words and ballots holding step
    T - 1 - r.  CUDA tensors launch the kernel (``csrc/tchain.cu``,
    ``tchain_heads_kernel`` over ``QuantileSteps<64>``), which leaves the
    words of lanes that flush nothing unwritten; CPU tensors run
    :func:`tchain24_head_pass_plain` and pack its flags with
    ``coder.flag_ballots``."""
    T = _tchain24_q_args(q, cdf, cfg)
    if not _on_cuda(q.device):
        syms, words, flags, heads = tchain24_head_pass_plain(q, cdf, cfg)
        return syms, words, flag_ballots(flags), heads
    return _launch_head_pass("24", q, cdf, cfg.num_lanes, T, 1 << 8,
                             torch.int64)


def tchain24_head_pass_plain(q, cdf, cfg: LaneConfig = TCHAIN24_CFG):
    """The head pass in plain PyTorch (any device, no checks): every
    quantile's symbol, cum and prob at once (``searchsorted`` over the
    CDF), then a loop over steps 0 .. T-1, vectorised over lanes, of head =
    head * prob + (q - cum), the head as (hi, lo) u32 halves (as in
    :func:`tchain24_decode_plain`); a head at or above 2^40 flushes its low
    32 bits.  Returns ``(symbols int32[T * L], words int32[T, L], flags
    bool[T, L], heads int64[L])``, the words and flags in reversed rows: row
    T - 1 - t holds step t's flushed words (0 elsewhere) and flags, so the
    row-major compaction (``coder.compact_pass_plain``) lays the stream out
    as the decode does."""
    L, W, S, P = (cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                  cfg.precision)
    device = q.device
    T = q.numel() // L
    cdf64 = cdf.to(torch.int64)
    qv = convert.u32_values(q)
    sym = _find_symbols(cdf64, qv, cdf64.numel() - 1)
    cum = cdf64[sym]
    probs = (cdf64[sym + 1] - cum).reshape(T, L)
    rems = (qv - cum).reshape(T, L)
    hi = torch.zeros(L, dtype=torch.int64, device=device)
    lo = torch.full((L,), 1 << (S - W - P), dtype=torch.int64, device=device)
    words = torch.zeros(T, L, dtype=torch.int64, device=device)
    flags = torch.zeros(T, L, dtype=torch.bool, device=device)
    for t in range(T):
        low = lo * probs[t] + rems[t]
        hi = hi * probs[t] + (low >> 32)
        lo = low & _M32
        m = hi >= 1 << (S - P - 32)  # head >= 2^40: flush lo
        words[T - 1 - t] = torch.where(m, lo, 0)
        flags[T - 1 - t] = m
        hi, lo = torch.where(m, 0, hi), torch.where(m, hi, lo)
    return (sym.to(torch.int32), convert.u32_bits(words), flags,
            convert.u64_join(hi, lo))


def tchain24_decode_plain(q, cdf, cfg: LaneConfig = TCHAIN24_CFG):
    """Plain PyTorch twin of :func:`tchain24_decode` (any device, no
    checks).  Numpy oracle: :func:`tchain24_decode_host`.  Heads are held
    as (hi, lo) u32 halves: head * prob reaches 2^64 - 1, past int64."""
    L, W, S, P = (cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                  cfg.precision)
    device = q.device
    T = q.numel() // L
    n = T * L
    q_all = convert.u32_values(q).reshape(T, L)
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1
    hi = torch.zeros(L, dtype=torch.int64, device=device)
    lo = torch.full((L,), 1 << (S - W - P), dtype=torch.int64, device=device)
    out = torch.empty(n, dtype=torch.int32, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(T):
        qt = q_all[t]
        sym = _find_symbols(cdf64, qt, K)
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        # head < 2^40, so hi < 2^8 and every partial fits int64
        low = lo * prob + (qt - cum)
        hi = hi * prob + (low >> 32)
        lo = low & _M32
        m = hi >= 1 << (S - P - 32)  # head >= 2^40: flush lo
        e = _emit_words(buf, m, lo, e, n)
        hi, lo = torch.where(m, 0, hi), torch.where(m, hi, lo)
        out[t * L:(t + 1) * L] = sym
    return (out, convert.u32_bits(buf[int(e):n]), convert.u64_join(hi, lo))


def tchain24_encode(symbols, remainders, heads, cdf,
                    cfg: LaneConfig = TCHAIN24_CFG):
    """The reverse pass of :func:`tchain24_decode`.  JAX counterpart:
    ``tchain.tchain24_encode_pallas``.

    ``symbols`` int32[T * L] in [0, K) and of nonzero probability,
    ``remainders`` int32 words, ``heads`` int64[L] (u64 bits), ``cdf``
    int64[K+1], on one device.  Returns ``(q int32[T * L], heads
    int64[L])``: the quantiles and the heads before step 0.  CUDA tensors
    launch the cluster encode (``csrc/tchain.cu``, kernel 24; num_lanes up
    to ``coder.MAX_DECODE_LANES``, else ValueError), CPU tensors run
    :func:`tchain24_encode_plain` at any L."""
    T = _encode_args(symbols, remainders, heads, cdf, cfg, TCHAIN24_CFG, 128,
                     torch.int64)
    if not _on_cuda(symbols.device):
        return tchain24_encode_plain(symbols, remainders, heads, cdf, cfg)
    return _launch_encode("24", symbols, remainders, heads, cdf, cfg, T,
                          cfg.num_lanes)


def tchain24_encode_cluster(symbols, remainders, heads, cdf, cluster: int,
                            cfg: LaneConfig = TCHAIN24_CFG):
    """:func:`tchain24_encode` on a cluster of ``cluster`` CTAs (1 .. 16) in
    place of the size the kernel picks from L (CUDA tensors): how the card
    tests reach uneven partitions and CTAs with no lanes."""
    T = _encode_args(symbols, remainders, heads, cdf, cfg, TCHAIN24_CFG, 128,
                     torch.int64)
    _forced_cluster(symbols, cluster)
    return _launch_encode("24", symbols, remainders, heads, cdf, cfg, T,
                          cfg.num_lanes, cluster)


_GEOMETRY_KEYS = ("cluster", "groups_per_cta", "lanes_per_thread",
                  "threads_per_cta", "max_active_clusters", "smem_bytes",
                  "records_in_smem")


def _geometry(tag: str, device, *args) -> dict:
    """An encode's cluster geometry as ``ctt_tchain{tag}_geometry(*args,
    out)`` reports it."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.zeros(len(_GEOMETRY_KEYS), dtype=torch.int64)
    _build.call(f"ctt_tchain{tag}_geometry", device, *args, out)
    geo = dict(zip(_GEOMETRY_KEYS, (int(v) for v in out)))
    geo["ctas"] = geo["cluster"]
    return geo


def geometry24(L: int, K: int, device=None, cluster: int = 0) -> dict:
    """The TChain-24 encode's launch geometry for L lanes and K symbols on
    ``device`` (a CUDA device; the current one by default): its cluster
    (``cluster`` 0: the size the kernel picks from L), the CTAs' groups,
    lanes per thread and threads, the card's maximum of such active
    clusters, the shared memory of a CTA and whether the K division
    records are in it."""
    return _geometry("24", device, L, K, cluster)


def tchain24_encode_plain(symbols, remainders, heads, cdf,
                          cfg: LaneConfig = TCHAIN24_CFG):
    """Plain PyTorch twin of :func:`tchain24_encode` (any device, no
    checks).  Numpy oracle: :func:`tchain24_encode_host`.  Heads are (hi,
    lo) u32 halves and divide by two base-2^32 digits: the remainder of the
    first is below prob <= 2^24, so ``r << 32 | lo`` fits int64."""
    L, W, S, P = (cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                  cfg.precision)
    T = symbols.numel() // L
    cdf64 = cdf.to(torch.int64)
    syms = symbols.to(torch.int64)
    hi, lo = convert.u64_halves(heads)
    words = convert.u32_values(remainders)
    q_out = torch.empty(T, L, dtype=torch.int64, device=symbols.device)
    base = torch.zeros((), dtype=torch.int64, device=symbols.device)
    for t in range(T - 1, -1, -1):
        s = syms[t * L:(t + 1) * L]
        cum = cdf64[s]
        prob = cdf64[s + 1] - cum
        # head < prob << 8 <= 2^32 needs hi == 0
        m = (hi == 0) & (lo < prob << (S - W - P))
        w, base = _refill_words(m, words, base)
        hi, lo = torch.where(m, lo, hi), torch.where(m, w, lo)
        q_hi, r = hi // prob, hi % prob
        part = (r << 32) | lo
        q_out[t] = cum + part % prob
        hi, lo = q_hi, part // prob
    return convert.u32_bits(q_out.reshape(-1)), convert.u64_join(hi, lo)
