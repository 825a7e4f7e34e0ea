"""TChain bits-back coding on the GPU: TChain-12 with per-symbol continuous
families (neural bits-back).

The counterpart of the TChain-12 part of ``constriction_tpu/ops/tchain.py``.
The decoder reads 12-bit quantiles as if they were compressed data: each
lane inverts its symbol's model (``family.invert_family``), and what the
quantile carried beyond the symbol goes into the lane's remainder head,
``head = head * prob + (q - cum)`` from the seed 2^(S-W-P) = 16; a head at
or above 2^(S-P) = 2^20 flushes its low 16 bits into a shared word stream
(step chunks right to left, lanes ascending within a step).  The encoder
runs the steps backward, refills a head below ``prob << 4`` from the stream
and recovers ``q = cum + head % prob`` exactly; after a full reverse every
head is back at 16.  W=16, S=32, P=12; a message is T full steps of L lanes
and L is a multiple of 1024.

The wrappers launch the hand-written kernels of ``csrc/tchain.cu`` for CUDA
tensors and run the plain PyTorch twins for CPU tensors; any other device
raises.

Tensor layout: quantiles travel packed, 12 bits each, as int32 tensors
holding the u32 words of :func:`pack_q12` (T * 3L/8 words); symbols
int32[T * L]; heads and stream words int32 holding u32 bits; means and
scales float32[T * L].
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from . import _build
from . import family as fam
from .coder import _check, _emit_words, _on_cuda, _refill_words
from .interleaved import LaneConfig

TCHAIN12_CFG = LaneConfig(num_lanes=32768, word_bits=16, state_bits=32,
                          precision=12)

# kernel launches made by this module's wrappers (never by the twins)
LAUNCHES = {"decode12_family": 0, "encode12_family": 0}

_M12 = 0xFFF
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
    tensors launch the kernel, CPU tensors run
    :func:`tchain12_family_decode_plain`."""
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
    LAUNCHES["decode12_family"] += 1
    _build.call("ctt_tchain12_family_decode", device, heads, qw, means,
                scales, syms, buf, n, end, L, T, fam.FAMILIES.index(family),
                min_sym, max_sym)
    return syms, buf[int(end.item()):], heads


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
    and the heads before step 0.  CUDA tensors launch the kernel, CPU
    tensors run :func:`tchain12_family_encode_plain`."""
    L = cfg.num_lanes
    T = _chain_args(symbols, "symbols", cfg, family, min_sym, max_sym, L)
    device = symbols.device
    fam.check_params(means, scales, T * L, device)
    _check("remainders", remainders, torch.int32, device)
    _check("heads", heads, torch.int32, device, L)
    fam.check_symbols(symbols, min_sym, max_sym)
    if not _on_cuda(device):
        return tchain12_family_encode_plain(symbols, remainders, heads, means,
                                            scales, family, min_sym, max_sym,
                                            cfg)
    out_heads = heads.clone()
    qw = torch.zeros(T * _step_words(L), dtype=torch.int32, device=device)
    if T:
        tables_scratch = torch.empty(L, dtype=torch.int32, device=device)
        LAUNCHES["encode12_family"] += 1
        _build.call("ctt_tchain12_family_encode", device, out_heads, symbols,
                    means, scales, remainders, remainders.numel(),
                    tables_scratch, qw, L, T, fam.FAMILIES.index(family),
                    min_sym, max_sym)
    return qw, out_heads


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
