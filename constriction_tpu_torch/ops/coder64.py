"""ILANS2 rANS at the reference's DEFAULT preset (W=32, S=64, P <= 24).

The counterpart of ``constriction_tpu/ops/pallas_coder64.py``'s rANS pair.
The TPU kernels hold a 64-bit lane state as two u32 tiles and need
``_mul40x25`` and ``_div64`` for the state update; the CUDA kernel
(``csrc/ilans2.cu``, instantiated at W=32, S=64) uses native ``uint64_t``,
so neither is ported.  The plain twins hold a state as a (hi, lo) pair of
u32 values in int64 tensors, because int64 cannot hold states >= 2^63: the
decoder's product ``(state >> P) * prob`` is split at the 32-bit boundary,
and the encoder's ``state // prob`` is a two-digit long division in base
2^32 (each partial dividend < 2^56).

Lane states travel as int64 tensors holding u64 bits
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
    _num_steps,
    _on_cuda,
    _refill_words,
    _symbol_tables,
)
from .interleaved import LaneConfig

# kernel launches made by this module's wrappers (never by the twins)
LAUNCHES = {"encode": 0, "decode": 0}

_M32 = 0xFFFFFFFF


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
    L, P = cfg.num_lanes, cfg.precision
    device = symbols.device
    n = symbols.numel()
    if seeds is not None:
        hi, lo = convert.u64_halves(seeds)
    else:  # the floor 2^32
        hi = torch.ones(L, dtype=torch.int64, device=device)
        lo = torch.zeros(L, dtype=torch.int64, device=device)
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1
    lanes = torch.arange(L, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(_num_steps(n, L) - 1, -1, -1):
        i = t * L + lanes
        active = i < n
        cum, prob = _symbol_tables(symbols, cdf64, i, n, K)
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
