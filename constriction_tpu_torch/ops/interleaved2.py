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

JAX counterpart: ``constriction_tpu.ops.interleaved2``.  The host functions
here (``encode_shared``, ``decode_shared_cdf``, the packers) are copies of
its numpy paths, so that the port imports nothing of the JAX package; the
JAX package runs the same algebra in C++ where it can, and
``tests/test_torch_host.py`` holds the two byte for byte.  Lane coding for
the containers runs on the port's coder: the kernels for a CUDA device, the
plain twins for the CPU.  Configs the kernels do not take are coded by the
host coder, exactly as the JAX package does: the same semantics, not a
fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
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
# host coder (numpy, any W/S/P and lane count)
# ---------------------------------------------------------------------------


def encode_shared(cums, probs, cfg: LaneConfig, seeds=None):
    """Host ILANS2 encoder over per-symbol (cum, prob) tables.  Returns
    ``(initial decoder states, stream u32[num_words])``: u64 states for
    S > 32, u32 otherwise; stream entries are W-bit words.  ``seeds``
    (optional, [L]) are the encoder's start states, each in
    [2^(S-W), 2^S); a full decode's final states equal them.  JAX
    counterpart: ``constriction_tpu.ops.interleaved2.encode_shared``."""
    n = len(cums)
    if len(probs) != n:
        raise ValueError(
            f"cums and probs must have equal length, got {n} vs {len(probs)}"
        )
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-n // L) if n else 0
    if seeds is not None:
        seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1)
        if len(seeds) != L:
            raise ValueError(f"seeds must have num_lanes={L} entries")
        if np.any(seeds >> np.uint64(S - W) == 0) or (
            S < 64 and np.any(seeds >> np.uint64(S))
        ):
            raise ValueError("seeds must lie in [2^(S-W), 2^S)")

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


def decode_shared_cdf(init_states, stream, num_symbols: int, cdf,
                      cfg: LaneConfig, return_final_states: bool = False):
    """Host ILANS2 decoder with a CDF-table model; reads past the end of
    the stream give zero words.  Returns symbols int32[num_symbols], and
    with ``return_final_states`` also the final lane states.  JAX
    counterpart: ``constriction_tpu.ops.interleaved2.decode_shared_cdf``."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    if len(init_states) != L:
        raise ValueError(
            f"init_states must have num_lanes={L} entries, got "
            f"{len(init_states)}"
        )
    if int(np.asarray(cdf)[-1]) != 1 << P:
        raise ValueError(
            f"cdf[-1] must equal 2**precision = {1 << P}, got "
            f"{int(np.asarray(cdf)[-1])}"
        )
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


def encode_lanes(symbols, cdf, cfg: LaneConfig, device, seeds=None):
    """Code numpy symbols on ``device`` with the port's coder; returns
    numpy ``(states, stream)`` as :func:`encode_shared` does (u64 states
    for S=64, u32 otherwise).  JAX counterpart:
    ``pallas_coder.encode_iid_pallas`` / ``pallas_coder64.encode_iid64_pallas``."""
    device = torch.device(device)
    syms = torch.from_numpy(
        np.ascontiguousarray(symbols, dtype=np.int32)
    ).to(device)
    cdf_t = convert.cdf_to_torch(cdf, device)
    seeds_t = (None if seeds is None
               else convert.states_to_torch(seeds, cfg, device))
    encode = coder64.encode_iid64 if cfg.state_bits == 64 else coder.encode_iid
    states, stream = encode(syms, cdf_t, cfg, seeds=seeds_t)
    return convert.states_from_torch(states, cfg), convert.u32_from_torch(stream)


def decode_lanes(states, stream, n: int, cdf, cfg: LaneConfig, device):
    """Decode with the port's coder on ``device``; returns numpy
    ``(symbols int32[n], final states)``.  JAX counterpart:
    ``pallas_coder.decode_shared_pallas`` /
    ``pallas_coder64.decode_shared64_pallas`` with
    ``return_final_states=True``."""
    device = torch.device(device)
    decode = (coder64.decode_shared64 if cfg.state_bits == 64
              else coder.decode_shared)
    syms, fin = decode(
        convert.states_to_torch(states, cfg, device),
        convert.u32_to_torch(stream, device),
        convert.cdf_to_torch(cdf, device), cfg, n, return_final_states=True,
    )
    return syms.cpu().numpy(), convert.states_from_torch(fin, cfg)


def encode_iid_categorical2(symbols, cdf, cfg: LaneConfig,
                            device="cuda") -> np.ndarray:
    """Encode i.i.d. categorical symbols into a v1 ILANS2 container (u32).
    JAX counterpart: ``constriction_tpu.ops.interleaved2.
    encode_iid_categorical2(..., device=True)``."""
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
