"""Compact v2 ILANS2 containers, with region A coded on the port's coder.

The v2 framing shrinks the v1 container's raw lane states in two ways:
lane states are stored in variable width (a width field plus the bits
below the leading 1, or the widths entropy-coded when that is smaller),
and the last k_B symbols (region B) are coded first on a few lanes and
carried inside region A's encoder seeds, which a full decode of region A
gives back as its final lane states.

Layout (u32 words):

    [0]  magic 0x494C4E32 ("ILN2")    [1] version = 2
    [2]  word_bits | precision << 8 | state_bits << 16
    [3]  num_symbols lo  [4] num_symbols hi   (A + B symbols)
    [5]  L_A   [6] stream_A length (W-bit words)
    [7]  k_B (region-B symbols; 0 = no seed payload)
    [8]  L_B   [9] stream_B length (W-bit words, carried in A's seeds)
    [10] psa_bits (packed states_A)   [11] psb_bits (packed states_B)
    [12 ..]  packed states_A, ceil(psa_bits/32) words
    [..]     the suffix of packed states_B that did not fit the seeds
    [..]     stream_A, W-bit words packed into u32 (as v1)

Packed sections are MSB-first bit streams; u32 words enter and leave the
bit domain big-endian.

JAX counterpart: ``constriction_tpu.ops.framing`` (``encode_iid_v2``,
``decode_iid_v2``, ``frame_planes_v2``, ``parse_v2``, the state packing and
the region coders).  The host framing here is a copy of it, so that the
port imports nothing of the JAX package, and ``tests/test_torch_host.py``
holds the two byte for byte.  Region A runs on the port's coder: its
encoder takes the seeds that carry region B, and its decoder returns the
final lane states from which region B is recovered.  Region B, a short
tail on a lane count that need not tile 128, runs on the host coder, as in
the JAX package.
"""

from __future__ import annotations

import bisect

import numpy as np

from ..models import fast_quantized_cdf
from . import interleaved2 as il2
from .interleaved import LaneConfig, state_dtype
from .interleaved2 import decode_lanes, encode_lanes, kernel_eligible

MAGIC2 = il2.MAGIC2
_WP = 12  # fixed-point precision of the coded-widths model


# ---------------------------------------------------------------------------
# bit streams (MSB-first)
# ---------------------------------------------------------------------------


def _bits_from_u32(words) -> np.ndarray:
    """u32 array -> uint8 bit array, MSB-first within each word."""
    return np.unpackbits(
        np.ascontiguousarray(words, dtype=np.uint32).astype(">u4").view(
            np.uint8)
    )


def _u32_from_bits(bits) -> np.ndarray:
    """uint8 bit array -> u32 array (zero-padded to a word boundary)."""
    pad = (-len(bits)) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits).view(">u4").astype(np.uint32)


def _bit_length_u64(x) -> np.ndarray:
    """Vectorized bit_length of u64 values (0 -> 0)."""
    v = np.asarray(x, dtype=np.uint64).copy()
    w = np.zeros(len(v), dtype=np.int64)
    for k in (32, 16, 8, 4, 2, 1):
        big = v >> np.uint64(k) != 0
        w += np.where(big, k, 0)
        v = np.where(big, v >> np.uint64(k), v)
    return w + (v != 0)


def _int_bits(values, nbits: int) -> np.ndarray:
    """[n] unsigned values -> [n, nbits] uint8 bits, MSB first."""
    v = np.asarray(values, dtype=np.uint64).reshape(-1, 1)
    shifts = np.arange(nbits - 1, -1, -1, dtype=np.uint64)
    return ((v >> shifts) & np.uint64(1)).astype(np.uint8)


def _bits_int(bits) -> np.ndarray:
    """[n, nbits] bits, MSB first -> [n] u64 values."""
    out = np.zeros(bits.shape[0], dtype=np.uint64)
    for j in range(bits.shape[1]):
        out = (out << np.uint64(1)) | bits[:, j].astype(np.uint64)
    return out


def _wbits(cfg: LaneConfig) -> int:
    """Width-field size: states span W bit lengths [S-W+1 .. S]."""
    return (cfg.word_bits - 1).bit_length()


# ---------------------------------------------------------------------------
# scalar rANS (W=32, S=64) for the coded widths
# ---------------------------------------------------------------------------


def _ans_encode_reverse(cums, probs, precision: int) -> np.ndarray:
    """One rANS coder (W=32, S=64, start state 0) over (cum, prob) tables,
    last symbol first; returns the compressed u32 words.  JAX counterpart:
    ``AnsCoderCore(32, 64).encode_reverse_tables`` + ``get_compressed``."""
    state = 0
    bulk = []
    for c, p in zip(reversed(cums.tolist()), reversed(probs.tolist())):
        if (state >> (64 - precision)) >= p:
            bulk.append(state & 0xFFFFFFFF)
            state >>= 32
        state = ((state // p) << precision) | (c + state % p)
    while state:  # the state's words, least significant first
        bulk.append(state & 0xFFFFFFFF)
        state >>= 32
    return np.asarray(bulk, dtype=np.uint32)


def _ans_decode_iid(words, amt: int, cdf, precision: int) -> np.ndarray:
    """Decode ``amt`` i.i.d. symbols from :func:`_ans_encode_reverse`'s
    words.  JAX counterpart: ``AnsCoderCore.from_compressed(words, 32, 64)
    .decode_iid_symbols``."""
    bulk = [int(w) for w in words]
    state = 0
    if bulk:
        if bulk[-1] == 0:
            raise ValueError(
                "Invalid compressed data: ANS compressed data never ends in "
                "a zero word."
            )
        state = bulk.pop()
        while state < 1 << 32 and bulk:
            state = (state << 32) | bulk.pop()
    cdf = [int(c) for c in cdf]
    mask = (1 << precision) - 1
    out = np.empty(amt, dtype=np.int64)
    for i in range(amt):
        q = state & mask
        s = bisect.bisect_right(cdf, q) - 1
        state = (state >> precision) * (cdf[s + 1] - cdf[s]) + (q - cdf[s])
        if state < 1 << 32 and bulk:
            state = (state << 32) | bulk.pop()
        out[i] = s
    return out


# ---------------------------------------------------------------------------
# variable-width lane states
# ---------------------------------------------------------------------------


def pack_states(states, cfg: LaneConfig):
    """Variable-width packing of lane states into a bit array: a 1-bit mode
    flag, then either L raw width fields (flag 0) or the entropy-coded
    widths (flag 1: a 16-bit word count, W 13-bit width probabilities, the
    rANS words), then the L value fields (bit_length - 1 bits each, the
    leading 1 implicit).  The coded form is taken only when strictly
    smaller.  Returns ``(bits uint8[nbits], nbits)``.  JAX counterpart:
    ``constriction_tpu.ops.framing.pack_states``."""
    S, W, L = cfg.state_bits, cfg.word_bits, cfg.num_lanes
    wmin = S - W + 1
    wb = _wbits(cfg)
    x = np.asarray(states, dtype=np.uint64).reshape(-1)
    if len(x) != L:
        raise ValueError(f"expected {L} states, got {len(x)}")
    w = _bit_length_u64(x)
    if np.any(w < wmin) or np.any(w > S):
        raise ValueError("state outside [2^(S-W), 2^S); corrupt coder state")
    wf = w - wmin
    vlen = w - 1
    vo = np.zeros(L, dtype=np.int64)
    np.cumsum(vlen[:-1], out=vo[1:])
    vtotal = int(vo[-1] + vlen[-1]) if L else 0

    width_block = None
    if L >= 64:
        hist = np.bincount(wf, minlength=W).astype(np.float64)
        cdfq = fast_quantized_cdf((hist + 1.0) / (L + W), _WP)
        probs_q = cdfq[1:] - cdfq[:-1]
        words = _ans_encode_reverse(cdfq[wf], probs_q[wf], _WP)
        coded_bits = 16 + W * 13 + len(words) * 32
        if coded_bits < L * wb and len(words) < (1 << 16):
            width_block = np.concatenate([
                np.ones(1, np.uint8), _int_bits([len(words)], 16).ravel(),
                _int_bits(probs_q, 13).ravel(), _bits_from_u32(words),
            ])
    if width_block is None:
        width_block = np.concatenate(
            [np.zeros(1, np.uint8), _int_bits(wf, wb).ravel()]
        )
    base = len(width_block)
    bits = np.zeros(base + vtotal, dtype=np.uint8)
    bits[:base] = width_block
    for j in range(int(vlen.max(initial=0))):  # ragged value fields
        m = vlen > j
        sh = (vlen[m] - 1 - j).astype(np.uint64)
        bits[base + vo[m] + j] = ((x[m] >> sh) & np.uint64(1)).astype(np.uint8)
    return bits, len(bits)


def unpack_states(bits, cfg: LaneConfig) -> np.ndarray:
    """Inverse of :func:`pack_states`; returns u64[L] states.  JAX
    counterpart: ``constriction_tpu.ops.framing.unpack_states``."""
    S, W, L = cfg.state_bits, cfg.word_bits, cfg.num_lanes
    wmin = S - W + 1
    wb = _wbits(cfg)
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) < 1:
        raise ValueError("empty packed-state section")
    if bits[0]:
        pos = 1
        nwords = int(_bits_int(bits[pos:pos + 16].reshape(1, 16))[0])
        pos += 16
        pq = _bits_int(bits[pos:pos + W * 13].reshape(W, 13))
        pos += W * 13
        if pq.sum() != (1 << _WP):
            raise ValueError("corrupt coded-widths model")
        words = _u32_from_bits(bits[pos:pos + nwords * 32])[:nwords]
        pos += nwords * 32
        cdf = np.concatenate([np.zeros(1, np.uint64), np.cumsum(pq)])
        wf = _ans_decode_iid(words, L, cdf, _WP)
        base = pos
    else:
        wf = _bits_int(bits[1:1 + L * wb].reshape(L, wb)).astype(np.int64)
        base = 1 + L * wb
    w = wf + wmin
    if np.any(w < wmin) or np.any(w > S):
        raise ValueError("corrupt width fields in packed-state section")
    vlen = w - 1
    vo = np.zeros(L, dtype=np.int64)
    np.cumsum(vlen[:-1], out=vo[1:])
    if base + (int(vo[-1] + vlen[-1]) if L else 0) > len(bits):
        raise ValueError("packed-state section shorter than its widths")
    x = np.zeros(L, dtype=np.uint64)
    for j in range(int(vlen.max(initial=0))):
        m = vlen > j
        x[m] = (x[m] << np.uint64(1)) | bits[base + vo[m] + j].astype(
            np.uint64)
    return x | (np.uint64(1) << vlen.astype(np.uint64))


# ---------------------------------------------------------------------------
# seed payload
# ---------------------------------------------------------------------------


def _seeds_from_payload(payload_bits, cfg: LaneConfig) -> np.ndarray:
    """(S-W)-bit MSB-first payload chunks -> seeds in [2^(S-W), 2^(S-W+1))."""
    F = cfg.state_bits - cfg.word_bits
    want = cfg.num_lanes * F
    if len(payload_bits) < want:
        payload_bits = np.concatenate(
            [payload_bits, np.zeros(want - len(payload_bits), np.uint8)])
    r = _bits_int(payload_bits[:want].reshape(cfg.num_lanes, F))
    return r | (np.uint64(1) << np.uint64(F))


def _payload_from_seeds(fin_states, cfg: LaneConfig) -> np.ndarray:
    """The payload bits, from the decoder's final lane states."""
    F = cfg.state_bits - cfg.word_bits
    x = np.asarray(fin_states, dtype=np.uint64).reshape(-1)
    if len(x) != cfg.num_lanes:
        raise ValueError(
            f"expected {cfg.num_lanes} final states, got {len(x)}")
    if np.any(x >> np.uint64(F) != 1):
        raise ValueError(
            "final decoder states did not return to the seed band "
            "[2^(S-W), 2^(S-W+1)); the stream is inconsistent with the model"
        )
    return _int_bits(x, F).reshape(-1)


def _bits_to_stream(bits, W: int, nwords: int) -> np.ndarray:
    """The first ``nwords`` W-bit words of an MSB-first bit stream, as u32.
    JAX counterpart: ``constriction_tpu.ops.framing._bits_to_stream``."""
    return _bits_int(
        np.asarray(bits[:nwords * W], dtype=np.uint8).reshape(nwords, W)
    ).astype(np.uint32)


def _pick_lb(L_A: int) -> int:
    """Region-B lane count: small, so that B's own state floor is noise
    against A's seed capacity."""
    return max(8, min(1024, L_A // 64))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def frame_planes_v2(cums, probs, cfg: LaneConfig, sym_bits, encode_a):
    """v2 framing over per-symbol (cum, prob) planes: region split,
    region-B host encode, seed payload, header.  ``encode_a(n_A, seeds)``
    -> ``(states_A, stream_A)`` is the seeded region-A encoder.  JAX
    counterpart: ``constriction_tpu.ops.framing.frame_planes_v2``."""
    n = len(cums)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision

    C_bits = L * (S - W)  # seed payload capacity
    if sym_bits is not None:
        bits_per_sym = np.asarray(sym_bits, np.float64).reshape(-1)
    else:
        bits_per_sym = P - np.log2(np.asarray(probs, np.float64))
    tail_cum = np.cumsum(bits_per_sym[::-1])
    L_B = _pick_lb(L)
    # split only when the message is long enough that the recovered A
    # floor dwarfs B's own framing floor
    k_B = 0
    if n >= 4 * L and tail_cum[-1] > 2.0 * C_bits:
        psb_est = L_B * (_wbits(cfg) + S - W // 2 - 1)
        target = max(C_bits - psb_est - L_B * W // 2, 0.0)
        k_B = min(int(np.searchsorted(tail_cum, target)), n // 2)

    cfg_B = LaneConfig(num_lanes=L_B, word_bits=W, state_bits=S, precision=P)
    stream_B = np.zeros(0, np.uint32)
    psb_bits_arr = np.zeros(0, np.uint8)
    refined = False
    while k_B > 0:
        states_B, stream_B = il2.encode_shared(
            cums[n - k_B:], probs[n - k_B:], cfg_B)
        psb_bits_arr, _ = pack_states(states_B, cfg_B)
        used = len(stream_B) * W + len(psb_bits_arr)
        if used > C_bits:  # overshoot: shrink by the measured rate
            k_B = int(k_B * 0.95 * C_bits / used)
            refined = True
            continue
        slack = C_bits - used
        if not refined and slack > L_B * W and k_B < n // 2:
            # much padding left: grow k_B by the measured bits per symbol
            rate = used / max(k_B, 1)
            k_B = min(int(k_B + slack / rate * 0.9), n // 2)
            refined = True
            continue
        break
    if k_B == 0:  # the shrinking may have emptied region B
        stream_B = np.zeros(0, np.uint32)
        psb_bits_arr = np.zeros(0, np.uint8)

    n_A = n - k_B
    if k_B > 0:
        payload = np.zeros(C_bits, dtype=np.uint8)
        sb = _int_bits(stream_B, W).reshape(-1)
        payload[:len(sb)] = sb
        psb_in_seed = min(len(psb_bits_arr), C_bits - len(sb))
        payload[len(sb):len(sb) + psb_in_seed] = psb_bits_arr[:psb_in_seed]
        seeds = _seeds_from_payload(payload, cfg)
        psb_rem = psb_bits_arr[psb_in_seed:]
    else:
        seeds = None
        psb_rem = np.zeros(0, np.uint8)

    states_A, stream_A = encode_a(n_A, seeds)
    stream_A = np.asarray(stream_A)
    psa_bits_arr, psa_bits = pack_states(np.asarray(states_A), cfg)

    for fname, fval in (
        ("stream_A length", len(stream_A)), ("k_B", k_B),
        ("stream_B length", len(stream_B)), ("psa_bits", psa_bits),
        ("psb_bits", len(psb_bits_arr)),
    ):
        if fval >> 32:
            raise ValueError(
                f"v2 container field {fname} = {fval} exceeds the u32 "
                "header field; split the message (parallel.encode)"
            )
    header = np.array([
        MAGIC2, 2, W | (P << 8) | (S << 16),
        n & 0xFFFFFFFF, (n >> 32) & 0xFFFFFFFF,
        L, len(stream_A), k_B, L_B if k_B else 0, len(stream_B),
        psa_bits, len(psb_bits_arr),
    ], dtype=np.uint32)
    return np.concatenate([
        header,
        _u32_from_bits(psa_bits_arr),
        _u32_from_bits(psb_rem) if len(psb_rem) else np.zeros(0, np.uint32),
        il2.pack_words(stream_A, W),
    ])


def _encode_region_a(symbols, cums, probs, cdf, cfg: LaneConfig, seeds,
                     device):
    """Seeded region-A encode.  JAX counterpart:
    ``constriction_tpu.ops.framing._encode_region_a``."""
    if kernel_eligible(cfg):
        return encode_lanes(symbols, cdf, cfg, device, seeds=seeds)
    return il2.encode_shared(cums, probs, cfg, seeds=seeds)


def encode_iid_v2(symbols, cdf, cfg: LaneConfig, device="cuda",
                  sym_bits: np.ndarray | None = None) -> np.ndarray:
    """Encode i.i.d. categorical symbols into a compact v2 container.  JAX
    counterpart: ``constriction_tpu.ops.framing.encode_iid_v2(...,
    device=True)``; ``sym_bits`` (each symbol's ideal code length in bits,
    optional) as there.  Unlike it, a config with P > W raises ValueError
    (``interleaved2.check_precision``)."""
    il2.check_precision(cfg)
    symbols = np.asarray(symbols, dtype=np.int64)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    cums = cdf64[symbols]
    probs = cdf64[symbols + 1] - cums

    def encode_a(n_A, seeds):
        return _encode_region_a(
            symbols[:n_A], cums[:n_A], probs[:n_A], cdf, cfg, seeds, device
        )

    return frame_planes_v2(cums, probs, cfg, sym_bits, encode_a)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class ParsedV2:
    """A parsed v2 container: header fields, region A's unpacked states
    and stream, and the shipped part of region B's packed states.  JAX
    counterpart: ``constriction_tpu.ops.framing._ParsedV2``."""

    __slots__ = (
        "cfg", "n", "n_A", "k_B", "L_B", "slen_B", "psb_in_seed",
        "psb_rem", "states_A", "stream_A",
    )


def parse_v2(data) -> ParsedV2:
    """Split a v2 container into its regions (no decoding); a corrupt or
    truncated header fails here with a clear error.  JAX counterpart:
    ``constriction_tpu.ops.framing.parse_v2``."""
    data = np.asarray(data, dtype=np.uint32)
    if len(data) < 12:
        raise ValueError("truncated v2 ILANS2 container header")
    if int(data[0]) != MAGIC2 or int(data[1]) != 2:
        raise ValueError("not a v2 ILANS2 container")
    flags = int(data[2])
    W, P, S = flags & 0xFF, (flags >> 8) & 0xFF, (flags >> 16) & 0xFF
    if W not in (8, 16, 32) or not 0 < P <= 24 or S not in (32, 64):
        raise ValueError("invalid (W, P, S) in v2 container header")
    p = ParsedV2()
    p.n = int(data[3]) | (int(data[4]) << 32)
    L = int(data[5])
    slen_A = int(data[6])
    p.k_B, p.L_B, p.slen_B = int(data[7]), int(data[8]), int(data[9])
    psa_bits, psb_bits = int(data[10]), int(data[11])
    if L <= 0 or (p.k_B and p.L_B <= 0):
        raise ValueError("invalid lane counts in v2 container header")
    # each lane stores a width field plus S-W .. S-1 value bits, so the
    # packed-state length pins the lane count
    wb = (W - 1).bit_length()
    if not (1 + L * (S - W) <= psa_bits <= 1 + L * (wb + S - 1)):
        raise ValueError(
            "packed-state length inconsistent with the lane count "
            "(corrupt v2 container header)"
        )
    if p.k_B and not (
        1 + p.L_B * (S - W) <= psb_bits <= 1 + p.L_B * (wb + S - 1)
    ):
        raise ValueError(
            "region-B packed-state length inconsistent with its lane "
            "count (corrupt v2 container header)"
        )
    p.cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)
    p.n_A = p.n - p.k_B
    if p.n_A < 0 or p.k_B < 0:
        raise ValueError("inconsistent symbol counts in v2 header")
    C_bits = L * (S - W)
    sb_bits = p.slen_B * W
    psb_in_seed = min(psb_bits, max(C_bits - sb_bits, 0)) if p.k_B else 0
    rem_bits = psb_bits - psb_in_seed
    expected = (12 + -(-psa_bits // 32) + -(-rem_bits // 32)
                + -(-slen_A // (32 // W)))
    if len(data) != expected:
        raise ValueError(
            f"truncated or oversized v2 container: {len(data)} u32 words, "
            f"header describes {expected}"
        )
    # leaky models cost >= 2^-P bits a symbol: a larger count is corrupt
    cap_bits = (slen_A + p.slen_B) * W + L * S + p.L_B * S + psb_bits
    if p.n > (cap_bits << P) + (1 << P):
        raise ValueError("symbol count inconsistent with container size")

    off = 12
    psa_words = -(-psa_bits // 32)
    psa = _bits_from_u32(data[off:off + psa_words])[:psa_bits]
    off += psa_words
    if p.k_B and sb_bits > C_bits:
        raise ValueError(
            "v2 container header: region-B stream exceeds the seed "
            "capacity (corrupt header)"
        )
    p.psb_in_seed = min(psb_bits, C_bits - sb_bits) if p.k_B else 0
    rem_bits = psb_bits - p.psb_in_seed
    rem_words = -(-rem_bits // 32)
    p.psb_rem = _bits_from_u32(data[off:off + rem_words])[:rem_bits]
    off += rem_words
    p.stream_A = il2.unpack_words(data[off:], W, slen_A)
    p.states_A = unpack_states(psa, p.cfg).astype(state_dtype(p.cfg))
    return p


def _decode_region_a(states, stream, n: int, cdf, cfg: LaneConfig, device):
    """Region-A decode returning (symbols, final lane states).  JAX
    counterpart: ``constriction_tpu.ops.framing._decode_region_a``."""
    if kernel_eligible(cfg):
        return decode_lanes(states, stream, n, cdf, cfg, device)
    return il2.decode_shared_cdf(states, stream, n, cdf, cfg,
                                 return_final_states=True)


def _decode_region_b(p: ParsedV2, fin_states, cdf) -> np.ndarray:
    """Recover region B from region A's final lane states and decode it on
    the host coder.  JAX counterpart:
    ``constriction_tpu.ops.framing._decode_region_b``."""
    W, S, P = p.cfg.word_bits, p.cfg.state_bits, p.cfg.precision
    payload = _payload_from_seeds(fin_states, p.cfg)
    sb_bits = p.slen_B * W
    stream_B = _bits_to_stream(payload, W, p.slen_B)
    psb = np.concatenate([payload[sb_bits:sb_bits + p.psb_in_seed],
                          p.psb_rem])
    cfg_B = LaneConfig(num_lanes=p.L_B, word_bits=W, state_bits=S,
                       precision=P)
    states_B = unpack_states(psb, cfg_B).astype(state_dtype(cfg_B))
    return il2.decode_shared_cdf(states_B, stream_B, p.k_B, cdf, cfg_B)


def decode_iid_v2(data, cdf, device="cuda") -> np.ndarray:
    """Decode a v2 container.  JAX counterpart:
    ``constriction_tpu.ops.framing.decode_iid_v2(..., device=True)``."""
    p = parse_v2(data)
    if p.n_A > 0:
        out_A, fin = _decode_region_a(
            p.states_A, p.stream_A, p.n_A, cdf, p.cfg, device
        )
    else:
        out_A, fin = np.zeros(0, np.int32), p.states_A
    if p.k_B == 0:
        return out_A
    return np.concatenate([out_A, _decode_region_b(p, fin, cdf)])


def build_checkpoints_v2(data, cdf, interval: int):
    """Periodic decoder snapshots over a v2 container's region A (region B
    is a short tail decoded from recovered seeds; seeks land in A).
    Returns ``(offsets, states)`` as ``interleaved2.build_checkpoints``.
    JAX counterpart: ``constriction_tpu.ops.framing.build_checkpoints_v2``."""
    p = parse_v2(data)
    return il2.build_checkpoints(p.states_A, p.stream_A, p.n_A, cdf, p.cfg,
                                 interval)


def decode_from_checkpoint_v2(data, cdf, interval: int, ckpt_index: int,
                              offsets, states, device="cuda"):
    """Decode a v2 container's suffix from checkpoint ``ckpt_index``
    (symbol ``(ckpt_index + 1) * interval * L``); the recovered-seed tail
    (region B) is decoded and appended, so the suffix runs to the end of
    the message.  Returns ``(start_symbol, suffix)``, equal to that slice of
    :func:`decode_iid_v2`.  JAX counterpart:
    ``constriction_tpu.ops.framing.decode_from_checkpoint_v2(...,
    device=True)``."""
    p = parse_v2(data)
    start = (ckpt_index + 1) * interval * p.cfg.num_lanes
    remaining = p.n_A - start
    if remaining <= 0:
        raise ValueError(
            f"checkpoint {ckpt_index} starts at symbol {start}, beyond "
            f"region A ({p.n_A} symbols); decode the tail with decode_iid_v2"
        )
    sub_stream = p.stream_A[int(offsets[ckpt_index]):]
    out_A, fin = _decode_region_a(np.asarray(states[ckpt_index]), sub_stream,
                                  remaining, cdf, p.cfg, device)
    if p.k_B == 0:
        return start, out_A
    return start, np.concatenate([out_A, _decode_region_b(p, fin, cdf)])


def container_version(data) -> int:
    """Version of an ILANS2 container (1 or 2).  JAX counterpart:
    ``constriction_tpu.ops.framing.container_version``."""
    data = np.asarray(data, dtype=np.uint32)
    if len(data) < 2 or int(data[0]) != MAGIC2:
        raise ValueError("not an ILANS2 container")
    return int(data[1])


def peek_cfg(data) -> LaneConfig:
    """LaneConfig from a container header of either version, without
    parsing the payload.  JAX counterpart:
    ``constriction_tpu.ops.framing.peek_cfg``."""
    data = np.asarray(data, dtype=np.uint32)
    if len(data) < 6 or int(data[0]) != MAGIC2:
        raise ValueError("not an ILANS2 container")
    flags = int(data[2])
    return LaneConfig(
        num_lanes=int(data[5]), word_bits=flags & 0xFF,
        state_bits=(flags >> 16) & 0xFF, precision=(flags >> 8) & 0xFF,
    )
