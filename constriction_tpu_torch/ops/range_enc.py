"""ILANS2-R range encoding on the GPU: both presets, two phases.

The counterpart of ``constriction_tpu/ops/pallas_range_enc.py``.  A range
coder's deferred carries are big-number arithmetic: every emitted word is a
base-2^W digit of an unbounded ``lower``, and a wrap of the S-bit lower
adds +1 to the digits emitted so far.  So the encoder runs in two phases:

- **phase A** (:func:`record`): per lane, the interval updates forward in
  time, recording per (step, lane) the provisional renorm word, the renorm
  flag and the carry flag, and the final (lower, range);
- **the seal** (:func:`seal32`, :func:`seal64_limbs`): closed-form per lane,
  the last word and the last carry;
- **phase B** (:func:`resolve`): backward in time, a pending +1 per lane
  resolves the carries, and a 2-deep delay line places each lane's words
  (its first two words form the point header) in the shared stream, step
  by step, lanes ascending.  A lane's carry chain reads only its own
  records, and the renorm flag that places a word is already in them, so
  at both presets the card runs it as a lane pass (:func:`resolve_lanes`:
  dense words and renorm ballots) and the encoders' row-major compaction
  (``coder.compact_pass``).

The wrappers launch the kernels of ``csrc/ilans2_range.cu`` for CUDA
tensors, the seal running between the two launches on the device; CPU
tensors run the plain PyTorch twins (``*_plain``); any other device raises.

Tensor layout (constriction_tpu_torch/convert.py): symbols int32, CDFs
int64, stream words int32 holding u32 bits; points and the final (lower,
range) planes int32 (u32 bits) at S=32 and int64 (u64 bits) at S=64.  A
record is one word of the state's width: bits [0, W) the provisional word,
bit W the renorm flag, bit W + 1 the carry.
"""

from __future__ import annotations

import torch

from .. import convert
from . import _build
from .coder import (
    _check,
    _check_cdf_arg,
    _check_cfg,
    _emit_words,
    compaction_scratch,
    _num_steps,
    _on_cuda,
    _symbol_tables,
    flag_ballots,
    trim,
)
from .coder64 import _add64, _mul_small, _shr64
from .interleaved import LaneConfig

# kernel launches made by this module's wrappers (never by the twins); phase
# B's lane pass launched alone (resolve_lanes, either preset) counts under
# its own key
LAUNCHES = {"record": 0, "resolve": 0, "record64": 0, "resolve64": 0,
            "resolve_lanes": 0}

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the seal, one rule for numpy and torch
# ---------------------------------------------------------------------------


def seal32(xp, low_f, rng_f, S: int, W: int):
    """``(s0, seal_carry)`` from the final (lower, range) planes at S=32:
    point = lower + (2^(S-W) - 1) mod 2^32, whose wrap is the seal's +1
    event; the seal's word is point >> (S-W).  Untouched lanes (range
    still 2^32 - 1: no symbol coded) seal to 0 with carry 0.  ``xp`` is
    numpy (u32 or u64 arrays) or torch (int64 tensors of u32 values); the
    results have the inputs' type.  JAX counterpart:
    ``pallas_range_enc.seal32``."""
    zero = xp.zeros_like(low_f)
    touched = rng_f != _M32
    point = (low_f + ((1 << (S - W)) - 1)) & _M32
    seal_carry = xp.where(touched & (point < low_f), zero + 1, zero)
    s0 = xp.where(touched, point >> (S - W), zero)
    return s0, seal_carry


def seal64_limbs(xp, lhi, llo, rhi, rlo):
    """``(s0, seal_carry)`` at S=64, W=32 from the u32 halves of the final
    (lower, range) planes: point = lower + (2^32 - 1), the low half's wrap
    carries into the high half, whose own wrap is the seal's +1 event; the
    seal's word is the high half.  Untouched lanes seal to 0 with carry 0.
    ``xp`` as in :func:`seal32`.  JAX counterpart:
    ``pallas_range_enc.seal64_limbs``."""
    zero = xp.zeros_like(lhi)
    touched = (rlo != _M32) | (rhi != _M32)
    plus = (llo + _M32) & _M32
    p_hi = (lhi + xp.where(plus < llo, zero + 1, zero)) & _M32
    s0 = xp.where(touched, p_hi, zero)
    seal_carry = xp.where(touched & (p_hi < lhi), zero + 1, zero)
    return s0, seal_carry


def seal(low_f, rng_f, cfg: LaneConfig):
    """The seal on the port's tensors (any device, no host round trip):
    final planes in the state layout -> ``(s0, seal_carry)`` int32."""
    if cfg.state_bits == 64:
        s0, c = seal64_limbs(torch, *convert.u64_halves(low_f),
                             *convert.u64_halves(rng_f))
    else:
        s0, c = seal32(torch, convert.u32_values(low_f),
                       convert.u32_values(rng_f), 32, cfg.word_bits)
    return convert.u32_bits(s0), convert.u32_bits(c)


# ---------------------------------------------------------------------------
# phase A
# ---------------------------------------------------------------------------


def _preset(cfg: LaneConfig):
    """(state dtype, kernel tag, LAUNCHES suffix) of a config the kernels
    take; raises for any other."""
    if cfg.state_bits == 64:
        _check_cfg(cfg, 32, 64, 24)
        return torch.int64, "w32s64", "64"
    _check_cfg(cfg, 16, 32, 16)
    return torch.int32, "w16s32", ""


def _check_symbols(symbols, cdf, values: bool = True) -> None:
    """The symbols' and the CDF's tensors; with ``values`` also the
    symbols' range (one read-back from a card)."""
    if not isinstance(symbols, torch.Tensor):
        raise TypeError("symbols must be a torch.Tensor")
    _check("symbols", symbols, torch.int32, symbols.device)
    _check_cdf_arg(cdf, symbols.device)
    K = cdf.numel() - 1
    if values and symbols.numel() and bool(
            ((symbols < 0) | (symbols >= K)).any()):
        raise ValueError(
            f"symbols must be in [0, {K}), got range "
            f"[{int(symbols.min())}, {int(symbols.max())}]"
        )


def record(symbols, cdf, cfg: LaneConfig):
    """Phase A: ``(records [T*L], low_f [L], rng_f [L])`` in the state
    layout (module docstring).  JAX counterpart:
    ``pallas_range_enc._range_record_kernel`` / ``_range_record_kernel64``.
    CUDA tensors launch the kernel, which walks the steps as
    :func:`record_tiles_plain` does at :func:`record_geometry`'s depth; CPU
    tensors run :func:`record_plain`."""
    _preset(cfg)
    _check_symbols(symbols, cdf)
    return _record(symbols, cdf, cfg)


def _record(symbols, cdf, cfg: LaneConfig):
    """:func:`record` past its checks."""
    dtype, tag, suffix = _preset(cfg)
    if not _on_cuda(symbols.device):
        return record_plain(symbols, cdf, cfg)
    L, n = cfg.num_lanes, symbols.numel()
    device = symbols.device
    records = torch.empty(_num_steps(n, L) * L, dtype=dtype, device=device)
    low_f = torch.zeros(L, dtype=dtype, device=device)
    rng_f = torch.full((L,), -1, dtype=dtype, device=device)
    if n:
        LAUNCHES["record" + suffix] += 1
        cdf32 = cdf.to(torch.int32)
        _build.call(
            f"ctt_ilans2_range_record_{tag}", device, symbols, n, cdf32,
            cdf32.numel() - 1, records, low_f, rng_f, L, cfg.precision,
        )
    return records, low_f, rng_f


def record_geometry(cfg: LaneConfig, K: int, device=None) -> dict:
    """Phase A's launch shape on ``device`` (a CUDA device; the current one
    by default) for ``cfg``'s lanes and K symbols: lanes a block, blocks,
    ``depth`` (the steps of symbols a lane has in flight, in registers),
    dynamic shared-memory bytes and whether the CDF is in shared memory."""
    _preset(cfg)
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.zeros(5, dtype=torch.int64)
    _build.call("ctt_ilans2_range_record_geometry", device, cfg.num_lanes, K,
                out)
    keys = ("lanes_per_block", "blocks", "depth", "smem_bytes",
            "cdf_in_smem")
    return dict(zip(keys, (int(v) for v in out)))


class _Lanes:
    """Every lane's (lower, range) as u32 halves in int64 tensors (S=32
    uses the low halves only) and one step of phase A over them."""

    def __init__(self, cfg: LaneConfig, device):
        L = cfg.num_lanes
        self.S, self.W, self.P = cfg.state_bits, cfg.word_bits, cfg.precision
        zeros = torch.zeros(L, dtype=torch.int64, device=device)
        ones = torch.full((L,), _M32, dtype=torch.int64, device=device)
        self.l_hi, self.l_lo, self.r_hi, self.r_lo = zeros, zeros, ones, ones

    def step(self, cum, prob, active):
        """One step on the lanes where ``active``; returns its records
        (int64, 0 on the other lanes, which stay as they are)."""
        S, W, P = self.S, self.W, self.P
        l_hi, l_lo, r_hi, r_lo = self.l_hi, self.l_lo, self.r_hi, self.r_lo
        zeros = torch.zeros_like(l_lo)
        if S == 64:
            s_hi, s_lo = _shr64(r_hi, r_lo, P)
            n_hi, n_lo, carry = _add64(l_hi, l_lo,
                                       *_mul_small(s_hi, s_lo, cum))
            g_hi, g_lo = _mul_small(s_hi, s_lo, prob)
        else:
            scale = r_lo >> P
            total = l_lo + scale * cum
            n_hi, n_lo, carry = zeros, total & _M32, total >> 32
            g_hi, g_lo = zeros, scale * prob
        carry = torch.where(active, carry, 0)
        l_hi = torch.where(active, n_hi, l_hi)
        l_lo = torch.where(active, n_lo, l_lo)
        r_hi = torch.where(active, g_hi, r_hi)
        r_lo = torch.where(active, g_lo, r_lo)
        if S == 64:  # range < 2^32 <=> hi == 0
            m = active & (r_hi == 0)
            word = l_hi
            l_hi, l_lo = torch.where(m, l_lo, l_hi), torch.where(m, 0, l_lo)
            r_hi, r_lo = torch.where(m, r_lo, r_hi), torch.where(m, 0, r_lo)
        else:
            m = active & (r_lo < 1 << (S - W))
            word = l_lo >> (S - W)
            l_lo = torch.where(m, (l_lo << W) & _M32, l_lo)
            r_lo = torch.where(m, r_lo << W, r_lo)
        self.l_hi, self.l_lo, self.r_hi, self.r_lo = l_hi, l_lo, r_hi, r_lo
        return torch.where(m, word | (1 << W), 0) | (carry << (W + 1))

    def result(self, recs):
        """``(records, low_f, rng_f)`` in the state layout."""
        if self.S == 64:
            return (recs, convert.u64_join(self.l_hi, self.l_lo),
                    convert.u64_join(self.r_hi, self.r_lo))
        return (recs.to(torch.int32), convert.u32_bits(self.l_lo),
                convert.u32_bits(self.r_lo))


def record_plain(symbols, cdf, cfg: LaneConfig):
    """Plain PyTorch twin of :func:`record` (any device, no checks); S=64
    on (hi, lo) halves."""
    L = cfg.num_lanes
    device = symbols.device
    n = symbols.numel()
    T = _num_steps(n, L)
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1
    lanes = torch.arange(L, device=device)
    recs = torch.empty(T * L, dtype=torch.int64, device=device)
    state = _Lanes(cfg, device)
    for t in range(T):
        i = t * L + lanes
        cum, prob = _symbol_tables(symbols, cdf64, i, n, K)
        recs[t * L:(t + 1) * L] = state.step(cum, prob, i < n)
    return state.result(recs)


def record_tiles_plain(symbols, cdf, cfg: LaneConfig, depth: int):
    """Phase A walked as the kernel walks it (any device, no checks), with
    the result of :func:`record_plain`: the steps in tiles of ``depth``,
    each tile's symbols read as one [depth, L] block before its steps run
    (the kernel's lanes hold ``depth`` steps of symbols in flight).  A step
    row that lies wholly below n comes from the block; the rest (the
    partial last step, all of it when n < L) is read lane by lane, 0 past
    n, and its lanes past n stay as they are with record 0."""
    L = cfg.num_lanes
    device = symbols.device
    n = symbols.numel()
    T = _num_steps(n, L)
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1
    lanes = torch.arange(L, device=device)
    recs = torch.empty(T * L, dtype=torch.int64, device=device)
    state = _Lanes(cfg, device)
    whole = n // L  # step rows wholly below n
    for t0 in range(0, T, depth):
        rows = min(depth, T - t0)
        tile = torch.zeros(rows, L, dtype=torch.int64, device=device)
        k = max(0, min(rows, whole - t0))
        tile[:k] = symbols[t0 * L:(t0 + k) * L].reshape(k, L)
        for j in range(rows):
            i = (t0 + j) * L + lanes
            active = i < n
            s = tile[j] if j < k else torch.where(
                active, symbols[i.clamp(max=n - 1)].to(torch.int64), 0)
            s = torch.where((s < 0) | (s >= K), K - 1, s)
            cum = cdf64[s]
            recs[(t0 + j) * L:(t0 + j + 1) * L] = state.step(
                cum, cdf64[s + 1] - cum, active)
    return state.result(recs)


# ---------------------------------------------------------------------------
# phase B
# ---------------------------------------------------------------------------


def _resolve_args(records, s0, seal_carry, cfg: LaneConfig, n: int):
    """Checks phase B's arguments; returns (state dtype, kernel tag,
    LAUNCHES suffix, T)."""
    dtype, tag, suffix = _preset(cfg)
    L = cfg.num_lanes
    device = records.device
    _check("records", records, dtype, device)
    _check("s0", s0, torch.int32, device, L)
    _check("seal_carry", seal_carry, torch.int32, device, L)
    T = _num_steps(n, L)
    if records.numel() != T * L:
        raise ValueError(f"records must have {T * L} entries for n={n}, "
                         f"got {records.numel()}")
    return dtype, tag, suffix, T


def resolve(records, s0, seal_carry, cfg: LaneConfig, n: int):
    """Phase B: resolve the carries and place the words.  ``records`` from
    :func:`record`, ``(s0, seal_carry)`` from :func:`seal`, ``n`` the
    message length.  Returns ``(points [L], stream int32[num_words])``.
    JAX counterpart: ``pallas_range_enc._range_resolve_kernel`` /
    ``_range_resolve_kernel64``.  CUDA tensors launch the lane pass and
    the compaction in one C call (their scratch: the dense words, the
    ballots and the compaction's block offsets), reading the stream's
    start back (one sync); CPU tensors run :func:`resolve_plain`."""
    _resolve_args(records, s0, seal_carry, cfg, n)
    if not _on_cuda(records.device):
        return resolve_plain(records, s0, seal_carry, cfg, n)
    points, buf, end = _resolve(records, s0, seal_carry, cfg, n)
    return points, trim(buf, end)


def _resolve(records, s0, seal_carry, cfg: LaneConfig, n: int):
    """Phase B on the card as a launch form (records on a CUDA device):
    ``(points, buf, end int64[1])``, the stream ``buf[end:]``, nothing read
    back; no checks."""
    dtype, tag, suffix = _preset(cfg)
    L = cfg.num_lanes
    T = _num_steps(n, L)
    device = records.device
    points = torch.zeros(L, dtype=dtype, device=device)
    end = torch.zeros(1, dtype=torch.int64, device=device)
    if T == 0:
        return points, torch.zeros(0, dtype=torch.int32, device=device), end
    buf = torch.empty(n, dtype=torch.int32, device=device)
    _build.call(
        f"ctt_ilans2_range_resolve_{tag}", device, records, s0, seal_carry,
        buf, n, end, points, *compaction_scratch(T, L, device), L, T,
    )
    LAUNCHES["resolve" + suffix] += 1
    return points, buf, end


def resolve_lanes(records, s0, seal_carry, cfg: LaneConfig, n: int):
    """Phase B's lane pass alone, at either preset (its arguments and
    checks, n > 0): ``(words int32[T, L], ballots int32[T, L / 32],
    points [L])``, row t holding step t's resolved words and renorm
    ballots, the points in the state layout; the compaction
    (``coder.compact_pass``) of the two is :func:`resolve`'s stream.  On
    the card the words of lanes that do not renorm are left unwritten; a
    CPU tensor runs :func:`resolve_lanes_plain` and packs its flags with
    ``coder.flag_ballots``."""
    dtype, tag, _, T = _resolve_args(records, s0, seal_carry, cfg, n)
    L = cfg.num_lanes
    device = records.device
    if not _on_cuda(device):
        words, flags, points = resolve_lanes_plain(records, s0, seal_carry,
                                                   cfg, n)
        return words, flag_ballots(flags), points
    words = torch.empty(T, L, dtype=torch.int32, device=device)
    ballots = torch.empty(T, L // 32, dtype=torch.int32, device=device)
    points = torch.zeros(L, dtype=dtype, device=device)
    _build.call(f"ctt_ilans2_range_resolve_lanes_{tag}", device, records, s0,
                seal_carry, words, ballots, points, L, T)
    LAUNCHES["resolve_lanes"] += 1
    return words, ballots, points


def resolve_lanes_plain(records, s0, seal_carry, cfg: LaneConfig, n: int):
    """The lane pass of phase B in plain PyTorch (any device, either
    preset, no checks): each lane's pending carry and delay line through
    steps T-1 .. 0, vectorised over lanes, on its own records.  Returns
    ``(words int32[T, L], flags bool[T, L], points)``: row t holds step
    t's resolved words (0 where a lane does not renorm) and renorm flags,
    so the row-major compaction (``coder.compact_pass_plain``) lays the
    stream out step 0 first, lanes ascending in a step, as
    :func:`resolve_plain` does."""
    L, W = cfg.num_lanes, cfg.word_bits
    device = records.device
    T = _num_steps(n, L)
    recs = records.to(torch.int64).reshape(T, L)
    wmask = (1 << W) - 1
    p = convert.u32_values(seal_carry)
    d1 = convert.u32_values(s0)
    d2 = torch.zeros(L, dtype=torch.int64, device=device)
    words = torch.zeros(T, L, dtype=torch.int64, device=device)
    flags = torch.zeros(T, L, dtype=torch.bool, device=device)
    for t in range(T - 1, -1, -1):
        rec = recs[t]
        m = ((rec >> W) & 1) == 1
        vfull = (rec & wmask) + p
        words[t] = torch.where(m, d2, 0)  # the word resolved two later
        flags[t] = m
        p = torch.where(m, vfull >> W, p) + ((rec >> (W + 1)) & 1)
        d2 = torch.where(m, d1, d2)
        d1 = torch.where(m, vfull & wmask, d1)
    return convert.u32_bits(words), flags, _points(d1, d2, cfg)


def _points(d1, d2, cfg: LaneConfig):
    """The point header of each lane from its first two resolved words."""
    if cfg.state_bits == 64:
        return convert.u64_join(d1, d2)
    return convert.u32_bits((d1 << cfg.word_bits) | d2)


def resolve_plain(records, s0, seal_carry, cfg: LaneConfig, n: int):
    """Plain PyTorch twin of :func:`resolve` (any device, no checks)."""
    L, W = cfg.num_lanes, cfg.word_bits
    device = records.device
    recs = records.to(torch.int64)
    wmask = (1 << W) - 1
    p = convert.u32_values(seal_carry)
    d1 = convert.u32_values(s0)
    d2 = torch.zeros(L, dtype=torch.int64, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(_num_steps(n, L) - 1, -1, -1):
        rec = recs[t * L:(t + 1) * L]
        m = ((rec >> W) & 1) == 1
        vfull = (rec & wmask) + p
        e = _emit_words(buf, m, d2, e, n)  # the word resolved two later
        p = torch.where(m, vfull >> W, p) + ((rec >> (W + 1)) & 1)
        d2 = torch.where(m, d1, d2)
        d1 = torch.where(m, vfull & wmask, d1)
    return _points(d1, d2, cfg), convert.u32_bits(buf[int(e):n])


# ---------------------------------------------------------------------------
# the encoders
# ---------------------------------------------------------------------------


def _encode(symbols, cdf, cfg: LaneConfig):
    _check_symbols(symbols, cdf)
    points, buf, end = launch_encode(symbols, cdf, cfg)
    return points, trim(buf, end)


def launch_encode(symbols, cdf, cfg: LaneConfig):
    """:func:`encode_iid_range` or :func:`encode_iid_range64` (by ``cfg``)
    as a launch form: record, seal and resolve, ``(points, buf, end
    int64[1])`` with the stream ``buf[end:]`` (``coder.trim``).  It reads
    nothing back, so the symbols' range is not checked: the caller checks
    it on the host.  CPU tensors run :func:`encode_iid_range_plain`, with
    end 0."""
    _preset(cfg)
    _check_symbols(symbols, cdf, values=False)
    if not _on_cuda(symbols.device):
        points, stream = encode_iid_range_plain(symbols, cdf, cfg)
        return points, stream, torch.zeros(1, dtype=torch.int64)
    records, low_f, rng_f = _record(symbols, cdf, cfg)
    s0, seal_carry = seal(low_f, rng_f, cfg)
    return _resolve(records, s0, seal_carry, cfg, symbols.numel())


def encode_iid_range(symbols, cdf, cfg: LaneConfig):
    """Range-code i.i.d. categorical symbols into ILANS2-R (W=16, S=32,
    P <= 16).  JAX counterpart:
    ``constriction_tpu.ops.pallas_range_enc.encode_iid_range_pallas``.

    ``symbols`` int32[n] in [0, K) (others raise ValueError) and ``cdf``
    int64[K+1] on one device.  Returns ``(points int32[L], stream
    int32[num_words])``: u32 points and W-bit words.  CUDA tensors launch
    the phase-A and phase-B kernels, CPU tensors run
    :func:`encode_iid_range_plain`."""
    _check_cfg(cfg, 16, 32, 16)
    return _encode(symbols, cdf, cfg)


def encode_iid_range_plain(symbols, cdf, cfg: LaneConfig):
    """Plain PyTorch twin of :func:`encode_iid_range` and
    :func:`encode_iid_range64` (any device, no checks).  Numpy oracle:
    ``interleaved2.encode_shared_range``."""
    records, low_f, rng_f = record_plain(symbols, cdf, cfg)
    s0, seal_carry = seal(low_f, rng_f, cfg)
    return resolve_plain(records, s0, seal_carry, cfg, symbols.numel())


def encode_iid_range64(symbols, cdf, cfg: LaneConfig):
    """Range-code i.i.d. categorical symbols into the DEFAULT-preset
    ILANS2-R64 format (W=32, S=64, P <= 24).  JAX counterpart:
    ``constriction_tpu.ops.pallas_range_enc.encode_iid_range64_pallas``.

    As :func:`encode_iid_range`, with ``points`` int64[L] (u64 bits)."""
    _check_cfg(cfg, 32, 64, 24)
    return _encode(symbols, cdf, cfg)


encode_iid_range64_plain = encode_iid_range_plain
