"""ILANS2 rANS and ILANS2-R range decoding at the small preset (W=16,
S=32, P <= 16) on the GPU.

The counterpart of the S=32 encode/decode pair and the range decoder of
``constriction_tpu/ops/pallas_coder.py``.  The wrappers here launch the
hand-written kernels of ``csrc/ilans2.cu`` and ``csrc/ilans2_range.cu`` for
CUDA tensors and run the plain PyTorch twins for CPU tensors; any other
device raises.  The twins
run the same step loop as the kernels with int64 tensors, and are also what
the kernels are held against on the card.

The rANS pair runs ``csrc/ilans2_wide.cuh``'s design at both presets: the
decode on a cluster of CTAs with the lane states in registers
(:func:`geometry` says which cluster the card runs for L lanes), the encode
as a lane-parallel pass and a row-major compaction.  The range decode runs
on the same cluster step at both presets (:func:`range_geometry`;
:func:`decode_range_lanes` is its lane form in Python integers).
:func:`lanes_pass32_plain` and :func:`compact_pass_plain` are those two
passes in plain PyTorch; the kernels' index math mirrors them, and their
composition is :func:`encode_iid_plain`'s stream.

The Pallas kernel's in-kernel helpers become, in GPU form:

- ``_refill_words`` / ``_ranks_flat`` / ``_expand_monotone_2d`` -> an
  exclusive scan of the refill mask plus an indexed read of the stream
  (:func:`_refill_words` here; a warp ballot plus a cluster-wide count in
  the kernel);
- ``_emit_words`` / ``_compact_monotone_2d`` -> an exclusive scan of the
  renorm mask plus an indexed write below the end pointer
  (:func:`_emit_words`; the encode kernel's pass B);
- ``_compare_sum_auto`` -> a binary search over the CDF with
  ``searchsorted(side="right") - 1`` semantics (a bucket table in front of
  it in the kernel);
- ``_cum_prob_from_sym`` -> two CDF reads; ``_exact_div`` -> integer
  division (a multiply-high by a per-symbol reciprocal in the kernel,
  :func:`division_magic32`).

Tensor layout (constriction_tpu_torch/convert.py): lane states, range
planes and stream words are int32 tensors holding u32 bits; CDFs are
int64; symbols int32.

The helpers below (argument checks, the scans, the launch glue, the
encode's pass B) are shared with the S=64 preset in
:mod:`constriction_tpu_torch.ops.coder64`.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from .. import convert
from . import _build
from .interleaved import LaneConfig

# kernel launches made by this module's wrappers (never by the twins); the
# encode's two passes launched alone (lanes_pass32, and compact_pass at
# either preset) count under their own keys
LAUNCHES = {"encode": 0, "decode": 0, "range_decode": 0, "encode_lanes": 0,
            "compact": 0}

# blocks of the encode's compaction pass at most: the length of its offsets
# scratch (csrc/ilans2_wide.cuh, kScanBlocks)
SCAN_BLOCKS = 1024
# the cluster decodes' reach (rANS and range at both presets, the S=64
# exact table decode): a cluster of 16 CTAs of 32 warps, 32 lanes a thread
# (csrc/ilans2_wide.cuh, plan_cluster)
MAX_DECODE_LANES = 16 * 32 * 32 * 32
_M32 = (1 << 32) - 1


# ---------------------------------------------------------------------------
# shared by both presets
# ---------------------------------------------------------------------------


def _num_steps(n: int, L: int) -> int:
    return -(-n // L) if n else 0


def _check_cfg(cfg: LaneConfig, W: int, S: int, max_p: int) -> None:
    if (cfg.word_bits, cfg.state_bits) != (W, S) or not (
        0 < cfg.precision <= max_p
    ):
        raise ValueError(
            f"this coder takes W={W}, S={S}, P<={max_p}; got W="
            f"{cfg.word_bits}, S={cfg.state_bits}, P={cfg.precision}"
        )
    if cfg.num_lanes <= 0 or cfg.num_lanes % 128:
        raise ValueError(
            f"num_lanes must be a positive multiple of 128, got "
            f"{cfg.num_lanes}"
        )


def _check(name: str, t, dtype: torch.dtype, device: torch.device,
           numel: int | None = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} must have {numel} entries, got {t.numel()}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _on_cuda(device: torch.device) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the twin); raises for any other device."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def _check_cdf_arg(cdf, device: torch.device) -> None:
    _check("cdf", cdf, torch.int64, device)
    if cdf.numel() < 2:
        raise ValueError("cdf needs at least 2 entries (one symbol)")


def _check_seeds(seeds, cfg: LaneConfig, dtype: torch.dtype,
                 device: torch.device, values: bool = True) -> None:
    """Same errors as ``interleaved2.encode_shared``; ``values`` checks the
    range of the seeds too (one read-back from a card)."""
    L, S, W = cfg.num_lanes, cfg.state_bits, cfg.word_bits
    if seeds.numel() != L:
        raise ValueError(f"seeds must have num_lanes={L} entries")
    _check("seeds", seeds, dtype, device)
    if not values:
        return
    if S > 32:  # int64 bits: below the floor 2^32 iff in [0, 2^32)
        bad = (seeds >= 0) & (seeds < 1 << (S - W))
    else:
        bad = convert.u32_values(seeds) < 1 << (S - W)
    if bool(bad.any()):
        raise ValueError("seeds must lie in [2^(S-W), 2^S)")


def _encode_args(symbols, cdf, cfg: LaneConfig, seeds, state_dtype,
                 seed_values: bool = True):
    """Validates the encoder's arguments (the seeds' range with
    ``seed_values``); returns the start states (a fresh tensor the coder
    may update in place)."""
    if not isinstance(symbols, torch.Tensor):
        raise TypeError("symbols must be a torch.Tensor")
    device = symbols.device
    _check("symbols", symbols, torch.int32, device)
    _check_cdf_arg(cdf, device)
    if seeds is not None:
        _check_seeds(seeds, cfg, state_dtype, device, seed_values)
        return seeds.clone()
    floor = 1 << (cfg.state_bits - cfg.word_bits)
    return torch.full((cfg.num_lanes,), floor, dtype=state_dtype,
                      device=device)


def _decode_args(states, stream, cdf, cfg: LaneConfig, state_dtype) -> None:
    if not isinstance(states, torch.Tensor):
        raise TypeError("states must be a torch.Tensor")
    device = states.device
    _check("states", states, state_dtype, device, cfg.num_lanes)
    _check("stream", stream, torch.int32, device)
    _check_cdf_arg(cdf, device)


def _check_cluster_args(states, stream, cdf, cfg: LaneConfig, cluster: int,
                        state_dtype) -> None:
    _decode_args(states, stream, cdf, cfg, state_dtype)
    if not _on_cuda(states.device):
        raise ValueError("a forced cluster size needs CUDA tensors")
    if not 1 <= cluster <= 16:
        raise ValueError(f"cluster must be in 1 .. 16, got {cluster}")


def _refill_words(m: torch.Tensor, words: torch.Tensor, base: torch.Tensor):
    """Decode-side refill: lane l with ``m[l]`` takes stream word ``base +
    rank_l`` (rank = exclusive prefix count of ``m``); reads past the end
    give 0.  Returns ``(per-lane words, next base)``."""
    mi = m.to(torch.int64)
    idx = base + torch.cumsum(mi, 0) - mi
    if words.numel() == 0:
        got = torch.zeros_like(idx)
    else:
        got = words[idx.clamp(0, words.numel() - 1)]
        got = torch.where(idx < words.numel(), got, 0)
    return got, base + mi.sum()


def _emit_words(buf: torch.Tensor, renorm: torch.Tensor, vals: torch.Tensor,
                e: torch.Tensor, cap: int) -> torch.Tensor:
    """Encode-side emission: the step's k renorming lanes write their words,
    in ascending lane order, to ``buf[e - k : e]``; the other lanes write
    the junk slot ``buf[cap]``.  Returns the new end pointer ``e - k``."""
    ri = renorm.to(torch.int64)
    e = e - ri.sum()
    pos = torch.where(renorm, e + torch.cumsum(ri, 0) - ri, cap)
    buf.scatter_(0, pos, vals)
    return e


def _symbol_tables(symbols, cdf64, i, n, K):
    """(cum, prob) of the symbols at flat indices ``i`` (clamped to the
    message); out-of-range symbols read as K-1, as in the kernel."""
    s = symbols[i.clamp(max=n - 1)].to(torch.int64)
    s = torch.where((s < 0) | (s >= K), K - 1, s)
    cum = cdf64[s]
    return cum, cdf64[s + 1] - cum


def _find_symbols(cdf64, q, K):
    """Quantile -> symbol: ``searchsorted(cdf, q, side="right") - 1``."""
    return (torch.searchsorted(cdf64, q, right=True) - 1).clamp(0, K - 1)


def _launch_decode(tag: str, states, stream, cdf, cfg: LaneConfig, n: int,
                   cluster: int = 0):
    """One launch of the cluster decode (``cluster`` CTAs, or the size it
    picks from L when 0); returns (symbols int32[n], final states).  Raises
    for an L past the cluster's reach."""
    L = cfg.num_lanes
    if L > MAX_DECODE_LANES:
        raise ValueError(
            f"the rANS decode kernel takes at most {MAX_DECODE_LANES} lanes "
            f"(16 CTAs x 1024 threads x 32 lanes a thread), got {L}"
        )
    device = states.device
    fin = states.clone()
    syms = torch.empty(n, dtype=torch.int32, device=device)
    cdf32 = cdf.to(torch.int32)
    entry, extra = ((f"ctt_ilans2_decode_cluster_{tag}", (cluster,))
                    if cluster else (f"ctt_ilans2_decode_{tag}", ()))
    _build.call(
        entry, device, fin, stream, stream.numel(), cdf32, cdf32.numel() - 1,
        syms, n, L, cfg.precision, *extra,
    )
    return syms, fin


def _records(cdf32, cfg: LaneConfig):
    """Scratch for the encode's K division records: 16 bytes each at S=64,
    8 at S=32 (csrc/ilans2_wide.cuh, DivisionRecord / DivisionRecord32)."""
    words = 4 if cfg.state_bits == 64 else 2
    return torch.empty(words * (cdf32.numel() - 1), dtype=torch.int32,
                       device=cdf32.device)


def compaction_scratch(T: int, L: int, device):
    """The scratch of a lane pass ahead of the compaction (pass B): dense
    words int32[T * L], ballots int32[T * L / 32] and the compaction's
    block offsets int64[SCAN_BLOCKS]."""
    return (torch.empty(T * L, dtype=torch.int32, device=device),
            torch.empty(T * L // 32, dtype=torch.int32, device=device),
            torch.empty(SCAN_BLOCKS, dtype=torch.int64, device=device))


def _launch_encode(tag: str, symbols, cdf, cfg: LaneConfig, states):
    """Both encode passes in one C call, coding into ``states`` in place;
    returns (final states, buf int32[n], end int64[1]), the stream
    ``buf[end:]`` (:func:`trim`).  The scratch: the dense words (T * L),
    the ballots (T * L / 32), the compaction's block offsets and each
    symbol's division record.  Reads nothing back."""
    device = symbols.device
    n, L = symbols.numel(), cfg.num_lanes
    T = _num_steps(n, L)
    buf = torch.empty(n, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int64, device=device)
    cdf32 = cdf.to(torch.int32)
    _build.call(
        f"ctt_ilans2_encode_{tag}", device, states, symbols, n, cdf32,
        cdf32.numel() - 1, buf, n, end, *compaction_scratch(T, L, device),
        _records(cdf32, cfg), L, cfg.precision,
    )
    return states, buf, end


def trim(buf, end):
    """The stream of a launch form's ``(buf, end)``: ``buf[end:]``.  Reads
    ``end`` back (one sync)."""
    return buf[int(end.item()):]


def _encode(tag: str, symbols, cdf, cfg: LaneConfig, seeds, state_dtype,
            seed_values: bool, plain, launches: dict):
    """The rANS encode of either preset as a launch form: ``(states, buf,
    end)`` on the symbols' device, the stream ``buf[end:]``, nothing read
    back but, with ``seed_values``, the seeds' range.  CPU tensors run the
    twin ``plain``, with end 0."""
    states = _encode_args(symbols, cdf, cfg, seeds, state_dtype, seed_values)
    device = symbols.device
    if not _on_cuda(device):
        states, stream = plain(symbols, cdf, cfg, seeds)
        return states, stream, torch.zeros(1, dtype=torch.int64)
    if symbols.numel() == 0:
        return (states, torch.zeros(0, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int64, device=device))
    launches["encode"] += 1
    return _launch_encode(tag, symbols, cdf, cfg, states)


def _launch_lanes(tag: str, symbols, cdf, cfg: LaneConfig, states):
    """Pass A alone, coding into ``states`` in place (n > 0): (words
    int32[T, L], ballots int32[T, L / 32])."""
    device = symbols.device
    n, L = symbols.numel(), cfg.num_lanes
    T = _num_steps(n, L)
    words = torch.empty(T, L, dtype=torch.int32, device=device)
    ballots = torch.empty(T, L // 32, dtype=torch.int32, device=device)
    cdf32 = cdf.to(torch.int32)
    _build.call(
        f"ctt_ilans2_encode_lanes_{tag}", device, states, symbols, n, cdf32,
        cdf32.numel() - 1, words, ballots, _records(cdf32, cfg), L,
        cfg.precision,
    )
    return words, ballots


_GEOMETRY_KEYS = ("cluster", "groups_per_cta", "lanes_per_thread",
                  "threads_per_cta", "max_active_clusters", "smem_bytes",
                  "cdf_in_smem", "lut_bits", "encode_blocks",
                  "encode_threads")


def _geometry(tag: str, L: int, K: int, P: int, device, cluster: int,
              entry: str = "ilans2_geometry", size: int = 10):
    """A cluster decode's launch geometry as the C entry ``ctt_{entry}_
    {tag}`` reports it (the rANS pair's by default: ``size`` 10 values,
    the decode's eight and the encode's grid)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.zeros(size, dtype=torch.int64)
    _build.call(f"ctt_{entry}_{tag}", device, L, K, P, cluster, out)
    geo = dict(zip(_GEOMETRY_KEYS, (int(v) for v in out)))
    geo["ctas"] = geo["cluster"]
    return geo


def compact_pass_plain(words, flags):
    """Pass B of the encoder in plain PyTorch (any device, either preset):
    the flagged words of ``words[T, L]`` (``flags`` bool[T, L]) in the
    decoder's consumption order, steps ascending and lanes ascending in a
    step.  The index math is the kernel's (``compact_*_kernel``): the flags
    of step t and 32-lane group g count c[t, g]; an exclusive scan of c in
    row-major order gives each group's offset, and lane j of the group
    lands at that offset plus the flagged lanes below j.  Returns
    int32[words]."""
    T, L = flags.shape
    f = flags.reshape(T * L // 32, 32).to(torch.int64)
    counts = f.sum(1)
    offsets = torch.cumsum(counts, 0) - counts
    below = torch.cumsum(f, 1) - f
    pos = (offsets[:, None] + below).reshape(-1)
    out = torch.zeros(int(counts.sum()), dtype=torch.int32,
                      device=words.device)
    sel = flags.reshape(-1)
    out[pos[sel]] = words.reshape(-1)[sel]
    return out


def flag_ballots(flags):
    """bool[T, L] renorm flags -> the kernel's int32[T, L / 32] ballots (bit
    j of group g: lane 32 g + j)."""
    T, L = flags.shape
    bits = flags.reshape(T, L // 32, 32).to(torch.int64) << torch.arange(
        32, device=flags.device)
    return convert.u32_bits(bits.sum(2))


def ballot_flags(ballots):
    """Inverse of :func:`flag_ballots`: int32[T, G] -> bool[T, 32 G]."""
    T, G = ballots.shape
    bits = (convert.u32_values(ballots)[..., None] >> torch.arange(
        32, device=ballots.device)) & 1
    return bits.reshape(T, G * 32).bool()


def compact_pass(words, ballots):
    """Pass B of the encoders alone (either preset): the stream of
    ``words`` int32[T, L] under ``ballots`` int32[T, L / 32] (T > 0).  A
    CPU tensor runs :func:`compact_pass_plain`."""
    if not _on_cuda(words.device):
        return compact_pass_plain(words, ballot_flags(ballots))
    device = words.device
    cap = words.numel()
    buf = torch.empty(cap, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int64, device=device)
    offsets = torch.empty(SCAN_BLOCKS, dtype=torch.int64, device=device)
    LAUNCHES["compact"] += 1
    _build.call("ctt_ilans2_compact", device, ballots, words, ballots.numel(),
                buf, cap, end, offsets)
    return buf[int(end.item()):]


def _range_decode_args(points, stream, cdf, cfg: LaneConfig, lows, rngs,
                       state_dtype):
    """Validates the range decoder's arguments; returns fresh initial
    (lows, rngs, pts) planes the coder may update in place: lower 0 and
    range 2^S - 1 unless a checkpoint's planes are given."""
    if not isinstance(points, torch.Tensor):
        raise TypeError("points must be a torch.Tensor")
    device = points.device
    L = cfg.num_lanes
    _check("points", points, state_dtype, device, L)
    _check("stream", stream, torch.int32, device)
    _check_cdf_arg(cdf, device)
    if (lows is None) != (rngs is None):
        raise ValueError("lows and rngs are given together or not at all")
    if lows is None:
        lows = torch.zeros(L, dtype=state_dtype, device=device)
        rngs = torch.full((L,), -1, dtype=state_dtype, device=device)
    else:
        _check("lows", lows, state_dtype, device, L)
        _check("rngs", rngs, state_dtype, device, L)
    return lows.clone(), rngs.clone(), points.clone()


def _raise_if_invalid(first_bad: int, n: int) -> None:
    """The host oracle's error for a quantile >= 2^P at symbol
    ``first_bad`` (no error when it is n)."""
    if first_bad < n:
        raise ValueError(
            "Tried to decode data that is inconsistent with the entropy "
            f"model (quantile >= 2**precision at symbol {first_bad})."
        )


def _launch_range_decode(tag: str, planes, stream, cdf, cfg: LaneConfig,
                         n: int, cluster: int = 0):
    """One range-decode launch updating ``planes`` (lows, rngs, pts) in
    place; returns (symbols int32[n], flag int64[1]): the flag holds the
    first symbol whose quantile was >= 2^P, or n.  Reads nothing back.  Both presets run the cluster decode (a
    ValueError for an L past its reach): ``cluster`` CTAs, or the size it
    picks from L when 0."""
    device = stream.device
    L = cfg.num_lanes
    if L > MAX_DECODE_LANES:
        raise ValueError(
            f"the range decode kernel takes at most {MAX_DECODE_LANES} lanes "
            f"(16 CTAs x 1024 threads x 32 lanes a thread), got {L}"
        )
    syms = torch.empty(n, dtype=torch.int32, device=device)
    bad = torch.full((1,), n, dtype=torch.int64, device=device)
    cdf32 = cdf.to(torch.int32)
    entry, extra = ((f"ctt_ilans2_range_decode_cluster_{tag}", (cluster,))
                    if cluster else (f"ctt_ilans2_range_decode_{tag}", ()))
    _build.call(
        entry, device, *planes, stream, stream.numel(), cdf32,
        cdf32.numel() - 1, syms, n, L, cfg.precision, bad, *extra,
    )
    return syms, bad


def _range_decode(tag: str, points, stream, cdf, cfg: LaneConfig, n: int,
                  lows, rngs, state_dtype, steps, launches: dict):
    """The range decode of either preset as a launch form: (symbols
    int32[n], flag int64[1], final (lows, rngs, pts)), nothing read back.
    CPU tensors run the twin's ``steps``."""
    planes = _range_decode_args(points, stream, cdf, cfg, lows, rngs,
                                state_dtype)
    device = points.device
    if not _on_cuda(device):
        syms, planes, bad = steps(points, stream, cdf, cfg, n, lows, rngs)
        return syms, bad.reshape(1), planes
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=device),
                torch.zeros(1, dtype=torch.int64, device=device), planes)
    syms, bad = _launch_range_decode(tag, planes, stream, cdf, cfg, n)
    launches["range_decode"] += 1
    return syms, bad, planes


# ---------------------------------------------------------------------------
# W=16 / S=32
# ---------------------------------------------------------------------------


def encode_iid(symbols, cdf, cfg: LaneConfig, seeds=None):
    """Encode i.i.d. categorical symbols into the ILANS2 format (W=16,
    S=32, P <= 16).  JAX counterpart:
    ``constriction_tpu.ops.pallas_coder.encode_iid_pallas``.

    ``symbols`` int32[n] and ``cdf`` int64[K+1] on one device; ``seeds``
    (optional, int32[L] holding u32 start states in [2^16, 2^32)).  Returns
    ``(states int32[L], stream int32[num_words])``: the decoder's initial
    states and the W-bit words, one per element.  CUDA tensors launch the
    kernel, CPU tensors run :func:`encode_iid_plain`."""
    _check_cfg(cfg, 16, 32, 16)
    states, buf, end = _encode("w16s32", symbols, cdf, cfg, seeds,
                               torch.int32, True, encode_iid_plain, LAUNCHES)
    return states, trim(buf, end)


def launch_encode_iid(symbols, cdf, cfg: LaneConfig, seeds=None):
    """:func:`encode_iid` as a launch form: ``(states int32[L], buf, end
    int64[1])`` on the symbols' device, the stream ``buf[end:]``
    (:func:`trim`).  It reads nothing back, so the seeds' range is not
    checked: the caller checks it on the host
    (``interleaved2.check_seeds``).  CPU tensors run
    :func:`encode_iid_plain`, with end 0."""
    _check_cfg(cfg, 16, 32, 16)
    return _encode("w16s32", symbols, cdf, cfg, seeds, torch.int32, False,
                   encode_iid_plain, LAUNCHES)


def encode_iid_plain(symbols, cdf, cfg: LaneConfig, seeds=None):
    """Plain PyTorch twin of :func:`encode_iid` (any device, no checks).
    JAX counterpart: ``constriction_tpu.ops.pallas_coder.encode_iid_pallas``;
    numpy oracle ``interleaved2.encode_shared``."""
    n = symbols.numel()
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1

    def tables_at(i):
        return _symbol_tables(symbols, cdf64, i, n, K)

    return encode32_steps(tables_at, n, cfg, seeds, symbols.device)


def encode32_steps(tables_at, n: int, cfg: LaneConfig, seeds, device):
    """The S=32 encoder's step loop, steps T-1 .. 0: ``tables_at(i)`` gives
    the (cum, prob) int64 of the flat symbol indices ``i`` (one step's
    lanes; indices past n are masked).  Shared by the categorical twin
    above and the exact-family planes twin
    (``exact_family.encode_tables_plain``).  ``seeds`` optional
    int32[L] (u32 bits).  Returns ``(states int32[L], stream int32)``."""
    L = cfg.num_lanes
    x = _start_states32(seeds, cfg, device)
    lanes = torch.arange(L, device=device)
    buf = torch.zeros(n + 1, dtype=torch.int64, device=device)
    e = torch.tensor(n, dtype=torch.int64, device=device)
    for t in range(_num_steps(n, L) - 1, -1, -1):
        i = t * L + lanes
        active = i < n
        cum, prob = tables_at(i)
        prob = torch.where(active, prob, 1)
        renorm = _renorms32(x, prob, active, cfg)
        e = _emit_words(buf, renorm, x & cfg.word_mask, e, n)
        x = _code32(x, cum, prob, active, renorm, cfg)
    return convert.u32_bits(x), convert.u32_bits(buf[int(e):n])


def _start_states32(seeds, cfg: LaneConfig, device):
    """The encoder's start states as int64 values: the seeds, or the floor
    2^16."""
    if seeds is not None:
        return convert.u32_values(seeds)
    return torch.full((cfg.num_lanes,), 1 << (cfg.state_bits - cfg.word_bits),
                      dtype=torch.int64, device=device)


def _renorms32(x, prob, active, cfg: LaneConfig):
    """The lanes that emit a word before coding: state >> (S - P) >= prob."""
    return active & ((x >> (cfg.state_bits - cfg.precision)) >= prob)


def _code32(x, cum, prob, active, renorm, cfg: LaneConfig):
    """One encode step: renorming lanes drop their low word, then active
    lanes take (state // prob) << P | (cum + state % prob)."""
    x = torch.where(renorm, x >> cfg.word_bits, x)
    return torch.where(active,
                       ((x // prob) << cfg.precision) | (cum + x % prob), x)


def lanes_pass32_plain(symbols, cdf, cfg: LaneConfig, seeds=None):
    """Pass A of the S=32 encoder in plain PyTorch (any device, no checks):
    every lane runs steps T-1 .. 0 on its own.  Returns ``(words int32[T,
    L], flags bool[T, L], states int32[L])``: ``flags[t, l]`` is set where
    lane l renorms at step t, before coding symbol t * L + l, and
    ``words[t, l]`` is then the 16-bit word it emits (0 elsewhere);
    ``states`` are the final states.  Lanes of a partial last step neither
    code nor flag.  The kernel (``csrc/ilans2_wide.cuh``,
    ``encode_lanes_kernel<16, 32, ...>``) keeps ``flags`` as one ballot per
    32 lanes (:func:`flag_ballots`)."""
    n = symbols.numel()
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1

    def tables_at(i):
        return _symbol_tables(symbols, cdf64, i, n, K)

    return lanes32_steps(tables_at, n, cfg, seeds, symbols.device)


def lanes32_steps(tables_at, n: int, cfg: LaneConfig, seeds, device):
    """Pass A's step loop at S=32, ``tables_at`` as in
    :func:`encode32_steps`.  Shared by :func:`lanes_pass32_plain` and the
    exact-family planes pass (``exact_family.encode_lanes_plain``, kernel
    14's pass A).  Returns ``(words int32[T, L], flags bool[T, L], states
    int32[L])`` as :func:`lanes_pass32_plain` does."""
    L = cfg.num_lanes
    T = _num_steps(n, L)
    x = _start_states32(seeds, cfg, device)
    lanes = torch.arange(L, device=device)
    words = torch.zeros(T, L, dtype=torch.int64, device=device)
    flags = torch.zeros(T, L, dtype=torch.bool, device=device)
    for t in range(T - 1, -1, -1):
        i = t * L + lanes
        active = i < n
        cum, prob = tables_at(i)
        prob = torch.where(active, prob, 1)
        renorm = _renorms32(x, prob, active, cfg)
        words[t] = torch.where(renorm, x & cfg.word_mask, 0)
        flags[t] = renorm
        x = _code32(x, cum, prob, active, renorm, cfg)
    return convert.u32_bits(words), flags, convert.u32_bits(x)


def lanes_pass32(symbols, cdf, cfg: LaneConfig, seeds=None):
    """Pass A of :func:`encode_iid` alone (n > 0): ``(words int32[T, L],
    ballots int32[T, L / 32], states int32[L])``.  On the card the words of
    lanes that emit nothing are left unwritten; a CPU tensor runs
    :func:`lanes_pass32_plain` and packs its flags with
    :func:`flag_ballots`."""
    states = _encode_args(symbols, cdf, cfg, seeds, torch.int32)
    if not _on_cuda(symbols.device):
        words, flags, fin = lanes_pass32_plain(symbols, cdf, cfg, seeds)
        return words, flag_ballots(flags), fin
    LAUNCHES["encode_lanes"] += 1
    words, ballots = _launch_lanes("w16s32", symbols, cdf, cfg, states)
    return words, ballots, states


def division_magic32(prob: int) -> tuple[int, int]:
    """The S=32 encode kernel's multiply-high reciprocal of a probability 1
    <= prob <= 2^16 (``csrc/ilans2_wide.cuh``, ``DivisionRecord32``;
    Granlund and Montgomery 1994, fig. 4.1): ``(magic, l)`` with l =
    ceil(log2 prob) and magic = floor(2^32 (2^l - prob) / prob) + 1 < 2^32,
    in Python integers."""
    l = (prob - 1).bit_length()
    return ((1 << 32) * ((1 << l) - prob)) // prob + 1, l


def divide_by_magic32(x, magic, l):
    """x // prob for a 32-bit x as the kernel computes it from
    ``division_magic32(prob)``: t = (magic x) >> 32 (``__umulhi``), then (t +
    ((x - t) >> min(l, 1))) >> max(l - 1, 0).  Python integers, or numpy
    uint64 arrays elementwise (every product stays below 2^64)."""
    t = (magic * x) >> 32
    up = l > 0  # min(l, 1); l - up is max(l - 1, 0)
    return (t + ((x - t) >> up)) >> (l - up)


def decode_shared(states, stream, cdf, cfg: LaneConfig, n: int,
                  return_final_states: bool = False):
    """Decode n symbols of an ILANS2 stream (W=16, S=32, P <= 16).  JAX
    counterpart: ``constriction_tpu.ops.pallas_coder.decode_shared_pallas``.

    ``states`` int32[L] (u32 bits), ``stream`` int32 words, ``cdf``
    int64[K+1], all on one device.  Returns symbols int32[n], and with
    ``return_final_states`` also the final states int32[L] (after a full
    decode, the encoder's seeds).  CUDA tensors launch the kernel (a
    ValueError for L above :data:`MAX_DECODE_LANES`), CPU tensors run
    :func:`decode_shared_plain`."""
    _check_cfg(cfg, 16, 32, 16)
    _decode_args(states, stream, cdf, cfg, torch.int32)
    if not _on_cuda(states.device):
        return decode_shared_plain(states, stream, cdf, cfg, n,
                                   return_final_states)
    if n == 0:
        syms, fin = torch.zeros(0, dtype=torch.int32,
                                device=states.device), states.clone()
    else:
        syms, fin = _launch_decode("w16s32", states, stream, cdf, cfg, n)
        LAUNCHES["decode"] += 1
    return (syms, fin) if return_final_states else syms


def decode_shared_plain(states, stream, cdf, cfg: LaneConfig, n: int,
                        return_final_states: bool = False):
    """Plain PyTorch twin of :func:`decode_shared` (any device, no checks).
    JAX counterpart: ``constriction_tpu.ops.pallas_coder.decode_shared_pallas``;
    numpy oracle ``interleaved2.decode_shared_cdf``."""
    L, S, W, P = cfg.num_lanes, cfg.state_bits, cfg.word_bits, cfg.precision
    device = states.device
    x = convert.u32_values(states)
    words = convert.u32_values(stream)
    cdf64 = cdf.to(torch.int64)
    K = cdf64.numel() - 1
    T = _num_steps(n, L)
    lanes = torch.arange(L, device=device)
    out = torch.empty(T * L, dtype=torch.int32, device=device)
    base = torch.zeros((), dtype=torch.int64, device=device)
    for t in range(T):
        active = t * L + lanes < n
        q = x & ((1 << P) - 1)
        sym = _find_symbols(cdf64, q, K)
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        x = torch.where(active, (x >> P) * prob + (q - cum), x)
        m = x < 1 << (S - W)
        w, base = _refill_words(m, words, base)
        x = torch.where(m, (x << W) | (w & cfg.word_mask), x)
        out[t * L:(t + 1) * L] = sym.to(torch.int32)
    syms = out[:n]
    return (syms, convert.u32_bits(x)) if return_final_states else syms


def decode_shared_cluster(states, stream, cdf, cfg: LaneConfig, n: int,
                          cluster: int):
    """The decode kernel on a cluster of ``cluster`` CTAs (1 .. 16) in place
    of the size it picks from L, for any L that is a multiple of 32 (n > 0,
    CUDA tensors): how the card tests reach uneven partitions and CTAs with
    no lanes.  Returns (symbols int32[n], final states)."""
    _check_cluster_args(states, stream, cdf, cfg, cluster, torch.int32)
    out = _launch_decode("w16s32", states, stream, cdf, cfg, n, cluster)
    LAUNCHES["decode"] += 1
    return out


def geometry(L: int, K: int, P: int, device=None, cluster: int = 0) -> dict:
    """The launch geometry of the rANS pair for L lanes, K symbols and
    precision P on ``device`` (a CUDA device; the current one by default):
    the decode's cluster (``cluster`` 0: the size the kernel picks from L,
    stepped down while the card cannot co-schedule it), its CTAs' groups,
    lanes per thread and threads, the card's maximum of such active
    clusters, the shared memory of a CTA, whether the CDF is in it and the
    bucket table's ``lut_bits`` (P when P <= 12: every quantile's symbol);
    the encode's pass-A grid."""
    return _geometry("w16s32", L, K, P, device, cluster)


def decode_shared_range(points, stream, cdf, cfg: LaneConfig, n: int,
                        lows=None, rngs=None,
                        return_final_states: bool = False):
    """Decode n symbols of an ILANS2-R range stream (W=16, S=32, P <= 16).
    JAX counterpart:
    ``constriction_tpu.ops.pallas_coder.decode_shared_range_pallas``
    (``_build_range_decoder``, ``seeded=True`` when ``lows``/``rngs`` are
    given).

    ``points`` int32[L] (u32 bits), ``stream`` int32 words, ``cdf``
    int64[K+1], all on one device; ``lows``, ``rngs`` (optional, int32[L]):
    a checkpoint's lower and range planes
    (``interleaved2.build_checkpoints_range``).  Returns symbols int32[n],
    and with ``return_final_states`` also the final ``(lows, rngs, pts)``
    planes.  Raises the host oracle's ValueError on data inconsistent with
    the model.  CUDA tensors launch the kernel (the cluster decode of
    ``csrc/ilans2_wide.cuh``; a ValueError for L above
    :data:`MAX_DECODE_LANES`), CPU tensors run
    :func:`decode_shared_range_plain`."""
    _check_cfg(cfg, 16, 32, 16)
    syms, bad, planes = _range_decode("w16s32", points, stream, cdf, cfg, n,
                                      lows, rngs, torch.int32, _range_steps32,
                                      LAUNCHES)
    _raise_if_invalid(int(bad.item()), n)
    return (syms, planes) if return_final_states else syms


def launch_decode_shared_range(points, stream, cdf, cfg: LaneConfig, n: int,
                               lows=None, rngs=None):
    """:func:`decode_shared_range` as a launch form: ``(symbols int32[n],
    flag int64[1])``, nothing read back: the flag holds the first symbol
    whose quantile was >= 2^P, or n.  CPU tensors run the twin's steps."""
    _check_cfg(cfg, 16, 32, 16)
    return _range_decode("w16s32", points, stream, cdf, cfg, n, lows, rngs,
                         torch.int32, _range_steps32, LAUNCHES)[:2]


def decode_shared_range_cluster(points, stream, cdf, cfg: LaneConfig, n: int,
                                cluster: int, lows=None, rngs=None):
    """The range decode kernel on a cluster of ``cluster`` CTAs (1 .. 16) in
    place of the size it picks from L, for any L that is a multiple of 32
    (n > 0, CUDA tensors): how the card tests reach uneven partitions and
    CTAs with no lanes.  Returns (symbols int32[n], final (lows, rngs,
    pts)).  JAX counterpart: none (the TPU kernel has no cluster)."""
    return _range_cluster("w16s32", points, stream, cdf, cfg, n, cluster,
                          lows, rngs, torch.int32, LAUNCHES)


def _range_cluster(tag: str, points, stream, cdf, cfg: LaneConfig, n: int,
                   cluster: int, lows, rngs, state_dtype, launches: dict):
    """The forced-cluster range decode of either preset; counts the launch
    in its module's ``launches``."""
    planes = _range_decode_args(points, stream, cdf, cfg, lows, rngs,
                                state_dtype)
    if not _on_cuda(points.device):
        raise ValueError("a forced cluster size needs CUDA tensors")
    if not 1 <= cluster <= 16:
        raise ValueError(f"cluster must be in 1 .. 16, got {cluster}")
    syms, bad = _launch_range_decode(tag, planes, stream, cdf, cfg, n,
                                     cluster)
    launches["range_decode"] += 1
    _raise_if_invalid(int(bad.item()), n)
    return syms, planes


def range_geometry(L: int, K: int, P: int, device=None,
                   cluster: int = 0) -> dict:
    """The launch geometry of the range decode for L lanes, K symbols and
    precision P <= 16 on ``device`` (a CUDA device; the current one by
    default): the keys of :func:`geometry` but the encode's grid."""
    return _geometry("w16s32", L, K, P, device, cluster,
                     entry="ilans2_range_geometry", size=8)


def range_correct(q: int, num: int, scale: int, state_bits: int) -> int:
    """The range kernel's correction of a quotient estimate ``q`` (a u32)
    of num / scale (``csrc/ilans2_wide.cuh``, ``f64_quotient``): one
    product against num, in state_bits-wide arithmetic, then one step down
    or up, in u32 arithmetic.  floor(num / scale) for every estimate within
    one of it, given 0 < scale, num < scale << P, P <= 24."""
    p = (q * scale) & ((1 << state_bits) - 1)
    if p > num:
        return (q - 1) & _M32
    return (q + 1) & _M32 if num - p >= scale else q


def range_quotient(num: int, scale: int, state_bits: int) -> int:
    """floor(num / scale) as the range kernel takes it for 0 < scale and
    num < scale << P, P <= 24, num < 2^state_bits: an estimate truncated to
    u32 (saturating, as ``__double2uint_rz``), then :func:`range_correct`.
    The kernel's estimate is num times an approximate reciprocal refined by
    one Newton step, within 2^-36 of num / scale relatively; here it is the
    correctly rounded float64 quotient, within 2^-52 (Python's int -> float
    conversion and float division round to nearest even).  Both are off by
    at most one, where the correction makes them equal."""
    q = min(int(float(num) / float(scale)), _M32)
    return range_correct(q, num, scale, state_bits)


def range_num_quantile(num: int, scale: int, P: int, state_bits: int):
    """A range lane's quantile as the kernel takes it from num = point -
    lower (mod 2^state_bits) and scale = range >> P (``range_quantile``):
    ``(q, over)`` with q = num // scale clamped to 2^P - 1 and over = the
    unclamped quotient was >= 2^P, told apart as num >= scale << P; (0,
    False) where the scale is 0."""
    if scale == 0:
        return 0, False
    if num >= scale << P:
        return (1 << P) - 1, True
    return range_quotient(num, scale, state_bits), False


def range_quantile(point: int, lower: int, rng: int, P: int,
                   state_bits: int):
    """:func:`range_num_quantile` of a lane's (point, lower, range)."""
    num = (point - lower) & ((1 << state_bits) - 1)
    return range_num_quantile(num, rng >> P, P, state_bits)


def decode_range_lanes(points, stream, cdf, cfg: LaneConfig, n: int,
                       lows=None, rngs=None):
    """The range kernel's lane form at either preset in Python integers
    (``cluster_range_decode_kernel``): a lane carries num = point - lower
    and range, takes its quantile from num (:func:`range_num_quantile`),
    subtracts scale cum from num, and on a refill shifts num and range left
    by W and adds the word; the point is only rewritten by a refill
    ((point << W) | word), and the final lower is point - num.  A word with
    bits above W (W=16: a corrupt stream) adds word & ~(point << W), the
    bits the shifted point does not already hold, so num follows the
    point the reference builds.  Slow (a Python loop over lanes and
    steps); it models the kernel's algebra for the tests.

    ``points``, ``lows``, ``rngs``: u32 or u64 values (numpy arrays or
    sequences); ``stream``: u32 words; ``cdf``: K+1 values.  Returns
    ``(symbols int32[n], (lows, rngs, pts))``, the planes as numpy uint64
    arrays.  Raises the host oracle's ValueError on a quantile >= 2^P."""
    L, S, W, P = cfg.num_lanes, cfg.state_bits, cfg.word_bits, cfg.precision
    m = (1 << S) - 1
    wmask = (1 << W) - 1
    pts = [int(x) for x in points]
    lo = [0] * L if lows is None else [int(x) for x in lows]
    rg = [m] * L if rngs is None else [int(x) for x in rngs]
    num = [(p - x) & m for p, x in zip(pts, lo)]
    plo = [p & wmask for p in pts]
    words = [int(x) for x in stream]
    cdf = [int(x) for x in cdf]
    K = len(cdf) - 1
    out = np.zeros(n, dtype=np.int32)
    base, first_bad = 0, n
    for t in range(_num_steps(n, L)):
        refills = []
        for l in range(min(L, n - t * L)):
            scale = rg[l] >> P
            q, over = range_num_quantile(num[l], scale, P, S)
            if over:
                first_bad = min(first_bad, t * L + l)
            sym = min(max(bisect.bisect_right(cdf, q) - 1, 0), K - 1)
            num[l] = (num[l] - scale * cdf[sym]) & m
            rg[l] = scale * (cdf[sym + 1] - cdf[sym])
            out[t * L + l] = sym
            if rg[l] < 1 << (S - W):
                refills.append(l)
        for k, l in enumerate(refills):
            word = words[base + k] if base + k < len(words) else 0
            num[l] = ((num[l] << W) + (word & ~(plo[l] << W))) & m
            rg[l] <<= W
            plo[l] = word & wmask
            pts[l] = ((pts[l] << W) | word) & m
        base += len(refills)
    _raise_if_invalid(first_bad, n)
    planes = ([(p - x) & m for p, x in zip(pts, num)], rg, pts)
    return out, tuple(np.array(v, dtype=np.uint64) for v in planes)


def decode_shared_range_plain(points, stream, cdf, cfg: LaneConfig, n: int,
                              lows=None, rngs=None,
                              return_final_states: bool = False):
    """Plain PyTorch twin of :func:`decode_shared_range` (any device, no
    argument checks).  JAX counterpart:
    ``constriction_tpu.ops.pallas_coder.decode_shared_range_pallas``; numpy
    oracle ``interleaved2.decode_shared_range_cdf``."""
    syms, planes, first_bad = _range_steps32(points, stream, cdf, cfg, n,
                                             lows, rngs)
    _raise_if_invalid(int(first_bad), n)
    return (syms, planes) if return_final_states else syms


def _range_steps32(points, stream, cdf, cfg: LaneConfig, n: int, lows,
                   rngs):
    """The step loop of :func:`decode_shared_range_plain`: (symbols
    int32[n], final (lows, rngs, pts), the first bad symbol or n as an
    int64 tensor)."""
    L, S, W, P = cfg.num_lanes, cfg.state_bits, cfg.word_bits, cfg.precision
    M = (1 << S) - 1
    device = points.device
    pt = convert.u32_values(points)
    lo = (torch.zeros(L, dtype=torch.int64, device=device) if lows is None
          else convert.u32_values(lows))
    rg = (torch.full((L,), M, dtype=torch.int64, device=device)
          if rngs is None else convert.u32_values(rngs))
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
        scale = rg >> P
        q = torch.where(scale > 0, ((pt - lo) & M) // scale.clamp(min=1), 0)
        bad = active & (q >= 1 << P)
        first_bad = torch.minimum(first_bad, torch.where(bad, i, n).min())
        sym = _find_symbols(cdf64, q.clamp(max=(1 << P) - 1), K)
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        lo = torch.where(active, (lo + scale * cum) & M, lo)
        rg = torch.where(active, scale * prob, rg)
        m = active & (rg < 1 << (S - W))
        w, base = _refill_words(m, words, base)
        lo = torch.where(m, (lo << W) & M, lo)
        rg = torch.where(m, rg << W, rg)
        pt = torch.where(m, ((pt << W) & M) | w, pt)
        out[t * L:(t + 1) * L] = sym.to(torch.int32)
    return (out[:n], tuple(convert.u32_bits(v) for v in (lo, rg, pt)),
            first_bad)
