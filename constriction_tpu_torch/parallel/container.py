"""Sharded ILANS2 containers: the message in equal blocks, one call.

The message is padded to ``num_blocks`` equal blocks and every block is an
ordinary ILANS2 unit (shared-stream interleaved rANS, or ILANS2-R range
coding).  The header holds the block geometry and not the device count,
so a container written on one card reads back bit for bit on any list of
devices, and on the JAX package's meshes of any shape.

``device`` is ``"cuda"`` (the default: one card; raises without one),
``"cpu"``, or a sequence of devices, such as ``["cuda:0", "cuda:1"]``: D
is the largest divisor of the block count B that is at most the number
of devices, and device d codes blocks [d B/D, (d+1) B/D).  A list may
name one card more than once; the bytes never depend on the list.

Each call is one block program in three halves:

- upload (:func:`upload`): one host -> device transfer a device, of its
  blocks' symbols (or states and streams), the v2 seeds and the CDF;
- launch (:func:`launch`): every block of every device, devices in order,
  through the coders' launch forms (``interleaved2.launch_encode`` /
  ``launch_decode`` / ``launch_encode_range`` / ``launch_decode_range``:
  the CUDA kernels on a CUDA device, their plain PyTorch twins on the
  CPU).  A launch form reads nothing back, so no device waits for the
  host and all D cards code at once;
- gather (:func:`gather`): a fixed number of read-backs a device, whatever
  its block count (an encode: the streams' starts, then the streams and
  states; a decode: the symbols, with the final states or the range
  flags), the results in block order.  Range data the model cannot have
  written raises ValueError once, after every block was launched.

Argument checks run on the host before the upload.  Configs the kernels
do not take are coded by the numpy host coders, as the JAX package does.

Container layout (u32 words):

    [0] magic 0x494C4E53 ("ILNS")   [1] version=1
    [2] word_bits | precision << 8 | state_bits << 16 | coder << 24
        (coder: 0 = rANS stack semantics, 1 = range queue semantics)
    [3] num_symbols lo  [4] num_symbols hi
    [5] num_lanes L     [6] num_blocks B    [7] block_len (symbols)
    [8 .. 8+B)          per-block stream length (in W-bit words)
    [8+B .. 8+B+B*L)    per-block initial lane states (u32) -- rANS lane
                        states or range-decoder point headers -- for
                        state_bits <= 32; for state_bits = 64 two u32
                        planes [8+B .. 8+B+2BL), all B*L low words then
                        all B*L high words
    [...]               per-block payloads, each u32-aligned (W-bit words
                        packed little-endian as in ILANS2)

Version 2 (``encode(..., compact=True)``, rANS only) stores per-block
variable-width packed states and a pooled tail: the last ``k_tail``
symbols are coded first into a nested compact container
(``ops/framing.py``) whose bits ride in all blocks' seed states and come
back from the blocks' final lane states.  Layout at :func:`pack_sharded_v2`.

JAX counterpart: ``constriction_tpu.parallel.container``: its one SPMD
program (``_encode_blocks_generic`` / ``_decode_blocks_generic``, a
``shard_map`` over the mesh, an in-order ``all_gather``, one transfer to
the host) becomes the three halves above over ``device``, and the bytes
are the same.  Unlike the JAX package, an encoder
config with precision above the word size raises ValueError, as the
port's i.i.d. encoders do (``interleaved2.check_precision``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..ops import framing as fr
from ..ops import interleaved2 as il2
from ..ops.interleaved import LaneConfig, state_dtype

MAGIC_S = 0x494C4E53

_HDR = 8
_HDR2 = 10

CODER_RANS = 0
CODER_RANGE = 1
_CODER_IDS = {"rans": CODER_RANS, "range": CODER_RANGE}


# ---------------------------------------------------------------------------
# v1 framing
# ---------------------------------------------------------------------------


def pack_sharded(states, streams: list, num_symbols: int, block_len: int,
                 cfg: LaneConfig, coder: int = CODER_RANS) -> np.ndarray:
    """Per-block states ``[B, L]`` (u32, or u64 at S=64) and B word streams
    -> v1 sharded container (u32).  JAX counterpart:
    ``container.pack_sharded``."""
    B = len(streams)
    header = np.array([
        MAGIC_S, 1,
        cfg.word_bits | (cfg.precision << 8) | (cfg.state_bits << 16)
        | (coder << 24),
        num_symbols & 0xFFFFFFFF, (num_symbols >> 32) & 0xFFFFFFFF,
        cfg.num_lanes, B, block_len,
    ], dtype=np.uint32)
    lens = np.array([len(s) for s in streams], dtype=np.uint32)
    payloads = [il2.pack_words(s, cfg.word_bits) for s in streams]
    if cfg.state_bits > 32:
        st = np.asarray(states, dtype=np.uint64).reshape(-1)
        states_words = np.concatenate([
            (st & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (st >> np.uint64(32)).astype(np.uint32),
        ])
    else:
        states_words = np.asarray(states).astype(np.uint32).reshape(-1)
    return np.concatenate([header, lens, states_words] + payloads)


def unpack_sharded(data):
    """v1 sharded container -> ``(states [B, L], streams (B word arrays),
    num_symbols, block_len, cfg, coder)``; ``coder`` is CODER_RANS or
    CODER_RANGE, and for range containers ``states`` holds the per-block
    decoder point headers.  JAX counterpart: ``container.unpack_sharded``."""
    data = np.asarray(data, dtype=np.uint32)
    if len(data) < _HDR or int(data[0]) != MAGIC_S or int(data[1]) != 1:
        raise ValueError("not a sharded ILANS2 container")
    flags = int(data[2])
    W = flags & 0xFF
    P = (flags >> 8) & 0xFF
    S = (flags >> 16) & 0xFF
    coder = (flags >> 24) & 0xFF
    if coder not in (CODER_RANS, CODER_RANGE):
        raise ValueError(
            f"unknown coder id {coder} in container header (corrupt data, "
            "or a container from a newer format version)")
    if W not in (16, 32):
        raise ValueError(f"invalid word_bits {W} in container header")
    num_symbols = int(data[3]) | (int(data[4]) << 32)
    L, B, block_len = int(data[5]), int(data[6]), int(data[7])
    cfg = LaneConfig(L, W, S, P)
    if len(data) < _HDR + B:
        raise ValueError("truncated container header")
    lens = data[_HDR:_HDR + B].astype(np.int64)
    off = _HDR + B
    per = 32 // W
    expected = (off + (2 if S > 32 else 1) * B * L
                + int(sum(-(-int(n) // per) for n in lens)))
    if len(data) != expected:
        raise ValueError(
            f"truncated or oversized container: {len(data)} u32 words, "
            f"header describes {expected}")
    if S > 32:
        lo = data[off:off + B * L].astype(np.uint64)
        hi = data[off + B * L:off + 2 * B * L].astype(np.uint64)
        states = (lo | (hi << np.uint64(32))).reshape(B, L)
        off += 2 * B * L
    else:
        states = data[off:off + B * L].reshape(B, L)
        off += B * L
    streams = []
    for b in range(B):
        nwords = int(lens[b])
        n_u32 = -(-nwords // per)
        streams.append(il2.unpack_words(data[off:off + n_u32], W, nwords))
        off += n_u32
    return states, streams, num_symbols, block_len, cfg, coder


# ---------------------------------------------------------------------------
# v2 framing: packed states and the pooled tail (rANS only)
#
# Layout (u32 words):
#   [0] MAGIC_S  [1] 2
#   [2] W | P<<8 | S<<16 | CODER_RANS<<24
#   [3] n lo  [4] n hi           (TOTAL symbols, blocks + tail)
#   [5] L  [6] B  [7] block_len  (region-A block length)
#   [8] k_tail   [9] tail_words  (nested tail container length, u32)
#   [10 .. 10+B)      per-block stream lengths (W-bit words)
#   [10+B .. 10+2B)   per-block packed-state bit lengths
#   [..]              packed states, word-aligned per block
#   [..]              tail spill: ceil(max(tail_bits - cap, 0)/32) words
#   [..]              per-block stream payloads (word-aligned, as v1)
# with cap = B * L * (S - W), the seed capacity of all blocks.
# ---------------------------------------------------------------------------


def pack_sharded_v2(states, streams: list, num_symbols: int, block_len: int,
                    cfg: LaneConfig, k_tail: int, tail_cont) -> np.ndarray:
    """Per-block states and streams, the pooled tail's symbol count and
    nested container -> v2 sharded container (u32).  JAX counterpart:
    ``container.pack_sharded_v2``."""
    B = len(streams)
    S, W = cfg.state_bits, cfg.word_bits
    for fname, fval in (
        ("k_tail", k_tail), ("tail_words", len(tail_cont)),
        ("block_len", block_len),
        ("max stream length", max((len(s) for s in streams), default=0)),
    ):
        if int(fval) >> 32:
            raise ValueError(
                f"v2 sharded header field {fname} = {fval} exceeds its "
                "u32 field; raise num_blocks to shorten the blocks")
    header = np.array([
        MAGIC_S, 2, W | (cfg.precision << 8) | (S << 16) | (CODER_RANS << 24),
        num_symbols & 0xFFFFFFFF, (num_symbols >> 32) & 0xFFFFFFFF,
        cfg.num_lanes, B, block_len, k_tail, len(tail_cont),
    ], dtype=np.uint32)
    lens = np.array([len(s) for s in streams], dtype=np.uint32)
    psa_words, psa_bits = [], []
    for b in range(B):
        bits, nbits = fr.pack_states(np.asarray(states[b]), cfg)
        psa_words.append(fr._u32_from_bits(bits))
        psa_bits.append(nbits)
    cap = B * cfg.num_lanes * (S - W)
    if len(tail_cont) * 32 > cap:
        all_bits = fr._bits_from_u32(np.asarray(tail_cont, np.uint32))
        spill = fr._u32_from_bits(all_bits[cap:])
    else:
        spill = np.zeros(0, np.uint32)
    payloads = [il2.pack_words(s, W) for s in streams]
    return np.concatenate([header, lens, np.asarray(psa_bits, np.uint32)]
                          + psa_words + [spill] + payloads)


def unpack_sharded_v2(data):
    """v2 sharded container -> ``(states [B, L], streams, num_symbols,
    block_len, cfg, k_tail, tail_words, spill_bits)``; a corrupt or
    truncated header raises ValueError.  JAX counterpart:
    ``container.unpack_sharded_v2``."""
    data = np.asarray(data, dtype=np.uint32)
    if len(data) < _HDR2:
        raise ValueError("truncated v2 sharded container header")
    if int(data[0]) != MAGIC_S or int(data[1]) != 2:
        raise ValueError("not a v2 sharded container")
    flags = int(data[2])
    W = flags & 0xFF
    P = (flags >> 8) & 0xFF
    S = (flags >> 16) & 0xFF
    if W not in (16, 32) or not 0 < P <= 24 or S not in (32, 64):
        raise ValueError("invalid (W, P, S) in v2 sharded header")
    num_symbols = int(data[3]) | (int(data[4]) << 32)
    L, B, block_len = int(data[5]), int(data[6]), int(data[7])
    k_tail, tail_words = int(data[8]), int(data[9])
    if L <= 0 or B <= 0 or block_len <= 0 or len(data) < _HDR2 + 2 * B:
        raise ValueError("invalid geometry in v2 sharded header")
    cfg = LaneConfig(L, W, S, P)
    lens = data[_HDR2:_HDR2 + B].astype(np.int64)
    psa_bits = data[_HDR2 + B:_HDR2 + 2 * B].astype(np.int64)
    # the packed-state bit lengths pin L: without this a scrambled
    # lane-count word drives L-sized allocations
    wb = (W - 1).bit_length()
    if not np.all((psa_bits >= 1 + L * (S - W))
                  & (psa_bits <= 1 + L * (wb + S - 1))):
        raise ValueError(
            "packed-state lengths inconsistent with the lane count "
            "(corrupt v2 sharded header)")
    cap = B * L * (S - W)
    spill_bits = max(tail_words * 32 - cap, 0)
    expected = (_HDR2 + 2 * B
                + int(sum(-(-int(pb) // 32) for pb in psa_bits))
                + -(-spill_bits // 32)
                + int(sum(-(-int(n) // (32 // W)) for n in lens)))
    if len(data) != expected:
        raise ValueError(
            f"truncated or oversized v2 sharded container: {len(data)} "
            f"u32 words, header describes {expected}")
    off = _HDR2 + 2 * B
    states = np.empty((B, L), state_dtype(cfg))
    for b in range(B):
        nw = -(-int(psa_bits[b]) // 32)
        bits = fr._bits_from_u32(data[off:off + nw])[:int(psa_bits[b])]
        states[b] = fr.unpack_states(bits, cfg)
        off += nw
    nw = -(-spill_bits // 32)
    spill = fr._bits_from_u32(data[off:off + nw])[:spill_bits]
    off += nw
    per = 32 // W
    streams = []
    for b in range(B):
        nwords = int(lens[b])
        n_u32 = -(-nwords // per)
        streams.append(il2.unpack_words(data[off:off + n_u32], W, nwords))
        off += n_u32
    return (states, streams, num_symbols, block_len, cfg, k_tail, tail_words,
            spill)


def _tail_container(symbols, cdf, cfg_tail: LaneConfig, device):
    """The pooled tail's nested compact container: ``framing.encode_iid_v2``
    on ``device``, or with ``device`` None the numpy host coder under the
    same framing."""
    if device is not None:
        return fr.encode_iid_v2(symbols, cdf, cfg_tail, device=device)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    cums = cdf64[symbols]
    probs = cdf64[symbols + 1] - cums

    def encode_a(n_A, seeds):
        return il2.encode_shared(cums[:n_A], probs[:n_A], cfg_tail,
                                 seeds=seeds)

    return fr.frame_planes_v2(cums, probs, cfg_tail, None, encode_a)


def _sharded_v2_tail_and_seeds(symbols, cdf, cfg: LaneConfig, B: int,
                               est_bits_per_sym: float, device):
    """Choose the pooled tail, encode it as a nested compact container
    (on ``device``; None: the numpy host coder), and spread its bits over
    the B*L seed states.  Returns ``(k_tail, tail_cont, seeds [B, L] or
    None)``.  JAX counterpart: ``container._sharded_v2_tail_and_seeds``."""
    n = len(symbols)
    L = cfg.num_lanes
    S, W = cfg.state_bits, cfg.word_bits
    cap = B * L * (S - W)
    if n < 4 * B * L or est_bits_per_sym * n < 2.0 * cap:
        return 0, np.zeros(0, np.uint32), None
    k = int(min(max(cap * 0.98 / max(est_bits_per_sym, 1e-9), 1), n // 2))
    L_tail = 128
    while L_tail * 2 <= min(2048, max(k // 8, 128)):
        L_tail *= 2
    cfg_tail = LaneConfig(num_lanes=L_tail, word_bits=W, state_bits=S,
                          precision=cfg.precision)
    tail_cont = _tail_container(symbols[n - k:], cdf, cfg_tail, device)
    payload = fr._bits_from_u32(np.asarray(tail_cont, np.uint32))[:cap]
    if len(payload) < cap:
        payload = np.concatenate(
            [payload, np.zeros(cap - len(payload), np.uint8)])
    per_block = L * (S - W)
    seeds = np.stack([
        fr._seeds_from_payload(payload[b * per_block:(b + 1) * per_block],
                               cfg)
        for b in range(B)
    ])
    return k, tail_cont, seeds


def _sharded_v2_recover_tail(fin_states, cdf, cfg: LaneConfig, B: int,
                             tail_words: int, spill, device) -> np.ndarray:
    """Pooled payload from all blocks' final states -> nested tail
    container -> decoded tail symbols (``framing.decode_iid_v2`` on
    ``device``).  JAX counterpart: ``container._sharded_v2_recover_tail``."""
    L, S, W = cfg.num_lanes, cfg.state_bits, cfg.word_bits
    cap = B * L * (S - W)
    payload = np.concatenate([
        fr._payload_from_seeds(np.asarray(fin_states[b]), cfg)
        for b in range(B)
    ])
    tail_bits_n = tail_words * 32
    blob = np.concatenate([payload[:min(cap, tail_bits_n)], spill])
    tail_cont = fr._u32_from_bits(blob[:tail_bits_n])[:tail_words]
    return fr.decode_iid_v2(tail_cont, cdf, device=device)


# ---------------------------------------------------------------------------
# devices and block placement
# ---------------------------------------------------------------------------


def _devices(device) -> list:
    """``device`` -> a list of torch devices, each checked as ``cuda.py``
    checks one (a CUDA device without a card raises).  A CUDA device with
    no index becomes the current card, once for the call: the kernels'
    C entries select their own card, which moves the current one."""
    from ..cuda import _device

    if isinstance(device, (str, torch.device)):
        device = [device]
    devices = [_device(d) for d in device]
    if not devices:
        raise ValueError("device must name at least one device")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devices]


def _pick_device_count(B: int, num_devices: int) -> int:
    """The largest divisor of B that is at most ``num_devices``.  JAX
    counterpart: ``container._pick_device_count`` (the mesh's device
    count)."""
    d = min(num_devices, B)
    while B % d:
        d -= 1
    return d


def _device_blocks(B: int, devices: list) -> list:
    """``[(device, slice of its blocks)]``: device d of the first D (D from
    :func:`_pick_device_count`) takes blocks [d B/D, (d+1) B/D)."""
    per = B // _pick_device_count(B, len(devices))
    return [(devices[d], slice(d * per, (d + 1) * per))
            for d in range(B // per)]


def block_devices(B: int, devices: list) -> list:
    """The device of each of B blocks (:func:`_device_blocks`).  JAX
    counterpart: the ``P(BLOCK_AXIS)`` split of ``shard_map``."""
    return [dev for dev, blocks in _device_blocks(B, devices)
            for _ in range(blocks.start, blocks.stop)]


# ---------------------------------------------------------------------------
# the block program: upload, launch, gather
# ---------------------------------------------------------------------------


def upload(blocks: list, shared: list, devices: list) -> list:
    """The upload half of a block program.  ``blocks`` holds one list of
    tensors per block, ``shared`` the tensors every block reads (the CDF);
    each device gets its blocks' tensors and the shared ones in one
    transfer (``convert.upload``).  Returns, per device that codes (in
    block order), one argument list per block: the shared tensors, then
    the block's own, all on that device."""
    programs = []
    for dev, mine in _device_blocks(len(blocks), devices):
        mine = blocks[mine]
        up = convert.upload(list(shared) + [t for b in mine for t in b], dev)
        k = len(shared)
        rest = up[k:]
        at = np.cumsum([0] + [len(b) for b in mine])
        programs.append([up[:k] + rest[at[i]:at[i + 1]]
                         for i in range(len(mine))])
    return programs


def launch(step, programs: list) -> list:
    """The launch half: ``step(*arguments)`` for every block of every
    device, devices in order and blocks in order, on inputs already on
    their devices (:func:`upload`).  The steps are launch forms, which
    read nothing back, so no device waits for another and all of them
    code at once; the window raises under
    ``torch.cuda.set_sync_debug_mode("error")`` if one did.  Returns each
    device's launched outputs.  JAX counterpart: the per-device loop of a
    ``shard_map`` body."""
    return [[step(*args) for args in blocks] for blocks in programs]


def gather(finish, launched: list) -> list:
    """The gather half: ``finish`` reads one device's launched outputs back
    in a number of transfers that does not depend on its block count
    (``interleaved2.finish_*``, ``convert.read_back``); returns every
    block's result, in block order.  JAX counterpart: the in-order
    ``all_gather`` and the one transfer to the host."""
    return [r for outs in launched for r in finish(outs)]


# ---------------------------------------------------------------------------
# block coding
# ---------------------------------------------------------------------------


def _check_cdf(cdf, cfg: LaneConfig, encoding: bool) -> None:
    """A CDF whose total is not 2^P would silently corrupt the blocks."""
    top = int(np.asarray(cdf)[-1])
    if top == 1 << cfg.precision:
        return
    if encoding:
        raise ValueError(
            f"cdf[-1] must equal 2**precision = {1 << cfg.precision}, got "
            f"{top} (rebuild the model at this precision or pass a "
            "matching cfg)")
    raise ValueError(
        f"cdf[-1] must equal 2**precision = {1 << cfg.precision} (the "
        f"container's header precision), got {top}")


def _encode_blocks(padded, cdf, cfg: LaneConfig, B: int, block_len: int,
                   coder_id: int, seeds, devices):
    """Code each block: one program over ``devices`` where the kernels take
    ``cfg``, else (and with ``devices`` None) the numpy host coders block
    by block.  Returns ``(states [B, L], streams)``."""
    if devices is None or not il2.kernel_eligible(cfg):
        return _encode_blocks_host(padded, cdf, cfg, B, block_len, coder_id,
                                   seeds)
    programs, step, finish = encode_program(padded, cdf, cfg, B, block_len,
                                            coder_id, seeds, devices)
    out = gather(finish, launch(step, programs))
    return np.stack([st for st, _ in out]), [w for _, w in out]


def encode_program(padded, cdf, cfg: LaneConfig, B: int, block_len: int,
                   coder_id: int, seeds, devices) -> tuple:
    """An encode's upload half, after the seeds' host check: ``(programs,
    step, finish)`` for :func:`launch` and :func:`gather`, whose results
    are each block's ``(states, stream)``.  ``padded`` holds the B blocks'
    symbols, ``seeds`` None or [B, L]."""
    syms = torch.from_numpy(padded.astype(np.int32).reshape(B, block_len))
    blocks = [[syms[b]] for b in range(B)]
    if seeds is not None:
        for b in range(B):
            blocks[b].append(convert.states_to_torch(
                il2.check_seeds(seeds[b], cfg), cfg))
    programs = upload(blocks, [convert.cdf_to_torch(cdf)], devices)
    if coder_id == CODER_RANGE:
        def step(cdf_t, s):
            return il2.launch_encode_range(s, cdf_t, cfg)
    else:
        def step(cdf_t, s, *seed):
            return il2.launch_encode(s, cdf_t, cfg, *seed)
    return programs, step, lambda outs: il2.finish_encodes(outs, cfg)


def _encode_blocks_host(padded, cdf, cfg: LaneConfig, B: int, block_len: int,
                        coder_id: int, seeds):
    """The numpy host coders block by block (the JAX package's
    ``device=False`` loop)."""
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    states = np.empty((B, cfg.num_lanes), state_dtype(cfg))
    streams = []
    for b in range(B):
        blk = padded[b * block_len:(b + 1) * block_len]
        cums, probs = cdf64[blk], cdf64[blk + 1] - cdf64[blk]
        if coder_id == CODER_RANGE:
            states[b], sw = il2.encode_shared_range(cums, probs, cfg)
        else:
            states[b], sw = il2.encode_shared(
                cums, probs, cfg, seeds=None if seeds is None else seeds[b])
        streams.append(sw)
    return states, streams


def _encode(symbols, cdf, cfg, num_blocks: int, coder: str, compact: bool,
            devices) -> np.ndarray:
    """:func:`encode` on a list of devices, or with ``devices`` None on the
    numpy host coders (the JAX package's ``device=False`` loop)."""
    if coder not in _CODER_IDS:
        raise ValueError(
            f"coder must be one of {sorted(_CODER_IDS)}, got {coder!r}")
    if compact and coder != "rans":
        raise ValueError(
            "compact=True covers rANS containers (range coding has no "
            "seed-recovery identity; its point headers must ship raw)")
    coder_id = _CODER_IDS[coder]
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    symbols = np.asarray(symbols, dtype=np.int64)
    n = len(symbols)
    if cfg is None:
        from ..cuda import _pick_cfg

        cfg = _pick_cfg(max(n // num_blocks, 1), None, cdf)
    il2.check_precision(cfg)
    K = len(cdf) - 1
    _check_cdf(cdf, cfg, encoding=True)
    if n and (int(symbols.min()) < 0 or int(symbols.max()) >= K):
        raise ValueError(
            f"symbols must be in [0, {K}), got range "
            f"[{int(symbols.min())}, {int(symbols.max())}]")
    B = num_blocks
    block_len = max(-(-n // B), 1)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    # one kernel shape for every block: pad with the first symbol of nonzero
    # probability (a zero-probability pad would divide by prob = 0)
    pad_sym = int(np.argmax(np.diff(cdf64.astype(np.int64)) > 0))
    k_tail, tail_cont, seeds = 0, np.zeros(0, np.uint32), None
    n_blocks_syms = n
    if compact:
        p_all = (cdf64[symbols + 1] - cdf64[symbols]).astype(np.float64)
        est_bps = (float(cfg.precision - np.log2(p_all).mean()) if n
                   else 1.0)
        k_tail, tail_cont, seeds = _sharded_v2_tail_and_seeds(
            symbols, cdf, cfg, B, est_bps,
            None if devices is None else devices[0])
        n_blocks_syms = n - k_tail
        block_len = max(-(-n_blocks_syms // B), 1)
    padded = np.full(B * block_len, pad_sym, dtype=np.int64)
    padded[:n_blocks_syms] = symbols[:n_blocks_syms]
    states, streams = _encode_blocks(padded, cdf, cfg, B, block_len,
                                     coder_id, seeds, devices)
    if compact:
        return pack_sharded_v2(states, streams, n, block_len, cfg, k_tail,
                               tail_cont)
    return pack_sharded(states, streams, n, block_len, cfg, coder_id)


def encode(symbols, cdf, cfg: LaneConfig | None = None, num_blocks: int = 8,
           device="cuda", coder: str = "rans",
           compact: bool = False) -> np.ndarray:
    """Encode ``symbols`` into a sharded container (u32 numpy) in one call.

    ``cfg=None`` picks ``cuda._pick_cfg``'s config for one block's share of
    the message and the model's precision.  ``coder`` picks the block coder:
    ``"rans"`` (stack semantics) or ``"range"`` (queue semantics: each block
    an ILANS2-R unit whose stored states are the decoder point headers);
    ``compact=True`` (rANS only) writes the v2 framing.  ``device`` as in
    the module docstring; the bytes do not depend on it.  JAX counterpart:
    ``container.encode(..., device=True)`` on any mesh, byte for byte."""
    return _encode(symbols, cdf, cfg, num_blocks, coder, compact,
                   _devices(device))


def encode_host(symbols, cdf, cfg: LaneConfig | None = None,
                num_blocks: int = 8, coder: str = "rans",
                compact: bool = False) -> np.ndarray:
    """:func:`encode` with every block (and a v2 container's pooled tail)
    on the port's numpy host coders, packed by the same framing: the
    oracle of the port's tests, its dry run and ``chip_smoke.py``.  JAX
    counterpart: ``container.encode(..., device=False)``."""
    return _encode(symbols, cdf, cfg, num_blocks, coder, compact, None)


def _decode_blocks(states, streams, cdf, cfg: LaneConfig, block_len: int,
                   coder_id: int, devices, want_final: bool = False):
    """Decode each block: one program over ``devices`` where the kernels
    take ``cfg``, else the numpy host decoders block by block.  Range data
    the model cannot have written raises ValueError, once, after every
    block was launched and read back.  Returns the symbols of all blocks,
    and with ``want_final`` also the final states [B, L]."""
    if not il2.kernel_eligible(cfg):
        return _decode_blocks_host(states, streams, cdf, cfg, block_len,
                                   coder_id, want_final)
    programs, step, finish = decode_program(states, streams, cdf, cfg,
                                            block_len, coder_id, devices)
    got = gather(finish, launch(step, programs))
    if coder_id == CODER_RANGE:
        return np.concatenate(il2.range_symbols(got))
    out = np.concatenate([syms for syms, _ in got])
    return (out, np.stack([fin for _, fin in got])) if want_final else out


def decode_program(states, streams, cdf, cfg: LaneConfig, block_len: int,
                   coder_id: int, devices) -> tuple:
    """A decode's upload half: ``(programs, step, finish)`` for
    :func:`launch` and :func:`gather`, whose results are each block's
    ``(symbols, final states)`` (rANS) or ``(symbols, flag)`` (range:
    ``interleaved2.range_symbols`` raises on the flags).  Each device gets
    its blocks' states and its streams concatenated."""
    B = len(streams)
    st = convert.states_to_torch(states, cfg).reshape(B, cfg.num_lanes)
    flat = convert.u32_to_torch(np.concatenate(streams))
    at = np.cumsum([0] + [len(w) for w in streams])
    programs = upload([[st[b], flat[at[b]:at[b + 1]]] for b in range(B)],
                      [convert.cdf_to_torch(cdf)], devices)
    if coder_id == CODER_RANGE:
        def step(cdf_t, pt, w):
            return il2.launch_decode_range(pt, w, cdf_t, cfg, block_len)
        return programs, step, il2.finish_range_decodes

    def step(cdf_t, s, w):
        return il2.launch_decode(s, w, cdf_t, cfg, block_len)
    return programs, step, lambda outs: il2.finish_decodes(outs, cfg)


def _decode_blocks_host(states, streams, cdf, cfg: LaneConfig,
                        block_len: int, coder_id: int, want_final: bool):
    """The numpy host decoders block by block."""
    outs, fins = [], []
    for b in range(len(streams)):
        if coder_id == CODER_RANGE:
            outs.append(il2.decode_shared_range_cdf(states[b], streams[b],
                                                    block_len, cdf, cfg))
            continue
        out, fin = il2.decode_shared_cdf(states[b], streams[b], block_len,
                                         cdf, cfg, return_final_states=True)
        outs.append(out)
        fins.append(fin)
    out = np.concatenate(outs)
    return (out, np.stack(fins)) if want_final else out


def decode(container, cdf, device="cuda") -> np.ndarray:
    """Decode a sharded container of either version in one call; the block
    coder and the framing version come from the header.  Returns int32
    symbols.  ``device`` as in the module docstring.  JAX counterpart:
    ``container.decode(..., device=True)`` on any mesh."""
    devices = _devices(device)
    data = np.asarray(container, dtype=np.uint32)
    if len(data) >= 2 and int(data[0]) == MAGIC_S and int(data[1]) == 2:
        return _decode_v2(data, cdf, devices)
    states, streams, n, block_len, cfg, coder_id = unpack_sharded(data)
    _check_cdf(cdf, cfg, encoding=False)
    out = _decode_blocks(states, streams, cdf, cfg, block_len, coder_id,
                         devices)
    return out[:n]


def _decode_v2(data, cdf, devices) -> np.ndarray:
    """Decode a v2 sharded container: the blocks with their final lane
    states, the pooled tail recovered from them, concatenated.  JAX
    counterpart: ``container._decode_v2``."""
    (states, streams, n, block_len, cfg, k_tail, tail_words,
     spill) = unpack_sharded_v2(data)
    _check_cdf(cdf, cfg, encoding=False)
    out, fin = _decode_blocks(states, streams, cdf, cfg, block_len,
                              CODER_RANS, devices, want_final=True)
    out = out[:n - k_tail]
    if k_tail == 0:
        return out
    tail = _sharded_v2_recover_tail(fin, cdf, cfg, len(streams), tail_words,
                                    spill, devices[0])
    return np.concatenate([out, tail])


# ---------------------------------------------------------------------------
# random access inside sharded containers: within-block checkpoints
# ---------------------------------------------------------------------------


def _unpack_any(container):
    """``(states, streams, n, block_len, cfg, coder)`` of either version;
    for v2, n counts the blocks' symbols only (seeks cannot reach the
    pooled tail, which needs every block's final states)."""
    container = np.asarray(container, dtype=np.uint32)
    if len(container) >= 2 and int(container[1]) == 2:
        (states, streams, n_tot, block_len, cfg, k_tail, _tw,
         _sp) = unpack_sharded_v2(container)
        return states, streams, n_tot - k_tail, block_len, cfg, CODER_RANS
    return unpack_sharded(container)


def build_block_checkpoints(container, cdf, interval: int):
    """Per-block decoder snapshots every ``interval`` grid steps, made by
    one host decode of each block (no ``device``: nothing runs on the card,
    as ``cuda.build_checkpoints``).

    Returns ``(offsets i64[B, C], states)`` with ``C = ceil(T_block /
    interval) - 1`` (the block header is the t=0 snapshot; shorter blocks
    are zero-padded).  For rANS containers ``states`` is one ``[B, C, L]``
    array; for range containers a ``(lows, rngs, pts)`` triple of ``[B, C,
    L]`` arrays.  v2 containers: the blocks only.  JAX counterpart:
    ``container.build_block_checkpoints``."""
    states, streams, n, block_len, cfg, coder_id = _unpack_any(container)
    B = len(streams)
    snaps = []
    for b in range(B):
        nb = min(block_len, max(n - b * block_len, 0))
        if coder_id == CODER_RANGE:
            snaps.append(il2.build_checkpoints_range(
                np.asarray(states[b]), streams[b], nb, cdf, cfg, interval))
        else:
            snaps.append(il2.build_checkpoints(
                states[b], streams[b], nb, cdf, cfg, interval))
    C = max(len(s[0]) for s in snaps)
    off_arr = np.zeros((B, C), dtype=np.int64)
    planes = [np.zeros((B, C) + p.shape[1:], dtype=p.dtype)
              for p in snaps[0][1:]]
    for b, (offs, *ps) in enumerate(snaps):
        off_arr[b, :len(offs)] = offs
        for arr, p in zip(planes, ps):
            arr[b, :len(offs)] = p
    if coder_id == CODER_RANGE:
        return off_arr, tuple(planes)
    return off_arr, planes[0]


def decode_block_from_checkpoint(container, cdf, interval: int, block: int,
                                 ckpt_index: int, offsets, states,
                                 device="cuda"):
    """Decode block ``block``'s suffix from its within-block checkpoint
    ``ckpt_index`` (from :func:`build_block_checkpoints`) on one device
    (``"cuda"``, the default, or ``"cpu"``); bit-equal to that slice of a
    full :func:`decode`.  Returns ``(global_start_symbol, suffix)``, the
    suffix clipped to the message (for v2: to the blocks) at the final
    block.  A ckpt_index past the block's real count raises ValueError.
    JAX counterpart: ``container.decode_block_from_checkpoint``."""
    from ..cuda import _device

    dev = _device(device)
    blk_states, streams, n, block_len, cfg, coder_id = _unpack_any(container)
    if not 0 <= block < len(streams):
        raise ValueError(f"block {block} out of range")
    nb = min(block_len, max(n - block * block_len, 0))
    # offsets and states are zero-padded to the largest per-block count: a
    # stale index into a shorter block would decode from offset 0 with zero
    # states, so the block's real count (il2.build_checkpoints' formula)
    # bounds it
    T_b = -(-nb // cfg.num_lanes) if nb else 0
    real_c = max(-(-T_b // interval) - 1, 0)
    if not 0 <= ckpt_index < real_c:
        raise ValueError(
            f"ckpt_index {ckpt_index} out of range for block {block}: it "
            f"has {real_c} within-block checkpoints "
            f"({nb} symbols, interval {interval})")
    if coder_id == CODER_RANGE:
        lows, rngs, pts = states
        rel_start, suffix = il2.decode_range_from_checkpoint(
            ckpt_index, offsets[block], lows[block], rngs[block], pts[block],
            streams[block], nb, cdf, cfg, interval, device=dev)
    else:
        rel_start, suffix = il2.decode_from_checkpoint(
            ckpt_index, offsets[block], states[block], streams[block], nb,
            cdf, cfg, interval, device=dev)
    return block * block_len + rel_start, suffix
