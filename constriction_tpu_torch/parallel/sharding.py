"""Block legs: the per-call coders over a list of independent blocks.

Each leg takes one input per block in the port's own layout (the one its
per-call wrapper takes), codes block b on the device
``container.block_devices`` gives it (``device``: ``"cuda"``, the
default, raising without a card; ``"cpu"``, the plain PyTorch twins; or a
sequence of devices, the blocks split in order over the largest divisor
of B they hold), and returns one numpy output per block, in block order,
read back to the host.  Blocks share nothing, so no leg communicates.

JAX counterpart: the ``shard_*_pallas`` legs of
``constriction_tpu.parallel.sharding`` (one Pallas kernel per device of a
mesh under ``shard_map``); their ``[D, rows, 128]`` window layouts do not
carry over (``convert.rows_to_torch`` and ``convert.family_params_to_torch``
turn them into the port's).  Its ILANS v1 and ``jax_coder2`` legs
(``shard_encode``, ``shard_decode_lookup``, ``shard_encode2``,
``shard_decode2``, ``gather_blocks``) are not ported.
"""

from __future__ import annotations

import numpy as np

from .. import convert
from ..ops import exact_family, family, tchain
from ..ops import interleaved2 as il2
from ..ops.interleaved import LaneConfig
from .container import _devices, block_devices


def prepare_blocks(symbols, cdf, num_blocks: int, cfg: LaneConfig):
    """Split symbols into ``num_blocks`` equal blocks (the last one short)
    and build their ``[D, T, L]`` (cum, prob) u32 tables, padded with (0,
    1); returns ``(cums, probs, lens i32[D], T)``.  JAX counterpart:
    ``sharding.prepare_blocks``."""
    n = len(symbols)
    D = num_blocks
    L = cfg.num_lanes
    block = -(-n // D)
    T = -(-block // L)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    symbols = np.asarray(symbols, dtype=np.int64)
    cums = np.zeros((D, T * L), dtype=np.uint32)
    probs = np.ones((D, T * L), dtype=np.uint32)
    lens = np.zeros(D, dtype=np.int32)
    for d in range(D):
        blk = symbols[d * block:(d + 1) * block]
        lens[d] = len(blk)
        cums[d, :len(blk)] = cdf64[blk]
        probs[d, :len(blk)] = (cdf64[blk + 1] - cdf64[blk]).astype(np.uint32)
    return cums.reshape(D, T, L), probs.reshape(D, T, L), lens, T


def _placed(blocks, device) -> list:
    """The device of each block, for ``len(blocks)`` blocks."""
    return block_devices(len(blocks), _devices(device))


def _check_preset(cfg: LaneConfig, S: int) -> None:
    if cfg.state_bits != S:
        raise ValueError(
            f"this leg codes S={S} blocks, got a cfg with S={cfg.state_bits}")


def shard_encode2_cuda(blocks, cdf, cfg: LaneConfig, device="cuda",
                       seeds=None) -> list:
    """rANS encode of each block (numpy symbols) with the port's coder
    (kernel 2 at S=64, kernel 3 at S=32); ``seeds`` optional, one [L]
    array per block.  Returns ``[(states, stream)]`` as
    ``interleaved2.encode_lanes`` does.  JAX counterpart:
    ``sharding.shard_encode2_pallas``."""
    where = _placed(blocks, device)
    return [il2.encode_lanes(blk, cdf, cfg, dev,
                             seeds=None if seeds is None else seeds[b])
            for b, (blk, dev) in enumerate(zip(blocks, where))]


def _decode(states, streams, cdf, cfg, block_len: int, device) -> list:
    return [il2.decode_lanes(st, sw, block_len, cdf, cfg, dev)[0]
            for st, sw, dev in zip(states, streams, _placed(streams, device))]


def shard_decode2_cuda(states, streams, cdf, cfg: LaneConfig, block_len: int,
                       device="cuda") -> list:
    """S=32 rANS decode (kernel 4) of ``block_len`` symbols from each
    block's (u32 states [L], stream) pair.  Returns int32 symbols per
    block.  JAX counterpart: ``sharding.shard_decode2_pallas``."""
    _check_preset(cfg, 32)
    return _decode(states, streams, cdf, cfg, block_len, device)


def shard_decode64_cuda(states, streams, cdf, cfg: LaneConfig,
                        block_len: int, device="cuda") -> list:
    """S=64 rANS decode (kernel 1) of each block's (u64 states [L],
    stream) pair.  JAX counterpart: ``sharding.shard_decode64_pallas``
    (which takes the states as (hi, lo) u32 planes)."""
    _check_preset(cfg, 64)
    return _decode(states, streams, cdf, cfg, block_len, device)


def _decode_range(points, streams, cdf, cfg, block_len: int, device) -> list:
    return [il2.decode_range_lanes(pt, sw, block_len, cdf, cfg, dev)
            for pt, sw, dev in zip(points, streams, _placed(streams, device))]


def shard_decode_range_cuda(points, streams, cdf, cfg: LaneConfig,
                            block_len: int, device="cuda") -> list:
    """S=32 range decode (kernel 6) of each block's (u32 points [L],
    stream) pair; data the model cannot have written raises ValueError
    (the JAX leg returns a flag per block instead).  JAX counterpart:
    ``sharding.shard_decode_range_pallas``."""
    _check_preset(cfg, 32)
    return _decode_range(points, streams, cdf, cfg, block_len, device)


def shard_decode_range64_cuda(points, streams, cdf, cfg: LaneConfig,
                              block_len: int, device="cuda") -> list:
    """S=64 range decode (kernel 5) of each block's (u64 points [L],
    stream) pair; ValueError as :func:`shard_decode_range_cuda`.  JAX
    counterpart: ``sharding.shard_decode_range64_pallas``."""
    _check_preset(cfg, 64)
    return _decode_range(points, streams, cdf, cfg, block_len, device)


def shard_decode_family_cuda(states, params, streams, family_name: str,
                             min_sym: int, max_sym: int, cfg: LaneConfig,
                             block_len: int, device="cuda") -> list:
    """Per-symbol family decode (kernel 11) of each block: ``states``
    int32[L] and ``streams`` int32 tensors, ``params`` one ``(means,
    scales)`` pair of float32[T * L] tensors a block (the padded layout of
    ``ops.family.decode_family``), moved to the block's device.  Returns
    int32 symbols per block.  JAX counterpart:
    ``sharding.shard_decode_family_pallas``."""
    out = []
    for st, (mu, sd), sw, dev in zip(states, params, streams,
                                     _placed(streams, device)):
        out.append(family.decode_family(
            st.to(dev), sw.to(dev), mu.to(dev), sd.to(dev), family_name,
            min_sym, max_sym, cfg, block_len).cpu().numpy())
    return out


def shard_tchain_decode_cuda(qwords, cdf, cfg: LaneConfig = tchain.TCHAIN_CFG,
                             device="cuda") -> list:
    """TChain-16 bits-back decode (kernel 19) of each block's planar
    quantile words (int32[T * L/2] tensors, ``ops.tchain.pack_quantiles``
    flattened).  Returns ``[(symbols int32, remainders u32, heads
    u32[L])]`` numpy per block.  JAX counterpart:
    ``sharding.shard_tchain_decode_pallas`` (which returns the remainder
    windows and their ends instead of the remainders)."""
    out = []
    for qw, dev in zip(qwords, _placed(qwords, device)):
        syms, rem, heads = tchain.tchain16_decode(
            qw.to(dev), convert.cdf_to_torch(cdf, dev), cfg)
        out.append((syms.cpu().numpy(), convert.u32_from_torch(rem),
                    convert.u32_from_torch(heads)))
    return out


def shard_decode_exact_family_cuda(states, tabs, streams, min_sym: int,
                                   max_sym: int, cfg: LaneConfig,
                                   block_len: int, device="cuda") -> list:
    """Reference-exact family decode of each block against its own
    precomputed tables (kernel 13 at W=16/S=32, kernel 15 at W=32/S=64):
    ``states`` int32[L] (int64 at S=64), ``tabs`` int32 ``[T, CP1, L]``
    (``convert.exact_tables_to_torch``) and ``streams`` int32 tensors,
    moved to the block's device.  Returns int32 symbols per block.  JAX
    counterpart: ``sharding.shard_decode_exact_family_pallas`` (whose
    ``cmax`` the tables' plane count gives here)."""
    out = []
    for st, tab, sw, dev in zip(states, tabs, streams,
                                _placed(streams, device)):
        out.append(exact_family.decode_tables(
            st.to(dev), sw.to(dev), tab.to(dev), cfg, min_sym, max_sym,
            block_len).cpu().numpy())
    return out
