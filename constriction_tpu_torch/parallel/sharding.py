"""Block legs: the coders over a list of independent blocks.

Each leg takes one input per block in the port's own layout (the one its
per-call wrapper takes) and runs one block program over ``device``
(``container.upload``, ``launch``, ``gather``): ``"cuda"``, the default,
raising without a card; ``"cpu"``, the plain PyTorch twins; or a sequence
of devices, the blocks split in order over the largest divisor of B they
hold (``container.block_devices``).  Each device gets one upload; its
blocks are launched back to back through the coders' launch forms, which
read nothing back; then a fixed number of read-backs a device returns one
numpy output per block, in block order.  Values the kernels cannot check
without a read-back (family parameters, the TChain CDF) are checked on the
host first.  Blocks share nothing, so no leg communicates.

JAX counterpart: the ``shard_*_pallas`` legs of
``constriction_tpu.parallel.sharding`` (one Pallas kernel per block under
``shard_map``); their ``[D, rows, 128]`` window layouts do not carry over
(``convert.rows_to_torch`` and ``convert.family_params_to_torch`` turn
them into the port's).  Its ILANS v1 and ``jax_coder2`` legs
(``shard_encode``, ``shard_decode_lookup``, ``shard_encode2``,
``shard_decode2``, ``gather_blocks``) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from ..ops import exact_family, family, tchain
from ..ops import interleaved2 as il2
from ..ops.interleaved import LaneConfig
from . import container
from .container import _devices


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


def _run(step, finish, blocks: list, shared: list, device) -> list:
    """A leg's three halves (``container.upload`` / ``launch`` /
    ``gather``) over ``device``."""
    programs = container.upload(blocks, shared, _devices(device))
    return container.gather(finish, container.launch(step, programs))


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
    inputs = []
    for b, blk in enumerate(blocks):
        t = [torch.from_numpy(np.ascontiguousarray(blk, dtype=np.int32))]
        if seeds is not None:
            t.append(convert.states_to_torch(il2.check_seeds(seeds[b], cfg),
                                             cfg))
        inputs.append(t)
    return _run(lambda c, s, *sd: il2.launch_encode(s, c, cfg, *sd),
                lambda outs: il2.finish_encodes(outs, cfg), inputs,
                [convert.cdf_to_torch(cdf)], device)


def _lane_inputs(states, streams, cfg: LaneConfig) -> list:
    return [[convert.states_to_torch(st, cfg), convert.u32_to_torch(sw)]
            for st, sw in zip(states, streams)]


def _decode(states, streams, cdf, cfg, block_len: int, device) -> list:
    return _run(
        lambda c, st, sw: il2.launch_decode(st, sw, c, cfg, block_len)[0],
        convert.read_back, _lane_inputs(states, streams, cfg),
        [convert.cdf_to_torch(cdf)], device)


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
    return il2.range_symbols(_run(
        lambda c, pt, sw: il2.launch_decode_range(pt, sw, c, cfg, block_len),
        il2.finish_range_decodes, _lane_inputs(points, streams, cfg),
        [convert.cdf_to_torch(cdf)], device))


def shard_decode_range_cuda(points, streams, cdf, cfg: LaneConfig,
                            block_len: int, device="cuda") -> list:
    """S=32 range decode (kernel 6) of each block's (u32 points [L],
    stream) pair; data the model cannot have written raises ValueError
    after every block was launched (the JAX leg returns a flag per block
    instead).  JAX counterpart: ``sharding.shard_decode_range_pallas``."""
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
    ``ops.family.decode_family``).  The parameters' values are checked on
    the host, every block's, before the upload.  Returns int32 symbols per
    block.  JAX counterpart: ``sharding.shard_decode_family_pallas``."""
    cpu = torch.device("cpu")
    count = -(-block_len // cfg.num_lanes) * cfg.num_lanes
    inputs = []
    for st, (mu, sd), sw in zip(states, params, streams):
        t = [x.detach().cpu() for x in (st, mu, sd, sw)]
        family.check_params(t[1], t[2], count, cpu)
        inputs.append(t)
    return _run(
        lambda st, mu, sd, sw: family.launch_decode_family(
            st, sw, mu, sd, family_name, min_sym, max_sym, cfg,
            block_len)[0],
        convert.read_back, inputs, [], device)


def shard_tchain_decode_cuda(qwords, cdf, cfg: LaneConfig = tchain.TCHAIN_CFG,
                             device="cuda") -> list:
    """TChain-16 bits-back decode (kernel 19) of each block's planar
    quantile words (int32[T * L/2] tensors, ``ops.tchain.pack_quantiles``
    flattened); the CDF is checked once, on the host.  Returns
    ``[(symbols int32, remainders u32, heads u32[L])]`` numpy per block.
    JAX counterpart: ``sharding.shard_tchain_decode_pallas`` (which returns
    the remainder windows and their ends instead of the remainders)."""
    cdf_t = convert.cdf_to_torch(cdf)
    tchain._check_model(cdf_t, cdf_t.device, tchain.TCHAIN_CFG.precision)

    def step(c, qw):
        syms, buf, end, heads = tchain.launch_tchain16_decode(qw, c, cfg)
        return syms, (buf, end), heads

    def finish(outs):
        got = convert.read_back([x for out in outs for x in out])
        return [(syms, rem.view(np.uint32), heads.view(np.uint32))
                for syms, rem, heads in zip(got[::3], got[1::3], got[2::3])]

    return _run(step, finish, [[qw] for qw in qwords], [cdf_t], device)


def shard_decode_exact_family_cuda(states, tabs, streams, min_sym: int,
                                   max_sym: int, cfg: LaneConfig,
                                   block_len: int, device="cuda") -> list:
    """Reference-exact family decode of each block against its own
    precomputed tables (kernel 13 at W=16/S=32, kernel 15 at W=32/S=64):
    ``states`` int32[L] (int64 at S=64), ``tabs`` int32 ``[T, CP1, L]``
    (``convert.exact_tables_to_torch``) and ``streams`` int32 tensors.
    Returns int32 symbols per block.  JAX counterpart:
    ``sharding.shard_decode_exact_family_pallas`` (whose ``cmax`` the
    tables' plane count gives here)."""
    return _run(
        lambda st, tab, sw: exact_family.decode_tables(
            st, sw, tab, cfg, min_sym, max_sym, block_len),
        convert.read_back, [list(blk) for blk in zip(states, tabs, streams)],
        [], device)
