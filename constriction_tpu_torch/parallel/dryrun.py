"""Dry run of every block-sharded path on a list of devices, at tiny shapes.

    from constriction_tpu_torch.parallel.dryrun import dryrun
    dryrun(["cuda"])          # or ["cpu"] * 4: the plain PyTorch twins

JAX counterpart: ``__graft_entry__.dryrun_multichip``, with a list of
devices in place of its mesh: one block per device (B = the number of
devices), the same models, sizes and seeds.  Its legs: the v1 rANS and
range containers, a compact v2 container (with a pooled tail; the JAX dry
run has no v2 leg), the rANS block pair, and the block decodes (range,
family, reference-exact family, TChain-16, and the DEFAULT-preset rANS
and range decodes).  Every leg is held against the port's numpy oracles:
the containers against :func:`container.encode_host`, the blocks' encodes
against the host coders, every decode against the symbols it must give.
The first mismatch raises AssertionError.  Each container call and each
leg is one block program (``container.upload``, ``launch``, ``gather``):
fourteen launch halves in all, none of which reads anything back.
"""

from __future__ import annotations

import numpy as np

from .. import convert
from ..models import fast_quantized_cdf
from ..ops import exact_family, family, tchain
from ..ops import interleaved2 as il2
from ..ops.interleaved import LaneConfig
from . import container, sharding

_CFG = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
_CFG64 = LaneConfig(num_lanes=128, word_bits=32, state_bits=64, precision=24)
_BLOCK_LEN = 200


def _same(got, want, what: str) -> None:
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise AssertionError(f"dryrun: {what} mismatch")


def _same_blocks(got: list, want: list, what: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"dryrun: {what}: {len(got)} blocks, not "
                             f"{len(want)}")
    for g, w in zip(got, want):
        _same(g, w, what)


def _host_tables(cdf, blk):
    c = np.asarray(cdf, dtype=np.uint64)
    return c[blk], c[blk + 1] - c[blk]


def _containers(devices, cdf, symbols, long_symbols) -> dict:
    """The v1 rANS and range containers and a compact v2 one."""
    B = len(devices)
    legs = {}
    for name, coder, compact, syms in (
        ("rans_container", "rans", False, symbols),
        ("range_container", "range", False, symbols),
        ("compact_container", "rans", True, long_symbols),
    ):
        cont = container.encode(syms, cdf, cfg=_CFG, num_blocks=B,
                                device=devices, coder=coder, compact=compact)
        _same(cont, container.encode_host(syms, cdf, _CFG, B, coder, compact),
              f"{name} bytes")
        _same(container.decode(cont, cdf, device=devices), syms,
              f"{name} round trip")
        legs[name] = {"blocks": B, "symbols": len(syms), "words": len(cont)}
    k_tail = container.unpack_sharded_v2(cont)[5]
    if not k_tail:
        raise AssertionError("dryrun: the compact container has no tail")
    legs["compact_container"]["k_tail"] = k_tail
    return legs


def dryrun(devices) -> dict:
    """Run every leg once on ``devices`` (a sequence of devices, as the
    ``device`` argument of ``parallel.encode`` takes); returns a dict of
    legs, each with its block count and sizes.  JAX counterpart:
    ``__graft_entry__.dryrun_multichip(len(devices))``."""
    devices = list(devices)
    B = len(devices)
    rng = np.random.RandomState(0)
    alphabet = 16
    probs = rng.dirichlet(np.ones(alphabet))
    cdf = fast_quantized_cdf(probs, 12)
    symbols = rng.choice(alphabet, size=64 * B + 3, p=probs)
    # long enough for a pooled tail: 4 B L symbols and twice the seed
    # capacity B L (S - W) in information
    long_symbols = rng.choice(alphabet, size=2048 * B, p=probs)
    legs = _containers(devices, cdf, symbols, long_symbols)

    n_p = _BLOCK_LEN * B
    symbols_p = rng.choice(alphabet, size=n_p, p=probs).astype(np.int64)
    blocks = [symbols_p[b * _BLOCK_LEN:(b + 1) * _BLOCK_LEN]
              for b in range(B)]
    L = _CFG.num_lanes

    # rANS block pair (kernels 3 and 4)
    coded = sharding.shard_encode2_cuda(blocks, cdf, _CFG, device=devices)
    for blk, (st, sw) in zip(blocks, coded):
        st_h, sw_h = il2.encode_shared(*_host_tables(cdf, blk), _CFG)
        _same(st, st_h, "block encode states")
        _same(sw, sw_h, "block encode stream")
    out = sharding.shard_decode2_cuda([c[0] for c in coded],
                                      [c[1] for c in coded], cdf, _CFG,
                                      _BLOCK_LEN, device=devices)
    _same_blocks(out, blocks, "block pair round trip")
    legs["rans_blocks"] = {"blocks": B, "symbols": n_p}

    # range decode (kernel 6) of host-coded blocks
    coded = [il2.encode_shared_range(*_host_tables(cdf, blk), _CFG)
             for blk in blocks]
    out = sharding.shard_decode_range_cuda([c[0] for c in coded],
                                           [c[1] for c in coded], cdf, _CFG,
                                           _BLOCK_LEN, device=devices)
    _same_blocks(out, blocks, "range decode")
    legs["range_decode"] = {"blocks": B, "symbols": n_p}

    # per-symbol family decode (kernel 11)
    means = rng.uniform(-30, 30, size=n_p)
    scales = rng.uniform(0.5, 12.0, size=n_p)
    fam_blocks = [np.clip(blk - 8, -40, 40) for blk in blocks]
    states, params, streams = [], [], []
    for b, blk in enumerate(fam_blocks):
        sl = slice(b * _BLOCK_LEN, (b + 1) * _BLOCK_LEN)
        cum, prob = family.family_tables_host(blk, means[sl], scales[sl],
                                              "gaussian", -50, 50)
        st, sw = il2.encode_shared(cum, prob, _CFG)
        states.append(convert.u32_to_torch(st))
        streams.append(convert.u32_to_torch(sw))
        params.append(convert.params_to_torch(means[sl], scales[sl],
                                              _BLOCK_LEN, L))
    out = sharding.shard_decode_family_cuda(states, params, streams,
                                            "gaussian", -50, 50, _CFG,
                                            _BLOCK_LEN, device=devices)
    _same_blocks(out, fam_blocks, "family decode")
    legs["family_decode"] = {"blocks": B, "symbols": n_p}

    # reference-exact family decode at S=32 (kernel 13), tables for cmax 64
    T = -(-_BLOCK_LEN // L)
    states, tabs, streams = [], [], []
    for b, blk in enumerate(fam_blocks):
        sl = slice(b * _BLOCK_LEN, (b + 1) * _BLOCK_LEN)
        m, s = means[sl], np.clip(scales[sl], 0.5, 4.0)
        cums, probs_e = exact_family.exact_ecp(blk, m, s, "gaussian", -50, 50,
                                               _CFG.precision)
        st, sw = il2.encode_shared(cums.astype(np.uint64),
                                   probs_e.astype(np.uint64), _CFG)
        pm, ps = exact_family._pad_params(m, s, T * L, "gaussian", 50)
        tabs4, _ = exact_family.narrow_tables(pm, ps, "gaussian", -50, 50,
                                              _CFG.precision, 64, T, L // 128)
        states.append(convert.u32_to_torch(st))
        streams.append(convert.u32_to_torch(sw))
        tabs.append(convert.exact_tables_to_torch(tabs4))
    out = sharding.shard_decode_exact_family_cuda(states, tabs, streams, -50,
                                                  50, _CFG, _BLOCK_LEN,
                                                  device=devices)
    _same_blocks(out, fam_blocks, "exact-family decode")
    legs["exact_family_decode"] = {"blocks": B, "symbols": n_p}

    # TChain-16 bits-back decode (kernel 19): a P=12 model lifted to P=16
    cfg_t = LaneConfig(num_lanes=256, word_bits=16, state_bits=32,
                       precision=16)
    cdf16 = np.asarray(cdf, dtype=np.uint64) << np.uint64(4)
    quants = [rng.randint(0, 1 << 16, size=2 * cfg_t.num_lanes)
              .astype(np.uint16) for _ in range(B)]
    out = sharding.shard_tchain_decode_cuda(
        [convert.quantiles16_to_torch(q, cfg_t.num_lanes) for q in quants],
        cdf16, cfg_t, device=devices)
    for q, got in zip(quants, out):
        for g, w in zip(got, tchain.tchain_decode_host(q, cdf16, cfg_t)):
            _same(g, w, "TChain-16 decode")
    legs["tchain16_decode"] = {"blocks": B, "quantiles": B * len(quants[0])}

    # the DEFAULT preset's rANS and range decodes (kernels 1 and 5)
    cdf24 = fast_quantized_cdf(probs, 24)
    for name, enc, dec in (
        ("rans64_decode", il2.encode_shared, sharding.shard_decode64_cuda),
        ("range64_decode", il2.encode_shared_range,
         sharding.shard_decode_range64_cuda),
    ):
        coded = [enc(*_host_tables(cdf24, blk), _CFG64) for blk in blocks]
        out = dec([c[0] for c in coded], [c[1] for c in coded], cdf24,
                  _CFG64, _BLOCK_LEN, device=devices)
        _same_blocks(out, blocks, name)
        legs[name] = {"blocks": B, "symbols": n_p}
    return legs
