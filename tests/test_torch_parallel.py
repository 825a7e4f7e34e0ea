"""The port's block-sharded containers and block legs against the JAX
package's ``parallel``, on the CPU (``device="cpu"``: the plain PyTorch
twins; lists of CPU devices for the device count).

Containers must equal the JAX package's byte for byte: rANS v1 and compact
v2 against its host loop (``encode(..., device=False)``, numpy), range
containers against one interpret-mode call of its device encoder per
preset (its host range encoder is C++ only) and the pinned golden vector.
Each package decodes the other's containers.  The JAX package's host code
takes its numpy path here (``native.LIB`` set to None), so no test
depends on its C++ build.
"""

import hashlib
import types

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu import parallel as jpar
from constriction_tpu.ops import exact_family as ref_exf
from constriction_tpu.ops import pallas_coder as pc
from constriction_tpu.ops import pallas_family as pf
from constriction_tpu.ops import tchain as ref_tc
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu.parallel import container as jcont
from constriction_tpu_torch import convert, parallel
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import chain as ch
from constriction_tpu_torch.ops import exact_family as exf
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops import tchain as tc
from constriction_tpu_torch.ops.interleaved import LaneConfig
from constriction_tpu_torch.parallel import container

CFG = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
CFG64 = LaneConfig(num_lanes=128, word_bits=32, state_bits=64, precision=24)


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host code on its numpy path."""
    monkeypatch.setattr(native, "LIB", None)


def _ref(cfg):
    return None if cfg is None else RefLaneConfig(
        cfg.num_lanes, cfg.word_bits, cfg.state_bits, cfg.precision)


def _workload(n, P=12, seed=5, K=37):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(K))
    cdf = fast_quantized_cdf(probs, P)
    return rng.choice(K, size=n, p=probs).astype(np.int64), cdf


def _both_decode(cont, cdf, symbols):
    np.testing.assert_array_equal(parallel.decode(cont, cdf, device="cpu"),
                                  symbols)
    np.testing.assert_array_equal(jpar.decode(cont, cdf, device=False),
                                  symbols)


# --- framing


@pytest.mark.parametrize("S,coder", [(32, 0), (64, 0), (32, 1), (64, 1)])
def test_pack_sharded_matches_jax(S, coder):
    rng = np.random.RandomState(S + coder)
    cfg = LaneConfig(128, S // 2, S, 12)
    B = 3
    states = rng.randint(0, 1 << 32, size=(B, 128)).astype(np.uint64)
    if S == 64:
        states = (states << np.uint64(32)) | states
    streams = [rng.randint(0, 1 << (S // 2), size=m).astype(np.uint32)
               for m in (0, 7, 300)]
    got = parallel.pack_sharded(states, streams, 777, 259, cfg, coder)
    want = jpar.pack_sharded(states, streams, 777, 259, _ref(cfg), coder)
    np.testing.assert_array_equal(got, want)
    mine, ref = parallel.unpack_sharded(got), jpar.unpack_sharded(got)
    np.testing.assert_array_equal(mine[0], ref[0])
    for a, b in zip(mine[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    assert mine[2:4] == ref[2:4] and mine[5] == ref[5] == coder
    assert mine[4] == cfg


@pytest.mark.parametrize("S,tail_words", [(32, 0), (32, 40), (64, 700)])
def test_pack_sharded_v2_matches_jax(S, tail_words):
    """Packed states, the tail words in the seeds and (at 700 words, more
    than B L (S - W) bits) the spill."""
    rng = np.random.RandomState(S + tail_words)
    cfg = LaneConfig(128, S // 2, S, 12)
    B = 2
    lo = np.uint64(1 << (S - S // 2))
    states = np.maximum(
        rng.randint(0, 1 << 31, size=(B, 128)).astype(np.uint64)
        << np.uint64(S - 31), lo)
    streams = [rng.randint(0, 1 << 16, size=m).astype(np.uint32)
               for m in (5, 90)]
    tail = rng.randint(0, 1 << 32, size=tail_words).astype(np.uint32)
    got = parallel.pack_sharded_v2(states, streams, 999, 400, cfg, 123, tail)
    want = jcont.pack_sharded_v2(states, streams, 999, 400, _ref(cfg), 123,
                                 tail)
    np.testing.assert_array_equal(got, want)
    mine, ref = parallel.unpack_sharded_v2(got), jcont.unpack_sharded_v2(got)
    np.testing.assert_array_equal(mine[0], ref[0])
    np.testing.assert_array_equal(mine[0], states)
    for a, b in zip(mine[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    assert mine[2:4] == ref[2:4] and mine[5:7] == ref[5:7]
    np.testing.assert_array_equal(mine[7], ref[7])
    assert (len(mine[7]) > 0) == (tail_words * 32 > B * 128 * (S - S // 2))


def test_container_format_is_pinned():
    """The golden vector of ``tests/test_container.py``: the port writes
    the JAX package's pinned bytes at every rANS and range container."""
    rng = np.random.RandomState(42)
    probs = rng.dirichlet(np.ones(17))
    syms = rng.choice(17, size=1000, p=probs).astype(np.int64)
    cdf = fast_quantized_cdf(probs, 12)
    want = {"rans": (2100240, "f013edd12ed31e0a"),
            "range": (18877456, "1dfd768b7498063c")}
    for coder, (packed_cfg, sha16) in want.items():
        for cont in (parallel.encode(syms, cdf, cfg=CFG, num_blocks=4,
                                     device="cpu", coder=coder),
                     parallel.encode_host(syms, cdf, CFG, 4, coder)):
            assert list(cont[:8]) == [0x494C4E53, 1, packed_cfg, 1000, 0,
                                      128, 4, 250], coder
            assert len(cont) == 524
            assert hashlib.sha256(cont.tobytes()).hexdigest()[:16] == sha16
        _both_decode(cont, cdf, syms)


def _v2_corruptions(good):
    def edit(i, v):
        bad = good.copy()
        bad[i] = np.uint32(v)
        return bad

    return [
        (good[:9], "truncated v2 sharded container header"),
        (edit(0, 0x494C4E32), "not a v2 sharded container"),
        (edit(2, int(good[2]) & ~0xFF | 8), r"invalid \(W, P, S\)"),
        (edit(2, int(good[2]) | (30 << 8)), r"invalid \(W, P, S\)"),
        (edit(5, 0), "invalid geometry"),
        (edit(6, 1 << 20), "invalid geometry"),
        (edit(5, 4096), "packed-state lengths inconsistent"),
        (good[:-1], "truncated or oversized"),
        (np.concatenate([good, good[:2]]), "truncated or oversized"),
    ]


def test_unpack_sharded_v2_rejects_corrupt_headers():
    syms, cdf = _workload(3000, seed=8)
    good = parallel.encode(syms, cdf, cfg=CFG, num_blocks=2, device="cpu",
                           compact=True)
    for bad, match in _v2_corruptions(good):
        with pytest.raises(ValueError, match=match):
            parallel.unpack_sharded_v2(bad)
        with pytest.raises(ValueError, match=match):
            jcont.unpack_sharded_v2(bad)


def test_unpack_sharded_rejects_corrupt_headers():
    syms, cdf = _workload(500, seed=34)
    good = parallel.encode(syms, cdf, cfg=CFG, num_blocks=2, device="cpu")
    coder_bad = good.copy()
    coder_bad[2] |= np.uint32(2 << 24)
    width_bad = good.copy()
    width_bad[2] = (int(good[2]) & ~0xFF) | 8
    for bad, match in ((good[:-3], "truncated or oversized"),
                       (coder_bad, "unknown coder id"),
                       (width_bad, "invalid word_bits")):
        for unpack in (parallel.unpack_sharded, jpar.unpack_sharded):
            with pytest.raises(ValueError, match=match):
                unpack(bad)
        with pytest.raises(ValueError, match=match):
            parallel.decode(bad, cdf, device="cpu")


# --- rANS containers against the JAX package's host loop


@pytest.mark.parametrize("P", [12, 24])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("n", [1, 777, 10007])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_rans_containers_identical_to_jax(P, compact, n, B):
    syms, cdf = _workload(n, P=P, seed=n + B)
    got = parallel.encode(syms, cdf, num_blocks=B, device="cpu",
                          compact=compact)
    want = jpar.encode(syms, cdf, num_blocks=B, device=False,
                       compact=compact)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        parallel.encode_host(syms, cdf, None, B, compact=compact), want)
    _both_decode(got, cdf, syms)


def test_blocks_of_padding_only():
    """n = 10, B = 8: blocks 5 .. 7 hold only the pad symbol; the header
    keeps the true length."""
    syms, cdf = _workload(10, seed=3)
    for compact in (False, True):
        got = parallel.encode(syms, cdf, cfg=CFG, num_blocks=8,
                              device="cpu", compact=compact)
        np.testing.assert_array_equal(
            got, jpar.encode(syms, cdf, cfg=_ref(CFG), num_blocks=8,
                             device=False, compact=compact))
        _both_decode(got, cdf, syms)
    assert list(got[3:8]) == [10, 0, 128, 8, 2]


@pytest.mark.parametrize("P", [12, 24])
def test_compact_pooled_tail_identical_to_jax(P):
    """A message long enough for the pooled tail.  At P=24 the tail
    container (its own framing included) overflows the blocks' seed
    capacity, and the rest ships raw as the spill."""
    rng = np.random.RandomState(21 + P)
    probs = rng.dirichlet(np.full(60, 1.2))
    cdf = fast_quantized_cdf(probs, P)
    n = 200_000
    syms = rng.choice(60, size=n, p=probs).astype(np.int64)
    W = 32 if P == 24 else 16
    cfg = LaneConfig(256, W, 2 * W, P)
    got = parallel.encode(syms, cdf, cfg=cfg, num_blocks=4, device="cpu",
                          compact=True)
    want = jpar.encode(syms, cdf, cfg=_ref(cfg), num_blocks=4, device=False,
                       compact=True)
    np.testing.assert_array_equal(got, want)
    fields = parallel.unpack_sharded_v2(got)
    assert fields[5] > 0  # k_tail
    if P == 24:
        assert len(fields[7]) > 0  # the spill
    _both_decode(got, cdf, syms)
    assert len(got) < len(parallel.encode(syms, cdf, cfg=cfg, num_blocks=4,
                                          device="cpu"))


def test_padding_avoids_zero_probability_symbol():
    """The pad symbol is the first one of nonzero probability."""
    cdf = np.array([0, 0, 1000, 3000, 1 << 12], dtype=np.uint32)
    syms = np.array([1, 2, 3, 2, 1, 3, 2], dtype=np.int64)
    for compact in (False, True):
        got = parallel.encode(syms, cdf, cfg=CFG, num_blocks=2,
                              device="cpu", compact=compact)
        np.testing.assert_array_equal(
            got, jpar.encode(syms, cdf, cfg=_ref(CFG), num_blocks=2,
                             device=False, compact=compact))
        _both_decode(got, cdf, syms)


# --- range containers against one interpret-mode JAX call per preset


@pytest.mark.parametrize("cfg", [CFG, CFG64])
def test_range_containers_identical_to_jax(cfg):
    syms, cdf = _workload(701, P=cfg.precision, seed=cfg.precision)
    want = jpar.encode(syms, cdf, cfg=_ref(cfg), num_blocks=2, device=True,
                       coder="range")
    np.testing.assert_array_equal(
        parallel.encode(syms, cdf, cfg=cfg, num_blocks=2, device="cpu",
                        coder="range"), want)
    np.testing.assert_array_equal(
        parallel.encode_host(syms, cdf, cfg, 2, "range"), want)
    assert parallel.unpack_sharded(want)[5] == parallel.CODER_RANGE
    _both_decode(want, cdf, syms)


# --- device lists


@pytest.mark.parametrize("B", [6, 8])
def test_device_count_does_not_change_the_bytes(B):
    syms, cdf = _workload(3001, seed=9)
    one = parallel.encode(syms, cdf, cfg=CFG, num_blocks=B, device="cpu")
    for D in (1, 2, 3, 4):
        devices = ["cpu"] * D
        for compact in (False, True):
            got = parallel.encode(syms, cdf, cfg=CFG, num_blocks=B,
                                  device=devices, compact=compact)
            if not compact:
                np.testing.assert_array_equal(got, one)
            np.testing.assert_array_equal(
                parallel.decode(got, cdf, device=devices), syms)
        mesh = types.SimpleNamespace(devices=np.arange(D))
        want = jcont._pick_device_count(B, mesh)
        placed = container.block_devices(B, list(range(D)))
        assert placed == sorted(placed) and len(set(placed)) == want
        assert all(placed.count(d) == B // want for d in set(placed))


# --- block checkpoints


@pytest.mark.parametrize("P,coder,compact", [(12, "rans", False),
                                             (24, "rans", False),
                                             (24, "range", False),
                                             (12, "rans", True)])
def test_block_checkpoints_match_jax(P, coder, compact):
    n = 6001
    syms, cdf = _workload(n, P=P, seed=11)
    cfg = CFG64 if P == 24 else CFG
    cont = parallel.encode_host(syms, cdf, cfg, 3, coder, compact)
    interval = 2
    offs, sts = parallel.build_block_checkpoints(cont, cdf, interval)
    r_offs, r_sts = jpar.build_block_checkpoints(cont, cdf, interval)
    np.testing.assert_array_equal(offs, r_offs)
    for a, b in zip(sts if coder == "range" else [sts],
                    r_sts if coder == "range" else [r_sts]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    unpack = parallel.unpack_sharded_v2 if compact else parallel.unpack_sharded
    fields = unpack(cont)
    block_len, n_blocks = fields[3], n - (fields[5] if compact else 0)
    full = parallel.decode(cont, cdf, device="cpu")
    for block in range(3):
        nb = min(block_len, max(n_blocks - block * block_len, 0))
        steps = -(-nb // 128)
        real = max(-(-steps // interval) - 1, 0)
        for ck in range(real):
            start, suffix = parallel.decode_block_from_checkpoint(
                cont, cdf, interval, block, ck, offs, sts, device="cpu")
            assert start == block * block_len + (ck + 1) * interval * 128
            end = min((block + 1) * block_len, n_blocks)
            np.testing.assert_array_equal(suffix, full[start:end])
        # a stale index into the block's zero padding, and one before it
        for ck in (real, -1):
            with pytest.raises(ValueError, match="ckpt_index"):
                parallel.decode_block_from_checkpoint(
                    cont, cdf, interval, block, ck, offs, sts, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        parallel.decode_block_from_checkpoint(cont, cdf, interval, 3, 0,
                                              offs, sts, device="cpu")


# --- argument checks


def test_encode_and_decode_raise_where_jax_does():
    syms, cdf = _workload(500, seed=33)
    bad = syms.copy()
    bad[3] = len(cdf) - 1
    neg = syms.copy()
    neg[3] = -1
    for kwargs, match in (
        ({"num_blocks": 0}, "num_blocks"),
        ({"cdf": cdf[:-1]}, "cdf"),
        ({"symbols": bad}, "symbols must be in"),
        ({"symbols": neg}, "symbols must be in"),
        ({"coder": "queue"}, "coder must be one of"),
        ({"compact": True, "coder": "range"}, "compact"),
    ):
        args = {"symbols": syms, "cdf": cdf, "num_blocks": 2, **kwargs}
        with pytest.raises(ValueError, match=match):
            parallel.encode(args.pop("symbols"), args.pop("cdf"), cfg=CFG,
                            device="cpu", **args)
        args = {"symbols": syms, "cdf": cdf, "num_blocks": 2, **kwargs}
        with pytest.raises(ValueError, match=match):
            jpar.encode(args.pop("symbols"), args.pop("cdf"), cfg=_ref(CFG),
                        device=False, **args)
    cont = parallel.encode(syms, cdf, cfg=CFG, num_blocks=2, device="cpu")
    for decode, kw in ((parallel.decode, {"device": "cpu"}),
                       (jpar.decode, {"device": False})):
        with pytest.raises(ValueError, match="cdf"):
            decode(cont, cdf[:-1], **kw)
        with pytest.raises(ValueError, match="truncated or oversized"):
            decode(cont[:-3], cdf, **kw)


def test_invalid_range_data_raises():
    syms, cdf = _workload(2000, seed=25)
    for cfg in (CFG, CFG64):
        c = fast_quantized_cdf(np.diff(cdf) / float(cdf[-1]), cfg.precision)
        cont = parallel.encode(syms, c, cfg=cfg, num_blocks=4, device="cpu",
                               coder="range")
        states, streams, n, bl, cfg2, coder = parallel.unpack_sharded(cont)
        top = np.full_like(states, np.iinfo(states.dtype).max)
        bad = parallel.pack_sharded(top, streams, n, bl, cfg2, coder)
        with pytest.raises(ValueError, match="inconsistent with the entropy"):
            parallel.decode(bad, c, device="cpu")


def test_precision_above_word_size_raises():
    """A deliberate difference: the JAX package writes such containers."""
    syms, cdf = _workload(300, P=24, seed=4)
    with pytest.raises(ValueError, match="precision 24 is incompatible"):
        parallel.encode(syms, cdf, cfg=LaneConfig(128, 16, 64, 24),
                        num_blocks=2, device="cpu")


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    syms, cdf = _workload(300, seed=1)
    cont = parallel.encode(syms, cdf, cfg=CFG, num_blocks=2, device="cpu")
    calls = [
        lambda: parallel.encode(syms, cdf, cfg=CFG, num_blocks=2),
        lambda: parallel.decode(cont, cdf),
        lambda: parallel.encode(syms, cdf, cfg=CFG, device=["cpu", "cuda"]),
        lambda: parallel.decode_block_from_checkpoint(
            cont, cdf, 1, 0, 0, *parallel.build_block_checkpoints(
                cont, cdf, 1)),
        lambda: parallel.shard_encode2_cuda([syms], cdf, CFG),
        lambda: parallel.dryrun(["cuda"]),
        lambda: ch.chain_decode_iid(np.ones(8, np.uint32), 4, cdf),
        lambda: ch.chain_decode_rows(np.ones(8, np.uint32),
                                     np.tile(cdf, (4, 1))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- block legs, from the JAX package's leg inputs


def test_prepare_blocks_matches_jax():
    syms, cdf = _workload(1001, seed=2)
    for a, b in zip(parallel.prepare_blocks(syms, cdf, 3, CFG),
                    jpar.prepare_blocks(syms, cdf, 3, _ref(CFG))):
        np.testing.assert_array_equal(a, b)


def test_rows_and_family_params_round_trip():
    rng = np.random.RandomState(6)
    rows = rng.randint(0, 1 << 32, size=(5, 128)).astype(np.uint32)
    np.testing.assert_array_equal(
        convert.rows_from_torch(convert.rows_to_torch(rows), 5), rows)
    words = rng.randint(0, 1 << 16, size=300).astype(np.uint32)
    stream2d = np.asarray(pc._pad_stream2d(words, 2))
    t = convert.rows_to_torch(stream2d)
    np.testing.assert_array_equal(convert.u32_from_torch(t)[:300], words)
    np.testing.assert_array_equal(
        convert.rows_from_torch(t, stream2d.shape[0]), stream2d)
    params = rng.randn(3, 2, 2, 128).astype(np.float32)
    mu, sd = convert.family_params_to_torch(params)
    assert mu.dtype == torch.float32 and mu.shape == (3 * 256,)
    np.testing.assert_array_equal(
        convert.family_params_from_torch(mu, sd, 256), params)


def _blocks(n_blocks, block_len, seed, K=16):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(K))
    syms = rng.choice(K, size=n_blocks * block_len, p=probs).astype(np.int64)
    return rng, probs, [syms[b * block_len:(b + 1) * block_len]
                        for b in range(n_blocks)]


def _host(cdf, blk):
    c = np.asarray(cdf, dtype=np.uint64)
    return c[blk], c[blk + 1] - c[blk]


@pytest.mark.parametrize("cfg", [CFG, CFG64])
def test_rans_and_range_legs(cfg):
    _, probs, blocks = _blocks(3, 300, seed=cfg.state_bits)
    cdf = fast_quantized_cdf(probs, cfg.precision)
    coded = parallel.shard_encode2_cuda(blocks, cdf, cfg,
                                        device=["cpu", "cpu", "cpu"])
    decode = (parallel.shard_decode64_cuda if cfg.state_bits == 64
              else parallel.shard_decode2_cuda)
    range_decode = (parallel.shard_decode_range64_cuda
                    if cfg.state_bits == 64
                    else parallel.shard_decode_range_cuda)
    for blk, (st, sw) in zip(blocks, coded):
        for a, b in zip((st, sw), il2.encode_lanes(blk, cdf, cfg, "cpu")):
            np.testing.assert_array_equal(a, b)
        for a, b in zip((st, sw), il2.encode_shared(*_host(cdf, blk), cfg)):
            np.testing.assert_array_equal(a, b)
    out = decode([c[0] for c in coded], [c[1] for c in coded], cdf, cfg, 300,
                 device="cpu")
    for got, blk, (st, sw) in zip(out, blocks, coded):
        np.testing.assert_array_equal(got, blk)
        np.testing.assert_array_equal(
            got, il2.decode_shared_cdf(st, sw, 300, cdf, cfg))
    ranged = [il2.encode_shared_range(*_host(cdf, blk), cfg)
              for blk in blocks]
    out = range_decode([r[0] for r in ranged], [r[1] for r in ranged], cdf,
                       cfg, 300, device="cpu")
    for got, blk, (pt, sw) in zip(out, blocks, ranged):
        np.testing.assert_array_equal(got, blk)
        np.testing.assert_array_equal(
            got, il2.decode_shared_range_cdf(pt, sw, 300, cdf, cfg))
    with pytest.raises(ValueError, match="S="):
        (parallel.shard_decode2_cuda if cfg.state_bits == 64
         else parallel.shard_decode64_cuda)(
            [coded[0][0]], [coded[0][1]], cdf, cfg, 300, device="cpu")


def test_family_leg_from_jax_layouts():
    """The JAX leg's inputs ([rows, 128] stream windows, [T, 2, R, 128]
    parameters) through the converters, against the per-call decode and
    both packages' numpy oracles."""
    import jax.numpy as jnp

    rng, _, blocks = _blocks(2, 300, seed=7)
    R, T = 1, 3
    states, params, streams, wants = [], [], [], []
    for blk in blocks:
        means = rng.uniform(-30, 30, size=300)
        scales = rng.uniform(0.5, 12.0, size=300)
        sym = np.clip(blk - 8, -40, 40)
        wants.append(sym)
        st, sw = il2.encode_shared(*fam.family_tables_host(
            sym, means, scales, "gaussian", -50, 50), CFG)
        m3 = pf._blocks3d(means, T, R, 300, jnp.float32)
        s3 = pf._blocks3d(scales, T, R, 300, jnp.float32, 1.0)
        params.append(convert.family_params_to_torch(
            np.asarray(jnp.stack([m3, s3], axis=1))))
        states.append(convert.u32_to_torch(st))
        streams.append(convert.rows_to_torch(pc._pad_stream2d(sw, R)))
        np.testing.assert_array_equal(
            fam.decode_family_host(st, sw, means, scales, "gaussian", -50,
                                   50, CFG, 300),
            pf.decode_family_host(st, sw, means, scales, "gaussian", -50, 50,
                                  _ref(CFG), 300))
    out = parallel.shard_decode_family_cuda(states, params, streams,
                                            "gaussian", -50, 50, CFG, 300,
                                            device=["cpu", "cpu"])
    for got, want, st, (mu, sd), sw in zip(out, wants, states, params,
                                           streams):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, fam.decode_family(st, sw, mu, sd, "gaussian", -50, 50, CFG,
                                   300).numpy())


def test_exact_family_leg_from_jax_layouts():
    """[T, CP1, R, 128] exact tables as the JAX dry run builds them."""
    rng, _, blocks = _blocks(2, 300, seed=8)
    L, T, cmax = 128, 3, 64
    states, tabs, streams, wants = [], [], [], []
    for blk in blocks:
        m = rng.uniform(-30, 30, size=300)
        s = rng.uniform(0.5, 4.0, size=300)
        sym = np.clip(blk - 8, -40, 40)
        wants.append(sym)
        cums, probs = ref_exf.exact_ecp(sym, m, s, "gaussian", -50, 50, 12)
        st, sw = il2.encode_shared(cums.astype(np.uint64),
                                   probs.astype(np.uint64), CFG)
        aux, core = ref_exf.exact_boundary_tables(
            ref_exf._pad_to(m, T * L), ref_exf._pad_to(s, T * L, 1.0),
            "gaussian", -50, 50, 12, cmax)
        tab, _ = ref_exf.pack_decode_tables(aux, core, 12)
        tabs4 = np.ascontiguousarray(
            tab.reshape(T, 1, 128, cmax // 2 + 1).transpose(0, 3, 1, 2))
        states.append(convert.u32_to_torch(st))
        tabs.append(convert.exact_tables_to_torch(tabs4))
        streams.append(convert.rows_to_torch(pc._pad_stream2d(sw, 1)))
    out = parallel.shard_decode_exact_family_cuda(states, tabs, streams, -50,
                                                  50, CFG, 300, device="cpu")
    for got, want, st, tab, sw in zip(out, wants, states, tabs, streams):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, exf.decode_tables(st, sw, tab, CFG, -50, 50, 300).numpy())


def test_tchain_leg_from_jax_layouts():
    """TChain-16 planar words from the JAX package's ``pack_quantiles``."""
    rng, probs, _ = _blocks(1, 1, seed=9)
    cfg = LaneConfig(256, 16, 32, 16)
    cdf16 = fast_quantized_cdf(probs, 16)
    quants = [rng.randint(0, 1 << 16, size=2 * 256).astype(np.uint16)
              for _ in range(3)]
    qwords = [convert.rows_to_torch(ref_tc.pack_quantiles(q, 256))
              for q in quants]
    out = parallel.shard_tchain_decode_cuda(qwords, cdf16, cfg,
                                            device=["cpu"] * 3)
    for q, qw, got in zip(quants, qwords, out):
        want = ref_tc.tchain_decode_host(q, cdf16, _ref(cfg))
        syms, rem, heads = tc.tchain16_decode(
            qw, convert.cdf_to_torch(cdf16), cfg)
        mine = (syms.numpy(), convert.u32_from_torch(rem),
                convert.u32_from_torch(heads))
        for g, w, m in zip(got, want, mine):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, m)


# --- the dry run


def test_dryrun_on_four_cpu_devices():
    legs = parallel.dryrun(["cpu"] * 4)
    assert set(legs) == {
        "rans_container", "range_container", "compact_container",
        "rans_blocks", "range_decode", "family_decode",
        "exact_family_decode", "tchain16_decode", "rans64_decode",
        "range64_decode"}
    assert all(leg["blocks"] == 4 for leg in legs.values())
    assert legs["compact_container"]["k_tail"] > 0
