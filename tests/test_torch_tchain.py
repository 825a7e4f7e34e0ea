"""The port's TChain-12 family bits-back pair against the JAX package, on
the CPU: the 12-bit quantile packing, the numpy host oracles byte for byte,
and the plain PyTorch twins (what a CPU tensor runs) against the host
oracles and the Pallas kernels in interpret mode.  Integer coding: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import tchain as ref_tc
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import tchain as tc
from constriction_tpu_torch.ops.interleaved import LaneConfig

LO, HI = -100, 100


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)


def _ref_cfg(cfg):
    return RefLaneConfig(cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                         cfg.precision)


def _data(L, T, seed):
    """test_tchain.py's inputs: (quantiles, means, scales)."""
    rng = np.random.RandomState(seed)
    n = L * T
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.4 + np.abs(rng.randn(n)) * 4).astype(np.float32)
    return rng.randint(0, 1 << 12, size=n).astype(np.uint16), means, scales


def _twin_decode(cfg, family, q, means, scales):
    L = cfg.num_lanes
    mt, st = convert.params_to_torch(means, scales, len(q), L)
    syms, rem, heads = tc.tchain12_family_decode(
        convert.quantiles_to_torch(q, L), mt, st, family, LO, HI, cfg)
    assert syms.dtype == rem.dtype == heads.dtype == torch.int32
    return (syms.numpy(), convert.u32_from_torch(rem),
            convert.u32_from_torch(heads))


def _twin_encode(cfg, family, syms, rem, heads, means, scales):
    L = cfg.num_lanes
    mt, st = convert.params_to_torch(means, scales, len(syms), L)
    qw, h = tc.tchain12_family_encode(
        torch.from_numpy(syms), convert.u32_to_torch(rem),
        convert.u32_to_torch(heads), mt, st, family, LO, HI, cfg)
    return convert.quantiles_from_torch(qw, L), convert.u32_from_torch(h)


# --- packing


def test_config_equals_the_jax_package():
    import dataclasses

    assert dataclasses.asdict(tc.TCHAIN12_CFG) == dataclasses.asdict(
        ref_tc.TCHAIN12_CFG)


@pytest.mark.parametrize("L,T", [(1024, 1), (1024, 3), (2048, 2)])
def test_pack_unpack_q12(L, T):
    q, _, _ = _data(L, T, L + T)
    q[:8] = 0xFFF  # all bits of the first fields
    ref = ref_tc.pack_q12(q, L)
    got = tc.pack_q12(q, L)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tc.unpack_q12(got), ref_tc.unpack_q12(ref))
    np.testing.assert_array_equal(tc.unpack_q12(got).reshape(-1), q)
    # the torch forms the twins use (int64 tensors of u32 values)
    wt = torch.from_numpy(got.astype(np.int64))
    qt = tc.unpack_q12(wt, torch)
    np.testing.assert_array_equal(qt.numpy().reshape(-1), q)
    back = tc._pack_q12_block(torch, qt.reshape(-1, 128))
    np.testing.assert_array_equal(back.numpy().reshape(got.shape), got)
    # and through convert, as the facade moves them
    moved = convert.quantiles_to_torch(q, L)
    assert moved.dtype == torch.int32 and moved.numel() == 3 * L * T // 8
    np.testing.assert_array_equal(convert.quantiles_from_torch(moved, L), q)


def test_pack_q12_needs_1024_lanes():
    with pytest.raises(ValueError, match="multiple of 1024"):
        tc.pack_q12(np.zeros(512, np.uint16), 512)


# --- host oracles and twins


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_host_oracles_equal_the_jax_package(family):
    cfg = _cfg(256)  # the oracles take any lane count
    q, means, scales = _data(256, 5, 3)
    ref = ref_tc.tchain12_family_decode_host(q, means, scales, family, LO, HI,
                                             _ref_cfg(cfg))
    got = tc.tchain12_family_decode_host(q, means, scales, family, LO, HI,
                                         cfg)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ref2 = ref_tc.tchain12_family_encode_host(*ref, means, scales, family, LO,
                                              HI, _ref_cfg(cfg))
    got2 = tc.tchain12_family_encode_host(*got, means, scales, family, LO, HI,
                                          cfg)
    for a, b in zip(got2, ref2):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got2[0], q)
    assert np.all(got2[1] == 16)
    # truncated remainders read as zero words in both
    cut = got[1][: len(got[1]) // 2]
    a = tc.tchain12_family_encode_host(got[0], cut, got[2], means, scales,
                                       family, LO, HI, cfg)
    b = ref_tc.tchain12_family_encode_host(ref[0], cut, ref[2], means, scales,
                                           family, LO, HI, _ref_cfg(cfg))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_twins_equal_host_and_pallas_interpret(family):
    cfg = _cfg(1024)
    q, means, scales = _data(1024, 3, len(family))
    host = tc.tchain12_family_decode_host(q, means, scales, family, LO, HI,
                                          cfg)
    twin = _twin_decode(cfg, family, q, means, scales)
    ref = ref_tc.tchain12_family_decode_pallas(q, means, scales, family, LO,
                                               HI, _ref_cfg(cfg))
    for a, b, c in zip(twin, host, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    q2, h2 = _twin_encode(cfg, family, *twin, means, scales)
    ref2 = ref_tc.tchain12_family_encode_pallas(*ref, means, scales, family,
                                                LO, HI, _ref_cfg(cfg))
    assert q2.dtype == np.asarray(ref2[0]).dtype
    np.testing.assert_array_equal(q2, np.asarray(ref2[0]))
    np.testing.assert_array_equal(h2, np.asarray(ref2[1]))
    np.testing.assert_array_equal(q2, q)
    assert np.all(h2 == 16)


@pytest.mark.parametrize("L,T", [(1024, 1), (2048, 4), (1024, 9)])
def test_twins_round_trip_over_shapes(L, T):
    cfg = _cfg(L)
    q, means, scales = _data(L, T, L * T)
    twin = _twin_decode(cfg, "laplace", q, means, scales)
    host = tc.tchain12_family_decode_host(q, means, scales, "laplace", LO, HI,
                                          cfg)
    for a, b in zip(twin, host):
        np.testing.assert_array_equal(a, b)
    q2, h2 = _twin_encode(cfg, "laplace", *twin, means, scales)
    np.testing.assert_array_equal(q2, q)
    assert np.all(h2 == 16)
    # truncated remainders: the twin follows the host oracle
    cut = twin[1][: len(twin[1]) // 2]
    a = _twin_encode(cfg, "laplace", twin[0], cut, twin[2], means, scales)
    b = tc.tchain12_family_encode_host(twin[0], cut, twin[2], means, scales,
                                       "laplace", LO, HI, cfg)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_empty_message():
    cfg = _cfg(1024)
    empty = np.zeros(0, np.float32)
    syms, rem, heads = _twin_decode(cfg, "gaussian", np.zeros(0, np.uint16),
                                    empty, empty)
    ref = ref_tc.tchain12_family_decode_pallas(
        np.zeros(0, np.uint16), empty, empty, "gaussian", LO, HI,
        _ref_cfg(cfg))
    assert len(syms) == len(rem) == 0 == len(ref[0]) == len(ref[1])
    np.testing.assert_array_equal(heads, ref[2])
    q2, h2 = _twin_encode(cfg, "gaussian", syms, rem, heads, empty, empty)
    assert len(q2) == 0 and q2.dtype == np.uint16
    np.testing.assert_array_equal(h2, heads)


# --- every ValueError


def test_argument_checks():
    cfg = _cfg(1024)
    q, means, scales = _data(1024, 2, 5)
    mt, st = convert.params_to_torch(means, scales, len(q), 1024)
    qw = convert.quantiles_to_torch(q, 1024)
    syms = torch.zeros(2048, dtype=torch.int32)
    rem = torch.zeros(10, dtype=torch.int32)
    heads = torch.full((1024,), 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tc.tchain12_family_decode(qw, mt, st, "gaussian", LO, HI, _cfg(512))
    with pytest.raises(ValueError, match="qw must hold whole steps"):
        tc.tchain12_family_decode(qw[:-1], mt, st, "gaussian", LO, HI, cfg)
    with pytest.raises(ValueError, match="symbols must hold whole steps"):
        tc.tchain12_family_encode(syms[:-1], rem, heads, mt, st, "gaussian",
                                  LO, HI, cfg)
    with pytest.raises(ValueError, match="max_sym must exceed min_sym"):
        tc.tchain12_family_decode(qw, mt, st, "gaussian", 3, 3, cfg)
    with pytest.raises(ValueError, match="family must be one of"):
        tc.tchain12_family_decode(qw, mt, st, "binomial", LO, HI, cfg)
    with pytest.raises(ValueError, match="precision must be 12"):
        tc.tchain12_family_decode(qw, mt, st, "gaussian", LO, HI,
                                  LaneConfig(1024, 16, 32, 16))
    with pytest.raises(ValueError, match="means must have 2048 entries"):
        tc.tchain12_family_decode(qw, mt[:1024], st, "gaussian", LO, HI, cfg)
    with pytest.raises(ValueError, match=r"symbols must be in \[min_sym"):
        tc.tchain12_family_encode(syms + 500, rem, heads, mt, st, "gaussian",
                                  LO, HI, cfg)
    with pytest.raises(ValueError, match="heads must have 1024 entries"):
        tc.tchain12_family_encode(syms, rem, heads[:-1], mt, st, "gaussian",
                                  LO, HI, cfg)
    bad = st.clone()
    bad[3] = 0.0
    with pytest.raises(ValueError, match="scales must be positive"):
        tc.tchain12_family_decode(qw, mt, bad, "gaussian", LO, HI, cfg)
    with pytest.raises(ValueError, match="multiple of num_lanes"):
        tc.tchain12_family_decode_host(q[:-1], means[:-1], scales[:-1],
                                       "gaussian", LO, HI, cfg)
