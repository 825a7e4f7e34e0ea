"""The port's device-family coder against the JAX package, on the CPU.

The integer CDF (``ops.family``: one rule for numpy and torch) is held
against ``pallas_family``'s numpy forms over the whole fixed-point domain
and an extreme parameter grid; the host oracles against the originals byte
for byte; the plain PyTorch twins (what a CPU tensor runs) against the
Pallas kernels in interpret mode (a few cases: each costs seconds) and
against the host oracles.  Integer coding: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops import pallas_family as pf
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig

LO, HI = -100, 100
FREE = 4095 - (HI - LO)


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)


def _ref_cfg(cfg):
    return RefLaneConfig(cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                         cfg.precision)


def _data(n, seed, cauchy=False):
    """test_family_int.py's inputs: (means, scales, symbols)."""
    rng = np.random.RandomState(seed)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    noise = rng.standard_cauchy(n) if cauchy else rng.randn(n)
    symbols = np.clip(np.round(means + noise * scales), LO, HI)
    return means, scales, symbols.astype(np.int32)


def _extreme_grid():
    """The quantizer stress grid of test_family_int.py, every interior x."""
    rows = [(x, m, s) for m in (-500.0, -100.0, 0.0, 99.7, 500.0)
            for s in (1e-6, 0.01, 1.0, 1e4, 1e6)
            for x in range(LO + 1, HI + 2)]
    g = np.array(rows, dtype=np.float64)
    return (g[:, 0].astype(np.int32), g[:, 1].astype(np.float32),
            g[:, 2].astype(np.float32))


def _tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# --- the integer CDF


def test_constants_equal_the_jax_package():
    assert fam.FAMILIES == pf.FAMILIES
    got = (fam.FX, fam.T_CLAMP, fam.P0, fam.P1, fam.P2, fam.PG, fam.LOG2E,
           fam.GA, fam.GB, fam.CA, fam.PI2EFF, fam.PIEFF)
    ref = (pf.FX, pf._T_CLAMP, pf._P0, pf._P1, pf._P2, pf._PG, pf._LOG2E,
           pf._GA, pf._GB, pf._CA, pf._PI2EFF, pf._PIEFF)
    assert got == ref


@pytest.mark.parametrize("free", [FREE, 4085, 2000, 100])
@pytest.mark.parametrize("family", fam.FAMILIES)
def test_ctrunc_over_the_whole_t_fix_domain(family, free):
    t = np.arange(-fam.T_CLAMP, fam.T_CLAMP, dtype=np.int32)
    ref = pf._ctrunc(np, family, t, free)
    got = fam.ctrunc(np, family, t, free)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    twin = fam.ctrunc(torch, family, torch.from_numpy(t), free)
    assert twin.dtype == torch.int32
    np.testing.assert_array_equal(twin.numpy(), ref)


def test_helpers_over_their_domains():
    mag = np.arange(0, 210000, dtype=np.int32)
    ref = pf._exp2_neg(np, mag)
    np.testing.assert_array_equal(fam.exp2_neg(np, mag), ref)
    np.testing.assert_array_equal(
        fam.exp2_neg(torch, torch.from_numpy(mag)).numpy(), ref)
    u = np.arange(0, fam.T_CLAMP + 1, dtype=np.int32)
    ref = pf._atan_fix(np, u)
    np.testing.assert_array_equal(fam.atan_fix(np, u), ref)
    np.testing.assert_array_equal(
        fam.atan_fix(torch, torch.from_numpy(u)).numpy(), ref)
    np.testing.assert_array_equal(fam.mag(np, "gaussian", u),
                                  pf._mag(np, "gaussian", u))
    rng = np.random.RandomState(2)
    num = rng.randint(0, (1 << 24) + 1, size=200_000).astype(np.int32)
    den = rng.randint(1, 1 << 20, size=200_000).astype(np.int32)
    ref = pf._floor_div_small(np, num, den)
    np.testing.assert_array_equal(ref, num // den)
    np.testing.assert_array_equal(fam.floor_div_small(np, num, den), ref)
    np.testing.assert_array_equal(
        fam.floor_div_small(torch, *_tensors(num, den)).numpy(), ref)


def test_t_fixed_reaches_every_value_and_matches():
    """x = 0, scale = 1, mean = -(0.5 + t / 4096) gives t_fix = t exactly;
    random arguments match the JAX package's form, clamp included."""
    t = np.arange(-fam.T_CLAMP, fam.T_CLAMP, dtype=np.int64)
    x = np.zeros(len(t), np.int32)
    mean = (-(0.5 + t / 4096.0)).astype(np.float32)
    inv = np.ones(len(t), np.float32)
    np.testing.assert_array_equal(fam.t_fixed(np, x, mean, inv), t)
    np.testing.assert_array_equal(
        fam.t_fixed(torch, *_tensors(x, mean, inv)).numpy(), t)
    rng = np.random.RandomState(3)
    x = rng.randint(LO, HI + 2, size=100_000).astype(np.int32)
    mean = (rng.randn(len(x)) * 40).astype(np.float32)
    inv = np.float32(1.0) / np.exp(rng.randn(len(x)) * 4).astype(np.float32)
    ref = pf._t_fixed(np, x, mean, inv)
    assert ref.min() == -fam.T_CLAMP and ref.max() == fam.T_CLAMP - 1
    np.testing.assert_array_equal(fam.t_fixed(np, x, mean, inv), ref)
    np.testing.assert_array_equal(
        fam.t_fixed(torch, *_tensors(x, mean, inv)).numpy(), ref)


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_left_on_random_and_extreme_parameters(family):
    ref_left = pf._left_fn(family, LO, 12, FREE)
    rng = np.random.RandomState(5)
    n = 50_000
    random = (rng.randint(LO + 1, HI + 2, size=n).astype(np.int32),
              (rng.randn(n) * 30).astype(np.float32),
              np.exp(rng.randn(n) * 3).astype(np.float32))
    for x, mean, scale in (random, _extreme_grid()):
        inv = np.float32(1.0) / scale
        ref = ref_left(x, mean, inv, xp=np)
        got = fam.left(np, family, LO, HI, x, mean, inv)
        np.testing.assert_array_equal(got, ref)
        xt, mt, st = _tensors(x, mean, scale)
        twin = fam.left(torch, family, LO, HI, xt, mt, 1.0 / st)
        assert twin.dtype == torch.int32
        np.testing.assert_array_equal(twin.numpy(), ref)
        np.testing.assert_array_equal(
            fam.family_left(xt, mt, st, family, LO, HI).numpy(), ref)


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_invert_family_inverts_the_tables(family):
    """Every quantile of a symbol's interval inverts to that symbol, with
    its (cum, prob), in numpy and in torch."""
    means, scales, symbols = _data(4000, 9, cauchy=family == "cauchy")
    inv = np.float32(1.0) / scales
    cum, prob = fam.tables(np, family, LO, HI, symbols, means, inv)
    assert prob.min() >= 1 and (cum + prob).max() <= 1 << 12
    rng = np.random.RandomState(1)
    q = (cum + rng.randint(0, 1 << 12, size=len(cum)) % prob).astype(np.int32)
    for xp, args in ((np, (q, means, inv)),
                     (torch, _tensors(q, means, inv))):
        sym, c, p = (np.asarray(v) for v in fam.invert_family(
            xp, family, LO, HI, *args))
        np.testing.assert_array_equal(sym, symbols)
        np.testing.assert_array_equal(c, cum)
        np.testing.assert_array_equal(p, prob)


# --- the host oracles, byte for byte


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_host_oracles_equal_the_jax_package(family):
    cfg = _cfg(128)
    n = 2000
    means, scales, symbols = _data(n, 7, cauchy=family == "cauchy")
    ref_c, ref_p = pf.family_tables_host(symbols, means, scales, family, LO,
                                         HI)
    cums, probs = fam.family_tables_host(symbols, means, scales, family, LO,
                                         HI)
    assert cums.dtype == ref_c.dtype and probs.dtype == ref_p.dtype
    np.testing.assert_array_equal(cums, ref_c)
    np.testing.assert_array_equal(probs, ref_p)
    states, stream = il2.encode_shared(cums, probs, cfg)
    ref = pf.decode_family_host(states, stream, means, scales, family, LO,
                                HI, _ref_cfg(cfg), n)
    got = fam.decode_family_host(states, stream, means, scales, family, LO,
                                 HI, cfg, n)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, symbols)
    # a truncated stream reads as zero words in both
    cut = stream[: len(stream) // 3]
    np.testing.assert_array_equal(
        fam.decode_family_host(states, cut, means, scales, family, LO, HI,
                               cfg, n),
        pf.decode_family_host(states, cut, means, scales, family, LO, HI,
                              _ref_cfg(cfg), n))


def test_host_oracles_on_the_extreme_grid():
    cfg = _cfg(128)
    rng = np.random.RandomState(11)
    cases = [(m, s) for m in (-500.0, -100.0, 0.0, 99.7, 500.0)
             for s in (1e-6, 0.01, 1.0, 1e4, 1e6)]
    means = np.array([c[0] for c in cases] * 8, np.float32)
    scales = np.array([c[1] for c in cases] * 8, np.float32)
    symbols = rng.randint(LO, HI + 1, size=len(means)).astype(np.int32)
    for family in fam.FAMILIES:
        cums, probs = fam.family_tables_host(symbols, means, scales, family,
                                             LO, HI)
        ref_c, ref_p = pf.family_tables_host(symbols, means, scales, family,
                                             LO, HI)
        np.testing.assert_array_equal(cums, ref_c)
        np.testing.assert_array_equal(probs, ref_p)
        assert probs.min() >= 1
        _round_trip_twins(cfg, family, means, scales, symbols)


# --- the twins


def _twin_encode(cfg, family, means, scales, symbols):
    mt, st = convert.params_to_torch(means, scales, len(symbols),
                                     cfg.num_lanes)
    states, stream = fam.encode_family(torch.from_numpy(symbols), mt, st,
                                       family, LO, HI, cfg)
    assert states.dtype == torch.int32 and stream.dtype == torch.int32
    return convert.u32_from_torch(states), convert.u32_from_torch(stream)


def _twin_decode(cfg, family, means, scales, states, stream, n):
    mt, st = convert.params_to_torch(means, scales, n, cfg.num_lanes)
    out, fin = fam.decode_family(
        convert.u32_to_torch(states), convert.u32_to_torch(stream), mt, st,
        family, LO, HI, cfg, n, return_final_states=True)
    return out.numpy(), convert.u32_from_torch(fin)


def _round_trip_twins(cfg, family, means, scales, symbols):
    """Twin encode equals the host oracle's stream; twin decode returns the
    symbols and the seeds, and equals the host decoder."""
    n = len(symbols)
    states, stream = _twin_encode(cfg, family, means, scales, symbols)
    cums, probs = fam.family_tables_host(symbols, means, scales, family, LO,
                                         HI)
    ref_states, ref_stream = il2.encode_shared(cums, probs, cfg)
    np.testing.assert_array_equal(states, ref_states)
    np.testing.assert_array_equal(stream, ref_stream)
    out, fin = _twin_decode(cfg, family, means, scales, states, stream, n)
    np.testing.assert_array_equal(out, symbols)
    np.testing.assert_array_equal(fin, np.full(cfg.num_lanes, 1 << 16))
    np.testing.assert_array_equal(
        out, fam.decode_family_host(states, stream, means, scales, family,
                                    LO, HI, cfg, n))
    return states, stream


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_twins_equal_pallas_interpret(family):
    """A partial last step (1000 = 7 * 128 + 104), as the JAX package's own
    test runs the kernels off the TPU."""
    cfg = _cfg(128)
    n = 1000
    means, scales, symbols = _data(n, 3, cauchy=family == "cauchy")
    ref_states, ref_stream = pf.encode_family_pallas(
        symbols, means, scales, family, LO, HI, _ref_cfg(cfg))
    states, stream = _round_trip_twins(cfg, family, means, scales, symbols)
    np.testing.assert_array_equal(states, np.asarray(ref_states))
    np.testing.assert_array_equal(stream, np.asarray(ref_stream))
    ref_out = pf.decode_family_pallas(states, stream, means, scales, family,
                                      LO, HI, _ref_cfg(cfg), n)
    np.testing.assert_array_equal(np.asarray(ref_out), symbols)


@pytest.mark.parametrize("L,n", [(128, 1), (128, 128), (256, 3000),
                                 (1024, 2049)])
def test_twins_round_trip_over_shapes(L, n):
    means, scales, symbols = _data(n, L + n)
    _round_trip_twins(_cfg(L), "logistic", means, scales, symbols)


def test_truncated_stream_twin_equals_host_decoder():
    cfg = _cfg(256)
    n = 4000
    means, scales, symbols = _data(n, 13)
    states, stream = _twin_encode(cfg, "gaussian", means, scales, symbols)
    cut = stream[: len(stream) // 3]
    out, _ = _twin_decode(cfg, "gaussian", means, scales, states, cut, n)
    np.testing.assert_array_equal(
        out, fam.decode_family_host(states, cut, means, scales, "gaussian",
                                    LO, HI, cfg, n))


def test_empty_message():
    cfg = _cfg(128)
    empty = np.zeros(0, np.float32)
    states, stream = _twin_encode(cfg, "gaussian", empty, empty,
                                  np.zeros(0, np.int32))
    ref_states, ref_stream = pf.encode_family_pallas(
        np.zeros(0, np.int32), empty, empty, "gaussian", LO, HI,
        _ref_cfg(cfg))
    np.testing.assert_array_equal(states, np.asarray(ref_states))
    assert len(stream) == 0 and len(np.asarray(ref_stream)) == 0
    out, fin = _twin_decode(cfg, "gaussian", empty, empty, states, stream, 0)
    assert len(out) == 0
    np.testing.assert_array_equal(fin, states)
    assert len(pf.decode_family_pallas(states, stream, empty, empty,
                                       "gaussian", LO, HI, _ref_cfg(cfg),
                                       0)) == 0


def test_params_to_torch_pads_as_blocks3d():
    means, scales, _ = _data(300, 1)
    mt, st = convert.params_to_torch(means.astype(np.float64), scales, 300,
                                     128)
    assert mt.dtype == st.dtype == torch.float32 and mt.numel() == 384
    np.testing.assert_array_equal(
        mt.numpy(), np.asarray(pf._blocks3d(means, 3, 1, 300, np.float32)
                               ).reshape(-1))
    np.testing.assert_array_equal(
        st.numpy(), np.asarray(pf._blocks3d(scales, 3, 1, 300, np.float32,
                                            1.0)).reshape(-1))
    with pytest.raises(ValueError, match="means must have 300 entries"):
        convert.params_to_torch(means[:-1], scales, 300, 128)


# --- every ValueError


def _args(n=256, L=128):
    means, scales, symbols = _data(n, 2)
    mt, st = convert.params_to_torch(means, scales, n, L)
    return torch.from_numpy(symbols), mt, st


@pytest.mark.parametrize("cfg,family,lo,hi,match", [
    (LaneConfig(200, 16, 32, 12), "gaussian", LO, HI, "num_lanes"),
    (LaneConfig(128, 32, 64, 12), "gaussian", LO, HI, "word_bits=16"),
    (LaneConfig(128, 16, 32, 16), "gaussian", LO, HI, "precision must be 12"),
    (_cfg(128), "student", LO, HI, "family must be one of"),
    (_cfg(128), "gaussian", 5, 5, "max_sym must exceed min_sym"),
    (_cfg(128), "gaussian", 0, 2048, "too wide"),
])
def test_model_checks(cfg, family, lo, hi, match):
    syms, mt, st = _args()
    states = torch.full((cfg.num_lanes,), 1 << 16, dtype=torch.int32)
    stream = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        fam.encode_family(syms, mt, st, family, lo, hi, cfg)
    with pytest.raises(ValueError, match=match):
        fam.decode_family(states, stream, mt, st, family, lo, hi, cfg, 256)


def test_widest_support_is_accepted():
    cfg = _cfg(128)
    means, scales, _ = _data(500, 4)
    symbols = np.random.RandomState(4).randint(0, 2048, 500).astype(np.int32)
    mt, st = convert.params_to_torch(means, scales, 500, 128)
    states, stream = fam.encode_family(torch.from_numpy(symbols), mt, st,
                                       "laplace", 0, 2047, cfg)
    out = fam.decode_family(states, stream, mt, st, "laplace", 0, 2047, cfg,
                            500)
    np.testing.assert_array_equal(out.numpy(), symbols)


@pytest.mark.parametrize("what,value,match", [
    ("means", float("nan"), "means must be finite"),
    ("means", float("inf"), "means must be finite"),
    ("scales", 0.0, "scales must be positive"),
    ("scales", -1.0, "scales must be positive"),
    ("scales", 1e-45, "scales must be positive"),  # denormal: 1/scale = inf
    ("scales", float("nan"), "scales must be positive"),
    ("scales", float("inf"), "scales must be positive"),
])
def test_parameter_checks(what, value, match):
    cfg = _cfg(128)
    syms, mt, st = _args()
    (mt if what == "means" else st)[17] = value
    with pytest.raises(ValueError, match=match):
        fam.encode_family(syms, mt, st, "gaussian", LO, HI, cfg)
    states = torch.full((128,), 1 << 16, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        fam.decode_family(states, torch.zeros(4, dtype=torch.int32), mt, st,
                          "gaussian", LO, HI, cfg, 256)


def test_symbol_and_layout_checks():
    cfg = _cfg(128)
    syms, mt, st = _args()
    bad = syms.clone()
    bad[5] = HI + 1
    with pytest.raises(ValueError, match=r"symbols must be in \[min_sym"):
        fam.encode_family(bad, mt, st, "gaussian", LO, HI, cfg)
    with pytest.raises(ValueError, match="means must have 256 entries"):
        fam.encode_family(syms, mt[:-1], st, "gaussian", LO, HI, cfg)
    with pytest.raises(TypeError, match="scales must be torch.float32"):
        fam.encode_family(syms, mt, st.double(), "gaussian", LO, HI, cfg)
    with pytest.raises(TypeError, match="symbols must be torch.int32"):
        fam.encode_family(syms.long(), mt, st, "gaussian", LO, HI, cfg)
    with pytest.raises(ValueError, match="states must have 128 entries"):
        fam.decode_family(torch.zeros(64, dtype=torch.int32),
                          torch.zeros(4, dtype=torch.int32), mt, st,
                          "gaussian", LO, HI, cfg, 256)
    with pytest.raises(ValueError, match="precision must be 12"):
        fam.family_tables_host(syms.numpy(), mt.numpy(), st.numpy(),
                               "gaussian", LO, HI, precision=16)


def test_jax_host_encoder_agrees_on_the_ports_tables():
    """The JAX package's generic host encoder over the port's tables gives
    the twin's stream (the two host layers are interchangeable)."""
    cfg = _cfg(128)
    means, scales, symbols = _data(1500, 21)
    cums, probs = fam.family_tables_host(symbols, means, scales, "laplace",
                                         LO, HI)
    ref_states, ref_stream = ref_il2.encode_shared(cums, probs,
                                                   _ref_cfg(cfg))
    states, stream = _twin_encode(cfg, "laplace", means, scales, symbols)
    np.testing.assert_array_equal(states, ref_states)
    np.testing.assert_array_equal(stream, ref_stream)
