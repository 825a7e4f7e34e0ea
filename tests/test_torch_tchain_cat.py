"""The port's categorical bits-back coders (TChain-16, TChain-24) and its
chain-coder fast decode against the JAX package, on the CPU: the packers
and numpy host oracles byte for byte, the plain PyTorch twins (what a CPU
tensor runs) and the ``device="cpu"`` facade against the Pallas kernels in
interpret mode and the JAX facade, and ``ops.chain`` against
``chain_jax`` and the scalar chain coder.  Integer coding: the tolerance
is exact equality.

Interpret-mode Pallas calls cost seconds each, so three cases run them: the
one-symbol model at P=16 (which ``tests/test_tchain.py`` tries only at
P=24) at that file's sizes, and each facade against ``tpu.py`` at its
fixed 32768 lanes.  Every other case is held
against the JAX package's host oracles, which ``tests/test_tchain.py``
holds against the same kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import constriction_tpu.tpu as tpu
from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import chain as ref_chain
from constriction_tpu.ops import chain_jax
from constriction_tpu.ops import tchain as ref_tc
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch import cuda as ctt
from constriction_tpu_torch.ops import chain as ch
from constriction_tpu_torch.ops import tchain as tc
from constriction_tpu_torch.ops.interleaved import LaneConfig

SEED_HEAD = {16: 1, 24: 256}


def _cfg(P, L):
    if P == 16:
        return LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                          precision=16)
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=24)


def _ref_cfg(cfg):
    return RefLaneConfig(cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                         cfg.precision)


def _cdf(K, P, seed):
    """test_tchain.py's models (K=1: the one-symbol CDF [0, 2^P])."""
    if K == 1:
        return np.array([0, 1 << P], np.uint64)
    probs = np.random.RandomState(seed).dirichlet(np.full(K, 1.2))
    return ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P).cdf


def _quantiles(P, n, seed):
    q = np.random.RandomState(seed).randint(0, 1 << P, size=n)
    return q.astype(np.uint16 if P == 16 else np.uint32)


def _host(P):
    if P == 16:
        return tc.tchain_decode_host, tc.tchain_encode_host
    return tc.tchain24_decode_host, tc.tchain24_encode_host


def _ref_host(P):
    if P == 16:
        return ref_tc.tchain_decode_host, ref_tc.tchain_encode_host
    return ref_tc.tchain24_decode_host, ref_tc.tchain24_encode_host


def _ref_pallas(P):
    if P == 16:
        return ref_tc.tchain_decode_pallas, ref_tc.tchain_encode_pallas
    return ref_tc.tchain24_decode_pallas, ref_tc.tchain24_encode_pallas


def _twin_decode(P, q, cdf, cfg):
    """The wrapper on CPU tensors (the twin), results as numpy."""
    L, t_cdf = cfg.num_lanes, convert.cdf_to_torch(cdf)
    if P == 16:
        syms, rem, heads = tc.tchain16_decode(
            convert.quantiles16_to_torch(q, L), t_cdf, cfg)
        heads_np = convert.u32_from_torch(heads)
    else:
        syms, rem, heads = tc.tchain24_decode(convert.u32_to_torch(q), t_cdf,
                                              cfg)
        heads_np = convert.u64_from_torch(heads)
    assert syms.dtype == rem.dtype == torch.int32
    return syms.numpy(), convert.u32_from_torch(rem), heads_np


def _twin_encode(P, syms, rem, heads, cdf, cfg):
    L, t_cdf = cfg.num_lanes, convert.cdf_to_torch(cdf)
    args = (torch.from_numpy(np.ascontiguousarray(syms, np.int32)),
            convert.u32_to_torch(rem))
    if P == 16:
        qw, h = tc.tchain16_encode(*args, convert.u32_to_torch(heads), t_cdf,
                                   cfg)
        return convert.quantiles16_from_torch(qw, L), convert.u32_from_torch(h)
    q, h = tc.tchain24_encode(*args, convert.u64_to_torch(heads), t_cdf, cfg)
    return convert.u32_from_torch(q), convert.u64_from_torch(h)


def _equal(got, ref):
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --- configs and packers


def test_configs_equal_the_jax_package():
    for name in ("TCHAIN_CFG", "TCHAIN24_CFG"):
        assert dataclasses.asdict(getattr(tc, name)) == dataclasses.asdict(
            getattr(ref_tc, name))


@pytest.mark.parametrize("L,T", [(256, 1), (256, 3), (512, 2), (768, 0)])
def test_pack_unpack_quantiles(L, T):
    q = _quantiles(16, L * T, L + T)
    if T:
        q[:2] = 0xFFFF
    ref = ref_tc.pack_quantiles(q, L)
    got = tc.pack_quantiles(q, L)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    _equal([tc.unpack_quantiles(got)], [ref_tc.unpack_quantiles(ref)])
    np.testing.assert_array_equal(tc.unpack_quantiles(got), q)
    # the torch form the twins use (int64 tensors of u32 values)
    qt = tc.unpack_quantiles(torch.from_numpy(got.astype(np.int64)), torch)
    np.testing.assert_array_equal(qt.numpy(), q)
    # and through convert, as the facade moves them
    moved = convert.quantiles16_to_torch(q, L)
    assert moved.dtype == torch.int32 and moved.numel() == L * T // 2
    _equal([convert.quantiles16_from_torch(moved, L)], [q])


@pytest.mark.parametrize("L,T", [(512, 1), (1024, 3)])
def test_pack_unpack_q24(L, T):
    q = _quantiles(24, L * T, L * T)
    q[:4] = 0xFFFFFF
    ref = ref_tc.pack_q24(q, L)
    _equal([tc.pack_q24(q, L)], [ref])
    _equal([tc.unpack_q24(ref)], [ref_tc.unpack_q24(ref)])
    np.testing.assert_array_equal(tc.unpack_q24(ref).reshape(-1), q)


def test_packers_reject_lane_counts():
    with pytest.raises(ValueError, match="multiple of 256"):
        tc.pack_quantiles(np.zeros(128, np.uint16), 128)
    with pytest.raises(ValueError, match="multiple of 512"):
        tc.pack_q24(np.zeros(256, np.uint32), 256)


# --- host oracles


@pytest.mark.parametrize("P,K,L,T", [
    (16, 16, 256, 4), (16, 2, 256, 1), (16, 100, 512, 7), (16, 1, 256, 3),
    (16, 1000, 512, 2),
    (24, 40, 512, 4), (24, 1000, 512, 3), (24, 1, 512, 2), (24, 2, 512, 5),
    (24, 60, 256, 6),
])
def test_host_oracles_equal_the_jax_package(P, K, L, T):
    cfg = _cfg(P, L)
    cdf = _cdf(K, P, K + T)
    q = _quantiles(P, L * T, T)
    dec, enc = _host(P)
    ref_dec, ref_enc = _ref_host(P)
    got = dec(q, cdf, cfg)
    _equal(got, ref_dec(q, cdf, _ref_cfg(cfg)))
    back = enc(*got, cdf, cfg)
    _equal(back, ref_enc(*got, cdf, _ref_cfg(cfg)))
    np.testing.assert_array_equal(back[0], q)
    assert np.all(back[1] == SEED_HEAD[P])
    # truncated remainders read as zero words in both
    cut = got[1][: len(got[1]) // 3]
    _equal(enc(got[0], cut, got[2], cdf, cfg),
           ref_enc(got[0], cut, got[2], cdf, _ref_cfg(cfg)))


def test_host_oracles_raise_value_errors():
    cdf = _cdf(16, 16, 0)
    with pytest.raises(ValueError, match="multiple of num_lanes=256"):
        tc.tchain_decode_host(np.zeros(300, np.uint16), cdf, _cfg(16, 256))
    with pytest.raises(ValueError, match="multiple of num_lanes=256"):
        tc.tchain_encode_host(np.zeros(300, np.int64), np.zeros(0, np.uint32),
                              np.ones(256, np.uint32), cdf, _cfg(16, 256))
    with pytest.raises(ValueError, match="cfg must be W=32, S=64, P=24"):
        tc.tchain24_decode_host(np.zeros(256, np.uint32), cdf, _cfg(16, 256))
    with pytest.raises(ValueError, match="cfg must be W=16, S=32, P=16"):
        tc.tchain_encode_host(np.zeros(512, np.int64), np.zeros(0, np.uint32),
                              np.ones(512, np.uint64), cdf, _cfg(24, 512))


# --- twins against the Pallas kernels (interpret mode) and the host oracles


@pytest.mark.parametrize("P,K,L,T", [(16, 1, 256, 2)])
def test_twins_equal_pallas_interpret(P, K, L, T):
    cfg = _cfg(P, L)
    cdf = _cdf(K, P, K + T)
    q = _quantiles(P, L * T, T)
    pal_dec, pal_enc = _ref_pallas(P)
    ref = pal_dec(q, cdf, _ref_cfg(cfg))
    got = _twin_decode(P, q, cdf, cfg)
    _equal(got, ref)
    back = _twin_encode(P, *got, cdf, cfg)
    _equal(back, pal_enc(*ref, cdf, _ref_cfg(cfg)))
    np.testing.assert_array_equal(back[0], q)
    assert np.all(back[1] == SEED_HEAD[P])


@pytest.mark.parametrize("P,K,L,T", [
    (16, 16, 256, 4), (16, 2, 256, 1), (16, 100, 512, 7), (16, 60, 512, 5),
    (16, 1000, 256, 3), (16, 1, 512, 4), (24, 2, 512, 5), (24, 1000, 512, 3),
    (24, 1, 512, 2), (24, 100, 256, 7), (24, 16, 384, 3), (24, 40, 512, 4),
])
def test_twins_equal_host_oracles(P, K, L, T):
    cfg = _cfg(P, L)
    cdf = _cdf(K, P, K * T)
    q = _quantiles(P, L * T, K + T)
    dec, enc = _ref_host(P)
    got = _twin_decode(P, q, cdf, cfg)
    _equal(got, dec(q, cdf, _ref_cfg(cfg)))
    back = _twin_encode(P, *got, cdf, cfg)
    np.testing.assert_array_equal(back[0], q)
    assert np.all(back[1] == SEED_HEAD[P])
    # truncated remainders: the twin follows the host oracle
    cut = got[1][: len(got[1]) // 2]
    _equal(_twin_encode(P, got[0], cut, got[2], cdf, cfg),
           enc(got[0], cut, got[2], cdf, _ref_cfg(cfg)))


@pytest.mark.parametrize("P", [16, 24])
def test_twins_take_any_u64_or_u32_head(P):
    """The reverse pass from arbitrary heads (u32 at P=16, u64 up to
    2^64 - 1 at P=24) equals the host oracle: no int64 wrap in the twin."""
    L, T = 256, 3
    cfg = _cfg(P, L)
    cdf = _cdf(50, P, 4)
    rng = np.random.RandomState(P)
    syms = rng.randint(0, 50, size=L * T)
    rem = rng.randint(0, 1 << 32, size=300, dtype=np.uint64).astype(np.uint32)
    if P == 16:
        heads = rng.randint(0, 1 << 32, size=L, dtype=np.uint64).astype(
            np.uint32)
    else:
        heads = rng.randint(0, 1 << 63, size=L, dtype=np.uint64) * np.uint64(2)
        heads[:4] = [0, 1, (1 << 64) - 1, 1 << 63]
    if P == 16:
        rem &= np.uint32(0xFFFF)  # the kernel keeps a refill's low 16 bits
    _equal(_twin_encode(P, syms, rem, heads, cdf, cfg),
           _ref_host(P)[1](syms, rem, heads, cdf, _ref_cfg(cfg)))


@pytest.mark.parametrize("P", [16, 24])
def test_empty_message(P):
    cfg = _cfg(P, 256)
    cdf = _cdf(20, P, 77)
    got = _twin_decode(P, _quantiles(P, 0, 0), cdf, cfg)
    _equal(got, _ref_pallas(P)[0](_quantiles(P, 0, 0), cdf, _ref_cfg(cfg)))
    assert np.all(got[2] == SEED_HEAD[P])
    back = _twin_encode(P, *got, cdf, cfg)
    assert len(back[0]) == 0
    np.testing.assert_array_equal(back[1], got[2])


# --- the facade against tpu.py


@pytest.mark.parametrize("P", [16, 24])
def test_facade_cpu_equals_jax_facade(P):
    n = 2 * 32768
    cdf = _cdf(100, P, 5)
    q = _quantiles(P, n, P)
    decode = ctt.bits_back_decode if P == 16 else ctt.bits_back_decode24
    encode = ctt.bits_back_encode if P == 16 else ctt.bits_back_encode24
    ref_decode = tpu.bits_back_decode if P == 16 else tpu.bits_back_decode24
    ref_encode = tpu.bits_back_encode if P == 16 else tpu.bits_back_encode24
    got = decode(q, cdf, device="cpu")
    ref = ref_decode(q, cdf)
    _equal(got, ref)
    assert len(got[1])  # the second step flushes
    back = encode(*got, cdf, device="cpu")
    _equal(back, ref_encode(*ref, cdf))
    np.testing.assert_array_equal(back[0], q)
    # empty messages: the seed heads, as tpu.py returns them
    empty = decode(q[:0], cdf, device="cpu")
    _equal(empty, ref_decode(q[:0], cdf))
    _equal(encode(*empty, cdf, device="cpu"), ref_encode(*empty, cdf))


@pytest.mark.parametrize("P", [16, 24])
def test_round_trips_across_packages(P):
    """JAX-decoded data re-encodes in the port, and the reverse, through
    convert.py's layouts."""
    L, T = 512, 3
    cfg = _cfg(P, L)
    cdf = _cdf(60, P, 9)
    q = _quantiles(P, L * T, 9)
    dec_h, enc_h = _ref_host(P)
    jax_dec = dec_h(q, cdf, _ref_cfg(cfg))
    np.testing.assert_array_equal(_twin_encode(P, *jax_dec, cdf, cfg)[0], q)
    port_dec = _twin_decode(P, q, cdf, cfg)
    back = enc_h(*port_dec, cdf, _ref_cfg(cfg))
    np.testing.assert_array_equal(back[0], q)
    assert np.all(back[1] == SEED_HEAD[P])


# --- every new ValueError


def test_argument_checks():
    cdf16 = _cdf(16, 16, 1)
    t16 = convert.cdf_to_torch(cdf16)
    cfg = _cfg(16, 256)
    qw = convert.quantiles16_to_torch(_quantiles(16, 512, 1), 256)
    syms = torch.zeros(512, dtype=torch.int32)
    rem = torch.zeros(10, dtype=torch.int32)
    heads = torch.ones(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 256"):
        tc.tchain16_decode(qw, t16, _cfg(16, 128))
    with pytest.raises(ValueError, match="cfg must be W=16, S=32, P=16"):
        tc.tchain16_decode(qw, t16, _cfg(24, 256))
    with pytest.raises(ValueError, match="qw must hold whole steps"):
        tc.tchain16_decode(qw[:-1], t16, cfg)
    with pytest.raises(ValueError, match=r"cdf must rise from 0 to 2\^16"):
        tc.tchain16_decode(qw, convert.cdf_to_torch(_cdf(16, 24, 1)), cfg)
    bad = t16.clone()
    bad[3] = bad[2] - 1
    with pytest.raises(ValueError, match="cdf must rise"):
        tc.tchain16_decode(qw, bad, cfg)
    with pytest.raises(ValueError, match=r"symbols must be in \[0, 16\)"):
        tc.tchain16_encode(syms + 16, rem, heads, t16, cfg)
    with pytest.raises(ValueError, match=r"symbols must be in \[0, 16\)"):
        tc.tchain16_encode(syms - 1, rem, heads, t16, cfg)
    zero = torch.tensor([0, 1 << 15, 1 << 15, 1 << 16])  # symbol 1: p = 0
    with pytest.raises(ValueError, match="zero probability"):
        tc.tchain16_encode(syms + 1, rem, heads, zero, cfg)
    with pytest.raises(ValueError, match="heads must have 256 entries"):
        tc.tchain16_encode(syms, rem, heads[:-1], t16, cfg)
    with pytest.raises(ValueError, match="symbols must hold whole steps"):
        tc.tchain16_encode(syms[:-1], rem, heads, t16, cfg)
    # TChain-24: 24-bit quantiles, 2^24 CDFs, int64 heads
    cdf24 = convert.cdf_to_torch(_cdf(16, 24, 1))
    cfg24 = _cfg(24, 128)
    q = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="quantiles must be 24-bit values"):
        tc.tchain24_decode(q + (1 << 24), cdf24, cfg24)
    with pytest.raises(ValueError, match="quantiles must be 24-bit values"):
        tc.tchain24_decode(q - 1, cdf24, cfg24)
    with pytest.raises(ValueError, match=r"cdf must rise from 0 to 2\^24"):
        tc.tchain24_decode(q, t16, cfg24)
    with pytest.raises(TypeError, match="heads must be torch.int64"):
        tc.tchain24_encode(q, rem, torch.ones(128, dtype=torch.int32), cdf24,
                           cfg24)
    # the facade: 16-bit quantiles, 24-bit quantiles, totals, symbols
    with pytest.raises(ValueError, match="quantiles must be 16-bit values"):
        ctt.bits_back_decode(np.full(32768, 1 << 16), cdf16, device="cpu")
    with pytest.raises(ValueError, match="quantiles must be 16-bit values"):
        ctt.bits_back_decode(np.full(32768, -1), cdf16, device="cpu")
    with pytest.raises(ValueError, match="quantiles must be 24-bit values"):
        ctt.bits_back_decode24(np.full(32768, 1 << 24), _cdf(16, 24, 1),
                               device="cpu")
    with pytest.raises(ValueError, match="multiple of 32768 lanes"):
        ctt.bits_back_decode(np.zeros(1000, np.uint16), cdf16, device="cpu")
    with pytest.raises(ValueError, match="cdf must rise"):
        ctt.bits_back_decode24(np.zeros(32768, np.uint32), cdf16,
                               device="cpu")
    with pytest.raises(ValueError, match=r"symbols must be in \[0, 16\)"):
        ctt.bits_back_encode(np.full(32768, 16), np.zeros(0, np.uint32),
                             np.ones(32768, np.uint32), cdf16, device="cpu")


def test_device_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cdf16, cdf24 = _cdf(16, 16, 1), _cdf(16, 24, 1)
    empty = np.zeros(0, np.uint32)
    calls = [
        lambda: ctt.bits_back_decode(empty, cdf16),  # "cuda" is the default
        lambda: ctt.bits_back_encode(empty, empty, np.ones(32768), cdf16),
        lambda: ctt.bits_back_decode24(empty, cdf24, device="cuda"),
        lambda: ctt.bits_back_encode24(empty, empty, np.ones(32768), cdf24),
        lambda: ctt.decode_chain_iid(np.ones(4, np.uint32), 1, cdf24),
        lambda: ctt.decode_chain_rows(np.ones(4, np.uint32), cdf24[None]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- the chain coder's parallel decode


def _chain_data(rng, words):
    """test_chain_jax.py's data: random words, a large trailing word."""
    data = rng.randint(1, 2**32, size=words, dtype=np.uint64).astype(
        np.uint32)
    data[-1] |= 0x8000_0000
    return data


def test_chain_helpers_equal_the_jax_package():
    rng = np.random.RandomState(1)
    for n in (0, 1, 5, 97, 256):
        pop = rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        for m in (0, 1, 3, 4, 7, n, n + 9):
            ref = chain_jax.extract_quantiles(np, pop, m)
            _equal([ch.extract_quantiles(np, pop, m)], [ref])
            got = ch.extract_quantiles(
                torch, torch.from_numpy(pop.astype(np.int64)), m)
            np.testing.assert_array_equal(got.numpy(), ref)
    for data in ([5], [0, 0, 7], [1 << 31, 3], [9, 1, 0, 0]):
        data = np.asarray(data, np.uint32)
        try:
            ref = chain_jax.head_init_words(data)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                ch.head_init_words(data)
        else:
            assert ch.head_init_words(data) == ref


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 100, 257])
@pytest.mark.parametrize("alphabet", [2, 17, 100])
def test_chain_decode_iid_equals_chain_jax(n, alphabet):
    rng = np.random.RandomState(n * 31 + alphabet)
    probs = rng.dirichlet(np.full(alphabet, 1.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24).cdf
    data = _chain_data(rng, n + 8)
    ref = chain_jax.chain_decode_iid(data, n, cdf, xp=np)
    got = ch.chain_decode_iid(data, n, cdf, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    _equal([ch.chain_decode_iid(data, n, cdf, np)], [ref])
    _equal([ctt.decode_chain_iid(data, n, cdf, device="cpu")], [ref])


def test_chain_decode_rows_equals_chain_jax_and_the_core():
    rng = np.random.RandomState(5)
    n, K = 203, 7
    rowsf = rng.dirichlet(np.full(K, 0.8), size=n)
    models = [
        ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
            rowsf[i], 24)
        for i in range(n)
    ]
    rows = np.stack([m.cdf for m in models]).astype(np.uint32)
    data = _chain_data(rng, n + 8)
    core = ref_chain.ChainCoderCore.from_compressed(list(data))
    ref = np.array([core.decode_symbol(models[i]) for i in range(n)],
                   np.int32)
    _equal([chain_jax.chain_decode_rows(data, rows, xp=np)], [ref])
    _equal([ctt.decode_chain_rows(data, rows, device="cpu")], [ref])
    _equal([ch.chain_decode_rows(data, rows, np)], [ref])
    # a one-symbol model in every row decodes to zeros
    one = np.tile(np.array([0, 1 << 24], np.uint32), (n, 1))
    _equal([ctt.decode_chain_rows(data, one, device="cpu")],
           [chain_jax.chain_decode_rows(data, one, xp=np)])


def test_chain_decode_rejects_truncated_data():
    rng = np.random.RandomState(9)
    probs = rng.dirichlet(np.ones(16))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24).cdf
    words = rng.randint(0, 2**32, size=100, dtype=np.uint64).astype(np.uint32)
    core = ref_chain.ChainCoderCore.from_compressed(list(words))
    ref = core.decode_iid_symbols(60, ContiguousCategoricalEntropyModel
                                  .from_floating_point_probabilities_fast(
                                      probs, 24))
    _equal([ctt.decode_chain_iid(words, 60, cdf, device="cpu")],
           [np.asarray(ref, np.int32)])
    with pytest.raises(ref_chain.OutOfCompressedData):
        chain_jax.chain_decode_iid(words[:20], 60, cdf, xp=np)
    for xp in (np, torch):
        with pytest.raises(ch.OutOfCompressedData, match="out of compressed"):
            ch.chain_decode_iid(words[:20], 60, cdf, xp, device="cpu")
    with pytest.raises(AssertionError):  # the reference's class
        ctt.decode_chain_iid(words[:20], 60, cdf, device="cpu")
    rows = np.tile(cdf.astype(np.uint32), (60, 1))
    with pytest.raises(ch.OutOfCompressedData):
        ctt.decode_chain_rows(words[:20], rows, device="cpu")
    with pytest.raises(ValueError, match="ends in zero word"):
        ctt.decode_chain_iid(np.zeros(4, np.uint32), 1, cdf, device="cpu")
