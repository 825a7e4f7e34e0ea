"""The port's host layer against the JAX package's, byte for byte.

The port carries its own copies of ``LaneConfig``, the categorical CDF
builder, the numpy ILANS2 host coder, the v1 packers and the v2 framing
(state packing, seed payload, parsing), so that it imports nothing of the
JAX package.  Each copy must give the reference's exact bytes, errors
included.  The reference's host coder runs in C++ where it can, so these
tests also hold the port's numpy algebra against that."""

import dataclasses

import numpy as np
import pytest

from constriction_tpu import native
from constriction_tpu.models.categorical import fast_quantized_cdf as ref_cdf
from constriction_tpu.ops import framing as ref_framing
from constriction_tpu.ops import interleaved as ref_il
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu_torch import models
from constriction_tpu_torch.ops import framing, interleaved, interleaved2
from constriction_tpu_torch.ops.interleaved import LaneConfig


def _fields(cfg):
    return dataclasses.astuple(cfg)


def _same_error(fn_ref, fn_port, exc=ValueError):
    with pytest.raises(exc) as a:
        fn_ref()
    with pytest.raises(exc) as b:
        fn_port()
    assert str(b.value) == str(a.value)


def _cdf(K, P, seed):
    probs = np.random.RandomState(seed).dirichlet(np.full(K, 2.0))
    return models.fast_quantized_cdf(probs, P), probs


def _planes(cdf, n, probs, seed):
    syms = np.random.RandomState(seed).choice(len(probs), size=n, p=probs)
    cdf64 = np.asarray(cdf, np.uint64)
    cums = cdf64[syms]
    return syms, cums, cdf64[syms + 1] - cums


def test_lane_config_matches():
    for port, ref in ((interleaved.SMALL, ref_il.SMALL),
                      (interleaved.DEFAULT, ref_il.DEFAULT),
                      (LaneConfig(), ref_il.LaneConfig())):
        assert _fields(port) == _fields(ref)
        assert port.word_mask == ref.word_mask
        assert port.lower_bound == ref.lower_bound
        assert interleaved.state_dtype(port) == ref_il._state_dtype(ref)
    for bad in ((128, 32, 32, 12), (128, 16, 32, 17), (128, 16, 32, 0)):
        with pytest.raises(AssertionError):
            ref_il.LaneConfig(*bad)
        with pytest.raises(AssertionError):
            LaneConfig(*bad)


@pytest.mark.parametrize("K,P,dtype", [
    (2, 12, np.float64), (100, 12, np.float64), (100, 24, np.float64),
    (100, 24, np.float32), (3000, 16, np.float64), (50, 8, np.float32),
])
def test_fast_quantized_cdf_matches(K, P, dtype):
    probs = np.random.RandomState(K + P).dirichlet(np.full(K, 0.5))
    probs = probs.astype(dtype)
    got = models.fast_quantized_cdf(probs, P)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, ref_cdf(probs, P))
    np.testing.assert_array_equal(models.fast_quantized_cdf(probs * 3, P, 3.0),
                                  ref_cdf(probs * 3, P, 3.0))


def test_fast_quantized_cdf_errors_match():
    for probs, P in (([1.0], 12), (np.ones(4095), 12), ([0.0, 0.0], 12),
                     ([np.nan, 1.0], 12), ([1.0, -1.0, 1.0], 12)):
        _same_error(lambda: ref_cdf(np.asarray(probs), P),
                    lambda: models.fast_quantized_cdf(np.asarray(probs), P))


def test_kernel_eligible_matches_pallas_eligible():
    for L in (8, 128, 200, 256, 32768):
        for W, S in ((8, 32), (16, 32), (16, 64), (32, 64)):
            for P in range(1, S - W + 1):
                cfg = LaneConfig(L, W, S, P)
                assert interleaved2.kernel_eligible(cfg) == \
                    ref_il2._pallas_eligible(cfg)


# (W, S, P, L, n): both presets, the configs only the host coder takes,
# lane counts that do not tile 128, partial last steps and tiny messages
HOST_CASES = [
    (16, 32, 12, 256, 5000), (16, 32, 16, 128, 1000), (32, 64, 24, 256, 3001),
    (32, 64, 20, 200, 4000), (8, 32, 8, 64, 2500), (16, 64, 24, 96, 1700),
    (16, 32, 12, 8, 300), (32, 64, 24, 512, 100),
]


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("W,S,P,L,n", HOST_CASES)
def test_host_coder_matches(W, S, P, L, n, seeded, monkeypatch):
    cfg = LaneConfig(L, W, S, P)
    cdf, probs = _cdf(60, P, seed=P)
    syms, cums, prbs = _planes(cdf, n, probs, seed=n)
    seeds = None
    if seeded:
        rng = np.random.RandomState(L)
        hi = rng.randint(0, 1 << 32, size=L).astype(np.uint64)
        lo = rng.randint(0, 1 << 32, size=L).astype(np.uint64)
        seeds = ((hi << np.uint64(32)) | lo) >> np.uint64(64 - S)
        seeds = np.maximum(seeds, np.uint64(1 << (S - W)))
    st, w = interleaved2.encode_shared(cums, prbs, cfg, seeds=seeds)
    st_r, w_r = ref_il2.encode_shared(cums, prbs, cfg, seeds=seeds)
    assert st.dtype == st_r.dtype and w.dtype == w_r.dtype
    np.testing.assert_array_equal(st, st_r)
    np.testing.assert_array_equal(w, w_r)
    out, fin = interleaved2.decode_shared_cdf(st, w, n, cdf, cfg,
                                              return_final_states=True)
    out_r, fin_r = ref_il2.decode_shared_cdf(st, w, n, cdf, cfg,
                                             return_final_states=True)
    np.testing.assert_array_equal(out, out_r)
    np.testing.assert_array_equal(out, syms)
    assert fin.dtype == fin_r.dtype
    np.testing.assert_array_equal(fin, fin_r)
    # a truncated stream zero-fills, as the reference's numpy path does
    # (its C++ path treats a truncated stream differently)
    monkeypatch.setattr(native, "LIB", None)
    cut = w[: len(w) // 3]
    np.testing.assert_array_equal(
        interleaved2.decode_shared_cdf(st, cut, n, cdf, cfg),
        ref_il2.decode_shared_cdf(st, cut, n, cdf, cfg))


def test_host_coder_errors_match():
    cfg = LaneConfig(128, 16, 32, 12)
    cdf, probs = _cdf(20, 12, seed=1)
    _, cums, prbs = _planes(cdf, 400, probs, seed=2)
    for seeds in (np.full(127, 1 << 16), np.full(128, 5),
                  np.full(128, 1 << 33)):
        _same_error(
            lambda: ref_il2.encode_shared(cums, prbs, cfg, seeds=seeds),
            lambda: interleaved2.encode_shared(cums, prbs, cfg, seeds=seeds))
    _same_error(lambda: ref_il2.encode_shared(cums, prbs[:-1], cfg),
                lambda: interleaved2.encode_shared(cums, prbs[:-1], cfg))
    st, w = interleaved2.encode_shared(cums, prbs, cfg)
    _same_error(lambda: ref_il2.decode_shared_cdf(st[:5], w, 400, cdf, cfg),
                lambda: interleaved2.decode_shared_cdf(st[:5], w, 400, cdf,
                                                       cfg))
    bad = cdf.copy()
    bad[-1] -= 1
    _same_error(lambda: ref_il2.decode_shared_cdf(st, w, 400, bad, cfg),
                lambda: interleaved2.decode_shared_cdf(st, w, 400, bad, cfg))


@pytest.mark.parametrize("W,S", [(8, 32), (16, 32), (16, 64), (32, 64)])
def test_v1_container_matches(W, S):
    cfg = LaneConfig(128, W, S, 8)
    cdf, probs = _cdf(30, 8, seed=W)
    _, cums, prbs = _planes(cdf, 1001, probs, seed=S)
    st, w = ref_il2.encode_shared(cums, prbs, cfg)
    data = interleaved2.pack_container2(st, w, 1001, cfg)
    np.testing.assert_array_equal(data,
                                  ref_il2.pack_container2(st, w, 1001, cfg))
    np.testing.assert_array_equal(interleaved2.pack_words(w, W),
                                  ref_il2.pack_words(w, W))
    st2, w2, n2, cfg2 = interleaved2.unpack_container2(data)
    np.testing.assert_array_equal(st2, st)
    np.testing.assert_array_equal(w2, w)
    assert n2 == 1001 and _fields(cfg2) == _fields(cfg)
    assert framing.container_version(data) == 1
    assert _fields(framing.peek_cfg(data)) == _fields(
        ref_framing.peek_cfg(data))
    _same_error(lambda: ref_il2.unpack_container2(data[1:]),
                lambda: interleaved2.unpack_container2(data[1:]))


@pytest.mark.parametrize("W,S,L,spread", [
    (32, 64, 256, "log_uniform"),  # raw width fields
    (32, 64, 1024, "floor"),       # coded widths win
    (16, 32, 512, "floor"),
    (16, 32, 64, "log_uniform"),
    (8, 32, 96, "floor"),
])
def test_pack_states_matches(W, S, L, spread):
    cfg = LaneConfig(L, W, S, 8)
    rng = np.random.RandomState(L)
    lo = 1 << (S - W)
    if spread == "floor":  # states hugging the floor: few distinct widths
        x = lo + rng.randint(0, lo, size=L).astype(np.uint64)
        x[::7] <<= np.uint64(3)
    else:
        widths = rng.randint(S - W + 1, S + 1, size=L)
        x = np.array([(1 << (int(b) - 1)) | rng.randint(0, 1 << 30)
                      for b in widths], dtype=np.uint64)
    bits, nbits = framing.pack_states(x, cfg)
    ref_bits, ref_nbits = ref_framing.pack_states(x, cfg)
    assert nbits == ref_nbits
    np.testing.assert_array_equal(bits, ref_bits)
    np.testing.assert_array_equal(framing.unpack_states(bits, cfg), x)
    np.testing.assert_array_equal(ref_framing.unpack_states(bits, cfg), x)
    _same_error(lambda: ref_framing.pack_states(x[:-1], cfg),
                lambda: framing.pack_states(x[:-1], cfg))


def test_v2_framing_over_host_planes_matches():
    """frame_planes_v2 with the host coder in region A: every section of
    the v2 container (region split, seed payload, packed states) equals
    the reference's, for a config only the host coder takes."""
    cfg = LaneConfig(64, 8, 32, 10)
    cdf, probs = _cdf(40, 10, seed=7)
    syms, cums, prbs = _planes(cdf, 40_000, probs, seed=8)

    def encode_a(n_A, seeds):
        return interleaved2.encode_shared(cums[:n_A], prbs[:n_A], cfg,
                                          seeds=seeds)

    data = framing.frame_planes_v2(cums, prbs, cfg, None, encode_a)
    ref = ref_framing.encode_iid_v2(syms, cdf, cfg, device=False)
    np.testing.assert_array_equal(data, ref)
    p, q = framing.parse_v2(data), ref_framing.parse_v2(data)
    assert p.k_B > 0
    for name in ("n", "n_A", "k_B", "L_B", "slen_B", "psb_in_seed"):
        assert getattr(p, name) == getattr(q, name)
    for name in ("psb_rem", "states_A", "stream_A"):
        np.testing.assert_array_equal(getattr(p, name), getattr(q, name))
    np.testing.assert_array_equal(framing.decode_iid_v2(data, cdf), syms)


def test_parse_v2_errors_match():
    cdf, probs = _cdf(40, 12, seed=3)
    syms = np.random.RandomState(4).choice(40, size=20_000, p=probs)
    data = ref_framing.encode_iid_v2(syms, cdf, LaneConfig(128, 16, 32, 12))
    corrupt = [data[:11], data[:-1], np.concatenate([data, data[:1]])]
    for index, value in ((1, 3), (2, 16 | (30 << 8) | (32 << 16)), (5, 0),
                         (5, 1 << 20), (10, 5), (7, 1 << 30), (3, 1 << 31),
                         (4, 7)):
        bad = data.copy()
        bad[index] = value
        corrupt.append(bad)
    for bad in corrupt:
        _same_error(lambda: ref_framing.parse_v2(bad),
                    lambda: framing.parse_v2(bad))
    _same_error(lambda: ref_framing.container_version(data[:1]),
                lambda: framing.container_version(data[:1]))
    _same_error(lambda: ref_framing.peek_cfg(data[:5]),
                lambda: framing.peek_cfg(data[:5]))


@pytest.mark.parametrize("W,nwords", [(32, 0), (32, 37), (16, 5), (8, 64)])
def test_bits_to_stream_matches(W, nwords):
    bits = np.random.RandomState(W + nwords).randint(
        0, 2, nwords * W + 11).astype(np.uint8)
    got = framing._bits_to_stream(bits, W, nwords)
    ref = ref_framing._bits_to_stream(bits, W, nwords)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
