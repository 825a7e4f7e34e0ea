"""The port's range coder (ILANS2-R) against the JAX package, on the CPU.

The port's host range coder (the host codec and its numpy plain version),
its plain PyTorch twins (what a CPU tensor runs) and its facade are held
against the JAX package: the Pallas
range kernels in interpret mode (kept to a few cases: each costs seconds),
its numpy host oracle, its checkpoints and its facade.  The JAX package's
host range code prefers its C++ library where that is loaded; every test
here takes the numpy path (``native.LIB`` set to None), so none depends on
that build.  Integer coding: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import constriction_tpu.tpu as ctpu
from constriction_tpu import native
from constriction_tpu.models.categorical import fast_quantized_cdf
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops import pallas_coder as pc
from constriction_tpu.ops import pallas_coder64 as pc64
from constriction_tpu.ops import pallas_range_enc as pre
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch import cuda as ctt
from constriction_tpu_torch.ops import coder, coder64, range_enc
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host range code on its numpy path."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(S, L, P):
    return LaneConfig(num_lanes=L, word_bits=S // 2, state_bits=S,
                      precision=P)


def _ref_cfg(cfg):
    return RefLaneConfig(cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                         cfg.precision)


def _data(K, P, n, seed, skewed=False):
    """(symbols int64, cdf u32); ``skewed`` puts 99.9% of the mass on one
    symbol, as the JAX package's carry-run test does."""
    rng = np.random.RandomState(seed)
    if skewed:
        q = np.array([(1 << P) - 3, 1, 1, 1], dtype=np.int64)
        cdf = np.concatenate([[0], np.cumsum(q)]).astype(np.uint32)
        syms = np.where(rng.random_sample(n) < 0.999, 0, rng.randint(1, 4, n))
        return syms.astype(np.int64), cdf
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = np.asarray(fast_quantized_cdf(probs, P), dtype=np.uint32)
    return rng.choice(K, size=n, p=probs).astype(np.int64), cdf


def _host_encode(syms, cdf, cfg):
    c = cdf.astype(np.uint64)
    return il2.encode_shared_range(c[syms], c[syms + 1] - c[syms], cfg)


def _twin_encode(syms, cdf, cfg):
    enc = (range_enc.encode_iid_range64 if cfg.state_bits == 64
           else range_enc.encode_iid_range)
    pts, words = enc(torch.from_numpy(syms.astype(np.int32)),
                     convert.cdf_to_torch(cdf), cfg)
    return convert.states_from_torch(pts, cfg), convert.u32_from_torch(words)


def _twin_decode(pts, words, cdf, cfg, n, planes=None):
    dec = (coder64.decode_shared_range64 if cfg.state_bits == 64
           else coder.decode_shared_range)
    extra = {}
    if planes is not None:
        lo, rn = convert.planes_to_torch(planes, cfg)
        extra = {"lows": lo, "rngs": rn}
    out, fin = dec(convert.states_to_torch(pts, cfg),
                   convert.u32_to_torch(words), convert.cdf_to_torch(cdf),
                   cfg, n, return_final_states=True, **extra)
    return out.numpy(), convert.planes_from_torch(fin, cfg)


def _outcome(fn):
    """A decode's symbols, or the text of its ValueError."""
    try:
        return np.asarray(fn())
    except ValueError as e:
        return str(e)


def _same_outcome(a, b):
    if isinstance(a, str) or isinstance(b, str):
        assert a == b
    else:
        np.testing.assert_array_equal(a, b)


# --- against the Pallas kernels in interpret mode (six calls in all) ------


@pytest.mark.parametrize("S,P", [(32, 12), (64, 24)])
def test_encoders_match_pallas_interpret(S, P):
    syms, cdf = _data(60, P, 1000, seed=P)  # 8 steps, partial tail
    cfg = _cfg(S, 128, P)
    enc = (pre.encode_iid_range64_pallas if S == 64
           else pre.encode_iid_range_pallas)
    ref_pts, ref_words = enc(syms, cdf, _ref_cfg(cfg))
    for pts, words in (_host_encode(syms, cdf, cfg),
                       _twin_encode(syms, cdf, cfg)):
        assert pts.dtype == np.asarray(ref_pts).dtype
        np.testing.assert_array_equal(pts, np.asarray(ref_pts))
        np.testing.assert_array_equal(words, np.asarray(ref_words))


@pytest.mark.parametrize("S,P", [(32, 16), (64, 20)])
def test_decode_twins_match_pallas_interpret(S, P):
    syms, cdf = _data(80, P, 900, seed=2 * P)
    cfg = _cfg(S, 128, P)
    pts, words = _host_encode(syms, cdf, cfg)
    dec = (pc64.decode_shared_range64_pallas if S == 64
           else pc.decode_shared_range_pallas)
    ref = np.asarray(dec(pts, words, cdf, _ref_cfg(cfg), len(syms)))
    out, _ = _twin_decode(pts, words, cdf, cfg, len(syms))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, syms)


@pytest.mark.parametrize("P", [12, 24])
def test_facade_identical_to_jax_facade(P):
    """cfg=None: the facade picks L with no entropy cap (L=128 here) and
    the preset from P, as ``tpu.encode_iid_range`` does."""
    syms, cdf = _data(100, P, 1500, seed=40 + P)
    ref_pts, ref_words = ctpu.encode_iid_range(syms, cdf)
    pts, words = ctt.encode_iid_range(syms, cdf, device="cpu")
    assert pts.dtype == np.asarray(ref_pts).dtype
    assert pts.dtype == (np.uint64 if P > 16 else np.uint32)
    np.testing.assert_array_equal(pts, np.asarray(ref_pts))
    np.testing.assert_array_equal(words, np.asarray(ref_words))
    out = ctt.decode_iid_range(pts, words, cdf, len(syms), device="cpu")
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, syms)


# --- against the JAX package's numpy host oracle --------------------------


ENCODE_CASES = [  # (S, P, L, n, K, skewed)
    (32, 12, 128, 2000, 16, False),
    (32, 16, 256, 5000, 100, False),
    (32, 8, 128, 3000, 30, False),
    (32, 12, 256, 256 * 7, 100, False),  # exact multiple of L
    (32, 12, 128, 1, 100, False),
    (32, 12, 128, 0, 100, False),
    (32, 12, 128, 30_000, 4, True),
    (64, 24, 256, 5000, 100, False),
    (64, 18, 128, 3000, 1000, False),
    (64, 24, 384, 384 * 3, 2, False),
    (64, 24, 128, 7, 100, False),  # fewer symbols than lanes
    (64, 24, 128, 30_000, 4, True),
]


@pytest.mark.parametrize("S,P,L,n,K,skewed", ENCODE_CASES)
def test_encoders_round_trip_under_jax_oracle(S, P, L, n, K, skewed):
    """The port's host encoder and its twins agree, and the JAX package's
    numpy oracle decodes their stream to the symbols, as does the twin."""
    syms, cdf = _data(K, P, n, seed=S + P + L + n, skewed=skewed)
    cfg = _cfg(S, L, P)
    pts, words = _host_encode(syms, cdf, cfg)
    pts_t, words_t = _twin_encode(syms, cdf, cfg)
    np.testing.assert_array_equal(pts_t, pts)
    np.testing.assert_array_equal(words_t, words)
    ref = ref_il2.decode_shared_range_cdf(pts, words, n, cdf, _ref_cfg(cfg))
    np.testing.assert_array_equal(ref, syms)
    np.testing.assert_array_equal(
        il2.decode_shared_range_cdf(pts, words, n, cdf, cfg), syms)
    out, (lo, rn, pt) = _twin_decode(pts, words, cdf, cfg, n)
    np.testing.assert_array_equal(out, syms)


def test_skewed_model_has_carries_and_renorms():
    """The round-trip cases above reach both halves of phase B: the skewed
    model renorms (after long runs without one), the Dirichlet model's
    records carry +1s into the words already emitted."""
    for S, P in ((32, 12), (64, 24)):
        syms, cdf = _data(4, P, 30_000, seed=3, skewed=True)
        cfg = _cfg(S, 128, P)
        rec, _, _ = range_enc.record(torch.from_numpy(syms.astype(np.int32)),
                                     convert.cdf_to_torch(cdf), cfg)
        rec = rec.to(torch.int64)
        W = cfg.word_bits
        assert int(((rec >> W) & 1).sum()) > 0
        syms, cdf = _data(100, P, 30_000, seed=3)
        rec, _, _ = range_enc.record(torch.from_numpy(syms.astype(np.int32)),
                                     convert.cdf_to_torch(cdf), cfg)
        assert int(((rec.to(torch.int64) >> (W + 1)) & 1).sum()) > 0


@pytest.mark.parametrize("S,P,interval", [(32, 12, 1), (32, 16, 3),
                                          (64, 24, 2), (64, 17, 5)])
def test_checkpoints_match_jax_package(S, P, interval):
    """build_checkpoints_range equals the JAX package's plane for plane;
    every checkpoint resumes to the suffix, through the host decoder and
    through the seeded twin, as the JAX package's host path does."""
    syms, cdf = _data(100, P, 256 * 11 + 13, seed=S * P + interval)
    cfg = _cfg(S, 256, P)
    pts, words = _host_encode(syms, cdf, cfg)
    ref = ref_il2.build_checkpoints_range(pts, words, len(syms), cdf,
                                          _ref_cfg(cfg), interval)
    got = il2.build_checkpoints_range(pts, words, len(syms), cdf, cfg,
                                      interval)
    assert len(got[0]) == len(ref[0]) > 0
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for c in range(len(ref[0])):
        start_r, out_r = ref_il2.decode_range_from_checkpoint(
            c, *ref, words, len(syms), cdf, _ref_cfg(cfg), interval)
        start, out = il2.decode_range_from_checkpoint(
            c, *got, words, len(syms), cdf, cfg, interval, device="cpu")
        assert start == start_r
        np.testing.assert_array_equal(out, out_r)
        np.testing.assert_array_equal(out, syms[start:])
        # the seeded twin's final planes equal a full decode's
        sub = words[got[0][c]:]
        tw, fin = _twin_decode(got[3][c], sub, cdf, cfg, len(syms) - start,
                               planes=(got[1][c], got[2][c]))
        np.testing.assert_array_equal(tw, syms[start:])
        _, fin_full = _twin_decode(pts, words, cdf, cfg, len(syms))
        for a, b in zip(fin, fin_full):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S,P", [(32, 12), (32, 16), (64, 24), (64, 20)])
def test_invalid_data_raises_as_jax_oracle(S, P):
    """Corrupt points: the JAX oracle, the port's host decoder and the twin
    give the same outcome (the same ValueError, naming the same symbol).
    A point of all ones lies outside every interval (quantile >= 2^P at
    once); random points may decode to garbage instead."""
    rng = np.random.RandomState(S + P)
    syms, cdf = _data(100, P, 3000, seed=P)
    cfg = _cfg(S, 128, P)
    pts, words = _host_encode(syms, cdf, cfg)
    outcomes = []
    for trial in range(3):
        bad = pts.copy()
        k = rng.randint(0, 128, size=5)
        if trial == 0:
            bad[k] = np.iinfo(pts.dtype).max
            first = int(k.min())  # step 0, so the lowest lane is first
        else:
            bad[k] = rng.randint(0, 1 << 31, size=5).astype(pts.dtype) << \
                pts.dtype.type(S - 31)
        ref = _outcome(lambda: ref_il2.decode_shared_range_cdf(
            bad, words, len(syms), cdf, _ref_cfg(cfg)))
        _same_outcome(_outcome(lambda: il2.decode_shared_range_cdf(
            bad, words, len(syms), cdf, cfg)), ref)
        _same_outcome(_outcome(lambda: _twin_decode(
            bad, words, cdf, cfg, len(syms))[0]), ref)
        outcomes.append(ref)
    assert outcomes[0] == (
        "Tried to decode data that is inconsistent with the entropy model "
        f"(quantile >= 2**precision at symbol {first}).")


@pytest.mark.parametrize("S,P,cut", [(32, 12, 3), (32, 16, 2), (64, 24, 3),
                                     (64, 24, 7)])
def test_truncated_stream_zero_fills_as_jax_oracle(S, P, cut):
    syms, cdf = _data(100, P, 250 * 8, seed=cut + P)
    cfg = _cfg(S, 128, P)
    pts, words = _host_encode(syms, cdf, cfg)
    short = words[: len(words) // cut]
    ref = _outcome(lambda: ref_il2.decode_shared_range_cdf(
        pts, short, len(syms), cdf, _ref_cfg(cfg)))
    _same_outcome(_outcome(lambda: il2.decode_shared_range_cdf(
        pts, short, len(syms), cdf, cfg)), ref)
    _same_outcome(_outcome(lambda: _twin_decode(
        pts, short, cdf, cfg, len(syms))[0]), ref)


# --- the host route, the facade's rules, the wrappers' checks -------------


@pytest.mark.parametrize("S,P", [(32, 12), (64, 24)])
def test_l64_host_route_decodes_under_jax_oracle(S, P):
    """64 lanes do not tile 128, so the facade codes on the host encoder;
    the JAX package can encode that config only in C++, so the port's
    stream is held to the JAX numpy oracle's decode instead."""
    syms, cdf = _data(20, P, 500, seed=6)
    cfg = _cfg(S, 64, P)
    assert not il2.kernel_eligible(cfg)
    pts, words = ctt.encode_iid_range(syms, cdf, cfg=cfg, device="cpu")
    ref = ref_il2.decode_shared_range_cdf(pts, words, len(syms), cdf,
                                          _ref_cfg(cfg))
    np.testing.assert_array_equal(ref, syms)
    out = ctt.decode_iid_range(pts, words, cdf, len(syms), cfg=cfg,
                               device="cpu")
    np.testing.assert_array_equal(out, syms)
    ref_out = ctpu.decode_iid_range(pts, words, cdf, len(syms), cfg=cfg)
    np.testing.assert_array_equal(ref_out, syms)


def test_empty_message_matches_jax_facade():
    _, cdf = _data(10, 12, 0, seed=1)
    ref_pts, ref_words = ctpu.encode_iid_range(np.zeros(0, np.int64), cdf)
    pts, words = ctt.encode_iid_range(np.zeros(0, np.int64), cdf,
                                      device="cpu")
    np.testing.assert_array_equal(pts, np.asarray(ref_pts))
    assert pts.dtype == np.asarray(ref_pts).dtype and len(words) == 0
    assert len(ctt.decode_iid_range(pts, words, cdf, 0, device="cpu")) == 0


def test_host_encoder_covers_the_two_presets_only():
    """The plain host range encoder covers the two presets' (W, S) only;
    the routed one (the host codec, as in the JAX package) codes any S <=
    64, so the facade takes (8, 32) too and decodes it back."""
    syms, cdf = _data(10, 8, 100, seed=2)
    cfg = LaneConfig(num_lanes=128, word_bits=8, state_bits=32, precision=8)
    c = cdf.astype(np.uint64)
    with pytest.raises(ValueError, match=r"\(W, S\) = \(16, 32\) and "
                                         r"\(32, 64\); got \(8, 32\)"):
        il2.encode_shared_range_plain(c[syms], c[syms + 1] - c[syms], cfg)
    pts, words = ctt.encode_iid_range(syms, cdf, cfg=cfg, device="cpu")
    for got in (_host_encode(syms, cdf, cfg), (pts, words)):
        np.testing.assert_array_equal(
            ctt.decode_iid_range(*got, cdf, len(syms), cfg=cfg,
                                 device="cpu"), syms)
        np.testing.assert_array_equal(
            ref_il2.decode_shared_range_cdf(*got, len(syms), cdf,
                                            _ref_cfg(cfg)), syms)


def test_symbols_out_of_range_raise():
    """Unlike the JAX facade, the port checks the symbols (a kernel would
    read the CDF out of bounds)."""
    _, cdf = _data(10, 12, 0, seed=3)
    for bad in (np.array([0, 10, 1]), np.array([-1, 0])):
        with pytest.raises(ValueError, match="symbols must be in"):
            ctt.encode_iid_range(bad, cdf, device="cpu")
        with pytest.raises(ValueError, match="symbols must be in"):
            range_enc.encode_iid_range(
                torch.from_numpy(bad.astype(np.int32)),
                convert.cdf_to_torch(cdf), _cfg(32, 128, 12))


def test_cdf_and_device_errors_match_jax_facade(monkeypatch):
    syms, cdf = _data(10, 12, 300, seed=4)
    odd = cdf.copy()
    odd[-1] = 5000
    for fn in (lambda c: ctpu.encode_iid_range(syms, c),
               lambda c: ctt.encode_iid_range(syms, c, device="cpu")):
        with pytest.raises(ValueError, match="not a supported power of two"):
            fn(odd)
    pts, words = ctt.encode_iid_range(syms, cdf, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.encode_iid_range(syms, cdf)  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.decode_iid_range(pts, words, cdf, len(syms))


def test_cpu_tensors_run_the_twins_and_launch_nothing():
    before = (dict(range_enc.LAUNCHES), dict(coder.LAUNCHES),
              dict(coder64.LAUNCHES))
    for P in (12, 24):
        syms, cdf = _data(50, P, 700, seed=P)
        pts, words = ctt.encode_iid_range(syms, cdf, device="cpu")
        ctt.decode_iid_range(pts, words, cdf, len(syms), device="cpu")
    assert (range_enc.LAUNCHES, coder.LAUNCHES, coder64.LAUNCHES) == before


def test_wrappers_reject_bad_arguments():
    syms, cdf = _data(50, 12, 300, seed=5)
    cfg = _cfg(32, 128, 12)
    pts, words = _host_encode(syms, cdf, cfg)
    p_t, w_t = convert.u32_to_torch(pts), convert.u32_to_torch(words)
    c_t = convert.cdf_to_torch(cdf)
    with pytest.raises(TypeError):  # S=32 points are int32
        coder.decode_shared_range(p_t.to(torch.int64), w_t, c_t, cfg, 300)
    with pytest.raises(ValueError, match="together"):
        coder.decode_shared_range(p_t, w_t, c_t, cfg, 300, lows=p_t)
    with pytest.raises(ValueError):  # S=64 is coder64's
        coder.decode_shared_range(p_t, w_t, c_t, _cfg(64, 128, 12), 300)
    with pytest.raises(ValueError):  # lanes must tile 128
        coder64.decode_shared_range64(p_t, w_t, c_t, _cfg(64, 64, 24), 300)
    with pytest.raises(ValueError):  # unsupported device
        coder.decode_shared_range(p_t.to("meta"), w_t.to("meta"),
                                  c_t.to("meta"), cfg, 300)
    s_t = torch.from_numpy(syms.astype(np.int32))
    with pytest.raises(ValueError):  # the S=32 encoder takes S=32 only
        range_enc.encode_iid_range(s_t, c_t, _cfg(64, 128, 24))
    rec, lo, rn = range_enc.record(s_t, c_t, cfg)
    s0, carry = range_enc.seal(lo, rn, cfg)
    with pytest.raises(ValueError, match="records must have"):
        range_enc.resolve(rec[:-128], s0, carry, cfg, 300)


@pytest.mark.parametrize("S", [32, 64])
def test_seal_matches_jax_package(S):
    """One seal rule for numpy and torch, equal to the JAX package's on
    random planes, untouched lanes and wrapping lowers included."""
    rng = np.random.RandomState(S)
    L = 512
    low = rng.randint(0, 1 << 32, size=(2, L)).astype(np.uint64)
    rng_ = rng.randint(1 << 16, 1 << 32, size=(2, L)).astype(np.uint64)
    low[:, :8] = 0xFFFFFFFF  # the point's add wraps
    rng_[:, 8:16] = 0xFFFFFFFF  # untouched (S=32: range all ones)
    if S == 64:
        lhi, llo, rhi, rlo = low[0], low[1], rng_[0], rng_[1]
        rlo[8:16] = 0xFFFFFFFF
        want = pre.seal64_limbs(np, *(a.astype(np.uint32)
                                      for a in (lhi, llo, rhi, rlo)))
        got_np = range_enc.seal64_limbs(np, lhi, llo, rhi, rlo)
        got_t = range_enc.seal64_limbs(
            torch, *(torch.from_numpy(a.astype(np.int64))
                     for a in (lhi, llo, rhi, rlo)))
    else:
        want = pre.seal32(np, low[0].astype(np.uint32),
                          rng_[0].astype(np.uint32), 32, 16)
        got_np = range_enc.seal32(np, low[0], rng_[0], 32, 16)
        got_t = range_enc.seal32(torch, torch.from_numpy(
            low[0].astype(np.int64)), torch.from_numpy(
                rng_[0].astype(np.int64)), 32, 16)
    for w, a, b in zip(want, got_np, got_t):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b.numpy(), w)
    assert want[1].any() and not want[0][8:16].any()
