"""Port of the DEFAULT-preset ILANS2-64 coder (constriction_tpu_torch.ops.
coder64) against the JAX package: the Pallas kernels in interpret mode
(as tests/test_pallas64.py runs them) and the host oracle
(interleaved2.encode_shared / decode_shared_cdf).  Integer coding, so the
tolerance is exact equality."""

import numpy as np
import pytest
import torch

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops import pallas_coder64 as pc64
from constriction_tpu.ops.interleaved import LaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder64


def _model(K, P, seed):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, 2.0))
    m = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    )
    return m.cdf, probs


def _seeds(rng, L):
    """u64 start states spread over [2^32, 2^64), half of them >= 2^63."""
    hi = rng.randint(1, 1 << 31, size=L).astype(np.uint64)
    hi[::2] |= np.uint64(1 << 31)
    lo = rng.randint(0, 1 << 32, size=L).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def _case(K, P, n, seed, L=256):
    cdf, probs = _model(K, P, seed)
    cfg = LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(seed + n)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    return cdf, cfg, syms, _seeds(rng, L)


def _encode(syms, cdf, cfg, seeds):
    st, w = coder64.encode_iid64(
        torch.from_numpy(syms.astype(np.int32)), convert.cdf_to_torch(cdf),
        cfg,
        seeds=None if seeds is None else convert.u64_to_torch(seeds),
    )
    return convert.u64_from_torch(st), convert.u32_from_torch(w)


def _decode(st, w, cdf, cfg, n):
    out, fin = coder64.decode_shared64(
        convert.u64_to_torch(st), convert.u32_to_torch(w),
        convert.cdf_to_torch(cdf), cfg, n, return_final_states=True,
    )
    return out.numpy(), convert.u64_from_torch(fin)


# --- against the Pallas kernels in interpret mode (kept few: each costs ~1 s)


@pytest.mark.parametrize("seeded", [False, True])
def test_encode64_matches_pallas_interpret(seeded):
    cdf, cfg, syms, seeds = _case(100, 24, 1000, seed=5)  # partial tail
    seeds = seeds if seeded else None
    ref_st, ref_w = pc64.encode_iid64_pallas(
        syms.astype(np.int32), cdf, cfg, seeds=seeds
    )
    st, w = _encode(syms, cdf, cfg, seeds)
    np.testing.assert_array_equal(st, np.asarray(ref_st, np.uint64))
    np.testing.assert_array_equal(w, np.asarray(ref_w))


def test_decode64_matches_pallas_interpret():
    cdf, cfg, syms, seeds = _case(100, 20, 900, seed=6)
    c = cdf.astype(np.uint64)
    st, w = il2.encode_shared(c[syms], c[syms + 1] - c[syms], cfg,
                              seeds=seeds)
    ref, ref_fin = pc64.decode_shared64_pallas(
        st, w, cdf, cfg, len(syms), return_final_states=True
    )
    out, fin = _decode(st, w, cdf, cfg, len(syms))
    np.testing.assert_array_equal(out, np.asarray(ref))
    np.testing.assert_array_equal(fin, ref_fin)
    np.testing.assert_array_equal(fin, seeds)


# --- against the host oracle


CASES = [
    (16, 24, 2000),
    (100, 24, 5000),
    (100, 20, 3000),
    (2, 24, 1500),
    (1000, 24, 4000),
    (100, 24, 256 * 7),  # exact multiple of L (no tail)
    (100, 24, 1),
    (100, 17, 0),
]


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("K,P,n", CASES)
def test_encode64_matches_host_oracle(K, P, n, seeded):
    cdf, cfg, syms, seeds = _case(K, P, n, seed=K + P)
    seeds = seeds if seeded else None
    c = cdf.astype(np.uint64)
    ref_st, ref_w = il2.encode_shared(c[syms], c[syms + 1] - c[syms], cfg,
                                      seeds=seeds)
    st, w = _encode(syms, cdf, cfg, seeds)
    np.testing.assert_array_equal(st, ref_st)
    np.testing.assert_array_equal(w, ref_w)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("K,P,n", CASES)
def test_decode64_matches_host_oracle(K, P, n, seeded):
    cdf, cfg, syms, seeds = _case(K, P, n, seed=2 * K + P)
    seeds = seeds if seeded else None
    c = cdf.astype(np.uint64)
    st, w = il2.encode_shared(c[syms], c[syms + 1] - c[syms], cfg,
                              seeds=seeds)
    ref, ref_fin = il2.decode_shared_cdf(st, w, n, cdf, cfg,
                                         return_final_states=True)
    out, fin = _decode(st, w, cdf, cfg, n)
    np.testing.assert_array_equal(out, syms)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(fin, ref_fin)


def test_decode64_zero_probability_entries():
    """Quantiles resolve as searchsorted(side="right") - 1, so symbols of
    zero probability are never decoded."""
    P = 24
    cdf = np.array([0, 0, 1 << 20, 1 << 20, 1 << 20, (1 << 24) - 7,
                    (1 << 24) - 7, 1 << 24], dtype=np.uint32)
    cfg = LaneConfig(num_lanes=128, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(3)
    syms = rng.choice([1, 4, 6], size=2000, p=[0.2, 0.7, 0.1]).astype(
        np.int64)
    c = cdf.astype(np.uint64)
    st, w = il2.encode_shared(c[syms], c[syms + 1] - c[syms], cfg)
    out, fin = _decode(st, w, cdf, cfg, len(syms))
    np.testing.assert_array_equal(out, syms)
    np.testing.assert_array_equal(fin, np.full(128, 1 << 32, np.uint64))


def test_decode64_truncated_stream_zero_fills():
    """Reads past the end of a truncated stream give 0 words, as the numpy
    oracle does (n < 256 keeps decode_shared_cdf on its numpy path)."""
    cdf, cfg, syms, _ = _case(100, 24, 250, seed=11, L=128)
    c = cdf.astype(np.uint64)
    st, w = il2.encode_shared(c[syms], c[syms + 1] - c[syms], cfg)
    cut = w[: len(w) // 2]
    ref, ref_fin = il2.decode_shared_cdf(st, cut, len(syms), cdf, cfg,
                                         return_final_states=True)
    out, fin = _decode(st, cut, cdf, cfg, len(syms))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(fin, ref_fin)


def test_seed_errors_match_host_oracle():
    cdf, cfg, syms, seeds = _case(100, 24, 500, seed=1)
    c = cdf.astype(np.uint64)
    cums, probs = c[syms], c[syms + 1] - c[syms]
    bad_seeds = seeds.copy()
    bad_seeds[7] = np.uint64(5)  # below the floor 2^32
    for bad in (seeds[:-1], bad_seeds):
        with pytest.raises(ValueError) as host:
            il2.encode_shared(cums, probs, cfg, seeds=bad)
        with pytest.raises(ValueError) as port:
            _encode(syms, cdf, cfg, bad)
        assert str(port.value) == str(host.value)


def test_cpu_tensors_run_the_twin_and_launch_nothing():
    cdf, cfg, syms, seeds = _case(100, 24, 700, seed=2)
    before = dict(coder64.LAUNCHES)
    st, w = _encode(syms, cdf, cfg, seeds)
    _decode(st, w, cdf, cfg, len(syms))
    assert coder64.LAUNCHES == before


def test_wrapper_rejects_wrong_dtype_and_config():
    cdf, cfg, syms, _ = _case(100, 24, 300, seed=4)
    cdf_t = convert.cdf_to_torch(cdf)
    with pytest.raises(TypeError):
        coder64.encode_iid64(torch.from_numpy(syms), cdf_t, cfg)  # int64
    with pytest.raises(ValueError):
        coder64.encode_iid64(
            torch.from_numpy(syms.astype(np.int32)), cdf_t,
            LaneConfig(num_lanes=256, word_bits=16, state_bits=32,
                       precision=12),
        )
    with pytest.raises(ValueError):
        coder64.decode_shared64(
            torch.zeros(255, dtype=torch.int64),
            torch.zeros(0, dtype=torch.int32), cdf_t, cfg, 10,
        )
