"""Port of the small-preset ILANS2 coder (constriction_tpu_torch.ops.coder,
W=16, S=32, P <= 16) against the JAX package: the Pallas kernels in
interpret mode and the host oracle (interleaved2.encode_shared /
decode_shared_cdf).  Integer coding, so the tolerance is exact equality."""

import numpy as np
import pytest
import torch

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops import pallas_coder as pc
from constriction_tpu.ops.interleaved import LaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder


def _model(K, P, seed):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, 2.0))
    m = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    )
    return m.cdf, probs


def _case(K, P, n, seed, L=256):
    cdf, probs = _model(K, P, seed)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)
    rng = np.random.RandomState(seed + n)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    # u32 start states over [2^16, 2^32), half of them >= 2^31
    seeds = rng.randint(1 << 16, 1 << 31, size=L).astype(np.uint32)
    seeds[::2] |= np.uint32(1 << 31)
    return cdf, cfg, syms, seeds


def _encode(syms, cdf, cfg, seeds):
    st, w = coder.encode_iid(
        torch.from_numpy(syms.astype(np.int32)), convert.cdf_to_torch(cdf),
        cfg,
        seeds=None if seeds is None else convert.u32_to_torch(seeds),
    )
    return convert.u32_from_torch(st), convert.u32_from_torch(w)


def _decode(st, w, cdf, cfg, n):
    out, fin = coder.decode_shared(
        convert.u32_to_torch(st), convert.u32_to_torch(w),
        convert.cdf_to_torch(cdf), cfg, n, return_final_states=True,
    )
    return out.numpy(), convert.u32_from_torch(fin)


# --- against the Pallas kernels in interpret mode (kept few: each costs ~1 s)


@pytest.mark.parametrize("seeded", [False, True])
def test_encode_matches_pallas_interpret(seeded):
    cdf, cfg, syms, seeds = _case(100, 12, 1000, seed=5)  # partial tail
    seeds = seeds if seeded else None
    ref_st, ref_w = pc.encode_iid_pallas(
        syms.astype(np.int32), cdf, cfg, seeds=seeds
    )
    st, w = _encode(syms, cdf, cfg, seeds)
    np.testing.assert_array_equal(st, np.asarray(ref_st))
    np.testing.assert_array_equal(w, np.asarray(ref_w))


def test_decode_matches_pallas_interpret():
    cdf, cfg, syms, seeds = _case(100, 16, 900, seed=6)
    c = cdf.astype(np.uint64)
    st, w = il2.encode_shared(c[syms], c[syms + 1] - c[syms], cfg,
                              seeds=seeds)
    ref, ref_fin = pc.decode_shared_pallas(
        st, w, cdf, cfg, len(syms), return_final_states=True
    )
    out, fin = _decode(st, w, cdf, cfg, len(syms))
    np.testing.assert_array_equal(out, np.asarray(ref))
    np.testing.assert_array_equal(fin, ref_fin)
    np.testing.assert_array_equal(fin, seeds)


# --- against the host oracle


CASES = [
    (16, 12, 2000),
    (100, 12, 5000),
    (100, 16, 3000),
    (2, 12, 1500),
    (1000, 16, 4000),
    (30, 8, 3000),
    (100, 12, 256 * 7),  # exact multiple of L (no tail)
    (100, 12, 1),
    (100, 12, 0),
]


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("K,P,n", CASES)
def test_encode_matches_host_oracle(K, P, n, seeded):
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
def test_decode_matches_host_oracle(K, P, n, seeded):
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


def test_decode_zero_probability_entries():
    P = 12
    cdf = np.array([0, 0, 1000, 1000, 4090, 4090, 4096], dtype=np.uint32)
    cfg = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=P)
    rng = np.random.RandomState(3)
    syms = rng.choice([1, 3, 5], size=2000, p=[0.25, 0.7, 0.05]).astype(
        np.int64)
    c = cdf.astype(np.uint64)
    st, w = il2.encode_shared(c[syms], c[syms + 1] - c[syms], cfg)
    out, fin = _decode(st, w, cdf, cfg, len(syms))
    np.testing.assert_array_equal(out, syms)
    np.testing.assert_array_equal(fin, np.full(128, 1 << 16, np.uint32))


def test_decode_truncated_stream_zero_fills():
    """n < 256 keeps decode_shared_cdf on its numpy path, which zero-fills
    reads past the end of the stream."""
    cdf, cfg, syms, _ = _case(100, 12, 250, seed=11, L=128)
    c = cdf.astype(np.uint64)
    st, w = il2.encode_shared(c[syms], c[syms + 1] - c[syms], cfg)
    cut = w[: len(w) // 2]
    ref, ref_fin = il2.decode_shared_cdf(st, cut, len(syms), cdf, cfg,
                                         return_final_states=True)
    out, fin = _decode(st, cut, cdf, cfg, len(syms))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(fin, ref_fin)


def test_seed_errors_match_host_oracle():
    cdf, cfg, syms, seeds = _case(100, 12, 500, seed=1)
    c = cdf.astype(np.uint64)
    cums, probs = c[syms], c[syms + 1] - c[syms]
    bad_seeds = seeds.copy()
    bad_seeds[3] = np.uint32(17)  # below the floor 2^16
    for bad in (seeds[:100], bad_seeds):
        with pytest.raises(ValueError) as host:
            il2.encode_shared(cums, probs, cfg, seeds=bad)
        with pytest.raises(ValueError) as port:
            _encode(syms, cdf, cfg, bad)
        assert str(port.value) == str(host.value)


def test_cpu_tensors_run_the_twin_and_launch_nothing():
    cdf, cfg, syms, seeds = _case(100, 12, 700, seed=2)
    before = dict(coder.LAUNCHES)
    st, w = _encode(syms, cdf, cfg, seeds)
    _decode(st, w, cdf, cfg, len(syms))
    assert coder.LAUNCHES == before


def test_wrapper_rejects_bad_arguments():
    cdf, cfg, syms, _ = _case(100, 12, 300, seed=4)
    cdf_t = convert.cdf_to_torch(cdf)
    syms_t = torch.from_numpy(syms.astype(np.int32))
    with pytest.raises(TypeError):
        coder.encode_iid(syms_t, cdf_t.to(torch.int32), cfg)
    with pytest.raises(ValueError):  # S=64 is coder64's
        coder.encode_iid(
            syms_t, cdf_t,
            LaneConfig(num_lanes=256, word_bits=32, state_bits=64,
                       precision=12),
        )
    with pytest.raises(ValueError):  # lanes must tile 128
        coder.encode_iid(
            syms_t, cdf_t,
            LaneConfig(num_lanes=200, word_bits=16, state_bits=32,
                       precision=12),
        )
    with pytest.raises(ValueError):  # unsupported device
        coder.encode_iid(syms_t.to("meta"), cdf_t.to("meta"), cfg)
