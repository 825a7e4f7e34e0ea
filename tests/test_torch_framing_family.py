"""The port's compact v2 family containers against the JAX package's.

``ops/framing_family.py`` must write the bytes of the JAX package's
``framing_family.encode_family_v2`` (host region coders, ``native.LIB`` set
to None) for a message with a region B and for a compact-only one, read
them back, and raise ValueError where the JAX module asserts or where the
arguments do not fit the format.  Tolerance: equality.
"""

import numpy as np
import pytest

from constriction_tpu import native
from constriction_tpu.ops import framing_family as ref_ff
from constriction_tpu.ops.interleaved import LaneConfig as RefCfg
from constriction_tpu_torch import cuda as ctt
from constriction_tpu_torch.ops import framing as fr
from constriction_tpu_torch.ops import framing_family as ff
from constriction_tpu_torch.ops.interleaved import LaneConfig


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    monkeypatch.setattr(native, "LIB", None)


def _data(n, seed):
    rng = np.random.RandomState(seed)
    means = rng.randn(n) * 20
    scales = np.exp(rng.normal(0.4, 0.6, n))
    syms = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
                   ).astype(np.int64)
    return means, scales, syms


@pytest.mark.parametrize("family,n,L,region_b", [
    ("gaussian", 20_000, 128, True), ("laplace", 12_000, 128, True),
    ("cauchy", 1_500, 256, False), ("gaussian", 700, 128, False),
])
def test_container_matches_jax(family, n, L, region_b):
    means, scales, syms = _data(n, seed=n + L)
    cfg = LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=24)
    data = ff.encode_family_v2(syms, means, scales, family, -100, 100, cfg,
                               "cpu")
    ref = ref_ff.encode_family_v2(syms, means, scales, family, -100, 100,
                                  RefCfg(L, 32, 64, 24))
    assert data.dtype == ref.dtype == np.uint32
    np.testing.assert_array_equal(data, ref)
    assert (fr.parse_v2(data).k_B > 0) == region_b
    out = ff.decode_family_v2(data, means, scales, family, -100, 100, "cpu")
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, syms)
    if region_b:  # the on-card builder's pipeline, run by its CPU twins
        np.testing.assert_array_equal(
            ff.decode_family_v2(data, means, scales, family, -100, 100, "cpu",
                                device_tables=True), syms)


def test_container_binomial_and_p17():
    rng = np.random.RandomState(3)
    n = 9_000
    ps = rng.uniform(0.05, 0.95, n)
    nt = np.full(n, 40.0)
    syms = rng.binomial(40, ps)
    cfg = LaneConfig(num_lanes=128, word_bits=32, state_bits=64,
                     precision=17)
    data = ff.encode_family_v2(syms, nt, ps, "binomial", 0, 40, cfg, "cpu")
    ref = ref_ff.encode_family_v2(syms, nt, ps, "binomial", 0, 40,
                                  RefCfg(128, 32, 64, 17))
    np.testing.assert_array_equal(data, ref)
    np.testing.assert_array_equal(
        ff.decode_family_v2(data, nt, ps, "binomial", 0, 40, "cpu"), syms)


def test_facade_container_on_cpu():
    n = 40_000
    means, scales, syms = _data(n, seed=4)
    data = ctt.encode_family_exact_container(syms, means, scales, "gaussian",
                                             -100, 100, device="cpu")
    # the facade's lane count: _pick_cfg_family's, entropy-blind
    assert fr.peek_cfg(data) == LaneConfig(4096, 32, 64, 24)
    ref = ref_ff.encode_family_v2(syms, means, scales, "gaussian", -100, 100,
                                  RefCfg(4096, 32, 64, 24))
    np.testing.assert_array_equal(data, ref)
    np.testing.assert_array_equal(
        ctt.decode_family_exact_container(data, means, scales, "gaussian",
                                          -100, 100, device="cpu"), syms)


def test_container_errors():
    means, scales, syms = _data(2_000, seed=5)
    cfg = LaneConfig(num_lanes=128, word_bits=32, state_bits=64,
                     precision=24)
    data = ff.encode_family_v2(syms, means, scales, "gaussian", -100, 100,
                               cfg, "cpu")
    with pytest.raises(ValueError, match="models given"):
        ff.decode_family_v2(data, means[:-1], scales[:-1], "gaussian", -100,
                            100, "cpu")
    with pytest.raises(ValueError, match="models given"):  # as the JAX one
        ref_ff.decode_family_v2(data, means[:-1], scales[:-1], "gaussian",
                                -100, 100)
    with pytest.raises(ValueError, match="means"):
        ff.encode_family_v2(syms, means[:-1], scales[:-1], "gaussian", -100,
                            100, cfg, "cpu")
    for bad_cfg, match in (
            (LaneConfig(192, 32, 64, 24), "multiple of 128"),
            (LaneConfig(128, 32, 64, 16), "16 < P <= 24"),
            (LaneConfig(128, 16, 32, 12), "W=32, S=64")):
        with pytest.raises(ValueError, match=match):
            ff.encode_family_v2(syms, means, scales, "gaussian", -100, 100,
                                bad_cfg, "cpu")
    for family in ("logistic", "uniform"):
        with pytest.raises(ValueError, match="families"):
            ff.encode_family_v2(syms, means, scales, family, -100, 100, cfg,
                                "cpu")
        with pytest.raises(ValueError, match="families"):
            ff.decode_family_v2(data, means, scales, family, -100, 100,
                                "cpu")
    # a header whose config the family path does not take
    bad = data.copy()
    bad[2] = 32 | (16 << 8) | (64 << 16)  # P = 16
    with pytest.raises(ValueError, match="16 < P <= 24"):
        ff.decode_family_v2(bad, means, scales, "gaussian", -100, 100, "cpu")
    assert len(ff.decode_family_v2(ff.encode_family_v2(
        syms[:0], means[:0], scales[:0], "gaussian", -100, 100, cfg, "cpu"),
        means[:0], scales[:0], "gaussian", -100, 100, "cpu")) == 0
