"""The port's table builders (``ops.tables``) against the JAX package's
``tables_jax`` and both packages' host builders, on the CPU, case by case
as ``tests/test_tables_jax.py`` holds the JAX ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu.ops import pallas_family as pf
from constriction_tpu.ops import tables_jax as tj
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops import tables
from constriction_tpu_torch.ops.interleaved import LaneConfig


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host code on its numpy path."""
    monkeypatch.setattr(native, "LIB", None)


def _pmf(k, seed):
    return np.random.RandomState(seed).dirichlet(np.full(k, 0.7)).astype(
        np.float32)


def _valid(cdf, P):
    assert cdf.dtype == torch.int64
    c = cdf.numpy()
    assert c[0] == 0 and c[-1] == 1 << P
    assert np.diff(c).min() >= 1  # leaky: every symbol codable


def _cumsum_gap(p, other_cumsum):
    """2^P-free measure of how far torch's float32 cumulative sum lies from
    another one: max_k |c_k - o_k| + |c_K - o_K|."""
    c = torch.cumsum(torch.from_numpy(p), 0).numpy().astype(np.float64)
    o = np.asarray(other_cumsum, dtype=np.float64)
    return np.abs(c - o).max() + abs(c[-1] - o[-1])


@pytest.mark.parametrize("P", [12, 16, 24])
@pytest.mark.parametrize("k", [2, 5, 64, 250])
def test_fast_quantized_cdf_valid_and_close_to_host_and_jax(k, P):
    """Within 1 of the host builder and of ``fast_quantized_cdf_jax`` at
    P <= 16.  At P = 24 one float32 ulp of a cumulative sum near 1 is one
    unit of the table, so the bound is the module's: 1 + 2^P times the
    gap between the two cumulative sums (the JAX builder's own distance
    from the host's is of the same kind)."""
    p = _pmf(k, seed=k + P)
    cdf = tables.fast_quantized_cdf(torch.from_numpy(p), P)
    _valid(cdf, P)
    host = fast_quantized_cdf(p, P).astype(np.int64)
    ref = np.asarray(tj.fast_quantized_cdf_jax(p, P)).astype(np.int64)
    for other, sums in ((host, np.add.accumulate(p, dtype=np.float32)),
                        (ref, np.asarray(jnp.cumsum(p)))):
        bound = 1 if P <= 16 else 1 + int(np.ceil(
            (1 << P) * _cumsum_gap(p, sums)))
        assert np.abs(cdf.numpy() - other).max() <= bound


def test_fast_quantized_cdf_clamps_overshoot_to_leaky():
    """The PMF of ``test_fast_cdf_jax_clamps_overshoot_to_leaky``: a float32
    truncation past the free weight is clamped, so the table stays a valid
    leaky model (the host builder raises there)."""
    p = torch.tensor([0.888, 0.631, 0.356, 0.528, 0.226, 0.777, 1e-7],
                     dtype=torch.float32)
    for P in (12, 24):
        cdf = tables.fast_quantized_cdf(p, P)
        _valid(cdf, P)
        n = len(p)
        assert (cdf[:-1] <= (1 << P) - n + torch.arange(n)).all()


def test_fast_quantized_cdf_input_checks():
    with pytest.raises(ValueError, match="invalid number"):
        tables.fast_quantized_cdf(torch.ones(1), 12)
    with pytest.raises(ValueError, match="invalid number"):
        tables.fast_quantized_cdf(torch.ones(4095), 12)
    with pytest.raises(TypeError, match="torch.Tensor"):
        tables.fast_quantized_cdf(np.ones(4, np.float32), 12)
    # float64 inputs are cast to float32 first, as in JAX
    p = _pmf(30, seed=3)
    want = tables.fast_quantized_cdf(torch.from_numpy(p), 12)
    got = tables.fast_quantized_cdf(torch.from_numpy(p).double(), 12)
    assert torch.equal(got, want)


def test_device_built_table_round_trip():
    """A table built here codes and decodes self-consistently (the port's
    numpy host coder)."""
    rng = np.random.RandomState(1)
    k, n = 40, 3000
    p = rng.dirichlet(np.full(k, 1.0)).astype(np.float32)
    cdf = tables.fast_quantized_cdf(torch.from_numpy(p), 12).numpy().astype(
        np.uint64)
    symbols = rng.randint(0, k, size=n).astype(np.int64)
    cfg = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
    states, stream = il2.encode_shared(cdf[symbols],
                                       cdf[symbols + 1] - cdf[symbols], cfg)
    np.testing.assert_array_equal(
        il2.decode_shared_cdf(states, stream, n, cdf, cfg), symbols)


@pytest.mark.parametrize("size,P", [(2, 2), (10, 12), (100, 12), (7, 16),
                                    (1 << 12, 12), (1000, 24)])
def test_uniform_cdf_equals_jax(size, P):
    got = tables.uniform_cdf(size, P, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(tj.uniform_cdf_jax(size, P)).astype(np.int64))


def test_uniform_cdf_validates_size():
    for size, P, match in ((5000, 12, "range too large"), (1, 12, "range > 1"),
                           (0, 12, "range > 1")):
        with pytest.raises(ValueError, match=match):
            tables.uniform_cdf(size, P, device="cpu")
        with pytest.raises(ValueError, match=match):
            tj.uniform_cdf_jax(size, P)


def test_uniform_cdf_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tables.uniform_cdf(10, 12)


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_family_tables_bit_identical_to_jax_and_host(family):
    rng = np.random.RandomState(2)
    n = 500
    means = (rng.randn(n) * 20).astype(np.float32)
    scales = (0.5 + np.abs(rng.randn(n)) * 3).astype(np.float32)
    symbols = np.clip(np.round(means), -100, 100).astype(np.int32)
    symbols[:4] = [-100, 100, -99, 99]  # the pinned ends and their neighbours
    cum, prob = tables.family_tables(torch.from_numpy(symbols),
                                     torch.from_numpy(means),
                                     torch.from_numpy(scales), family,
                                     -100, 100)
    for want_c, want_p in (
        tj.family_tables_jax(symbols, means, scales, family, -100, 100),
        pf.family_tables_host(symbols, means, scales, family, -100, 100),
        fam.family_tables_host(symbols, means, scales, family, -100, 100),
    ):
        np.testing.assert_array_equal(cum.numpy().astype(np.uint64),
                                      np.asarray(want_c).astype(np.uint64))
        np.testing.assert_array_equal(prob.numpy().astype(np.uint64),
                                      np.asarray(want_p).astype(np.uint64))


def test_family_tables_input_checks():
    t = torch.zeros(3)
    with pytest.raises(ValueError, match="family"):
        tables.family_tables(t, t, t + 1, "student", -10, 10)
    with pytest.raises(TypeError, match="torch.Tensor"):
        tables.family_tables(np.zeros(3), t, t + 1, "gaussian", -10, 10)
