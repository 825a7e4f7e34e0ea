"""The port's fixed-point models (``constriction_tpu_torch.models`` and the
models of ``stream.model``) against the JAX package's, on the CPU.

Every model of the host API is built in both packages from the same
seeded parameters, and its ``(cum, prob)`` over the whole support and its
quantile function at a seeded sample of quantiles plus the ends ``0`` and
``2^P - 1`` must be equal: QuantizedGaussian, QuantizedLaplace,
QuantizedCauchy, Binomial, Bernoulli, Uniform, Categorical in its perfect,
fast and lazy forms, the lookup and non-contiguous models, CustomModel and
ScipyModel.  Also ``perfectly_quantized_probabilities``,
``fast_quantized_cdf``, the approximate inverse CDFs of ``utils.special``
and ``QuantizedFamily.ecp_all`` (the host codec's ``ctpu_quantized_ecp``
at 64 symbols or more) against its ``ecp_all_plain`` and the JAX
package's numpy branch; errors must match in class and text.  The JAX
package's ``native.LIB`` is None here, so its numpy branches are the
oracle.  Integer models and f64 guesses: tolerance is equality.
"""

import numpy as np
import pytest
import scipy.stats

import constriction_tpu as ref
import constriction_tpu_torch as ctt
from constriction_tpu import native as ref_native
from constriction_tpu.utils import special as ref_special
from constriction_tpu_torch.utils import special

PKGS = (ref, ctt)


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host paths take their numpy branches."""
    monkeypatch.setattr(ref_native, "LIB", None)


def _table(model, support):
    return [(s, *model.ecp(int(s))) for s in support]


def _quantiles(P: int, seed: int):
    rng = np.random.RandomState(seed)
    return [0, (1 << P) - 1, *(int(q) for q in rng.randint(0, 1 << P, 48))]


def _concrete(pkg, name: str):
    """(model, support) of the host API's concrete model ``name``."""
    sm, m = pkg.stream.model, pkg.models
    rng = np.random.RandomState(7)
    probs = rng.dirichlet(np.full(23, 0.7))
    if name == "gaussian":
        return sm.QuantizedGaussian(-100, 100, 3.2, 9.6)._as_parameterized(), range(-100, 101)
    if name == "gaussian_narrow":
        return sm.QuantizedGaussian(-100, 100, -50.3, 0.4)._as_parameterized(), range(-100, 101)
    if name == "gaussian_outside":
        return sm.QuantizedGaussian(-100, 100, -500.0, 4.0)._as_parameterized(), range(-100, 101)
    if name == "laplace":
        return sm.QuantizedLaplace(-100, 100, 10.5, 20.0)._as_parameterized(), range(-100, 101)
    if name == "cauchy":
        return sm.QuantizedCauchy(-100, 100, 60.0, 0.5)._as_parameterized(), range(-100, 101)
    if name == "binomial":
        return sm.Binomial(40, 0.3)._as_parameterized(), range(41)
    if name == "bernoulli_perfect":
        return sm.Bernoulli(0.3, perfect=True)._as_parameterized(), range(2)
    if name == "bernoulli_fast":
        return sm.Bernoulli(0.3, perfect=False)._as_parameterized(), range(2)
    if name == "uniform":
        return sm.Uniform(37)._as_parameterized(), range(37)
    if name == "uniform_p12":
        return m.UniformModel(255, 12), range(255)
    if name == "categorical_perfect":
        return sm.Categorical(probs, perfect=True)._as_parameterized(), range(23)
    if name == "categorical_fast":
        return sm.Categorical(probs, perfect=False)._as_parameterized(), range(23)
    if name == "categorical_lazy":
        return sm.Categorical(probs.astype(np.float32), lazy=True)._as_parameterized(), range(23)
    if name == "lookup":
        return (m.ContiguousLookupDecoderModel.from_floating_point_probabilities_fast(probs, 12),
                range(23))
    if name == "lookup_perfect":
        return (m.ContiguousLookupDecoderModel.from_floating_point_probabilities_perfect(probs, 12),
                range(23))
    if name == "noncontiguous":
        return (m.NonContiguousCategoricalDecoderModel
                .from_symbols_and_floating_point_probabilities_perfect(
                    [3 * s - 20 for s in range(23)], probs, 24),
                [3 * s - 20 for s in range(23)])
    if name == "noncontiguous_lookup":
        base = m.ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(probs, 12)
        return (m.NonContiguousLookupDecoderModel
                .from_symbols_and_nonzero_fixed_point_probabilities(
                    [5 * s + 1 for s in range(23)], np.diff(base.cdf.astype(np.int64)), 12),
                [5 * s + 1 for s in range(23)])
    if name == "custom":
        norm = scipy.stats.norm(1.2, 4.9)
        return sm.CustomModel(norm.cdf, norm.ppf, -30, 30)._as_parameterized(), range(-30, 31)
    if name == "scipy":
        return sm.ScipyModel(scipy.stats.cauchy(-3.0, 2.5), -30, 30)._as_parameterized(), range(-30, 31)
    raise KeyError(name)


CONCRETE = ("gaussian", "gaussian_narrow", "gaussian_outside", "laplace",
            "cauchy", "binomial", "bernoulli_perfect", "bernoulli_fast",
            "uniform", "uniform_p12", "categorical_perfect",
            "categorical_fast", "categorical_lazy", "lookup",
            "lookup_perfect", "noncontiguous", "noncontiguous_lookup",
            "custom", "scipy")


@pytest.mark.parametrize("name", CONCRETE)
def test_concrete_model_equals_reference(name):
    (mr, support), (mp, _) = (_concrete(pkg, name) for pkg in PKGS)
    assert mp.precision == mr.precision
    table = _table(mp, support)
    assert table == _table(mr, support)
    assert sum(p for _, _, p in table) == 1 << mp.precision
    assert list(mp.symbol_table()) == list(mr.symbol_table())
    for q in _quantiles(mp.precision, len(name)):
        assert mp.qf(q) == mr.qf(q), q
    if hasattr(mr, "ecp_array"):
        sym = np.asarray(list(support))
        for a, b in zip(mp.ecp_array(sym), mr.ecp_array(sym)):
            np.testing.assert_array_equal(a, b)


def test_encoder_model_and_conversions_equal_reference():
    """The non-contiguous encoder model's table and the generic
    conversions of a quantized model."""
    outs = []
    for pkg in PKGS:
        m = pkg.models
        enc = (m.NonContiguousCategoricalEncoderModel
               .from_symbols_and_floating_point_probabilities_fast(
                   [9, -4, 30, 2], np.array([0.1, 0.5, 0.15, 0.25]), 16))
        q = m.LeakyQuantizer(-20, 20, 12).quantize(m.Laplace(1.5, 3.0))
        outs.append((enc.table, q.to_generic_encoder_model().table,
                     list(q.to_generic_decoder_model().symbol_table()),
                     [q.to_generic_lookup_decoder_model().qf(i)
                      for i in range(0, 1 << 12, 37)],
                     q.entropy_base2()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("P", [8, 12, 24])
def test_quantizers_equal_reference(P, dtype):
    rng = np.random.RandomState(P)
    for K in (2, 3, 50, 200):
        if K >= (1 << P) - 1:
            continue
        probs = rng.dirichlet(np.full(K, 0.3)).astype(dtype)
        np.testing.assert_array_equal(
            ctt.models.perfectly_quantized_probabilities(probs, P),
            ref.models.perfectly_quantized_probabilities(probs, P))
        np.testing.assert_array_equal(
            ctt.models.fast_quantized_cdf(probs, P),
            ref.models.fast_quantized_cdf(probs, P))
        np.testing.assert_array_equal(
            ctt.models.fast_quantized_cdf(probs * 3, P, 3.0),
            ref.models.fast_quantized_cdf(probs * 3, P, 3.0))


def test_ppfs_equal_reference():
    rng = np.random.RandomState(3)
    xi = np.concatenate([rng.uniform(0.0, 1.0, 4096), [0.0, 1.0, 1e-300,
                                                       0.5, 1 - 1e-16]])
    mean = rng.uniform(-50, 50, xi.size)
    sc = np.exp(rng.uniform(-3, 3, xi.size))
    for fn in ("gaussian_ppf", "laplace_ppf", "cauchy_ppf"):
        np.testing.assert_array_equal(getattr(special, fn)(xi, mean, sc),
                                      getattr(ref_special, fn)(xi, mean, sc))
    y = rng.uniform(-1.0, 1.0, 4096)
    np.testing.assert_array_equal(special._erfinv(y), ref_special._erfinv(y))
    n = rng.randint(1, 200, xi.size)
    p = rng.uniform(0, 1, xi.size)
    np.testing.assert_array_equal(special.binomial_ppf(xi, n, p),
                                  ref_special.binomial_ppf(xi, n, p))


@pytest.mark.parametrize("n", [10, 300, 4096])
@pytest.mark.parametrize("kind", ["gaussian", "laplace", "cauchy"])
def test_family_ecp_all_route_equals_plain_and_reference(kind, n):
    """At 64 symbols or more ``ecp_all`` runs ``ctpu_quantized_ecp``;
    below, and in ``ecp_all_plain``, the numpy formulas; the JAX
    package's numpy branch is the oracle."""
    rng = np.random.RandomState(n + len(kind))
    a = rng.uniform(-120, 120, n)
    b = np.exp(rng.uniform(np.log(0.05), np.log(40.0), n))
    sym = np.clip(np.round(a + rng.randn(n) * b), -100, 100).astype(np.int64)
    sym[:2] = (-100, 100)
    fam = ctt.models.QuantizedFamily(kind, -100, 100, a, b, 24)
    want = ref.models.QuantizedFamily(kind, -100, 100, a, b, 24).ecp_all(sym)
    for got in (fam.ecp_all(sym), fam.ecp_all_plain(sym)):
        for x, y in zip(got, want):
            assert x.dtype == y.dtype == np.uint64
            np.testing.assert_array_equal(x, y)


def _probs_nan():
    return np.array([0.5, np.nan, 0.5])


ERRORS = {
    "categorical_nan": lambda pkg: pkg.stream.model.Categorical(_probs_nan(), perfect=False),
    "categorical_lazy_perfect": lambda pkg: pkg.stream.model.Categorical(lazy=True, perfect=True),
    "categorical_rank2": lambda pkg: pkg.stream.model.Categorical(np.ones((2, 2)), perfect=False),
    "support_empty": lambda pkg: pkg.stream.model.QuantizedGaussian(5, 5),
    "support_too_large": lambda pkg: pkg.models.LeakyQuantizer(0, 1 << 13, 12),
    "std_negative": lambda pkg: pkg.models.Gaussian(0.0, -1.0),
    "scale_zero": lambda pkg: pkg.models.Laplace(0.0, 0.0),
    "binomial_params": lambda pkg: pkg.models.Binomial(0, 0.5),
    "uniform_one": lambda pkg: pkg.models.UniformModel(1),
    "bernoulli_p": lambda pkg: pkg.stream.model.Bernoulli(1.5, perfect=True),
    "no_params": lambda pkg: pkg.stream.model.QuantizedGaussian(-5, 5)._as_parameterized(),
    "already_parameterized": lambda pkg: pkg.stream.model.Uniform(5)._parameterize((np.ones(2),)),
    "wrong_param_count": lambda pkg: pkg.stream.model.QuantizedGaussian(-5, 5)._parameterize(
        (np.ones(3),)),
    "unequal_params": lambda pkg: pkg.stream.model.QuantizedGaussian(-5, 5)._parameterize(
        (np.ones(3), np.ones(2))),
    "int_param_dtype": lambda pkg: pkg.stream.model.QuantizedGaussian(-5, 5)._parameterize(
        (np.ones(3, np.int32), np.ones(3))),
    "int32_overflow": lambda pkg: pkg.stream.model.Uniform()._parameterize(
        (np.array([1 << 31]),)),
    "impossible_symbol": lambda pkg: pkg.models.ContiguousCategoricalEntropyModel
    .from_floating_point_probabilities_fast(np.array([0.2, 0.8]), 12).ecp(2),
    "impossible_array": lambda pkg: pkg.stream.model.Uniform(4)._as_parameterized().ecp_array(
        np.array([1, 9])),
    "quantized_out_of_support": lambda pkg: pkg.stream.model.QuantizedGaussian(
        -5, 5, 0.0, 1.0)._as_parameterized().ecp(6),
    "fast_too_few": lambda pkg: pkg.models.fast_quantized_cdf(np.array([1.0]), 12),
    "perfect_too_many": lambda pkg: pkg.models.perfectly_quantized_probabilities(
        np.ones(5000) / 5000, 12),
    "lookup_bad_cdf": lambda pkg: pkg.models.ContiguousLookupDecoderModel(
        np.array([0, 5, 5, 4096]), 12),
    "fixed_point_sum": lambda pkg: pkg.models.ContiguousCategoricalEntropyModel
    .from_nonzero_fixed_point_probabilities(np.array([1, 2, 3]), 12),
    "duplicate_symbol": lambda pkg: pkg.models.NonContiguousCategoricalEncoderModel
    .from_symbols_and_nonzero_fixed_point_probabilities(
        [7, 7, 3], np.array([1 << 11, 1 << 10, 1 << 10], dtype=np.uint64), 12),
    "family_wrong_length": lambda pkg: pkg.models.QuantizedFamily(
        "gaussian", -10, 10, np.zeros(3), np.ones(3)).ecp_all(np.zeros(2, np.int64)),
    "family_nan_mean": lambda pkg: pkg.models.QuantizedFamily(
        "gaussian", -10, 10, [0.0, np.nan], [1.0, 1.0], 12).ecp_all(np.array([0, 1])),
    "family_impossible": lambda pkg: pkg.models.QuantizedFamily(
        "laplace", -10, 10, np.zeros(100), np.ones(100)).ecp_all(np.full(100, 11)),
    "family_unequal_shape": lambda pkg: pkg.models.QuantizedFamily(
        "cauchy", -10, 10, np.zeros(3), np.ones(2)),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_equal_reference(case):
    caught = []
    for pkg in PKGS:
        with pytest.raises(Exception) as info:
            ERRORS[case](pkg)
        caught.append(info.value)
    want, got = caught
    assert type(got).__name__ == type(want).__name__
    assert [c.__name__ for c in type(got).__mro__] == [
        c.__name__ for c in type(want).__mro__]
    assert str(got) == str(want)
