"""Python API parity layer: `constriction_tpu_torch.stream.model`.

Mirrors `constriction.stream.model`
(the reference's src/pybindings/stream/model.rs:101-1055): the `Model` base
class, `CustomModel`, `ScipyModel`, `Categorical`, `Uniform`,
`QuantizedGaussian`, `QuantizedLaplace`, `QuantizedCauchy`, `Binomial`, and
`Bernoulli` -- all at the "default" preset (word u32 / state u64 /
PRECISION 24).

A `Model` is either *concrete* (fully parameterized at construction) or a
*model family* whose per-symbol parameters are passed to the entropy coder's
encode/decode methods (rank-1 float arrays, or a single rank-2 array for
`Categorical`).  Families iterate parameters in reverse for stack/chain
encoding (internals.rs:226-235).

JAX counterpart: ``constriction_tpu/stream/model.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..models import base as _base
from ..models import categorical as _cat
from ..models import quantized as _quant
from ..models import uniform as _uni

PRECISION = 24

_WARNED_CATEGORICAL = [False]
_WARNED_BERNOULLI = [False]


def _cast_float_param(arr, name: str = "parameter") -> np.ndarray:
    """Accept rank-1 f32/f64 arrays; f32 widens exactly to f64
    (pybindings/mod.rs:186-243, `PyReadonlyFloatArray::cast_f64`)."""
    a = np.asarray(arr)
    if a.dtype not in (np.float32, np.float64):
        raise TypeError(f"{name} must be a numpy array with float dtype")
    if a.ndim != 1:
        raise ValueError(f"{name} must be a rank-1 array")
    return a.astype(np.float64)


def _cast_i32_param(arr, name: str = "parameter") -> np.ndarray:
    a = np.asarray(arr)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"{name} must be a numpy array with dtype np.int32")
    if a.ndim != 1:
        raise ValueError(f"{name} must be a rank-1 array")
    if len(a) and (int(a.min()) < -(1 << 31) or int(a.max()) >= (1 << 31)):
        raise OverflowError(f"{name} contains values outside the int32 range")
    return a.astype(np.int32)


class Model:
    """Abstract base class for all entropy models."""

    def _as_parameterized(self) -> _base.EntropyModel:
        raise ValueError("No model parameters specified.")

    def _parameterize(self, params: Tuple) -> _base.ModelFamily:
        raise ValueError(
            "Model parameters were specified but the model is already fully parameterized."
        )

    def _family_len(self, param0) -> int:
        raise ValueError(
            "Model parameters were specified but the model is already fully parameterized."
        )


class _ConcreteModel(Model):
    def __init__(self, inner: _base.EntropyModel):
        self._inner = inner

    def _as_parameterized(self) -> _base.EntropyModel:
        return self._inner


class _GenericFamily(_base.ModelFamily):
    def __init__(self, size: int, concrete_fn):
        self.size = size
        self._concrete_fn = concrete_fn

    def concrete(self, i: int) -> _base.EntropyModel:
        return self._concrete_fn(i)


class CustomModel(Model):
    """Quantized user-defined distribution via `cdf`/`approximate_inverse_cdf`
    callbacks (model.rs:224-247).  The callbacks receive a scalar position and
    any per-symbol model parameters, and must return a float."""

    def __init__(self, cdf, approximate_inverse_cdf, min_symbol_inclusive, max_symbol_inclusive):
        self._cdf = cdf
        self._ppf = approximate_inverse_cdf
        self._min = int(min_symbol_inclusive)
        self._max = int(max_symbol_inclusive)
        self._quantizer = _quant.LeakyQuantizer(self._min, self._max, PRECISION)

    def _as_parameterized(self) -> _base.EntropyModel:
        return self._quantizer.quantize(
            _quant.CallbackDistribution(self._cdf, self._ppf, ())
        )

    def _parameterize(self, params: Tuple) -> _base.ModelFamily:
        arrays = [_cast_float_param(p, "model parameter") for p in params]
        if len({len(a) for a in arrays}) != 1:
            raise ValueError("Model parameters have unequal lengths.")
        return _quant.CallbackFamily(self._cdf, self._ppf, self._min, self._max, arrays, PRECISION)

    def _family_len(self, param0) -> int:
        return len(np.asarray(param0))


class ScipyModel(CustomModel):
    """Adapter for scipy.stats distributions or frozen distributions
    (model.rs:326-348): extracts `.cdf` and `.ppf`."""

    def __init__(self, scipy_model, min_symbol_inclusive, max_symbol_inclusive):
        super().__init__(
            scipy_model.cdf, scipy_model.ppf, min_symbol_inclusive, max_symbol_inclusive
        )


class _CategoricalFamily(_base.ModelFamily):
    """Rank-2 parameterization: row i is the PMF of symbol i
    (internals.rs:398-522).  `perfect=False` rows use the lazy model."""

    def __init__(self, probabilities: np.ndarray, perfect: bool):
        probs = np.asarray(probabilities)
        if probs.dtype not in (np.float32, np.float64):
            raise TypeError("probabilities must have a float dtype")
        if probs.ndim != 2:
            raise ValueError(
                "To use a categorical distribution, provide a rank-2 numpy array."
            )
        self.probs = probs
        self.perfect = perfect
        self.size = probs.shape[0]

    def concrete(self, i: int) -> _base.EntropyModel:
        row = self.probs[i]
        try:
            if self.perfect:
                return _cat.ContiguousCategoricalEntropyModel.from_floating_point_probabilities_perfect(
                    row, PRECISION
                )
            return _cat.LazyContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
                row, PRECISION
            )
        except ValueError as e:
            raise ValueError(
                "Probability distribution not normalizable (the array of probabilities\n"
                "might be empty, contain negative values or NaNs, or sum to infinity)."
            ) from e


class Categorical(Model):
    """Categorical distribution (model.rs:455-559).

    - `Categorical(probs, perfect=..., lazy=...)`: concrete model over
      `{0, ..., len(probs)-1}`.
    - `Categorical(perfect=...)`: model family; pass a rank-2 probability
      array to the coder's encode/decode.
    """

    def __init__(self, probabilities=None, lazy: Optional[bool] = None, perfect: Optional[bool] = None):
        if lazy is None and perfect is None:
            if not _WARNED_CATEGORICAL[0]:
                _WARNED_CATEGORICAL[0] = True
                print(
                    "WARNING: Neither argument `perfect` nor `lazy` were specified for "
                    "`Categorical` entropy model.\n"
                    "         In this case, `perfect` currently defaults to `True` for backward "
                    "compatibility, but\n"
                    "         this default will change to `perfect=False` in constriction version 0.5.\n"
                    "         To suppress this warning, explicitly set:\n"
                    "         - `perfect=False`: recommended for most new use cases; or\n"
                    "         - `perfect=True`: if you need backward compatibility with "
                    "constriction <= 0.3.5."
                )
            lazy, perfect = False, True
        elif lazy and perfect:
            raise ValueError(
                "Both arguments `lazy` and `perfect` cannot be set to `True` at the same time.\n"
                "Lazy categorical entropy models cannot perfectly quantize probabilities."
            )
        else:
            lazy = bool(lazy) if lazy is not None else False
            perfect = bool(perfect) if perfect is not None else False

        self._perfect = perfect
        self._lazy = lazy
        self._inner: Optional[_base.EntropyModel] = None

        if probabilities is not None:
            probs = np.asarray(probabilities)
            if probs.dtype not in (np.float32, np.float64):
                probs = probs.astype(np.float64)
            if probs.ndim != 1:
                raise ValueError("probabilities must be a rank-1 array")
            try:
                if lazy:
                    self._inner = _cat.LazyContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
                        probs, PRECISION
                    )
                elif perfect:
                    self._inner = _cat.ContiguousCategoricalEntropyModel.from_floating_point_probabilities_perfect(
                        probs, PRECISION
                    )
                else:
                    self._inner = _cat.ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
                        probs, PRECISION
                    )
            except ValueError as e:
                raise ValueError(
                    "Probability distribution not normalizable (the array of probabilities\n"
                    "might be empty, contain negative values or NaNs, or sum to infinity)."
                ) from e

    def _as_parameterized(self) -> _base.EntropyModel:
        if self._inner is None:
            raise ValueError("No model parameters specified.")
        return self._inner

    def _parameterize(self, params: Tuple) -> _base.ModelFamily:
        if self._inner is not None:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        if len(params) != 1:
            raise ValueError(
                f"Wrong number of model parameters: expected 1, got {len(params)}."
            )
        return _CategoricalFamily(params[0], self._perfect)

    def _family_len(self, param0) -> int:
        if self._inner is not None:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        return np.asarray(param0).shape[0]


class Uniform(Model):
    """Uniform distribution over `{0, ..., size-1}` (model.rs:579-600)."""

    def __init__(self, size: Optional[int] = None):
        self._inner = _uni.UniformModel(int(size), PRECISION) if size is not None else None

    def _as_parameterized(self) -> _base.EntropyModel:
        if self._inner is None:
            raise ValueError("No model parameters specified.")
        return self._inner

    def _parameterize(self, params: Tuple) -> _base.ModelFamily:
        if self._inner is not None:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        if len(params) != 1:
            raise ValueError(
                f"Wrong number of model parameters: expected 1, got {len(params)}."
            )
        sizes = _cast_i32_param(params[0], "size")
        return _GenericFamily(len(sizes), lambda i: _uni.UniformModel(int(sizes[i]), PRECISION))

    def _family_len(self, param0) -> int:
        if self._inner is not None:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        return len(np.asarray(param0))


class _QuantizedModelBase(Model):
    """Common logic for QuantizedGaussian/Laplace/Cauchy (model.rs:645-900):
    all four partial-parameterization combinations are supported."""

    _kind: str = ""
    _param_names = ("mean", "scale")

    def __init__(self, min_symbol_inclusive, max_symbol_inclusive, a=None, b=None):
        self._min = int(min_symbol_inclusive)
        self._max = int(max_symbol_inclusive)
        # Validate the support eagerly (like LeakyQuantizer::new).
        _quant.LeakyQuantizer(self._min, self._max, PRECISION)
        self._a = None if a is None else float(a)
        self._b = None if b is None else float(b)

    def _make_concrete(self, a: float, b: float) -> _base.EntropyModel:
        fam = _quant._DIST_BY_KIND[self._kind][0]
        return _quant.LeakyQuantizer(self._min, self._max, PRECISION).quantize(fam(a, b))

    def _as_parameterized(self) -> _base.EntropyModel:
        if self._a is None or self._b is None:
            raise ValueError("No model parameters specified.")
        return self._make_concrete(self._a, self._b)

    def _parameterize(self, params: Tuple) -> _base.ModelFamily:
        expected = (self._a is None) + (self._b is None)
        if expected == 0:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        if len(params) != expected:
            raise ValueError(
                f"Wrong number of model parameters: expected {expected}, got {len(params)}."
            )
        arrays = [_cast_float_param(p) for p in params]
        if len({len(x) for x in arrays}) != 1:
            raise ValueError("Model parameters have unequal shape")
        n = len(arrays[0])
        if self._a is None and self._b is None:
            a_arr, b_arr = arrays
        elif self._a is None:
            a_arr, b_arr = arrays[0], np.full(n, self._b, dtype=np.float64)
        else:
            a_arr, b_arr = np.full(n, self._a, dtype=np.float64), arrays[0]
        return _quant.QuantizedFamily(self._kind, self._min, self._max, a_arr, b_arr, PRECISION)

    def _family_len(self, param0) -> int:
        if self._a is not None and self._b is not None:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        return len(np.asarray(param0))


class QuantizedGaussian(_QuantizedModelBase):
    """Gaussian quantized over bins of size 1 centered at integers
    (model.rs:645-735)."""

    _kind = "gaussian"

    def __init__(self, min_symbol_inclusive, max_symbol_inclusive, mean=None, std=None):
        super().__init__(min_symbol_inclusive, max_symbol_inclusive, mean, std)


class QuantizedLaplace(_QuantizedModelBase):
    """Laplace quantized over bins of size 1 (model.rs:736-801)."""

    _kind = "laplace"

    def __init__(self, min_symbol_inclusive, max_symbol_inclusive, mean=None, scale=None):
        super().__init__(min_symbol_inclusive, max_symbol_inclusive, mean, scale)


class QuantizedCauchy(_QuantizedModelBase):
    """Cauchy quantized over bins of size 1 (model.rs:836-900)."""

    _kind = "cauchy"

    def __init__(self, min_symbol_inclusive, max_symbol_inclusive, loc=None, scale=None):
        super().__init__(min_symbol_inclusive, max_symbol_inclusive, loc, scale)


class Binomial(Model):
    """Binomial distribution with support `{0, ..., n}` (model.rs:923-966)."""

    def __init__(self, n: Optional[int] = None, p: Optional[float] = None):
        self._n = None if n is None else int(n)
        self._p = None if p is None else float(p)

    def _as_parameterized(self) -> _base.EntropyModel:
        if self._n is None or self._p is None:
            raise ValueError("No model parameters specified.")
        quantizer = _quant.LeakyQuantizer(0, self._n, PRECISION)
        return quantizer.quantize(_quant.Binomial(self._n, self._p))

    def _parameterize(self, params: Tuple) -> _base.ModelFamily:
        if self._n is None and self._p is None:
            if len(params) != 2:
                raise ValueError(
                    f"Wrong number of model parameters: expected 2, got {len(params)}."
                )
            ns = _cast_i32_param(params[0], "n")
            ps = _cast_float_param(params[1], "p")
            if len(ns) != len(ps):
                raise ValueError("Model parameters have unequal shape")
            return _quant.BinomialFamily(ns, ps, PRECISION)
        if self._n is not None and self._p is None:
            if len(params) != 1:
                raise ValueError(
                    f"Wrong number of model parameters: expected 1, got {len(params)}."
                )
            ps = _cast_float_param(params[0], "p")
            ns = np.full(len(ps), self._n, dtype=np.int64)
            return _quant.BinomialFamily(ns, ps, PRECISION)
        if self._n is None:
            if len(params) != 1:
                raise ValueError(
                    f"Wrong number of model parameters: expected 1, got {len(params)}."
                )
            ns = _cast_i32_param(params[0], "n")
            ps = np.full(len(ns), self._p, dtype=np.float64)
            return _quant.BinomialFamily(ns, ps, PRECISION)
        raise ValueError(
            "Model parameters were specified but the model is already fully parameterized."
        )

    def _family_len(self, param0) -> int:
        if self._n is not None and self._p is not None:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        return len(np.asarray(param0))


class Bernoulli(Model):
    """Bernoulli distribution over {0, 1} (model.rs:983-1055)."""

    def __init__(self, p: Optional[float] = None, perfect: Optional[bool] = None):
        if perfect is None and not _WARNED_BERNOULLI[0]:
            _WARNED_BERNOULLI[0] = True
            print(
                "WARNING: Argument `perfect` was not specified for `Bernoulli` distribution.\n"
                "         It currently defaults to `perfect=True` for backward compatibility, "
                "but this default\n"
                "         will change to `perfect=False` in constriction version 0.5. To "
                "suppress this warning,\n"
                "         explicitly set `perfect=False` (recommended for most new use cases) "
                "or explicitly set\n"
                "         `perfect=True` (if you need backward compatibility with "
                "constriction <= 0.3.5)."
            )
        self._perfect = True if perfect is None else bool(perfect)
        self._p = None if p is None else float(p)
        if self._p is not None:
            self._inner = self._build(self._p)
        else:
            self._inner = None

    def _build(self, p: float) -> _base.EntropyModel:
        try:
            if self._perfect:
                return _cat.ContiguousCategoricalEntropyModel.from_floating_point_probabilities_perfect(
                    np.array([1.0 - p, p], dtype=np.float64), PRECISION
                )
            return _cat.ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
                np.array([1.0 - p, p], dtype=np.float64), PRECISION
            )
        except ValueError as e:
            raise ValueError("`p` must be >= 0.0 and <= 1.0.") from e

    def _as_parameterized(self) -> _base.EntropyModel:
        if self._inner is None:
            raise ValueError("No model parameters specified.")
        return self._inner

    def _parameterize(self, params: Tuple) -> _base.ModelFamily:
        if self._inner is not None:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        if len(params) != 1:
            raise ValueError(
                f"Wrong number of model parameters: expected 1, got {len(params)}."
            )
        ps = _cast_float_param(params[0], "p")
        return _GenericFamily(len(ps), lambda i: self._build(float(ps[i])))

    def _family_len(self, param0) -> int:
        if self._inner is not None:
            raise ValueError(
                "Model parameters were specified but the model is already fully parameterized."
            )
        return len(np.asarray(param0))


__all__ = [
    "Model",
    "CustomModel",
    "ScipyModel",
    "Categorical",
    "Uniform",
    "QuantizedGaussian",
    "QuantizedLaplace",
    "QuantizedCauchy",
    "Binomial",
    "Bernoulli",
]
