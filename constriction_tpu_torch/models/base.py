"""Base protocol for exactly-invertible fixed-point entropy models.

A model at fixed-point precision ``P`` assigns every symbol in its support a
half-open quantile interval ``[left, left + prob)`` of ``[0, 2**P)`` such that
the intervals tile ``[0, 2**P)`` exactly and every in-support symbol has
``prob >= 1`` ("leaky").  Encoders consume ``(left, prob)``; decoders invert a
quantile back to ``(symbol, left, prob)``.

This mirrors the reference's EntropyModel/EncoderModel/DecoderModel trait
contract (its src/stream/model.rs:212-465) in array-friendly form:
in addition to the scalar hooks, models may override the vectorized hooks used
by the numpy and host-codec bulk paths.

JAX counterpart: ``constriction_tpu/models/base.py``.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, Tuple

import numpy as np


class ImpossibleSymbol(ValueError, KeyError):
    # the reference maps EncoderFrontendError::ImpossibleSymbol to KeyError
    # (pybindings/stream/mod.rs:82-86); ValueError kept for backward
    # compatibility with earlier releases of this package
    """Raised when trying to encode a symbol with zero probability."""


class EntropyModel:
    """Base class; precision is in bits (default preset: 24)."""

    precision: int = 24

    # -- scalar hooks (must be implemented) ---------------------------------

    def ecp(self, symbol: int) -> Tuple[int, int]:
        """Return ``(left_cumulative, probability)`` for `symbol`.

        Raises :class:`ImpossibleSymbol` if the symbol has zero probability.
        """
        raise NotImplementedError

    def qf(self, quantile: int) -> Tuple[int, int, int]:
        """Quantile function: return ``(symbol, left_cumulative, probability)``
        for the unique symbol with ``left <= quantile < left + prob``."""
        raise NotImplementedError

    # -- vectorized hooks (optional; default loops over the scalar hooks) ---

    def ecp_array(self, symbols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        cums = np.empty(len(symbols), dtype=np.uint64)
        probs = np.empty(len(symbols), dtype=np.uint64)
        for i, s in enumerate(symbols):
            c, p = self.ecp(int(s))
            cums[i] = c
            probs[i] = p
        return cums, probs

    # -- iteration / diagnostics --------------------------------------------

    def symbol_table(self) -> Iterator[Tuple[int, int, int]]:
        """Yield ``(symbol, left_cumulative, probability)`` over the support
        in order of increasing left cumulative.  Only available for iterable
        models (cf. IterableEntropyModel, model.rs:486-821)."""
        raise NotImplementedError

    def _float_probabilities(self) -> Iterable[Tuple[int, float]]:
        total = float(1 << self.precision)
        for symbol, _, prob in self.symbol_table():
            yield symbol, prob / total

    def entropy_base2(self) -> float:
        """Shannon entropy (base 2) of the fixed-point model (model.rs:561)."""
        acc = 0.0
        for _, p in self._float_probabilities():
            if p > 0.0:
                acc -= p * math.log2(p)
        return acc

    def cross_entropy_base2(self, p_iter: Iterable[float]) -> float:
        """Cross entropy H(p, model) where `p_iter` gives the true probability
        of each symbol in support order (model.rs:624-668)."""
        acc = 0.0
        for (_, q), p in zip(self._float_probabilities(), p_iter):
            if p > 0.0:
                acc -= p * math.log2(q)
        return acc

    def kl_divergence_base2(self, p_iter: Iterable[float]) -> float:
        """KL(p || model), base 2 (model.rs:683-719)."""
        acc = 0.0
        for (_, q), p in zip(self._float_probabilities(), p_iter):
            if p > 0.0:
                acc += p * (math.log2(p) - math.log2(q))
        return acc

    def reverse_cross_entropy_base2(self, p_iter: Iterable[float]) -> float:
        """Cross entropy H(model, p) (model.rs:670-681)."""
        acc = 0.0
        for (_, q), p in zip(self._float_probabilities(), p_iter):
            # leaky models always have q > 0; f64 log2 semantics for p:
            # log2(0) = -inf (=> +inf cross entropy), log2(<0) = NaN
            lp = (math.log2(p) if p > 0.0
                  else (-math.inf if p == 0.0 else math.nan))
            acc -= q * lp
        return acc

    def reverse_kl_divergence_base2(self, p_iter: Iterable[float]) -> float:
        """KL(model || p), base 2 (model.rs:721-745)."""
        acc = 0.0
        for (_, q), p in zip(self._float_probabilities(), p_iter):
            lp = (math.log2(p) if p > 0.0
                  else (-math.inf if p == 0.0 else math.nan))
            acc += q * (math.log2(q) - lp)
        return acc

    # -- conversions (model.rs:747-820) --------------------------------------

    def to_generic_encoder_model(self):
        from .categorical import NonContiguousCategoricalEncoderModel

        return NonContiguousCategoricalEncoderModel.from_symbol_table(
            self.symbol_table(), self.precision
        )

    def to_generic_decoder_model(self):
        from .categorical import NonContiguousCategoricalDecoderModel

        return NonContiguousCategoricalDecoderModel.from_symbol_table(
            self.symbol_table(), self.precision
        )

    def to_generic_lookup_decoder_model(self):
        from .categorical import NonContiguousLookupDecoderModel

        return NonContiguousLookupDecoderModel.from_symbol_table(
            self.symbol_table(), self.precision
        )


class ModelFamily:
    """A family of models parameterized per symbol (e.g. per-symbol mean/std).

    `concrete(i)` returns the :class:`EntropyModel` for position `i`; `size`
    is the number of parameter sets.  Families may expose vectorized encode
    tables via `ecp_all(symbols)`.
    """

    size: int

    def concrete(self, i: int) -> EntropyModel:
        raise NotImplementedError

    def ecp_all(self, symbols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        cums = np.empty(len(symbols), dtype=np.uint64)
        probs = np.empty(len(symbols), dtype=np.uint64)
        for i, s in enumerate(symbols):
            c, p = self.concrete(i).ecp(int(s))
            cums[i] = c
            probs[i] = p
        return cums, probs
