"""Closed-form uniform entropy model (the reference's src/stream/model/uniform.rs).

``prob_per_bin = floor(2**P / range)``; the last bin absorbs the remainder
``2**P - (range - 1) * prob_per_bin`` (uniform.rs:53-75, 91-112).

JAX counterpart: ``constriction_tpu/models/uniform.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .base import EntropyModel, ImpossibleSymbol


class UniformModel(EntropyModel):
    def __init__(self, size: int, precision: int = 24):
        if size <= 1:
            raise ValueError("UniformModel requires range > 1")
        if size - 1 > (1 << precision) - 1:
            raise ValueError("range too large for precision")
        self.size = int(size)
        self.precision = precision
        self.last_symbol = self.size - 1
        self.probability_per_bin = (1 << precision) // self.size
        assert self.probability_per_bin > 0

    def ecp(self, symbol: int) -> Tuple[int, int]:
        if symbol < 0 or symbol > self.last_symbol:
            raise ImpossibleSymbol(symbol)
        left = symbol * self.probability_per_bin
        if symbol < self.last_symbol:
            return left, self.probability_per_bin
        return left, (1 << self.precision) - left

    def ecp_array(self, symbols: np.ndarray):
        symbols = np.asarray(symbols)
        if np.any((symbols < 0) | (symbols > self.last_symbol)):
            bad = symbols[(symbols < 0) | (symbols > self.last_symbol)][0]
            raise ImpossibleSymbol(int(bad))
        left = symbols.astype(np.uint64) * np.uint64(self.probability_per_bin)
        prob = np.where(
            symbols < self.last_symbol,
            np.uint64(self.probability_per_bin),
            np.uint64((1 << self.precision)) - left,
        )
        return left, prob

    def qf(self, quantile: int) -> Tuple[int, int, int]:
        guess = quantile // self.probability_per_bin
        remainder = quantile % self.probability_per_bin
        if guess < self.last_symbol:
            return guess, quantile - remainder, self.probability_per_bin
        left = self.last_symbol * self.probability_per_bin
        return self.last_symbol, left, (1 << self.precision) - left

    def symbol_table(self):
        for s in range(self.size):
            left, prob = self.ecp(s)
            yield s, left, prob
