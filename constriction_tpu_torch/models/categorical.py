"""Categorical entropy models: fast / perfect / lazy / non-contiguous / lookup.

Quantization kernels reproduce the reference exactly:

- ``fast_quantized_cdf`` (the reference's src/stream/model/categorical.rs:16-54):
  ``free = 2**P - n``, ``scale = F(free) / sum(probs)`` computed in the input
  float dtype F (f32 or f64) with *sequential* accumulation, and
  ``left_k = trunc(cumsum_{<k} * scale) + k`` with a final entry ``2**P``.

- ``perfectly_quantized_probabilities``
  (the reference's src/stream/model/categorical.rs:56-177): weights
  initialized proportionally, leftover budget distributed to max-win slots via
  a reproducible stable sort, then a buyer/seller exchange minimizing cross
  entropy with ``log1p`` win/loss and monotone locking.  Tie-breaking follows
  Rust's ``Iterator::max_by`` (last maximal element) and ``min_by`` (first
  minimal element).

- The lazy model (the reference's src/stream/model/categorical/lazy_contiguous.rs)
  stores the float PMF + scale and quantizes per call; it is bitstream-
  compatible with the eager "fast" variant because it performs the identical
  float operations.

JAX counterpart: ``constriction_tpu/models/categorical.py``. ``fast_quantized_cdf`` here is
the one copy of the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .base import EntropyModel, ImpossibleSymbol


def _sequential_cumsum(probs: np.ndarray) -> np.ndarray:
    """Sequential (left-to-right) cumulative sum in the array's own dtype.

    ``np.add.accumulate`` is a plain sequential loop, matching Rust's
    ``Iterator::sum``/running accumulation semantics (unlike ``np.sum``'s
    pairwise reduction for floats).
    """
    return np.add.accumulate(probs, dtype=probs.dtype)


def _trunc_to_u64(x: np.ndarray) -> np.ndarray:
    """Truncating float -> u64 cast with Rust `as` semantics (saturating,
    NaN -> 0), like models/quantized._trunc_to_uint: a negative partial
    cumsum (legal input with a negative probability entry) must clamp to 0,
    not wrap (categorical/contiguous.rs uses `as` casts throughout)."""
    with np.errstate(invalid="ignore"):
        clipped = np.where(np.isnan(x), 0.0, np.clip(x, 0.0, float(2**64 - 1)))
    return np.trunc(clipped).astype(np.uint64)


def fast_quantized_cdf(
    probabilities: np.ndarray,
    precision: int,
    normalization: Optional[float] = None,
) -> np.ndarray:
    """Return the length-(n+1) fixed-point CDF (uint64), last entry ``2**P``."""
    probs = np.asarray(probabilities)
    if probs.dtype not in (np.float32, np.float64):
        probs = probs.astype(np.float64)
    n = len(probs)
    if n < 2 or n >= (1 << precision) - 1:
        raise ValueError("invalid number of probabilities")

    free_weight = (1 << precision) - n
    cumsum = _sequential_cumsum(probs)
    norm = probs.dtype.type(normalization) if normalization is not None else cumsum[-1]
    normf = float(norm)
    if not (math.isfinite(normf) and normf > 0.0) or _is_subnormal(norm):
        raise ValueError(
            "Probability distribution not normalizable (the array of probabilities\n"
            "might be empty, contain negative values or NaNs, or sum to infinity)."
        )
    scale = probs.dtype.type(free_weight) / norm

    cumulative = np.concatenate([np.zeros(1, dtype=probs.dtype), cumsum[:-1]])
    left = _trunc_to_u64(cumulative * scale) + np.arange(n, dtype=np.uint64)
    cdf = np.empty(n + 1, dtype=np.uint64)
    cdf[:n] = left
    cdf[n] = 1 << precision
    if np.any(np.diff(cdf.astype(np.int64)) <= 0):
        raise ValueError(
            "Probability distribution not normalizable (the array of probabilities\n"
            "might be empty, contain negative values or NaNs, or sum to infinity)."
        )
    return cdf


def _is_subnormal(x) -> bool:
    xf = float(x)
    if xf == 0.0 or not math.isfinite(xf):
        return True  # zero/inf/nan are "not normal" in Rust's sense
    dt = np.asarray(x).dtype
    tiny = np.finfo(dt).tiny
    return abs(np.asarray(x, dtype=dt)) < tiny


def perfectly_quantized_probabilities(
    probabilities: np.ndarray, precision: int
) -> np.ndarray:
    """Return KL-optimal integer weights summing to exactly ``2**P``."""
    probs_in = np.asarray(probabilities)
    n = len(probs_in)
    if n < 2:
        raise ValueError("need at least two probabilities")
    probs = probs_in.astype(np.float64)
    if n > (1 << precision):
        # the fast path rejects this up front; the reference's wrapping
        # arithmetic would distribute a wrapped-huge free weight (garbage)
        raise ValueError("invalid number of probabilities")

    remaining = (1 << precision) - n
    # the reference widens each element to f64 BEFORE the sequential sum
    # (categorical.rs:79 `x.into()`), so f32 inputs normalize in f64 here
    norm = float(_sequential_cumsum(probs)[-1])
    if not (math.isfinite(norm) and norm > 0.0) or _is_subnormal(
        np.asarray(norm)
    ):
        raise ValueError(
            "Probability distribution not normalizable (the array of probabilities\n"
            "might be empty, contain negative values or NaNs, or sum to infinity)."
        )
    scale = float(remaining) / norm

    weights = np.empty(n, dtype=np.int64)
    wins = np.empty(n, dtype=np.float64)
    losses = np.empty(n, dtype=np.float64)
    probs64 = np.empty(n, dtype=np.float64)

    for i in range(n):
        p = float(probs[i])
        if p < 0.0 or math.isnan(p):
            raise ValueError("negative or NaN probability")
        current = int(p * scale)  # truncating f64 -> uint cast
        remaining -= current
        w = current + 1
        weights[i] = w
        probs64[i] = p
        wins[i] = p * math.log1p(1.0 / w)
        losses[i] = math.inf if w == 1 else -p * math.log1p(-1.0 / w)

    # Distribute remaining weight evenly among symbols with highest wins
    # (stable descending sort by win; categorical.rs:118-129).
    order = list(range(n))
    while remaining != 0:
        order.sort(key=lambda i: wins[i], reverse=True)  # stable, like Rust sort_by
        batch = min(remaining, n)
        for i in order[:batch]:
            w = weights[i] + 1
            weights[i] = w
            wins[i] = probs64[i] * math.log1p(1.0 / w)
            losses[i] = -probs64[i] * math.log1p(-1.0 / w)
        remaining -= batch

    # Buyer/seller exchange (categorical.rs:131-173).  Rust iterates the
    # `slots` VEC, whose order is the last stable win-sort from the
    # distribution phase above (original order if it never ran) -- NOT
    # original-index order; `order` still holds exactly that permutation.
    ordv = np.asarray(order)
    while True:
        wo = wins[ordv]
        lo = losses[ordv]
        # Rust `max_by` returns the LAST maximal element in vec order:
        buyer = int(ordv[np.where(wo == wo.max())[0][-1]])
        buyer_win = wins[buyer]
        # Rust `min_by` returns the FIRST minimal element in vec order:
        seller = int(ordv[int(np.argmin(lo))])
        if buyer == seller:
            break
        if buyer_win <= losses[seller]:
            break
        w = weights[seller] - 1
        weights[seller] = w
        wins[seller] = -math.inf
        losses[seller] = math.inf if w == 1 else -probs64[seller] * math.log1p(-1.0 / w)

        w = weights[buyer] + 1
        weights[buyer] = w
        losses[buyer] = math.inf
        wins[buyer] = probs64[buyer] * math.log1p(1.0 / w)

    return weights.astype(np.uint64)


# ---------------------------------------------------------------------------
# Contiguous categorical (eager)
# ---------------------------------------------------------------------------


class ContiguousCategoricalEntropyModel(EntropyModel):
    """Explicit CDF table over symbols ``0..n``
    (the reference's src/stream/model/categorical/contiguous.rs)."""

    def __init__(self, cdf: np.ndarray, precision: int = 24):
        self.cdf = np.asarray(cdf, dtype=np.uint64)
        self.precision = precision

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_floating_point_probabilities_fast(
        cls, probabilities, precision: int = 24, normalization=None
    ) -> "ContiguousCategoricalEntropyModel":
        return cls(fast_quantized_cdf(np.asarray(probabilities), precision, normalization), precision)

    @classmethod
    def from_floating_point_probabilities_perfect(
        cls, probabilities, precision: int = 24
    ) -> "ContiguousCategoricalEntropyModel":
        weights = perfectly_quantized_probabilities(np.asarray(probabilities), precision)
        cdf = np.zeros(len(weights) + 1, dtype=np.uint64)
        np.cumsum(weights, out=cdf[1:])
        return cls(cdf, precision)

    @classmethod
    def from_nonzero_fixed_point_probabilities(
        cls, probabilities, precision: int = 24, infer_last_probability: bool = False
    ) -> "ContiguousCategoricalEntropyModel":
        probs = np.asarray(probabilities, dtype=np.uint64)
        total = 1 << precision
        acc = int(np.sum(probs))
        if np.any(probs == 0):
            raise ValueError("all probabilities must be nonzero")
        if infer_last_probability:
            if acc >= total:
                raise ValueError("probabilities exceed 2**precision")
            probs = np.concatenate([probs, np.array([total - acc], dtype=np.uint64)])
        elif acc != total:
            raise ValueError("probabilities must sum to exactly 2**precision")
        cdf = np.zeros(len(probs) + 1, dtype=np.uint64)
        np.cumsum(probs, out=cdf[1:])
        return cls(cdf, precision)

    # -- model interface -------------------------------------------------------

    @property
    def num_symbols(self) -> int:
        return len(self.cdf) - 1

    def ecp(self, symbol: int) -> Tuple[int, int]:
        if not 0 <= symbol < self.num_symbols:
            raise ImpossibleSymbol(symbol)
        left = int(self.cdf[symbol])
        prob = int(self.cdf[symbol + 1]) - left
        if prob == 0:
            raise ImpossibleSymbol(symbol)
        return left, prob

    def ecp_array(self, symbols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        symbols = np.asarray(symbols)
        if np.any((symbols < 0) | (symbols >= self.num_symbols)):
            bad = symbols[(symbols < 0) | (symbols >= self.num_symbols)][0]
            raise ImpossibleSymbol(int(bad))
        left = self.cdf[symbols]
        prob = self.cdf[symbols.astype(np.int64) + 1] - left
        if np.any(prob == 0):
            raise ImpossibleSymbol(int(symbols[prob == 0][0]))
        return left, prob

    def qf(self, quantile: int) -> Tuple[int, int, int]:
        s = int(np.searchsorted(self.cdf, quantile, side="right")) - 1
        return s, int(self.cdf[s]), int(self.cdf[s + 1] - self.cdf[s])

    def qf_array(self, quantiles: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        s = np.searchsorted(self.cdf, quantiles, side="right") - 1
        return s, self.cdf[s], self.cdf[s + 1] - self.cdf[s]

    def symbol_table(self):
        for s in range(self.num_symbols):
            yield s, int(self.cdf[s]), int(self.cdf[s + 1] - self.cdf[s])

    def to_lookup_decoder_model(self) -> "ContiguousLookupDecoderModel":
        return ContiguousLookupDecoderModel(self.cdf, self.precision)


# ---------------------------------------------------------------------------
# Lazy contiguous categorical
# ---------------------------------------------------------------------------


class LazyContiguousCategoricalEntropyModel(EntropyModel):
    """Stores the float PMF + scale; quantizes per call (lazy_contiguous.rs).

    Bitstream-compatible with the eager "fast" variant.
    """

    def __init__(self, pmf: np.ndarray, scale, precision: int = 24):
        self.pmf = pmf
        self.scale = scale
        self.precision = precision
        self._cumsum = None  # lazily computed sequential cumsum (same values)
        self._b = None  # cached boundary array (the model is immutable)

    @classmethod
    def from_floating_point_probabilities_fast(
        cls, probabilities, precision: int = 24, normalization=None
    ) -> "LazyContiguousCategoricalEntropyModel":
        probs = np.asarray(probabilities)
        if probs.dtype not in (np.float32, np.float64):
            probs = probs.astype(np.float64)
        n = len(probs)
        if n < 2 or n >= (1 << precision) - 1:
            raise ValueError("invalid number of probabilities")
        free_weight = (1 << precision) - n
        if normalization is None:
            norm = _sequential_cumsum(probs)[-1]
        else:
            norm = probs.dtype.type(normalization)
        normf = float(norm)
        if not (math.isfinite(normf) and normf > 0.0) or _is_subnormal(norm):
            raise ValueError(
                "Probability distribution not normalizable (the array of probabilities\n"
                "might be empty, contain negative values or NaNs, or sum to infinity)."
            )
        scale = probs.dtype.type(free_weight) / norm
        return cls(probs, scale, precision)

    @property
    def num_symbols(self) -> int:
        return len(self.pmf)

    def _boundaries(self) -> np.ndarray:
        """Exact fixed-point left boundaries b(0..n), b(n) = 2**P; computed
        once and cached (the model is immutable), with the reference's
        saturating `as` cast semantics (lazy_contiguous.rs:240)."""
        if self._b is None:
            if self._cumsum is None:
                self._cumsum = _sequential_cumsum(self.pmf)
            n = len(self.pmf)
            cumulative = np.concatenate(
                [np.zeros(1, dtype=self.pmf.dtype), self._cumsum[:-1]]
            )
            left = _trunc_to_u64(cumulative * self.scale) + np.arange(
                n, dtype=np.uint64
            )
            b = np.empty(n + 1, dtype=np.uint64)
            b[:n] = left
            b[n] = 1 << self.precision
            self._b = b
        return self._b

    def ecp(self, symbol: int) -> Tuple[int, int]:
        n = len(self.pmf)
        if not 0 <= symbol < n:
            raise ImpossibleSymbol(symbol)
        b = self._boundaries()
        left = int(b[symbol])
        prob = int(b[symbol + 1]) - left
        if prob <= 0:
            raise ValueError("leakiness should guarantee nonzero probabilities.")
        return left, prob

    def ecp_array(self, symbols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        b = self._boundaries()
        symbols = np.asarray(symbols)
        if np.any((symbols < 0) | (symbols >= len(self.pmf))):
            bad = symbols[(symbols < 0) | (symbols >= len(self.pmf))][0]
            raise ImpossibleSymbol(int(bad))
        left = b[symbols]
        prob = b[symbols.astype(np.int64) + 1] - left
        if np.any(prob.astype(np.int64) <= 0):
            raise ValueError("leakiness should guarantee nonzero probabilities.")
        return left, prob

    def qf(self, quantile: int) -> Tuple[int, int, int]:
        b = self._boundaries()
        s = int(np.searchsorted(b, quantile, side="right")) - 1
        return s, int(b[s]), int(b[s + 1] - b[s])

    def symbol_table(self):
        b = self._boundaries()
        for s in range(len(self.pmf)):
            yield s, int(b[s]), int(b[s + 1] - b[s])


# ---------------------------------------------------------------------------
# Non-contiguous categorical (arbitrary symbol alphabets)
# ---------------------------------------------------------------------------


class NonContiguousCategoricalEncoderModel(EntropyModel):
    """Hash-map from symbol to (cum, prob) (non_contiguous.rs:782-788)."""

    def __init__(self, table: Dict[int, Tuple[int, int]], precision: int = 24):
        self.table = table
        self.precision = precision

    @classmethod
    def from_symbols_and_nonzero_fixed_point_probabilities(
        cls, symbols, probabilities, precision: int = 24, infer_last_probability: bool = False
    ):
        symbols = list(symbols)
        probs = np.asarray(probabilities, dtype=np.uint64)
        total = 1 << precision
        acc = int(np.sum(probs))
        if np.any(probs == 0):
            raise ValueError("all probabilities must be nonzero")
        if infer_last_probability:
            if acc >= total:
                raise ValueError("probabilities exceed 2**precision")
            probs = np.concatenate([probs, np.array([total - acc], dtype=np.uint64)])
        elif acc != total:
            raise ValueError("probabilities must sum to exactly 2**precision")
        if len(symbols) != len(probs):
            raise ValueError("symbols and probabilities must have equal length")
        table = {}
        cum = 0
        for s, p in zip(symbols, probs):
            key = int(s)
            if key in table:
                # the reference rejects duplicate ENCODER symbols
                # (non_contiguous.rs:946, Occupied -> Err)
                raise ValueError(f"duplicate symbol {key}")
            table[key] = (cum, int(p))
            cum += int(p)
        return cls(table, precision)

    @classmethod
    def from_symbols_and_floating_point_probabilities_fast(
        cls, symbols, probabilities, precision: int = 24, normalization=None
    ):
        cdf = fast_quantized_cdf(np.asarray(probabilities), precision, normalization)
        table = {
            int(s): (int(cdf[i]), int(cdf[i + 1] - cdf[i]))
            for i, s in enumerate(symbols)
        }
        return cls(table, precision)

    @classmethod
    def from_symbols_and_floating_point_probabilities_perfect(
        cls, symbols, probabilities, precision: int = 24
    ):
        weights = perfectly_quantized_probabilities(np.asarray(probabilities), precision)
        table = {}
        cum = 0
        for s, w in zip(symbols, weights):
            table[int(s)] = (cum, int(w))
            cum += int(w)
        return cls(table, precision)

    @classmethod
    def from_symbol_table(cls, symbol_table, precision: int = 24):
        return cls({s: (c, p) for s, c, p in symbol_table}, precision)

    def ecp(self, symbol: int) -> Tuple[int, int]:
        try:
            return self.table[int(symbol)]
        except KeyError:
            raise ImpossibleSymbol(symbol) from None

    @property
    def num_symbols(self) -> int:
        return len(self.table)


class NonContiguousCategoricalDecoderModel(EntropyModel):
    """CDF + symbol arrays with binary-search decode (non_contiguous.rs)."""

    def __init__(self, cdf: np.ndarray, symbols: Sequence[int], precision: int = 24):
        self.cdf = np.asarray(cdf, dtype=np.uint64)  # length n+1
        self.symbols = list(symbols)
        self.precision = precision

    @classmethod
    def from_symbols_and_nonzero_fixed_point_probabilities(
        cls, symbols, probabilities, precision: int = 24, infer_last_probability: bool = False
    ):
        # Order-preserving Vec semantics (non_contiguous.rs decoder): the
        # reference's DECODER supports duplicate symbols, so do NOT route
        # through the encoder dict (which rejects them).
        symbols = list(symbols)
        probs = np.asarray(probabilities, dtype=np.uint64)
        total = 1 << precision
        if np.any(probs == 0):
            raise ValueError("all probabilities must be nonzero")
        acc = int(np.sum(probs))
        if infer_last_probability:
            if acc >= total:
                raise ValueError("probabilities exceed 2**precision")
            probs = np.concatenate(
                [probs, np.array([total - acc], dtype=np.uint64)]
            )
        elif acc != total:
            raise ValueError("probabilities must sum to exactly 2**precision")
        if len(symbols) != len(probs):
            raise ValueError("symbols and probabilities must have equal length")
        cdf = np.zeros(len(probs) + 1, dtype=np.uint64)
        cdf[1:] = np.cumsum(probs)
        return cls(cdf, symbols, precision)

    @classmethod
    def from_symbols_and_floating_point_probabilities_fast(
        cls, symbols, probabilities, precision: int = 24, normalization=None
    ):
        cdf = fast_quantized_cdf(np.asarray(probabilities), precision, normalization)
        return cls(cdf, list(symbols), precision)

    @classmethod
    def from_symbols_and_floating_point_probabilities_perfect(
        cls, symbols, probabilities, precision: int = 24
    ):
        weights = perfectly_quantized_probabilities(np.asarray(probabilities), precision)
        cdf = np.zeros(len(weights) + 1, dtype=np.uint64)
        np.cumsum(weights, out=cdf[1:])
        return cls(cdf, list(symbols), precision)

    @classmethod
    def from_symbol_table(cls, symbol_table, precision: int = 24):
        symbols = []
        cums = []
        last_right = 0
        for s, c, p in symbol_table:
            symbols.append(s)
            cums.append(c)
            last_right = c + p
        cdf = np.array(cums + [last_right], dtype=np.uint64)
        return cls(cdf, symbols, precision)

    def ecp(self, symbol: int) -> Tuple[int, int]:
        # O(n); the encoder model is the right tool for encoding.
        for i, s in enumerate(self.symbols):
            if s == symbol:
                return int(self.cdf[i]), int(self.cdf[i + 1] - self.cdf[i])
        raise ImpossibleSymbol(symbol)

    def qf(self, quantile: int) -> Tuple[int, int, int]:
        i = int(np.searchsorted(self.cdf, quantile, side="right")) - 1
        return self.symbols[i], int(self.cdf[i]), int(self.cdf[i + 1] - self.cdf[i])

    def symbol_table(self):
        for i, s in enumerate(self.symbols):
            yield s, int(self.cdf[i]), int(self.cdf[i + 1] - self.cdf[i])


# ---------------------------------------------------------------------------
# Lookup decoder models (O(1) decode; lookup_contiguous.rs / lookup_noncontiguous.rs)
# ---------------------------------------------------------------------------


class ContiguousLookupDecoderModel(EntropyModel):
    """O(1) decode via a full quantile -> symbol lookup table.

    The table has ``2**P`` entries (8 KiB at the "small" preset u16/P=12 --
    lookup_contiguous.rs:177-186).
    """

    def __init__(self, cdf: np.ndarray, precision: int = 12):
        self.cdf = np.asarray(cdf, dtype=np.uint64)
        self.precision = precision
        counts = np.diff(self.cdf.astype(np.int64))
        if int(self.cdf[-1]) != 1 << precision or np.any(counts <= 0):
            raise ValueError("invalid CDF for lookup model")
        n = len(self.cdf) - 1
        dtype = np.uint16 if n <= 0xFFFF else np.uint32
        self.lookup = np.repeat(np.arange(n, dtype=dtype), counts)

    @classmethod
    def from_floating_point_probabilities_fast(cls, probabilities, precision: int = 12):
        return cls(fast_quantized_cdf(np.asarray(probabilities), precision), precision)

    @classmethod
    def from_floating_point_probabilities_perfect(cls, probabilities, precision: int = 12):
        weights = perfectly_quantized_probabilities(np.asarray(probabilities), precision)
        cdf = np.zeros(len(weights) + 1, dtype=np.uint64)
        np.cumsum(weights, out=cdf[1:])
        return cls(cdf, precision)

    def ecp(self, symbol: int) -> Tuple[int, int]:
        if not 0 <= symbol < len(self.cdf) - 1:
            raise ImpossibleSymbol(symbol)
        return int(self.cdf[symbol]), int(self.cdf[symbol + 1] - self.cdf[symbol])

    def qf(self, quantile: int) -> Tuple[int, int, int]:
        s = int(self.lookup[quantile])
        return s, int(self.cdf[s]), int(self.cdf[s + 1] - self.cdf[s])

    def qf_array(self, quantiles: np.ndarray):
        s = self.lookup[quantiles]
        return s, self.cdf[s], self.cdf[s.astype(np.int64) + 1] - self.cdf[s]

    def symbol_table(self):
        for s in range(len(self.cdf) - 1):
            yield s, int(self.cdf[s]), int(self.cdf[s + 1] - self.cdf[s])


class NonContiguousLookupDecoderModel(EntropyModel):
    """Lookup decode for arbitrary symbol alphabets (lookup_noncontiguous.rs)."""

    def __init__(self, cdf: np.ndarray, symbols: Sequence[int], precision: int = 12):
        self.inner = ContiguousLookupDecoderModel(cdf, precision)
        self.symbols = np.asarray(symbols)
        self.precision = precision

    @classmethod
    def from_symbols_and_nonzero_fixed_point_probabilities(
        cls, symbols, probabilities, precision: int = 12, infer_last_probability: bool = False
    ):
        dec = NonContiguousCategoricalDecoderModel.from_symbols_and_nonzero_fixed_point_probabilities(
            symbols, probabilities, precision, infer_last_probability
        )
        return cls(dec.cdf, dec.symbols, precision)

    @classmethod
    def from_symbol_table(cls, symbol_table, precision: int = 12):
        dec = NonContiguousCategoricalDecoderModel.from_symbol_table(symbol_table, precision)
        return cls(dec.cdf, dec.symbols, precision)

    def ecp(self, symbol: int) -> Tuple[int, int]:
        hits = np.where(self.symbols == symbol)[0]
        if len(hits) == 0:
            raise ImpossibleSymbol(symbol)
        i = int(hits[0])
        return self.inner.ecp(i)

    def qf(self, quantile: int) -> Tuple[int, int, int]:
        i, c, p = self.inner.qf(quantile)
        return int(self.symbols[i]), c, p

    def qf_array(self, quantiles: np.ndarray):
        i, c, p = self.inner.qf_array(quantiles)
        return self.symbols[i], c, p

    def symbol_table(self):
        for i, c, p in self.inner.symbol_table():
            yield int(self.symbols[i]), c, p
