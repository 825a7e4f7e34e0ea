"""Fixed-point categorical models for the port's coders.

JAX counterpart: ``constriction_tpu.models.categorical``
(``fast_quantized_cdf``, i.e.
``ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast``),
which follows the reference's ``categorical/contiguous.rs``.  The port
carries its own copy so that it imports nothing of the JAX package;
``tests/test_torch_host.py`` holds the two CDFs equal.
"""

from __future__ import annotations

import math

import numpy as np

_NOT_NORMALIZABLE = (
    "Probability distribution not normalizable (the array of probabilities\n"
    "might be empty, contain negative values or NaNs, or sum to infinity)."
)


def _is_subnormal(x) -> bool:
    """Rust's ``!is_normal()``: zero, inf, NaN or subnormal."""
    xf = float(x)
    if xf == 0.0 or not math.isfinite(xf):
        return True
    dt = np.asarray(x).dtype
    return abs(np.asarray(x, dtype=dt)) < np.finfo(dt).tiny


def _trunc_to_u64(x: np.ndarray) -> np.ndarray:
    """Float -> u64 with Rust ``as`` semantics (saturating, NaN -> 0)."""
    with np.errstate(invalid="ignore"):
        clipped = np.where(np.isnan(x), 0.0, np.clip(x, 0.0, float(2**64 - 1)))
    return np.trunc(clipped).astype(np.uint64)


def fast_quantized_cdf(probabilities, precision: int,
                       normalization: float | None = None) -> np.ndarray:
    """Fixed-point CDF (u64[n+1], last entry 2^P) of floating-point
    probabilities: every symbol gets weight >= 1, the rest is spread by a
    truncating scale of the sequential cumulative sum.  JAX counterpart:
    ``constriction_tpu.models.categorical.fast_quantized_cdf``."""
    probs = np.asarray(probabilities)
    if probs.dtype not in (np.float32, np.float64):
        probs = probs.astype(np.float64)
    n = len(probs)
    if n < 2 or n >= (1 << precision) - 1:
        raise ValueError("invalid number of probabilities")
    free_weight = (1 << precision) - n
    # sequential left-to-right sum in the array's dtype, as Rust's running
    # accumulation (np.sum would sum pairwise)
    cumsum = np.add.accumulate(probs, dtype=probs.dtype)
    norm = (probs.dtype.type(normalization) if normalization is not None
            else cumsum[-1])
    normf = float(norm)
    if not (math.isfinite(normf) and normf > 0.0) or _is_subnormal(norm):
        raise ValueError(_NOT_NORMALIZABLE)
    scale = probs.dtype.type(free_weight) / norm
    cumulative = np.concatenate([np.zeros(1, dtype=probs.dtype), cumsum[:-1]])
    cdf = np.empty(n + 1, dtype=np.uint64)
    cdf[:n] = _trunc_to_u64(cumulative * scale) + np.arange(n, dtype=np.uint64)
    cdf[n] = 1 << precision
    if np.any(np.diff(cdf.astype(np.int64)) <= 0):
        raise ValueError(_NOT_NORMALIZABLE)
    return cdf
