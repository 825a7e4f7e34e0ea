"""Shared encode/decode argument dispatch for the coder classes.

Implements the reference's three call forms
(the reference's src/pybindings/stream/stack.rs:529-752):

1. `encode(symbol, model)` -- scalar symbol, concrete model;
2. `encode(symbols, model)` -- i.i.d. symbols, concrete model;
3. `encode(symbols, model_family, params...)` -- per-symbol parameters.

and the dual decode forms `decode(model)`, `decode(model, amt)`,
`decode(model_family, params...)`.

JAX counterpart: ``constriction_tpu/stream/_dispatch.py``.
"""

from __future__ import annotations

import numbers
from typing import Tuple

import numpy as np

from .model import Model


def _as_scalar_symbol(symbols) -> Tuple[bool, int]:
    # bools count as integers, like the reference's pyo3 i32 extraction
    # (True encodes symbol 1 -- Bernoulli users pass native bools)
    if isinstance(symbols, (bool, np.bool_, int, np.integer)):
        return True, int(symbols)
    arr = np.asarray(symbols)
    if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
        return True, int(arr)
    return False, 0


def _as_symbol_array(symbols) -> np.ndarray:
    arr = np.asarray(symbols)
    if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.integer):
        raise TypeError("symbols must be an int scalar or a rank-1 integer numpy array")
    return arr.astype(np.int64)


def dispatch_encode(core_encode_single, core_encode_iid, core_encode_family, symbols, model: Model, params):
    """Route one of the three encode call forms to the coder core."""
    is_scalar, scalar = _as_scalar_symbol(symbols)
    if is_scalar:
        if params:
            raise ValueError(
                "To encode a single symbol, use a concrete model, i.e., pass the\n"
                "model parameters directly to the constructor of the model and not to the\n"
                "`encode` method of the entropy coder."
            )
        core_encode_single(scalar, model._as_parameterized())
        return

    arr = _as_symbol_array(symbols)
    if not params:
        core_encode_iid(arr, model._as_parameterized())
    else:
        if len(arr) != model._family_len(params[0]):
            raise ValueError("`symbols` argument has wrong length.")
        family = model._parameterize(tuple(params))
        core_encode_family(arr, family)


def dispatch_decode(core_decode_single, core_decode_iid, core_decode_family, model: Model, args):
    """Route one of the three decode call forms; returns int or int32 array."""
    if len(args) == 0:
        return int(core_decode_single(model._as_parameterized()))
    if len(args) == 1 and isinstance(args[0], numbers.Integral):
        amt = int(args[0])
        return np.asarray(core_decode_iid(amt, model._as_parameterized()), dtype=np.int32)
    family = model._parameterize(tuple(args))
    return np.asarray(core_decode_family(family), dtype=np.int32)


def as_u32_words(data, name: str = "compressed"):
    """Validate and convert input words to uint32 without silent wrapping
    (the reference pybindings take PyReadonlyArray1<u32>; we additionally
    accept lists / other integer dtypes whose VALUES fit u32)."""
    arr = np.asarray(data)
    if arr.dtype == np.uint32:
        return arr
    if arr.ndim != 1 and arr.size:
        arr = arr.reshape(-1)
    if arr.size == 0:
        return arr.astype(np.uint32)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"{name} must be an array of uint32 words")
    if int(arr.min()) < 0 or int(arr.max()) > 0xFFFFFFFF:
        raise OverflowError(
            f"{name} contains values outside the uint32 range"
        )
    return arr.astype(np.uint32)
