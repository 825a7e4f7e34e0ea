"""Python API parity layer: `constriction_tpu_torch.stream.chain.ChainCoder`.

Mirrors `constriction.stream.chain.ChainCoder`
(the reference's src/pybindings/stream/chain.rs:257-520) at the default
preset.

JAX counterpart: ``constriction_tpu/stream/chain.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.chain import ChainCoderCore
from . import _dispatch
from .model import Model


class ChainCoder:
    """Bits-back entropy coder with symbol-local decoding."""

    def __init__(self, data: np.ndarray, is_remainders: bool = False, seal: bool = False):
        data = _dispatch.as_u32_words(data, "data")
        if is_remainders:
            if seal:
                raise AssertionError("Cannot seal remainders data.")
            self._core = ChainCoderCore.from_remainders(data)
        elif seal:
            self._core = ChainCoderCore.from_binary(data)
        else:
            self._core = ChainCoderCore.from_compressed(data)

    def get_data(self, unseal: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        core = self._core.clone()
        if unseal:
            return core.into_binary()
        return core.into_compressed()

    def get_remainders(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._core.clone().into_remainders()

    def encode_reverse(self, symbols, model: Model, *optional_model_params) -> None:
        _dispatch.dispatch_encode(
            self._core.encode_symbol,
            lambda arr, m: self._core.encode_iid_symbols_reverse(arr, m),
            lambda arr, fam: self._core.encode_symbols_reverse(arr, fam),
            symbols,
            model,
            optional_model_params,
        )

    def decode(self, model: Model, *optional_amt_or_model_params):
        return _dispatch.dispatch_decode(
            self._core.decode_symbol,
            self._core.decode_iid_symbols,
            self._core.decode_symbols,
            model,
            optional_amt_or_model_params,
        )

    def clone(self) -> "ChainCoder":
        out = ChainCoder.__new__(ChainCoder)
        out._core = self._core.clone()
        return out
