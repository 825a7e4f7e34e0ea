"""Python API parity layer: `constriction_tpu_torch.stream.queue`.

Mirrors `constriction.stream.queue.{RangeEncoder, RangeDecoder}`
(the reference's src/pybindings/stream/queue.rs:92-670) at the default preset.

JAX counterpart: ``constriction_tpu/stream/queue.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.range import RangeDecoderCore, RangeEncoderCore
from . import _dispatch
from .model import Model


class RangeEncoder:
    def __init__(self):
        self._core = RangeEncoderCore()

    def clear(self) -> None:
        self._core.clear()

    def pos(self) -> Tuple[int, Tuple[int, int]]:
        return self._core.pos()

    def num_words(self) -> int:
        return self._core.num_words()

    def num_bits(self) -> int:
        return self._core.num_bits()

    def is_empty(self) -> bool:
        return self._core.is_empty()

    def get_compressed(self) -> np.ndarray:
        return self._core.get_compressed()

    def get_decoder(self) -> "RangeDecoder":
        out = RangeDecoder.__new__(RangeDecoder)
        out._core = self._core.get_decoder()
        return out

    def encode(self, symbols, model: Model, *optional_model_params) -> None:
        _dispatch.dispatch_encode(
            self._core.encode_symbol,
            lambda arr, m: self._core.encode_iid_symbols(arr, m),
            lambda arr, fam: self._core.encode_symbols(arr, fam),
            symbols,
            model,
            optional_model_params,
        )

    def clone(self) -> "RangeEncoder":
        out = RangeEncoder.__new__(RangeEncoder)
        out._core = self._core.clone()
        return out


class RangeDecoder:
    def __init__(self, compressed: np.ndarray):
        self._core = RangeDecoderCore.from_compressed(
            _dispatch.as_u32_words(compressed)
        )

    def seek(self, position: int, state: Tuple[int, int]) -> None:
        self._core.seek(position, state)

    def maybe_exhausted(self) -> bool:
        return self._core.maybe_exhausted()

    def decode(self, model: Model, *optional_amt_or_model_params):
        return _dispatch.dispatch_decode(
            self._core.decode_symbol,
            self._core.decode_iid_symbols,
            self._core.decode_symbols,
            model,
            optional_amt_or_model_params,
        )

    def clone(self) -> "RangeDecoder":
        out = RangeDecoder.__new__(RangeDecoder)
        out._core = self._core.clone()  # shares the immutable bulk array
        return out
