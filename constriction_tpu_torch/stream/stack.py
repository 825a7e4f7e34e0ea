"""Python API parity layer: `constriction_tpu_torch.stream.stack.AnsCoder`.

Mirrors `constriction.stream.stack.AnsCoder`
(the reference's src/pybindings/stream/stack.rs:196-770) at the default
preset (u32 words, u64 state, precision 24).

JAX counterpart: ``constriction_tpu/stream/stack.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.ans import AnsCoderCore
from . import _dispatch
from .model import Model


class AnsCoder:
    """Entropy coder based on range Asymmetric Numeral Systems (stack / LIFO)."""

    def __init__(self, compressed: Optional[np.ndarray] = None, seal: bool = False):
        if compressed is None:
            if seal:
                raise ValueError("Need compressed data to seal.")
            self._core = AnsCoderCore()
        else:
            compressed = _dispatch.as_u32_words(compressed)
            if seal:
                self._core = AnsCoderCore.from_binary(compressed)
            else:
                self._core = AnsCoderCore.from_compressed(compressed)

    # -- checkpoints ---------------------------------------------------------

    def pos(self) -> Tuple[int, int]:
        return self._core.pos()

    def seek(self, position: int, state: int) -> None:
        try:
            self._core.seek(position, state)
        except ValueError:
            raise ValueError(
                "Tried to seek past end of stream. Note: in an ANS coder,\n"
                "both decoding and seeking *consume* compressed data. The Python API of\n"
                "`constriction`'s ANS coder currently does not support seeking backward."
            ) from None

    # -- introspection --------------------------------------------------------

    def clear(self) -> None:
        self._core.clear()

    def num_words(self) -> int:
        return self._core.num_words()

    def num_bits(self) -> int:
        return self._core.num_bits()

    def num_valid_bits(self) -> int:
        return self._core.num_valid_bits()

    def is_empty(self) -> bool:
        return self._core.is_empty()

    def get_compressed(self, unseal: bool = False) -> np.ndarray:
        if unseal:
            return self._core.get_binary()
        return self._core.get_compressed()

    # -- coding -----------------------------------------------------------------

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

    def clone(self) -> "AnsCoder":
        out = AnsCoder.__new__(AnsCoder)
        out._core = self._core.clone()
        return out
