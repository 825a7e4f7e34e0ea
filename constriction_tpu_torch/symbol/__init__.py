"""Symbol codes: bit-granular coders + Huffman / Exp-Golomb codebooks.

API parity with `constriction.symbol`
(the reference's src/pybindings/symbol/mod.rs:112-387): `StackCoder`,
`QueueEncoder`, `QueueDecoder`, and the `huffman` submodule.

JAX counterpart: ``constriction_tpu/symbol/__init__.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.bitstream import QueueBitDecoder, QueueBitEncoder, StackBitCoder
from . import exp_golomb, huffman


class StackCoder:
    """A stack (LIFO) of compressed bits; encoding appends code words in
    suffix order so they decode from the end."""

    def __init__(self, compressed: Optional[np.ndarray] = None):
        if compressed is None:
            self._inner = StackBitCoder()
        else:
            self._inner = StackBitCoder.from_compressed(np.asarray(compressed, dtype=np.uint32))

    def encode_symbol(self, symbol: int, codebook) -> None:
        self._inner.encode_symbol(int(symbol), codebook)

    def decode_symbol(self, codebook) -> int:
        return self._inner.decode_symbol(codebook)

    def get_compressed_and_bitrate(self) -> Tuple[np.ndarray, int]:
        return self._inner.get_compressed(), self._inner.bit_len()

    def get_compressed(self) -> Tuple[np.ndarray, int]:
        return self.get_compressed_and_bitrate()


class QueueEncoder:
    """A queue (FIFO) encoder of compressed bits (prefix code emission)."""

    def __init__(self):
        self._inner = QueueBitEncoder()

    def encode_symbol(self, symbol: int, codebook) -> None:
        self._inner.encode_symbol(int(symbol), codebook)

    def get_compressed_and_bitrate(self) -> Tuple[np.ndarray, int]:
        return self._inner.get_compressed(), self._inner.bit_len()

    def get_compressed(self) -> Tuple[np.ndarray, int]:
        return self.get_compressed_and_bitrate()

    def get_decoder(self) -> "QueueDecoder":
        out = QueueDecoder.__new__(QueueDecoder)
        out._inner = self._inner.get_decoder()
        return out


class QueueDecoder:
    def __init__(self, compressed: np.ndarray):
        self._inner = QueueBitDecoder(np.asarray(compressed, dtype=np.uint32))

    def decode_symbol(self, codebook) -> int:
        return self._inner.decode_symbol(codebook)

    def maybe_exhausted(self) -> bool:
        return self._inner.maybe_exhausted()


__all__ = ["StackCoder", "QueueEncoder", "QueueDecoder", "huffman", "exp_golomb"]
