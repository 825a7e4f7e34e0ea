"""Bit-granular symbol coders (stack and queue of bits).

Mirrors the reference's src/symbol/mod.rs:

- Writing (both stack and queue): bits fill the current word from the least
  significant bit upward; full words are flushed to the backend
  (symbol/mod.rs write_bit).
- Stack reading: bits are read back in reverse write order -- from
  ``mask_last_written`` downward within the current word, then popped backend
  words are read from the most significant bit down (symbol/mod.rs:631-658).
- Queue reading: words in order, bits LSB -> MSB (symbol/mod.rs:404-447).
- A stack's compressed representation is sealed with one additional 1 bit so
  the end can be discovered (symbol/mod.rs:495-510); `from_compressed`
  interprets the lowest set bit of the final word as that seal
  (symbol/mod.rs:478-499, replicated exactly).

JAX counterpart: ``constriction_tpu/ops/bitstream.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class _BitWriter:
    def __init__(self, word_bits: int = 32):
        self.W = word_bits
        self.backend: List[int] = []
        self.current_word = 0
        self.mask_last_written = 0

    def write_bit(self, bit: bool) -> None:
        write_mask = self.mask_last_written << 1
        if write_mask >> self.W == 0 and write_mask != 0:
            if bit:
                self.current_word |= write_mask
            self.mask_last_written = write_mask
        else:
            if self.mask_last_written != 0:
                self.backend.append(self.current_word)
            self.current_word = 1 if bit else 0
            self.mask_last_written = 1

    def bit_len(self) -> int:
        extra = 0
        if self.mask_last_written != 0:
            extra = self.mask_last_written.bit_length()  # trailing_zeros + 1
        return len(self.backend) * self.W + extra

    def is_empty(self) -> bool:
        return self.mask_last_written == 0 and not self.backend


class StackBitCoder(_BitWriter):
    """SymbolCoder<Word, Stack>: encode appends suffix-emitted code words;
    decode reads bits in reverse write order."""

    @classmethod
    def from_compressed(cls, compressed: Sequence[int], word_bits: int = 32) -> "StackBitCoder":
        """Inverse of :meth:`get_compressed`: the seal is the *highest* set bit
        of the final word.

        Note: the reference's `StackCoder::from_compressed`
        (symbol/mod.rs:478-499) looks for the seal at the lowest set bit,
        which is inconsistent with its own `get_compressed` output whenever
        the final word contains a 1 data bit below the seal (the reference
        never exercises this constructor in its tests).  We implement the
        self-consistent inverse instead; the compressed *words* produced by
        encoding are bit-identical to the reference either way.
        """
        self = cls(word_bits)
        backend = [int(w) for w in compressed]
        if backend:
            last_word = backend.pop()
            if last_word == 0:
                raise ValueError("Compressed data for a stack must not end in a zero word.")
            mask_end_bit = 1 << (last_word.bit_length() - 1)  # highest set bit
            self.current_word = last_word ^ mask_end_bit
            self.mask_last_written = mask_end_bit >> 1
        self.backend = backend
        return self

    def read_bit(self) -> Optional[bool]:
        if self.mask_last_written == 0:
            if not self.backend:
                return None
            self.current_word = self.backend.pop()
            self.mask_last_written = 1 << (self.W - 1)
        bit = self.current_word & self.mask_last_written
        self.current_word ^= bit
        self.mask_last_written >>= 1
        return bit != 0

    def get_compressed(self) -> np.ndarray:
        """Seal with one 1 bit and return the full word array (non-destructive)."""
        words = list(self.backend)
        # Simulate write_bit(True) + flush on a copy.
        current, mask = self.current_word, self.mask_last_written
        write_mask = mask << 1
        if write_mask >> self.W == 0 and write_mask != 0:
            current |= write_mask
            words.append(current)
        else:
            if mask != 0:
                words.append(current)
            words.append(1)
        return np.array(words, dtype=_dtype(self.W))

    # encoding/decoding with codebooks -----------------------------------------

    def encode_symbol(self, symbol: int, codebook) -> None:
        codebook.encode_symbol_suffix(symbol, self.write_bit)

    def decode_symbol(self, codebook) -> int:
        return codebook.decode_symbol(self.read_bit)

    def encode_iid_symbols_reverse(self, symbols, codebook) -> None:
        for s in reversed(list(symbols)):
            self.encode_symbol(int(s), codebook)


class QueueBitEncoder(_BitWriter):
    """SymbolCoder<Word, Queue>: prefix-emitted code words, FIFO decoding."""

    def get_compressed(self) -> np.ndarray:
        words = list(self.backend)
        if self.mask_last_written != 0:
            words.append(self.current_word)
        return np.array(words, dtype=_dtype(self.W))

    def encode_symbol(self, symbol: int, codebook) -> None:
        codebook.encode_symbol_prefix(symbol, self.write_bit)

    def get_decoder(self) -> "QueueBitDecoder":
        return QueueBitDecoder(self.get_compressed(), self.W)


class QueueBitDecoder:
    def __init__(self, compressed: Sequence[int], word_bits: int = 32):
        self.W = word_bits
        self.backend = [int(w) for w in compressed]
        self.cursor = 0
        self.current_word = 0
        self.mask_next_to_read = 0

    def read_bit(self) -> Optional[bool]:
        # mask is reset to 0 whenever it shifts past the word width below,
        # so == 0 is the only refill condition
        if self.mask_next_to_read == 0:
            if self.cursor >= len(self.backend):
                return None
            self.current_word = self.backend[self.cursor]
            self.cursor += 1
            self.mask_next_to_read = 1
        bit = (self.current_word & self.mask_next_to_read) != 0
        self.mask_next_to_read <<= 1
        if self.mask_next_to_read >> self.W:
            self.mask_next_to_read = 0
        return bit

    def decode_symbol(self, codebook) -> int:
        return codebook.decode_symbol(self.read_bit)

    def maybe_exhausted(self) -> bool:
        remaining = self.current_word & ~(self.mask_next_to_read - 1) if self.mask_next_to_read else 0
        return remaining == 0 and self.cursor >= len(self.backend)


def _dtype(word_bits: int):
    return {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[word_bits]
