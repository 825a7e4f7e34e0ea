"""Exponential Golomb code (the reference's src/symbol/exp_golomb.rs).

An infinite codebook over unsigned integers: symbol ``n`` encodes ``n + 1``
as ``len`` zero bits followed by the binary representation of ``n + 1``
(MSB first), where ``len = floor(log2(n + 1))``.

JAX counterpart: ``constriction_tpu/symbol/exp_golomb.py``.
"""

from __future__ import annotations

from typing import Callable, Optional


class ExpGolomb:
    """Codebook over unsigned integers with `bits`-bit wrapping semantics
    (default 32, matching `ExpGolomb<u32>`)."""

    def __init__(self, bits: int = 32):
        self.bits = bits

    def encode_symbol_prefix(self, symbol: int, emit: Callable[[bool], None]) -> None:
        n_plus1 = (int(symbol) + 1) & ((1 << self.bits) - 1)
        if n_plus1 == 0:  # symbol == 2**bits - 1 wraps (exp_golomb.rs:69-79)
            for _ in range(self.bits):
                emit(False)
            emit(True)
            for _ in range(self.bits):
                emit(False)
            return
        length = n_plus1.bit_length() - 1
        for _ in range(length):
            emit(False)
        mask = 1 << length
        while mask != 0:
            emit((n_plus1 & mask) != 0)
            mask >>= 1

    def encode_symbol_suffix(self, symbol: int, emit: Callable[[bool], None]) -> None:
        n_plus1 = (int(symbol) + 1) & ((1 << self.bits) - 1)
        if n_plus1 == 0:
            for _ in range(self.bits):
                emit(False)
            emit(True)
            for _ in range(self.bits):
                emit(False)
            return
        length = n_plus1.bit_length() - 1
        remaining = n_plus1
        while True:
            emit((remaining & 1) != 0)
            remaining >>= 1
            if remaining == 0:
                break
        for _ in range(length):
            emit(False)

    def decode_symbol(self, read_bit: Callable[[], Optional[bool]]) -> int:
        length = 0
        while True:
            bit = read_bit()
            if bit is None:
                raise ValueError("Ran out of bits in compressed data.")
            if bit:
                break
            length += 1
            if length > self.bits:
                raise ValueError("Invalid codeword for this codebook.")
        value = 1
        for _ in range(length):
            bit = read_bit()
            if bit is None:
                raise ValueError("Ran out of bits in compressed data.")
            value = (value << 1) | (1 if bit else 0)
        if length == self.bits and (value & ((1 << self.bits) - 1)) != 0:
            # exp_golomb.rs:165: a maximal-length codeword is only valid
            # when the wrapped value is zero (symbol N::MAX); anything else
            # is a corrupt/adversarial codeword, not a wrapped symbol
            raise ValueError("Invalid codeword for this codebook.")
        return (value - 1) & ((1 << self.bits) - 1)
