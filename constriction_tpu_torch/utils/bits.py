"""Bit/word helpers shared by the coder cores.

Mirrors the reference's core primitives (its src/lib.rs:602-739):
word chunking with leading-zero-chunk truncation, and bit-length helpers.

JAX counterpart: ``constriction_tpu/utils/bits.py``.
"""

from __future__ import annotations

from typing import List


def significant_bits(x: int) -> int:
    """Number of significant bits (0 for x == 0)."""
    return x.bit_length()


def chunks_truncated_msb_first(data: int, chunk_bits: int) -> List[int]:
    """Chunks of `data` from most to least significant, skipping leading zero
    chunks (lib.rs:719-730, `bit_array_to_chunks_truncated`)."""
    nbits = data.bit_length()
    mask = (1 << chunk_bits) - 1
    shifts = range(0, nbits, chunk_bits)
    return [(data >> shift) & mask for shift in reversed(shifts)]


def leading_zeros(x: int, total_bits: int) -> int:
    return total_bits - x.bit_length()
