"""Lane configuration shared by every ILANS2 coder of the port.

A message of n symbols is coded by L lanes: symbol i belongs to lane i mod L
at step i // L.  Each lane is a rANS coder with W-bit words, S-bit states
and P-bit fixed-point probabilities.

JAX counterpart: ``constriction_tpu.ops.interleaved`` (``LaneConfig``,
``SMALL``, ``DEFAULT``, ``_state_dtype``).  The port carries its own copy
so that it imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LaneConfig:
    """L lanes of W-bit words, S-bit states, P-bit precision.  JAX
    counterpart: ``constriction_tpu.ops.interleaved.LaneConfig``."""

    num_lanes: int = 1024
    word_bits: int = 16
    state_bits: int = 32
    precision: int = 12

    def __post_init__(self):
        assert self.state_bits >= 2 * self.word_bits
        assert self.state_bits >= self.word_bits + self.precision
        assert self.precision > 0

    @property
    def word_mask(self) -> int:
        return (1 << self.word_bits) - 1

    @property
    def lower_bound(self) -> int:
        return 1 << (self.state_bits - self.word_bits)


SMALL = LaneConfig(word_bits=16, state_bits=32, precision=12)
DEFAULT = LaneConfig(word_bits=32, state_bits=64, precision=24)


def state_dtype(cfg: LaneConfig):
    """numpy dtype of a lane state: u64 for S > 32, else u32.  JAX
    counterpart: ``constriction_tpu.ops.interleaved._state_dtype``."""
    return np.uint64 if cfg.state_bits > 32 else np.uint32
