"""Coder cores: the exact scalar state machines (host) and the Hopper
kernels' wrappers.  JAX counterpart: ``constriction_tpu/ops/__init__.py``,
with the same exports."""

from .ans import AnsCoderCore
from .chain import ChainCoderCore
from .range import RangeDecoderCore, RangeEncoderCore

__all__ = ["AnsCoderCore", "ChainCoderCore", "RangeDecoderCore", "RangeEncoderCore"]
