"""Stream codes: rANS (stack), range coding (queue), chain coding (bits-back).

API parity with `constriction.stream`
(the reference's src/pybindings/stream/mod.rs:50-58).

JAX counterpart: ``constriction_tpu/stream/__init__.py``.  Host code: numpy arrays and Python
ints in and out, no device argument, as in the JAX package.
"""

from . import chain, model, queue, stack

__all__ = ["model", "stack", "queue", "chain"]
