"""constriction_tpu_torch: the PyTorch and CUDA port of constriction_tpu.

The JAX package ``constriction_tpu`` stays the reference; this package
imports ``torch`` and nothing of ``jax`` or of the JAX package.  It carries
its own copy of the host layer it needs (``LaneConfig``, the categorical
CDF builder, the container framing and the numpy host coder), held byte
for byte against the reference by the tests, and replaces the device
layer: every Pallas kernel on a ported path becomes a hand-written Hopper
kernel under ``ops/csrc``, with a plain PyTorch twin beside it.

Everything ``cuda.py`` exports is ported: the i.i.d. categorical coders
at both presets, ILANS2 rANS (``cuda.encode_iid`` / ``cuda.decode_iid``,
v1 and v2 containers, random access through ``cuda.build_checkpoints`` /
``cuda.decode_from_checkpoint``) and ILANS2-R range coding
(``cuda.encode_iid_range`` / ``cuda.decode_iid_range``, with range
checkpoints); the device families (``cuda.encode_family`` /
``cuda.decode_family``); bits-back coding (``cuda.bits_back_decode`` /
``_encode`` at P=16, ``bits_back_decode24`` / ``_encode24`` at P=24,
``bits_back_decode_family`` / ``_encode_family``); the chain coder's
parallel decode (``cuda.decode_chain_iid`` / ``cuda.decode_chain_rows``);
and the reference-exact per-symbol families (gaussian, laplace, cauchy,
binomial): ``cuda.encode_family_exact`` / ``cuda.decode_family_exact``
(W=16, S=32, P=12 by default; W=32, S=64 ungrouped or core-size grouped)
and the v2 family container, ``cuda.encode_family_exact_container`` /
``cuda.decode_family_exact_container``.  All 24 Pallas kernels of the
JAX package have a Hopper kernel here.

Beside the facade: ``parallel`` (the JAX package's ``parallel``) writes
and reads block-sharded containers (``parallel.encode`` /
``parallel.decode``, v1 and compact v2, rANS or range blocks, with
within-block checkpoints) on one card or a list of devices, runs the
block legs (``parallel.shard_*_cuda``) and its dry run
(``parallel.dryrun``); ``ops.tables`` (the JAX package's
``ops.tables_jax``) builds model tables on the tensors' device.

The constriction-compatible host API is ported too: ``stream`` (``stack.
AnsCoder``, ``queue.RangeEncoder`` / ``RangeDecoder``, ``chain.ChainCoder``
and the models of ``stream.model``), ``symbol`` (bit-granular coders,
Huffman and Exp-Golomb) and ``models`` (the fixed-point models), over the
scalar coder cores of ``ops`` and the word backends of ``backends``.  It
is host code, as in the JAX package: numpy arrays and Python ints in and
out, no ``device`` argument; its bulk paths run the host codec
(``native``), so ``import constriction_tpu_torch as constriction`` runs
constriction's examples bit for bit.
"""

from . import models, stream, symbol

__version__ = "0.1.0"

__all__ = ["models", "stream", "symbol", "__version__"]
