"""Exact scalar rANS stack coder (host path, bit-exact with the reference).

State-update algebra (the reference's src/stream/stack.rs:1014-1100):

- encode: if ``state >> (S - P) >= prob``: emit low word, ``state >>= W``;
  then ``state = (state // prob) << P | (cum + state % prob)``.
- decode: ``q = state & (2**P - 1)``; find the symbol whose interval contains
  ``q``; ``state = (state >> P) * prob + (q - cum)``; refill one word if
  ``state < 2**(S - W)`` and the bulk is nonempty.

Framing (stack.rs:891-955, 249-462): compressed = bulk words followed by the
state's words least-significant first with leading zero words dropped;
``from_compressed`` reads words from the end until ``state >= 2**(S - W)``
and rejects a trailing zero word; ``from_binary`` appends a virtual 1-bit
seal.

The bulk methods run the host codec (:mod:`..native`) where the data
allow it: 64 or more symbols, W <= 32, S <= 64, a :class:`WordBuffer`
bulk and, to decode, a table form of the model or a
:class:`~..models.quantized.QuantizedFamily`.  A failed build of the codec
raises RuntimeError; there is no silent fallback.  Each such method has a
``*_plain`` version beside it, the per-symbol Python loop, which smaller
inputs take.

JAX counterpart: ``constriction_tpu/ops/ans.py`` (whose bulk methods take
their Python loop wherever its codec did not load).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import ctypes

import numpy as np

from .. import native
from ..backends import StackIterReader, WordBuffer
from ..models.base import EntropyModel, ModelFamily
from ..utils.bits import chunks_truncated_msb_first


class FractionalNumberOfWords(ValueError, AssertionError):
    """Unsealing data whose valid bits are not a whole number of words
    (the reference maps this to AssertionError, stack.rs:417-421;
    ValueError kept for backward compatibility)."""


class AnsCoderCore:
    """Generic rANS coder over (word_bits W, state_bits S); default preset
    W=32, S=64 ("default"); "small" preset is W=16, S=32."""

    def __init__(self, word_bits: int = 32, state_bits: int = 64):
        assert state_bits >= 2 * word_bits
        self.W = word_bits
        self.S = state_bits
        self.word_mask = (1 << word_bits) - 1
        self.state = 0
        self.bulk = WordBuffer()

    @classmethod
    def with_write_backend(
        cls, backend, word_bits: int = 32, state_bits: int = 64
    ) -> "AnsCoderCore":
        """Empty coder emitting bulk words into ``backend`` -- a
        fixed-capacity WordBuffer (Cursor analog, errors on overflow) or a
        CallbackSink (stack.rs:380-399 / backends.rs:1061,1824)."""
        self = cls(word_bits, state_bits)
        self.bulk = backend
        return self

    @classmethod
    def from_reversed_compressed_iterator(
        cls, reversed_words, word_bits: int = 32, state_bits: int = 64
    ) -> "AnsCoderCore":
        """Lazy decoder over a reversed word iterator (last compressed
        word first; iterator-source analog of backends.rs:1681).  Only
        decoding operations are supported."""
        self = cls(word_bits, state_bits)
        src = StackIterReader(reversed_words)
        state = 0
        if src:
            state = src.pop()
            if state == 0:
                raise ValueError(
                    "Invalid compressed data: ANS compressed data never ends in a zero word."
                )
            threshold = 1 << (self.S - self.W)
            while state < threshold and src:
                state = (state << self.W) | src.pop()
        self.state = state
        self.bulk = src
        return self

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_compressed(
        cls, compressed: Sequence[int], word_bits: int = 32, state_bits: int = 64
    ) -> "AnsCoderCore":
        self = cls(word_bits, state_bits)
        bulk = WordBuffer(np.asarray(compressed, dtype=np.uint64))
        if bulk:
            if bulk[len(bulk) - 1] == 0:
                raise ValueError(
                    "Invalid compressed data: ANS compressed data never ends in a zero word."
                )
            state = bulk.pop()
            threshold = 1 << (self.S - self.W)
            while state < threshold and bulk:
                state = (state << self.W) | bulk.pop()
            self.state = state
        self.bulk = bulk
        return self

    @classmethod
    def from_binary(
        cls, data: Sequence[int], word_bits: int = 32, state_bits: int = 64
    ) -> "AnsCoderCore":
        self = cls(word_bits, state_bits)
        bulk = WordBuffer(np.asarray(data, dtype=np.uint64))
        state = 1
        threshold = 1 << (self.S - self.W)
        while state < threshold and bulk:
            state = (state << self.W) | bulk.pop()
        self.state = state
        self.bulk = bulk
        return self

    @classmethod
    def from_raw_parts(
        cls, bulk: Sequence[int], state: int, word_bits: int = 32, state_bits: int = 64
    ) -> "AnsCoderCore":
        self = cls(word_bits, state_bits)
        self.bulk = WordBuffer(np.asarray(bulk, dtype=np.uint64))
        self.state = int(state)
        return self

    def into_raw_parts(self):
        """(bulk words, state) -- exact coder internals (stack.rs:418-474
        analog); `from_raw_parts` restores them verbatim."""
        return np.asarray(self.bulk, dtype=_dtype_for(self.W)), self.state

    def clone(self) -> "AnsCoderCore":
        out = AnsCoderCore(self.W, self.S)
        out.state = self.state
        out.bulk = self.bulk.copy() if isinstance(self.bulk, WordBuffer) else list(self.bulk)
        return out

    # -- introspection ----------------------------------------------------------

    def is_empty(self) -> bool:
        # stack.rs:481-487: the state invariant makes checking `state == 0` enough.
        return self.state == 0

    def _state_chunks(self) -> List[int]:
        return chunks_truncated_msb_first(self.state, self.W)

    def num_words(self) -> int:
        return len(self.bulk) + len(self._state_chunks())

    def num_bits(self) -> int:
        return self.W * self.num_words()

    def num_valid_bits(self) -> int:
        # stack.rs:625-630
        return self.W * len(self.bulk) + max(self.state.bit_length(), 1) - 1

    def clear(self) -> None:
        self.state = 0
        self.bulk = WordBuffer()

    # -- compressed data access ---------------------------------------------------

    def get_compressed(self) -> np.ndarray:
        dt = _dtype_for(self.W)
        chunks = np.array(list(reversed(self._state_chunks())), dtype=dt)
        return np.concatenate([np.asarray(self.bulk, dtype=dt), chunks])

    def into_compressed(self) -> np.ndarray:
        out = self.get_compressed()
        self.bulk = WordBuffer()
        self.state = 0
        return out

    def get_binary(self) -> np.ndarray:
        """Unseal: requires the state's most significant word to be exactly 1;
        returns bulk + the state's lower words (stack.rs CoderGuard SEALED)."""
        chunks = self._state_chunks()
        if not chunks or chunks[0] != 1:
            raise ValueError(
                "Cannot unseal compressed data because it doesn't fit into an "
                "integer number of words. Did you create the encoder with "
                "`seal=True` and restore its original state?"
            )
        dt = _dtype_for(self.W)
        rest = np.array(list(reversed(chunks[1:])), dtype=dt)
        return np.concatenate([np.asarray(self.bulk, dtype=dt), rest])

    def into_binary(self) -> np.ndarray:
        """Rust `into_binary` (stack.rs:944-983): clears the leading 1 bit and
        appends the truncated state's words; errors unless the number of valid
        bits is a multiple of the word size."""
        valid_bits = self.state.bit_length() - 1
        if valid_bits < 0 or valid_bits % self.W != 0:
            raise FractionalNumberOfWords(
                "compressed data (excluding the trailing 1 bit) does not fit "
                "into an integer number of words"
            )
        truncated = self.state ^ (1 << valid_bits)
        dt = _dtype_for(self.W)
        rest = np.array(
            list(reversed(chunks_truncated_msb_first(truncated, self.W))), dtype=dt
        )
        return np.concatenate([np.asarray(self.bulk, dtype=dt), rest])

    # -- random access ---------------------------------------------------------------

    def pos(self) -> Tuple[int, int]:
        return len(self.bulk), self.state

    def seek(self, position: int, state: int) -> None:
        if position > len(self.bulk):
            raise ValueError("Tried to seek past end of stream.")
        self.bulk.truncate(position)
        self.state = int(state)

    # -- coding -------------------------------------------------------------------------

    def _check_precision(self, precision: int) -> None:
        """The reference statically asserts PRECISION <= Word::BITS and
        State::BITS >= Word::BITS + PRECISION (stack.rs generic asserts);
        violating either silently corrupts the stream (the renorm test
        reads the wrong state field), so validate per call here."""
        if precision > self.W or self.S < self.W + precision:
            raise ValueError(
                f"model precision {precision} is incompatible with this "
                f"coder (word_bits={self.W}, state_bits={self.S}): needs "
                "precision <= word_bits and state_bits >= word_bits + "
                "precision"
            )

    def encode_symbol(self, symbol: int, model: EntropyModel) -> None:
        cum, prob = model.ecp(int(symbol))
        self._encode_cp(cum, prob, model.precision)

    def _encode_cp(self, cum: int, prob: int, precision: int) -> None:
        self._check_precision(precision)
        state = self.state
        if (state >> (self.S - precision)) >= prob:
            self.bulk.append(state & self.word_mask)
            state >>= self.W
        self.state = ((state // prob) << precision) | (cum + state % prob)

    def decode_symbol(self, model: EntropyModel) -> int:
        precision = model.precision
        self._check_precision(precision)
        state = self.state
        quantile = state & ((1 << precision) - 1)
        symbol, cum, prob = model.qf(quantile)
        state = (state >> precision) * prob + (quantile - cum)
        if state < (1 << (self.S - self.W)) and self.bulk:
            state = (state << self.W) | self.bulk.pop()
        self.state = state
        return symbol

    # -- batched APIs ------------------------------------------------------------------------

    def encode_iid_symbols_reverse(self, symbols: Sequence[int], model: EntropyModel) -> None:
        symbols = np.asarray(symbols)
        cums, probs = model.ecp_array(symbols)
        self.encode_reverse_tables(cums, probs, model.precision)

    def encode_reverse_tables(
        self, cums: np.ndarray, probs: np.ndarray, precision: int
    ) -> None:
        """Encode per-symbol (cum, prob) tables, iterating in reverse order:
        ``ctpu_ans_encode_reverse`` for 64 or more symbols at W <= 32, S <=
        64 into a WordBuffer, else :meth:`encode_reverse_tables_plain`."""
        self._check_precision(precision)
        if not (len(cums) >= 64 and self.W <= 32 and self.S <= 64
                and isinstance(self.bulk, WordBuffer)):
            self.encode_reverse_tables_plain(cums, probs, precision)
            return
        lib = native.library()
        words = np.empty(len(self.bulk) + len(cums) + 8, dtype=np.uint32)
        words[: len(self.bulk)] = self.bulk.view()
        state = ctypes.c_uint64(self.state)
        n = lib.ctpu_ans_encode_reverse(
            ctypes.byref(state),
            words,
            len(self.bulk),
            np.ascontiguousarray(cums, dtype=np.uint32),
            np.ascontiguousarray(probs, dtype=np.uint32),
            len(cums),
            self.W,
            self.S,
            precision,
        )
        self.bulk.set_content(words[:n])
        self.state = state.value

    def encode_reverse_tables_plain(
        self, cums: np.ndarray, probs: np.ndarray, precision: int
    ) -> None:
        """:meth:`encode_reverse_tables` as the per-symbol Python loop."""
        self._check_precision(precision)
        cums_l = [int(c) for c in cums]
        probs_l = [int(p) for p in probs]
        for i in range(len(cums_l) - 1, -1, -1):
            self._encode_cp(cums_l[i], probs_l[i], precision)

    def encode_symbols_reverse(
        self, symbols: Sequence[int], family: ModelFamily, precision: int = 24
    ) -> None:
        symbols = np.asarray(symbols)
        cums, probs = family.ecp_all(symbols)
        self.encode_reverse_tables(cums, probs, precision)

    def decode_iid_symbols(self, amt: int, model: EntropyModel) -> np.ndarray:
        """``amt`` symbols under one model: the host codec where
        :meth:`_native_decode_iid` takes the input, else
        :meth:`decode_iid_symbols_plain`."""
        self._check_precision(model.precision)
        out = self._native_decode_iid(amt, model)
        if out is not None:
            return out
        return self.decode_iid_symbols_plain(amt, model)

    def decode_iid_symbols_plain(self, amt: int, model: EntropyModel) -> np.ndarray:
        """:meth:`decode_iid_symbols` as the per-symbol Python loop."""
        self._check_precision(model.precision)
        out = np.empty(amt, dtype=np.int64)
        for i in range(amt):
            out[i] = self.decode_symbol(model)
        return out

    def _native_decode_iid(self, amt: int, model: EntropyModel) -> Optional[np.ndarray]:
        """Dispatch i.i.d. decoding to the host codec where a table form of
        the model is available; None where the input takes the loop."""
        if amt < 64 or self.W > 32 or self.S > 64:
            return None
        if not isinstance(self.bulk, WordBuffer):
            return None
        cdf = getattr(model, "cdf", None)
        lookup = getattr(model, "lookup", None)
        if lookup is None and hasattr(model, "inner"):
            lookup = getattr(model.inner, "lookup", None)
            if cdf is None:
                cdf = getattr(model.inner, "cdf", None)
        if cdf is None and hasattr(model, "_boundaries"):
            cdf = model._boundaries()  # lazy categorical: exact fixed-point bounds
        if not isinstance(cdf, np.ndarray) or not isinstance(
            lookup, (np.ndarray, type(None))
        ):
            return None
        lib = native.library()
        cdf32 = np.ascontiguousarray(cdf, dtype=np.uint32)
        words = np.ascontiguousarray(self.bulk.view(), dtype=np.uint32)
        out = np.empty(amt, dtype=np.int32)
        state = ctypes.c_uint64(self.state)
        if lookup is not None and model.precision <= 16:
            lut = np.ascontiguousarray(lookup, dtype=np.uint32)
            remaining = lib.ctpu_ans_decode_lookup(
                ctypes.byref(state), words, len(words), lut, cdf32,
                out, amt, self.W, self.S, model.precision,
            )
        else:
            remaining = lib.ctpu_ans_decode_cdf(
                ctypes.byref(state), words, len(words), cdf32, len(cdf32) - 1,
                out, amt, self.W, self.S, model.precision,
            )
        self.bulk.set_content(words[:remaining])
        self.state = state.value
        symbols = getattr(model, "symbols", None)
        if symbols is not None:  # non-contiguous alphabets
            return np.asarray(symbols)[out].astype(np.int64)
        return out.astype(np.int64)

    def decode_symbols(self, family: ModelFamily) -> np.ndarray:
        """One symbol per model of ``family``: ``ctpu_ans_decode_quantized``
        where :meth:`_native_decode_family` takes the input, else
        :meth:`decode_symbols_plain`."""
        out = self._native_decode_family(family)
        if out is not None:
            return out
        return self.decode_symbols_plain(family)

    def decode_symbols_plain(self, family: ModelFamily) -> np.ndarray:
        """:meth:`decode_symbols` as the per-symbol Python loop."""
        out = np.empty(family.size, dtype=np.int64)
        for i in range(family.size):
            out[i] = self.decode_symbol(family.concrete(i))
        return out

    def _native_decode_family(self, family: ModelFamily) -> Optional[np.ndarray]:
        from ..models.quantized import QuantizedFamily

        if not isinstance(family, QuantizedFamily) or family.size < 64:
            return None
        self._check_precision(family.quantizer.precision)
        if self.W > 32 or self.S > 64 or not isinstance(self.bulk, WordBuffer):
            return None
        lib = native.library()
        q = family.quantizer
        words = np.ascontiguousarray(self.bulk.view(), dtype=np.uint32)
        out = np.empty(family.size, dtype=np.int32)
        state = ctypes.c_uint64(self.state)
        remaining = lib.ctpu_ans_decode_quantized(
            ctypes.byref(state), words, len(words),
            native.DIST_KIND[family.kind], q.min, q.max,
            np.ascontiguousarray(family.param_a), np.ascontiguousarray(family.param_b),
            out, family.size, self.W, self.S, q.precision,
        )
        self.bulk.set_content(words[:remaining])
        self.state = state.value
        return out.astype(np.int64)


def _dtype_for(word_bits: int):
    return {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[word_bits]
