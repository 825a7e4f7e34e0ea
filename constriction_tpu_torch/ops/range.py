"""Exact scalar range coder (queue / FIFO), bit-exact with the reference.

State is ``(lower, range)`` with invariant ``range >= 2**(S - W)``
(the reference's src/stream/queue.rs:60-71).  Carry handling is deferred, not
propagated: the encoder may hold back words whose final value can still change,
tracked as ``Inverted(num_inverted, first_word)`` (queue.rs:120-142); they are
resolved when the interval stops straddling a word-boundary wrap
(queue.rs:647-666) or at sealing time (queue.rs:458-523).

Encode step (queue.rs:637-702): ``scale = range >> P``; ``range = scale *
prob``; ``lower += scale * cum`` (wrapping); renormalize when
``range < 2**(S - W)`` by shifting ``lower``/``range`` left one word and
emitting or holding back the shifted-out word.

Decode (queue.rs:968-1035): ``q = (point - lower) / scale`` (wrapping sub),
``InvalidData`` if ``q >= 2**P``; same interval update; renorm shifts in the
next word of ``point`` (zero once exhausted).

The bulk methods run the host codec (:mod:`..native`) under the same data
gates as the JAX package: 64 or more symbols at W <= 32, S <= 64; a
WordBuffer bulk to encode; to decode, a lookup-table model at P <= 16 or a
:class:`~..models.quantized.QuantizedFamily`, over an array (not an
iterator source).  A failed build of the codec raises RuntimeError.  Each
such method has a ``*_plain`` version beside it, the per-symbol Python
loop, which smaller inputs take.

JAX counterpart: ``constriction_tpu/ops/range.py`` (whose bulk methods take
their Python loop wherever its codec did not load).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import ctypes

import numpy as np

from .. import native
from ..models.base import EntropyModel, ModelFamily
from .ans import _dtype_for


class InvalidData(ValueError, AssertionError):
    # the reference maps DecoderFrontendError::InvalidData to
    # AssertionError (pybindings/stream/queue.rs:676-684); ValueError kept
    # for backward compatibility
    pass


from ..backends import QueueIterReader, WordBuffer  # noqa: E402


class RangeEncoderCore:
    def __init__(self, word_bits: int = 32, state_bits: int = 64):
        assert state_bits >= 2 * word_bits and state_bits % word_bits == 0
        self.W = word_bits
        self.S = state_bits
        self.word_mask = (1 << word_bits) - 1
        self.state_mask = (1 << state_bits) - 1
        self.lower = 0
        self.range = self.state_mask  # State::max_value()
        # Inverted situation: (num_inverted, first_word) or None for Normal.
        self.inverted: Optional[Tuple[int, int]] = None
        self.bulk = WordBuffer()

    @classmethod
    def with_write_backend(
        cls, backend, word_bits: int = 32, state_bits: int = 64
    ) -> "RangeEncoderCore":
        """Empty encoder emitting bulk words into ``backend`` (fixed-capacity
        WordBuffer / CallbackSink; Cursor analog backends.rs:1061-1466)."""
        self = cls(word_bits, state_bits)
        self.bulk = backend
        return self

    # -- introspection ----------------------------------------------------------

    def is_empty(self) -> bool:
        return self.range == self.state_mask and not self.bulk

    def _seal_words(self) -> List[int]:
        """Words appended by sealing (queue.rs:458-523)."""
        if self.range == self.state_mask:
            return []  # nothing encoded yet -> empty output
        point = (self.lower + ((1 << (self.S - self.W)) - 1)) & self.state_mask
        out: List[int] = []
        if self.inverted is not None:
            num_inverted, first_word = self.inverted
            if point >= self.lower:  # no wrap
                out.append(first_word)
                out.extend([self.word_mask] * (num_inverted - 1))
            else:  # wrapped: carry into the held-back words
                out.append((first_word + 1) & self.word_mask)
                out.extend([0] * (num_inverted - 1))
        point_word = point >> (self.S - self.W)
        out.append(point_word)
        upper_word = ((self.lower + self.range) & self.state_mask) >> (self.S - self.W)
        if upper_word == point_word:
            out.append(0)
        return out

    def num_words(self) -> int:
        return len(self.bulk) + len(self._seal_words())

    def num_bits(self) -> int:
        return self.W * self.num_words()

    def clear(self) -> None:
        self.lower = 0
        self.range = self.state_mask
        self.inverted = None
        self.bulk = WordBuffer()

    def clone(self) -> "RangeEncoderCore":
        out = RangeEncoderCore(self.W, self.S)
        out.lower, out.range, out.inverted = self.lower, self.range, self.inverted
        if isinstance(self.bulk, WordBuffer):
            out.bulk = self.bulk.copy()
        else:
            try:
                out.bulk = list(self.bulk)
            except TypeError:
                raise ValueError(
                    "cannot clone a coder with a write-only (callback) "
                    "backend"
                ) from None
        return out

    @classmethod
    def from_raw_parts(cls, bulk, state, word_bits: int = 32,
                       state_bits: int = 64) -> "RangeEncoderCore":
        """Restore exact encoder internals (queue.rs:420-455 analog);
        ``state`` is the (lower, range) pair.  Only a Normal-situation
        encoder round-trips through raw parts (held-back inverted words are
        internal)."""
        from ..backends import WordBuffer as _WB

        self = cls(word_bits, state_bits)
        self.bulk = _WB(np.asarray(bulk, dtype=np.uint64))
        self.lower, self.range = (int(state[0]) & self.state_mask,
                                  int(state[1]) & self.state_mask)
        return self

    def into_raw_parts(self):
        if self.inverted is not None:
            raise ValueError(
                "cannot expose raw parts while carry resolution is pending"
            )
        return (np.asarray(self.bulk, dtype=_dtype_for(self.W)),
                (self.lower, self.range))

    def pos(self) -> Tuple[int, Tuple[int, int]]:
        """(position, (lower, range)); position counts words incl. held-back
        inverted words (queue.rs:182-196)."""
        num_inverted = self.inverted[0] if self.inverted is not None else 0
        return len(self.bulk) + num_inverted, (self.lower, self.range)

    def get_compressed(self) -> np.ndarray:
        dt = _dtype_for(self.W)
        seal = np.array(self._seal_words(), dtype=dt)
        return np.concatenate([np.asarray(self.bulk, dtype=dt), seal])

    # -- coding -------------------------------------------------------------------

    def encode_symbol(self, symbol: int, model: EntropyModel) -> None:
        cum, prob = model.ecp(int(symbol))
        self._encode_cp(cum, prob, model.precision)

    def _check_precision(self, precision: int) -> None:
        """Reference generic asserts: PRECISION <= Word::BITS and
        State::BITS >= Word::BITS + PRECISION (queue.rs); a too-large model
        precision silently corrupts the interval arithmetic."""
        if precision > self.W or self.S < self.W + precision:
            raise ValueError(
                f"model precision {precision} is incompatible with this "
                f"coder (word_bits={self.W}, state_bits={self.S}): needs "
                "precision <= word_bits and state_bits >= word_bits + "
                "precision"
            )

    def _encode_cp(self, cum: int, prob: int, precision: int) -> None:
        self._check_precision(precision)
        scale = self.range >> precision
        new_range = scale * prob
        if new_range == 0:
            raise ValueError("ImpossibleSymbol: probability underflow")
        self.range = new_range
        new_lower = (self.lower + scale * cum) & self.state_mask

        if self.inverted is not None:
            # Unlikely branch: check whether the interval stopped straddling
            # the wrap point (queue.rs:647-666).
            if (new_lower + self.range) & self.state_mask > new_lower:
                num_inverted, first_word = self.inverted
                if new_lower < self.lower:  # carry happened
                    first = (first_word + 1) & self.word_mask
                    consecutive = 0
                else:
                    first = first_word
                    consecutive = self.word_mask
                self.bulk.append(first)
                self.bulk.extend([consecutive] * (num_inverted - 1))
                self.inverted = None

        self.lower = new_lower

        if self.range < (1 << (self.S - self.W)):
            self.range = (self.range << self.W) & self.state_mask
            lower_word = self.lower >> (self.S - self.W)
            self.lower = (self.lower << self.W) & self.state_mask
            if self.inverted is not None:
                self.inverted = (self.inverted[0] + 1, self.inverted[1])
            elif (self.lower + self.range) & self.state_mask > self.lower:
                self.bulk.append(lower_word)
            else:
                self.inverted = (1, lower_word)

    def encode_iid_symbols(self, symbols: Sequence[int], model: EntropyModel) -> None:
        cums, probs = model.ecp_array(np.asarray(symbols))
        self.encode_tables(cums, probs, model.precision)

    def encode_tables(self, cums: np.ndarray, probs: np.ndarray, precision: int) -> None:
        """Encode per-symbol (cum, prob) tables in order:
        ``ctpu_range_encode`` for 64 or more symbols at W <= 32, S <= 64
        into a WordBuffer, else :meth:`encode_tables_plain`."""
        self._check_precision(precision)
        if not (len(cums) >= 64 and self.W <= 32 and self.S <= 64
                and isinstance(self.bulk, WordBuffer)):
            self.encode_tables_plain(cums, probs, precision)
            return
        lib = native.library()
        # worst case: the pending Inverted run flushes entirely plus
        # one renorm word per symbol (omitting num_inverted here was
        # a heap overflow for encoders with a long pending run)
        num_inverted = self.inverted[0] if self.inverted else 0
        words = np.empty(
            len(self.bulk) + num_inverted + len(cums) + 8,
            dtype=np.uint32,
        )
        words[: len(self.bulk)] = self.bulk.view()
        st = native.RangeEncState(
            self.lower,
            self.range,
            0 if self.inverted is None else self.inverted[0],
            0 if self.inverted is None else self.inverted[1],
        )
        n = lib.ctpu_range_encode(
            ctypes.byref(st), words, len(self.bulk),
            np.ascontiguousarray(cums, dtype=np.uint32),
            np.ascontiguousarray(probs, dtype=np.uint32),
            len(cums), self.W, self.S, precision,
        )
        self.bulk.set_content(words[:n])
        self.lower, self.range = st.lower, st.range
        self.inverted = (
            (st.num_inverted, st.first_inverted) if st.num_inverted else None
        )

    def encode_tables_plain(self, cums: np.ndarray, probs: np.ndarray,
                            precision: int) -> None:
        """:meth:`encode_tables` as the per-symbol Python loop."""
        self._check_precision(precision)
        for c, p in zip((int(c) for c in cums), (int(p) for p in probs)):
            self._encode_cp(c, p, precision)

    def encode_symbols(self, symbols: Sequence[int], family: ModelFamily, precision: int = 24) -> None:
        symbols = np.asarray(symbols)
        cums, probs = family.ecp_all(symbols)
        self.encode_tables(cums, probs, precision)

    def get_decoder(self) -> "RangeDecoderCore":
        return RangeDecoderCore.from_compressed(self.get_compressed(), self.W, self.S)


class RangeDecoderCore:
    def __init__(self, word_bits: int = 32, state_bits: int = 64):
        self.W = word_bits
        self.S = state_bits
        self.word_mask = (1 << word_bits) - 1
        self.state_mask = (1 << state_bits) - 1
        self.lower = 0
        self.range = self.state_mask
        self.point = 0
        self.bulk = np.zeros(0, dtype=np.uint64)
        self.cursor = 0  # read position into bulk
        # number of zero words currently shifted into `point` past the
        # stream end (0 while words remain); makes pos()/seek() exact even
        # for streams shorter than S/W words or after tail exhaustion
        self._point_shortfall = 0

    @classmethod
    def from_compressed(
        cls, compressed: Sequence[int], word_bits: int = 32, state_bits: int = 64
    ) -> "RangeDecoderCore":
        self = cls(word_bits, state_bits)
        self.bulk = np.asarray(compressed, dtype=np.uint64).reshape(-1)
        self.point = self._read_point()
        return self

    @classmethod
    def from_word_iterator(
        cls, words, word_bits: int = 32, state_bits: int = 64
    ) -> "RangeDecoderCore":
        """Lazy decoder over a forward word iterator (iterator-source
        analog of backends.rs:1681): words are pulled on demand and
        memoized, so pos/seek within the consumed prefix still work."""
        self = cls(word_bits, state_bits)
        self.bulk = QueueIterReader(words)
        self.point = self._read_point()
        return self

    def _has_word(self, i: int) -> bool:
        if isinstance(self.bulk, QueueIterReader):
            return self.bulk.length_at_least(i + 1)
        return i < len(self.bulk)

    def _read_word(self) -> Optional[int]:
        if self._has_word(self.cursor):
            w = int(self.bulk[self.cursor])
            self.cursor += 1
            return w
        return None

    def _read_point(self) -> int:
        """queue.rs:847-868: load S/W words MSB-first; left-align if short."""
        num_read = 0
        point = 0
        max_words = self.S // self.W
        while num_read < max_words:
            w = self._read_word()
            if w is None:
                break
            point = ((point << self.W) | w) & self.state_mask
            num_read += 1
        if num_read < max_words and num_read != 0:
            point = (point << (self.S - num_read * self.W)) & self.state_mask
        self._point_shortfall = max_words - num_read if num_read else 0
        return point

    def maybe_exhausted(self) -> bool:
        # queue.rs:868-898 (strict <, like the reference)
        max_difference = ((1 << (self.S - self.W)) << 1) - 1
        exhausted = not self._has_word(self.cursor)
        in_tail = ((self.point - self.lower) & self.state_mask) < max_difference
        return exhausted and (self.range == self.state_mask or in_tail)

    def clone(self) -> "RangeDecoderCore":
        out = RangeDecoderCore(self.W, self.S)
        out.lower, out.range, out.point = self.lower, self.range, self.point
        out.bulk = self.bulk
        out.cursor = self.cursor
        out._point_shortfall = self._point_shortfall
        return out

    def pos(self) -> Tuple[int, Tuple[int, int]]:
        """Word position such that ``seek(*pos())`` reproduces the current
        state exactly, including short streams and tail exhaustion (the
        current ``point`` holds the last ``S//W - shortfall`` real words)."""
        return (
            self.cursor - (self.S // self.W - self._point_shortfall),
            (self.lower, self.range),
        )

    def seek(self, position: int, state: Tuple[int, int]) -> None:
        lower, range_ = state
        if (int(range_) >> (self.S - self.W)) == 0:
            # queue.rs:75-85 RangeCoderState::new rejects range < 2^(S-W)
            # (decode would divide by scale == 0)
            raise ValueError("Invalid coder state.")
        if position < 0 or (
            not isinstance(self.bulk, QueueIterReader)
            and position > len(self.bulk)
        ):
            raise ValueError("seek out of range")
        self.cursor = position
        self.point = self._read_point()
        self.lower = int(lower) & self.state_mask
        self.range = int(range_) & self.state_mask

    def _check_precision(self, precision: int) -> None:
        if precision > self.W or self.S < self.W + precision:
            raise ValueError(
                f"model precision {precision} is incompatible with this "
                f"coder (word_bits={self.W}, state_bits={self.S}): needs "
                "precision <= word_bits and state_bits >= word_bits + "
                "precision"
            )

    def decode_symbol(self, model: EntropyModel) -> int:
        precision = model.precision
        self._check_precision(precision)
        scale = self.range >> precision
        quantile = ((self.point - self.lower) & self.state_mask) // scale
        if quantile >= (1 << precision):
            raise InvalidData(
                "Tried to decode data that is inconsistent with the entropy model."
            )
        symbol, cum, prob = model.qf(quantile)
        self.lower = (self.lower + scale * cum) & self.state_mask
        self.range = scale * prob
        if self.range < (1 << (self.S - self.W)):
            self.lower = (self.lower << self.W) & self.state_mask
            self.range = self.range << self.W
            self.point = (self.point << self.W) & self.state_mask
            w = self._read_word()
            if w is not None:
                self.point |= w
            else:
                self._point_shortfall = min(
                    self._point_shortfall + 1, self.S // self.W
                )
        return symbol

    def decode_iid_symbols(self, amt: int, model: EntropyModel) -> np.ndarray:
        """``amt`` symbols under one model: ``ctpu_range_decode_lookup``
        where :meth:`_native_decode_iid` takes the input, else
        :meth:`decode_iid_symbols_plain`."""
        out = self._native_decode_iid(amt, model)
        if out is not None:
            return out
        return self.decode_iid_symbols_plain(amt, model)

    def decode_iid_symbols_plain(self, amt: int, model: EntropyModel) -> np.ndarray:
        """:meth:`decode_iid_symbols` as the per-symbol Python loop."""
        out = np.empty(amt, dtype=np.int64)
        for i in range(amt):
            out[i] = self.decode_symbol(model)
        return out

    def _native_decode_iid(self, amt: int, model: EntropyModel) -> Optional[np.ndarray]:
        if amt < 64 or self.W > 32 or self.S > 64 or model.precision > 16:
            return None
        cdf = getattr(model, "cdf", None)
        lookup = getattr(model, "lookup", None)
        if lookup is None and hasattr(model, "inner"):
            lookup = getattr(model.inner, "lookup", None)
            if cdf is None:
                cdf = getattr(model.inner, "cdf", None)
        if not isinstance(cdf, np.ndarray) or not isinstance(lookup, np.ndarray):
            return None
        if isinstance(self.bulk, QueueIterReader):
            return None
        lib = native.library()
        st = native.RangeDecState(self.lower, self.range, self.point, self.cursor)
        words = self._padded_words()
        out = np.empty(amt, dtype=np.int32)
        n = lib.ctpu_range_decode_lookup(
            ctypes.byref(st), words, len(words),
            np.ascontiguousarray(lookup, dtype=np.uint32),
            np.ascontiguousarray(cdf, dtype=np.uint32),
            out, amt, self.W, self.S, model.precision,
        )
        # adopt the state up to (and including) the last good symbol, so
        # the coder ends in the same state as the per-symbol Python path
        self._adopt(st)
        if n < amt:
            raise InvalidData(
                "Tried to decode data that is inconsistent with the entropy model."
            )
        symbols = getattr(model, "symbols", None)
        if symbols is not None:
            return np.asarray(symbols)[out].astype(np.int64)
        return out.astype(np.int64)

    def _padded_words(self) -> np.ndarray:
        """The bulk as u32 for the host codec, followed by S/W zero words:
        the codec's cursor then counts the zero words a refill shifts in
        past the end, as :meth:`decode_symbol` counts them in
        ``_point_shortfall`` (and ``pos()`` reads them)."""
        words = np.zeros(len(self.bulk) + self.S // self.W, dtype=np.uint32)
        words[: len(self.bulk)] = self.bulk
        return words

    def _adopt(self, st) -> None:
        """Take the host codec's state after a decode over
        :meth:`_padded_words`.  The JAX package's route keeps
        ``_point_shortfall`` as it was, so its ``pos()`` after a decode
        into the stream's tail differs from its Python loop's; here the
        two agree."""
        total = len(self.bulk)
        past = st.cursor - max(self.cursor, total)
        if past > 0:
            self._point_shortfall = min(self._point_shortfall + past,
                                        self.S // self.W)
        self.lower, self.range, self.point = st.lower, st.range, st.point
        self.cursor = min(st.cursor, total)

    def decode_symbols(self, family: ModelFamily) -> np.ndarray:
        """One symbol per model of ``family``:
        ``ctpu_range_decode_quantized`` where
        :meth:`_native_decode_family` takes the input, else
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
        if self.W > 32 or self.S > 64:
            return None
        if isinstance(self.bulk, QueueIterReader):
            return None
        lib = native.library()
        q = family.quantizer
        st = native.RangeDecState(self.lower, self.range, self.point, self.cursor)
        words = self._padded_words()
        out = np.empty(family.size, dtype=np.int32)
        n = lib.ctpu_range_decode_quantized(
            ctypes.byref(st), words, len(words),
            native.DIST_KIND[family.kind], q.min, q.max,
            np.ascontiguousarray(family.param_a),
            np.ascontiguousarray(family.param_b),
            out, family.size, self.W, self.S, q.precision,
        )
        self._adopt(st)
        if n < family.size:
            raise InvalidData(
                "Tried to decode data that is inconsistent with the entropy model."
            )
        return out.astype(np.int64)
