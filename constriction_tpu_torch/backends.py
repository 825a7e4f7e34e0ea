"""Pluggable word-stream backends for the host coders.

The reference's L2 is a trait pair ``ReadWords``/``WriteWords`` with Vec,
fixed-capacity Cursor, Reverse, iterator-source and callback-sink
implementations (its src/backends.rs:200-269, 470-514,
1061-1466, 807-849, 1681-1861).  The host cores here (ops/ans.py,
ops/range.py, ops/chain.py) grow/shrink a word buffer with stack semantics
and occasionally hand the whole buffer to the host codec; this module
provides the equivalent seam:

- :class:`WordBuffer` -- the default growable store: an amortized-doubling
  numpy u64 array (list protocol for the scalar loops, zero-copy
  ``view()``/``__array__`` for the native bulk paths).
- ``WordBuffer(capacity=n, fixed=True)`` -- the Cursor analog: encode into a
  preallocated, fixed-capacity buffer; overflow raises
  :class:`CapacityError` instead of growing.
- :class:`CallbackSink` -- write backend that forwards every emitted word to
  a Python callback (backends.rs:1824-1861); the coder never materializes
  the bulk.
- :class:`StackIterReader` -- lazy read backend over a REVERSED word
  iterator for stack-semantics (ANS) decoding (backends.rs:1681).
- :class:`QueueIterReader` -- lazy, memoizing read backend over a forward
  word iterator for queue-semantics (range) decoding.

The Reverse adapter (backends.rs:807-849) appears here as the pairing of
the two iterator readers: wrapping ``reversed(buffer)`` in a
StackIterReader IS reading the queue-written buffer with stack semantics.

JAX counterpart: ``constriction_tpu/backends.py``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np


class CapacityError(ValueError):
    """A fixed-capacity write backend ran out of space (Cursor analog:
    the reference's write to a full Cursor fails with a Backend error,
    backends.rs:1452-1494)."""


class WordBuffer:
    """Growable (or fixed-capacity) word store over a numpy u64 array.

    Implements the slice of the list protocol the coder cores use --
    append/extend/pop/len/iter/index -- plus zero-copy ``view()`` for the
    native (C++) bulk paths and ``set_content`` for their writebacks.
    """

    __slots__ = ("_arr", "_len", "_fixed")

    def __init__(self, initial=None, capacity: Optional[int] = None,
                 fixed: bool = False):
        if initial is not None:
            arr = np.asarray(initial, dtype=np.uint64).reshape(-1).copy()
            n = len(arr)
            cap = capacity if capacity is not None else max(n, 8)
            if cap < n:
                raise CapacityError(f"capacity {cap} < initial length {n}")
            self._arr = np.empty(cap, dtype=np.uint64)
            self._arr[:n] = arr
            self._len = n
        else:
            self._arr = np.empty(capacity if capacity is not None else 8,
                                 dtype=np.uint64)
            self._len = 0
        self._fixed = bool(fixed)

    # -- write side --------------------------------------------------------

    def _grow(self, need: int) -> None:
        if need <= len(self._arr):
            return
        if self._fixed:
            raise CapacityError(
                f"fixed-capacity buffer full ({len(self._arr)} words)"
            )
        new = np.empty(max(need, 2 * len(self._arr)), dtype=np.uint64)
        new[: self._len] = self._arr[: self._len]
        self._arr = new

    def append(self, word: int) -> None:
        self._grow(self._len + 1)
        self._arr[self._len] = word
        self._len += 1

    def extend(self, words) -> None:
        words = np.asarray(words, dtype=np.uint64).reshape(-1)
        self._grow(self._len + len(words))
        self._arr[self._len : self._len + len(words)] = words
        self._len += len(words)

    def set_content(self, words) -> None:
        """Replace the whole contents (native bulk writeback); respects a
        fixed capacity."""
        words = np.asarray(words, dtype=np.uint64).reshape(-1)
        if len(words) > len(self._arr):
            self._grow(len(words))
        self._arr[: len(words)] = words
        self._len = len(words)

    # -- read side ---------------------------------------------------------

    def pop(self) -> int:
        if not self._len:
            raise IndexError("pop from empty WordBuffer")
        self._len -= 1
        return int(self._arr[self._len])

    def truncate(self, n: int) -> None:
        if n < 0 or n > self._len:
            raise ValueError("truncate out of range")
        self._len = n

    def view(self) -> np.ndarray:
        """Zero-copy view of the valid region (u64)."""
        return self._arr[: self._len]

    def __array__(self, dtype=None, copy=None):
        # always a defensive copy: a live view would alias internal storage
        # that _grow() reallocates, so callers would see stale or mutating
        # data depending on the buffer's current capacity
        v = self.view()
        return v.astype(dtype) if dtype is not None else v.copy()

    def tolist(self):
        return [int(x) for x in self.view()]

    def copy(self) -> "WordBuffer":
        # preserve capacity: a fixed-capacity clone must keep the original
        # headroom, not shrink to the current length
        out = WordBuffer(capacity=max(len(self._arr), 8), fixed=self._fixed)
        out._arr[: self._len] = self._arr[: self._len]
        out._len = self._len
        return out

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        return iter(self.tolist())

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self.view()[idx]
        return int(self.view()[idx])

    def __add__(self, other):
        return self.tolist() + list(other)

    def __radd__(self, other):
        return list(other) + self.tolist()

    def __eq__(self, other):
        if isinstance(other, WordBuffer):
            return np.array_equal(self.view(), other.view())
        try:
            return self.tolist() == list(other)
        except TypeError:
            return NotImplemented


class CallbackSink:
    """Write backend forwarding every word to ``fn(word)``; never stores the
    bulk (backends.rs:1824-1861).  Read operations are unsupported -- a
    coder writing here cannot be interleaved-decoded or seeked."""

    __slots__ = ("_fn", "_len")

    def __init__(self, fn: Callable[[int], None]):
        self._fn = fn
        self._len = 0

    def append(self, word: int) -> None:
        self._fn(int(word))
        self._len += 1

    def extend(self, words) -> None:
        for w in np.asarray(words, dtype=np.uint64).reshape(-1):
            self._fn(int(w))
            self._len += 1

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def pop(self):
        raise TypeError("CallbackSink is write-only")

    def __iter__(self):
        raise TypeError("CallbackSink is write-only")


class StackIterReader:
    """Lazy stack-semantics read backend: ``pop()`` pulls the next word from
    a REVERSED iterator (last compressed word first), as the reference's
    iterator sources do for ANS decoding (backends.rs:1681-1754).
    Write operations are unsupported; ``len`` is unknown."""

    __slots__ = ("_it", "_peek")

    def __init__(self, reversed_words: Iterable[int]):
        self._it: Iterator[int] = iter(reversed_words)
        self._peek: Optional[int] = None
        self._advance()

    def _advance(self) -> None:
        try:
            self._peek = int(next(self._it))
        except StopIteration:
            self._peek = None

    def pop(self) -> int:
        if self._peek is None:
            raise IndexError("pop from exhausted iterator source")
        w = self._peek
        self._advance()
        return w

    def __bool__(self) -> bool:
        return self._peek is not None

    def append(self, word):
        raise TypeError("StackIterReader is read-only")

    def extend(self, words):
        raise TypeError("StackIterReader is read-only")


class QueueIterReader:
    """Lazy queue-semantics read source: indexing by a monotone cursor pulls
    words from a forward iterator on demand (memoized, so `seek` backward
    within the already-pulled prefix still works)."""

    __slots__ = ("_it", "_buf", "_done")

    def __init__(self, words: Iterable[int]):
        self._it = iter(words)
        self._buf: list = []
        self._done = False

    def _pull_to(self, n: int) -> None:
        while not self._done and len(self._buf) <= n:
            try:
                self._buf.append(int(next(self._it)))
            except StopIteration:
                self._done = True

    def __getitem__(self, idx: int) -> int:
        self._pull_to(idx)
        return self._buf[idx]

    def length_at_least(self, n: int) -> bool:
        self._pull_to(n - 1)
        return len(self._buf) >= n

    def __len__(self) -> int:
        # materializes; only used by diagnostics
        while not self._done:
            self._pull_to(len(self._buf) + 1024)
        return len(self._buf)
