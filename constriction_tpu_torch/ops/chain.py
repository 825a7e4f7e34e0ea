"""The chain coder (bits-back): the exact scalar coder and the fast decode.

Two counterparts of the JAX package live here:

- :class:`ChainCoderCore`, the exact scalar chain coder of
  ``constriction_tpu/ops/chain.py``, bit-exact with the reference (its
  src/stream/chain.rs).  It keeps two word streams, ``compressed`` (read
  by the decoder, written by the encoder) and ``remainders`` (written by
  the decoder, read by the encoder), and two heads (chain.rs:230-258): the
  ``compressed`` head, a nonzero Word whose bits above the sentinel 1-bit
  are leftover bits of earlier reads (at most W-1 of them), and the
  ``remainders`` head, a State with ``2**(S - W - P) <= head < 2**(S -
  P)``.  Decoding pulls exactly P bits per symbol from the compressed
  stream (chain.rs:1060-1101) and pushes leftover information into the
  remainders head (chain.rs:1112-1119); encoding is the exact inverse
  (chain.rs:1140-1206).  Its bulk methods run the host codec
  (``ctpu_chain_decode_lookup``, ``ctpu_chain_encode_reverse``) under the
  JAX package's data gates, each with a ``*_plain`` Python loop beside it;
  a failed build of the codec raises RuntimeError.

- The fast decode, the counterpart of ``constriction_tpu/ops/chain_jax.py``
  (plain XLA there, no Pallas kernel; torch operations here).  Because
  each symbol consumes a fixed P bits, at the default preset (W=32, P=24)
  the quantiles follow a fixed cycle of four symbols per three words:

    q[4k+0] = w[3k+0] & 0xFFFFFF
    q[4k+1] = w[3k+1] & 0xFFFFFF
    q[4k+2] = w[3k+2] & 0xFFFFFF
    q[4k+3] = (w[3k]>>24)<<16 | (w[3k+1]>>24)<<8 | (w[3k+2]>>24)

  (w = compressed words in pop order), and each symbol depends only on its
  own quantile and model.  The decode is one quantile extraction and one
  batched search; the remainders the scalar chain coder would keep for a
  bits-back round trip are not produced.  The symbol search is
  ``searchsorted(cdf[1:K], q, side="right")``: the number of inner
  boundaries at or below q, which is what the JAX package's compare-sum
  counts (``chain_jax._searchsorted_sym``) for any sorted CDF.

Both raise the one :class:`OutOfCompressedData`, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import convert, native
from ..backends import WordBuffer
from ..models.base import EntropyModel, ModelFamily
from .ans import FractionalNumberOfWords, _dtype_for

_M24 = 0xFFFFFF


class OutOfCompressedData(ValueError, AssertionError):
    """The data holds fewer quantiles than the symbols asked for.  JAX
    counterpart: ``constriction_tpu.ops.chain.OutOfCompressedData`` (a
    ValueError and, as in the reference, an AssertionError: chain.rs:535)."""


class OutOfRemainders(ValueError, AssertionError):
    """The remainders ran out while encoding (the reference:
    AssertionError, chain.rs:525).  JAX counterpart:
    ``constriction_tpu.ops.chain.OutOfRemainders``."""


def head_init_words(data, word_bits=32, state_bits=64, precision=24) -> int:
    """The number of trailing words that seed the remainders head
    (``ChainCoderCore._init_heads`` for ``from_compressed``).  JAX
    counterpart: ``chain_jax.head_init_words``."""
    threshold = 1 << (state_bits - word_bits - precision)
    if len(data) == 0 or int(data[-1]) == 0:
        raise ValueError("Too little data provided, or data ends in zero word.")
    rem = int(data[-1])
    used = 1
    while rem < threshold:
        if used >= len(data):
            raise ValueError("Too little data provided.")
        rem = (rem << word_bits) | int(data[-1 - used])
        used += 1
    return used


def extract_quantiles(xp, pop_words, n: int):
    """Quantiles of the first ``n`` symbols from the compressed words in pop
    order (W=32, P=24); missing words read as zero.  ``xp`` is numpy (u32
    words) or torch (int64 tensors of u32 values).  JAX counterpart:
    ``chain_jax.extract_quantiles``."""
    groups = -(-n // 4)
    need = 3 * groups
    w = pop_words[:need]
    have = int(w.shape[0])
    if have < need:
        if xp is np:
            w = np.concatenate([w, np.zeros(need - have, w.dtype)])
        else:
            w = torch.nn.functional.pad(w, (0, need - have))
    w3 = w.reshape(groups, 3)
    a, b, c = w3[:, 0], w3[:, 1], w3[:, 2]
    q = xp.stack([
        a & _M24,
        b & _M24,
        c & _M24,
        ((a >> 24) << 16) | ((b >> 24) << 8) | (c >> 24),
    ], 1)
    return q.reshape(-1)[:n]


def _pop_words(data, n: int) -> np.ndarray:
    """The words below the head in pop order; raises if they hold fewer than
    ``n`` quantiles (the scalar chain coder raises there too)."""
    data = np.asarray(data, dtype=np.uint32)
    used = head_init_words(data)
    pop = data[:len(data) - used][::-1]
    if len(pop) < n - n // 4:
        raise OutOfCompressedData("out of compressed data")
    return pop


def _torch_device(xp, device):
    """The device of the torch path (``cuda._device``: a CUDA device without
    a card raises); None for numpy."""
    if xp is np:
        return None
    from ..cuda import _device

    return _device(device)


def chain_decode_iid(data, n: int, cdf, xp=torch, device="cuda"):
    """Decode ``n`` i.i.d. symbols from chain-coder data (default preset,
    ``ChainCoderCore.from_compressed`` framing) under the fixed-point
    ``cdf`` (P=24).  With ``xp=torch`` the work runs on ``device`` (the
    card by default; ``"cpu"`` for the CPU) and returns an int32 tensor
    there; with ``xp=np`` it is numpy throughout.  JAX counterpart:
    ``chain_jax.chain_decode_iid``."""
    device = _torch_device(xp, device)
    pop = _pop_words(data, n)
    cuts = np.asarray(cdf, dtype=np.int64)[1:-1]
    if xp is np:
        q = extract_quantiles(np, pop, n).astype(np.int64)
        return np.searchsorted(cuts, q, side="right").astype(np.int32)
    q = extract_quantiles(
        torch, convert.u32_values(convert.u32_to_torch(pop, device)), n)
    return torch.searchsorted(torch.from_numpy(cuts).to(device), q,
                              right=True).to(torch.int32)


def chain_decode_rows(data, rows, xp=torch, device="cuda"):
    """Decode with one categorical model per symbol: ``rows`` is [n, K+1]
    fixed-point CDFs (last column 2^24).  ``xp`` and ``device`` as in
    :func:`chain_decode_iid`.  JAX counterpart:
    ``chain_jax.chain_decode_rows``."""
    device = _torch_device(xp, device)
    rows = np.asarray(rows)
    n = rows.shape[0]
    pop = _pop_words(data, n)
    cuts = rows[:, 1:-1].astype(np.int64)
    if xp is np:
        q = extract_quantiles(np, pop, n).astype(np.int64)
        return (q[:, None] >= cuts).sum(1).astype(np.int32)
    q = extract_quantiles(
        torch, convert.u32_values(convert.u32_to_torch(pop, device)), n)
    return torch.searchsorted(torch.from_numpy(cuts).to(device),
                              q[:, None], right=True)[:, 0].to(torch.int32)


class ChainCoderCore:
    """The exact scalar chain coder over (W, S, P), default (32, 64, 24).
    JAX counterpart: ``constriction_tpu.ops.chain.ChainCoderCore``."""

    def __init__(self, word_bits: int = 32, state_bits: int = 64, precision: int = 24):
        assert precision <= word_bits and state_bits >= word_bits + precision
        self.W = word_bits
        self.S = state_bits
        self.P = precision
        self.word_mask = (1 << word_bits) - 1
        # pluggable word buffers (growable by default; pass fixed-capacity
        # WordBuffers via with_backends for preallocated encoding)
        self.compressed = WordBuffer()  # written by encoder, popped by decoder
        self.remainders = WordBuffer()  # written by decoder, popped by encoder
        self.head_compressed = 1
        self.head_remainders = 0

    # -- constructors (chain.rs:269-303, 326-377, 430-470) ----------------------

    @classmethod
    def with_backends(
        cls, compressed_backend=None, remainders_backend=None,
        word_bits: int = 32, state_bits: int = 64, precision: int = 24,
    ) -> "ChainCoderCore":
        """Fresh coder with caller-provided word buffers (fixed-capacity
        WordBuffers for preallocated encode, CallbackSinks, ...)."""
        self = cls(word_bits, state_bits, precision)
        if compressed_backend is not None:
            self.compressed = compressed_backend
        if remainders_backend is not None:
            self.remainders = remainders_backend
        return self

    @classmethod
    def _init_heads(cls, self: "ChainCoderCore", source, push_one: bool) -> None:
        threshold = 1 << (self.S - self.W - self.P)
        if push_one:
            rem = 1
        else:
            if not source or source[len(source) - 1] == 0:
                raise ValueError("Too little data provided, or data ends in zero word.")
            rem = source.pop()
        while rem < threshold:
            if not source:
                raise ValueError("Too little data provided.")
            rem = (rem << self.W) | source.pop()
        self.head_compressed = 1
        self.head_remainders = rem

    @classmethod
    def from_binary(
        cls, data: Sequence[int], word_bits: int = 32, state_bits: int = 64, precision: int = 24
    ) -> "ChainCoderCore":
        self = cls(word_bits, state_bits, precision)
        src = WordBuffer(np.asarray(data, dtype=np.uint64))
        cls._init_heads(self, src, push_one=True)
        self.compressed = src
        return self

    @classmethod
    def from_compressed(
        cls, data: Sequence[int], word_bits: int = 32, state_bits: int = 64, precision: int = 24
    ) -> "ChainCoderCore":
        self = cls(word_bits, state_bits, precision)
        src = WordBuffer(np.asarray(data, dtype=np.uint64))
        cls._init_heads(self, src, push_one=False)
        self.compressed = src
        return self

    @classmethod
    def from_remainders(
        cls, data: Sequence[int], word_bits: int = 32, state_bits: int = 64, precision: int = 24
    ) -> "ChainCoderCore":
        self = cls(word_bits, state_bits, precision)
        src = WordBuffer(np.asarray(data, dtype=np.uint64))
        if not src or src[len(src) - 1] == 0:
            raise ValueError("Too little data provided, or data ends in zero word.")
        compressed_head = src.pop()
        cls._init_heads(self, src, push_one=False)
        self.head_compressed = compressed_head
        self.remainders = src
        return self

    def clone(self) -> "ChainCoderCore":
        out = ChainCoderCore(self.W, self.S, self.P)
        out.compressed = (self.compressed.copy()
                          if isinstance(self.compressed, WordBuffer)
                          else list(self.compressed))
        out.remainders = (self.remainders.copy()
                          if isinstance(self.remainders, WordBuffer)
                          else list(self.remainders))
        out.head_compressed = self.head_compressed
        out.head_remainders = self.head_remainders
        return out

    # -- exporters (chain.rs:406-546) ---------------------------------------------

    def is_whole(self) -> bool:
        return self.head_compressed == 1

    def into_remainders(self) -> Tuple[np.ndarray, np.ndarray]:
        """(compressed_prefix, remainders_suffix); chain.rs:406-420."""
        remainders = list(self.remainders)
        rem = self.head_remainders
        while rem != 0:
            remainders.append(rem & self.word_mask)
            rem >>= self.W
        remainders.append(self.head_compressed)
        dt = _dtype_for(self.W)
        return np.asarray(self.compressed, dtype=dt), np.array(remainders, dtype=dt)

    def into_compressed(self) -> Tuple[np.ndarray, np.ndarray]:
        """(remainders_prefix, compressed_suffix); chain.rs:487-516."""
        if not self.is_whole():
            raise FractionalNumberOfWords(
                "Fractional number of words in compressed or remainders data."
            )
        compressed = list(self.compressed)
        rem = self.head_remainders
        while rem != 0:
            compressed.append(rem & self.word_mask)
            rem >>= self.W
        dt = _dtype_for(self.W)
        return np.asarray(self.remainders, dtype=dt), np.array(compressed, dtype=dt)

    def into_binary(self) -> Tuple[np.ndarray, np.ndarray]:
        """Like into_compressed but drops the virtual seal bit (chain.rs:516-546)."""
        rem_sig = self.head_remainders.bit_length() - 1
        if not self.is_whole() or rem_sig < 0 or rem_sig % self.W != 0:
            raise FractionalNumberOfWords(
                "Fractional number of words in compressed or remainders data."
            )
        compressed = list(self.compressed)
        rem = self.head_remainders
        while rem > 1:
            compressed.append(rem & self.word_mask)
            rem >>= self.W
        dt = _dtype_for(self.W)
        return np.asarray(self.remainders, dtype=dt), np.array(compressed, dtype=dt)

    # -- coding (chain.rs:1044-1206) --------------------------------------------------

    def decode_symbol(self, model: EntropyModel) -> int:
        W, P = self.W, self.P
        if P == W or self.head_compressed < (1 << P):
            if not self.compressed:
                raise OutOfCompressedData("out of compressed data")
            word = self.compressed.pop()
            if P != W:
                self.head_compressed = (
                    (self.head_compressed << (W - P)) | (word >> P)
                ) & self.word_mask
        else:
            word = self.head_compressed
            self.head_compressed >>= P

        quantile = word if P == W else word & ((1 << P) - 1)
        symbol, cum, prob = model.qf(quantile)
        remainder = quantile - cum
        self.head_remainders = self.head_remainders * prob + remainder
        if self.head_remainders >= 1 << (self.S - P):
            self.remainders.append(self.head_remainders & self.word_mask)
            self.head_remainders >>= W
        return symbol

    def encode_symbol(self, symbol: int, model: EntropyModel) -> None:
        cum, prob = model.ecp(int(symbol))
        self._encode_cp(cum, prob)

    def _encode_cp(self, cum: int, prob: int) -> None:
        W, P = self.W, self.P
        if self.head_remainders < (prob << (self.S - W - P)):
            if not self.remainders:
                raise OutOfRemainders("out of remainders data")
            self.head_remainders = (self.head_remainders << W) | self.remainders.pop()

        remainder = self.head_remainders % prob
        quantile = cum + remainder
        self.head_remainders //= prob

        if P != W and self.head_compressed < (1 << (W - P)):
            self.head_compressed = (self.head_compressed << P) | quantile
        else:
            if P == W:
                word = quantile
            else:
                word = ((self.head_compressed << P) | quantile) & self.word_mask
                self.head_compressed >>= W - P
            self.compressed.append(word)

    # -- batched ----------------------------------------------------------------------

    def decode_iid_symbols(self, amt: int, model: EntropyModel) -> np.ndarray:
        """``amt`` symbols under one model: ``ctpu_chain_decode_lookup``
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

    def _native_decode_iid(self, amt: int, model: EntropyModel):
        """The host codec's decode where the input allows it (64 or more
        symbols, W <= 32, S <= 64, a lookup-table model at the coder's P <=
        16, WordBuffer streams); None where it takes the loop."""
        if amt < 64 or self.W > 32 or self.S > 64 or model.precision != self.P:
            return None
        cdf = getattr(model, "cdf", None)
        lookup = getattr(model, "lookup", None)
        if lookup is None and hasattr(model, "inner"):
            lookup = getattr(model.inner, "lookup", None)
            if cdf is None:
                cdf = getattr(model.inner, "cdf", None)
        if not isinstance(cdf, np.ndarray) or not isinstance(lookup, np.ndarray):
            return None
        if self.P > 16:
            return None
        if not (isinstance(self.compressed, WordBuffer)
                and isinstance(self.remainders, WordBuffer)):
            return None
        lib = native.library()
        comp = np.ascontiguousarray(self.compressed.view(), dtype=np.uint32)
        rem = np.empty(len(self.remainders) + amt + 8, dtype=np.uint32)
        rem[: len(self.remainders)] = self.remainders.view()
        out = np.empty(amt, dtype=np.int32)
        st = native.ChainState(
            self.head_compressed, self.head_remainders, len(comp), len(self.remainders)
        )
        done = lib.ctpu_chain_decode_lookup(
            ctypes.byref(st), comp, rem, len(rem),
            np.ascontiguousarray(lookup, dtype=np.uint32),
            np.ascontiguousarray(cdf, dtype=np.uint32),
            out, amt, self.W, self.S, self.P,
        )
        # adopt the partial state BEFORE raising, so the coder ends where
        # the per-symbol Python path would (native codec writes back its
        # progress up to the failing symbol)
        self.compressed.set_content(comp[: st.compressed_len])
        self.remainders.set_content(rem[: st.remainders_len])
        self.head_compressed = st.head_compressed
        self.head_remainders = st.head_remainders
        if done < amt:
            raise OutOfCompressedData("out of compressed data")
        symbols = getattr(model, "symbols", None)
        if symbols is not None:
            return np.asarray(symbols)[out].astype(np.int64)
        return out.astype(np.int64)

    def decode_symbols(self, family: ModelFamily) -> np.ndarray:
        out = np.empty(family.size, dtype=np.int64)
        for i in range(family.size):
            out[i] = self.decode_symbol(family.concrete(i))
        return out

    def encode_iid_symbols_reverse(self, symbols: Sequence[int], model: EntropyModel) -> None:
        cums, probs = model.ecp_array(np.asarray(symbols))
        self.encode_reverse_tables(cums, probs)

    def encode_reverse_tables(self, cums: np.ndarray, probs: np.ndarray) -> None:
        """Encode per-symbol (cum, prob) tables in reverse order:
        ``ctpu_chain_encode_reverse`` for 64 or more symbols at W <= 32, S
        <= 64 with WordBuffer streams, else
        :meth:`encode_reverse_tables_plain`."""
        if not (len(cums) >= 64 and self.W <= 32 and self.S <= 64
                and isinstance(self.compressed, WordBuffer)
                and isinstance(self.remainders, WordBuffer)):
            self.encode_reverse_tables_plain(cums, probs)
            return
        lib = native.library()
        comp = np.empty(len(self.compressed) + len(cums) + 8, dtype=np.uint32)
        comp[: len(self.compressed)] = self.compressed.view()
        rem = np.ascontiguousarray(self.remainders.view(), dtype=np.uint32)
        st = native.ChainState(
            self.head_compressed, self.head_remainders,
            len(self.compressed), len(rem),
        )
        done = lib.ctpu_chain_encode_reverse(
            ctypes.byref(st), comp, len(comp), rem,
            np.ascontiguousarray(cums, dtype=np.uint32),
            np.ascontiguousarray(probs, dtype=np.uint32),
            len(cums), self.W, self.S, self.P,
        )
        if done < len(cums):
            raise OutOfRemainders("out of remainders data")
        self.compressed.set_content(comp[: st.compressed_len])
        self.remainders.set_content(rem[: st.remainders_len])
        self.head_compressed = st.head_compressed
        self.head_remainders = st.head_remainders

    def encode_reverse_tables_plain(self, cums: np.ndarray,
                                    probs: np.ndarray) -> None:
        """:meth:`encode_reverse_tables` as the per-symbol Python loop."""
        for i in range(len(cums) - 1, -1, -1):
            self._encode_cp(int(cums[i]), int(probs[i]))

    def encode_symbols_reverse(self, symbols: Sequence[int], family: ModelFamily) -> None:
        symbols = np.asarray(symbols)
        cums, probs = family.ecp_all(symbols)
        self.encode_reverse_tables(cums, probs)
