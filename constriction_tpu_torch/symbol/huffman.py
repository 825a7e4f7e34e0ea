"""Huffman codebooks (the reference's src/symbol/huffman.rs).

Deterministic tree construction: a min-heap keyed by ``(weight, node_index)``
tuples -- the node index breaks ties, so the tree shape is reproducible for
equal probabilities (huffman.rs:69-86, 207-227).  Float probabilities keep
their input dtype (f32 sums stay f32), matching the reference's generic
``from_float_probabilities``.

- ``EncoderHuffmanTree``: parent-pointer array of size ``2n - 1``; an entry
  ``x`` encodes the parent at ``x >> 1`` and the child bit in the LSB; the
  root is 0.  Code words are emitted leaf -> root (suffix emission), which the
  stack bit coder then reverses (huffman.rs:128-157).
- ``DecoderHuffmanTree``: array of ``[left, right]`` child pairs for non-leaf
  nodes, root last; decode walks root -> leaf (huffman.rs:160-274).

JAX counterpart: ``constriction_tpu/symbol/huffman.py``.
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Optional

import numpy as np


class NanError(ValueError):
    pass


def _prepare_probs(probabilities) -> List:
    probs = np.asarray(probabilities)
    if probs.dtype not in (np.float32, np.float64):
        probs = probs.astype(np.float64)
    if np.any(np.isnan(probs)):
        raise NanError("NaN probability")
    return list(probs)


def _heap_merge(probabilities, on_merge: Callable[[int, int, int], None]) -> int:
    """Run the Huffman heap merge; calls on_merge(index0, index1, new_index)
    for every merge in deterministic order.  Returns num_symbols."""
    items = list(probabilities)
    if len(items) == 0:
        raise ValueError("need at least one symbol")
    heap = [(p, i) for i, p in enumerate(items)]
    heapq.heapify(heap)
    next_node_index = len(items)
    while len(heap) >= 2:
        prob0, index0 = heapq.heappop(heap)
        prob1, index1 = heapq.heappop(heap)
        heapq.heappush(heap, (prob0 + prob1, next_node_index))
        on_merge(index0, index1, next_node_index)
        next_node_index += 1
    return len(items)


class EncoderHuffmanTree:
    def __init__(self, probabilities):
        probs = _prepare_probs(probabilities)
        self.nodes = [0] * (2 * len(probs) - 1)

        def on_merge(i0, i1, new):
            self.nodes[i0] = new << 1
            self.nodes[i1] = (new << 1) | 1

        _heap_merge(probs, on_merge)

    @classmethod
    def from_probabilities(cls, probabilities):
        """Integer/exact probabilities (no NaN check needed)."""
        self = cls.__new__(cls)
        probs = list(probabilities)
        self.nodes = [0] * (2 * len(probs) - 1)

        def on_merge(i0, i1, new):
            self.nodes[i0] = new << 1
            self.nodes[i1] = (new << 1) | 1

        _heap_merge(probs, on_merge)
        return self

    @property
    def num_symbols(self) -> int:
        return len(self.nodes) // 2 + 1

    def encode_symbol_suffix(self, symbol: int, emit: Callable[[bool], None]) -> None:
        """Emit the code word bits leaf -> root (huffman.rs:128-157)."""
        if not 0 <= symbol < self.num_symbols:
            raise ValueError("symbol out of range")
        node_index = symbol
        while True:
            node = self.nodes[node_index]
            if node == 0:
                break
            emit(node & 1 != 0)
            node_index = node >> 1

    def encode_symbol_prefix(self, symbol: int, emit: Callable[[bool], None]) -> None:
        bits: List[bool] = []
        self.encode_symbol_suffix(symbol, bits.append)
        for bit in reversed(bits):
            emit(bit)


class DecoderHuffmanTree:
    def __init__(self, probabilities):
        probs = _prepare_probs(probabilities)
        self.nodes: List[List[int]] = []

        def on_merge(i0, i1, new):
            self.nodes.append([i0, i1])

        _heap_merge(probs, on_merge)

    @classmethod
    def from_probabilities(cls, probabilities):
        self = cls.__new__(cls)
        self.nodes = []

        def on_merge(i0, i1, new):
            self.nodes.append([i0, i1])

        _heap_merge(list(probabilities), on_merge)
        return self

    @property
    def num_symbols(self) -> int:
        return len(self.nodes) + 1

    def decode_symbol(self, read_bit: Callable[[], Optional[bool]]) -> int:
        num_nodes = len(self.nodes)
        num_symbols = num_nodes + 1
        node_index = 2 * num_nodes  # root
        while node_index >= num_symbols:
            bit = read_bit()
            if bit is None:
                raise ValueError("Ran out of bits in compressed data.")
            node_index = self.nodes[node_index - num_symbols][1 if bit else 0]
        return node_index
