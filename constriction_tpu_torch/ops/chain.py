"""Chain-coder fast decode: symbols of the reference's chain-coder format
in one parallel pass.

The counterpart of ``constriction_tpu/ops/chain_jax.py`` (plain XLA there,
no Pallas kernel; torch operations here).  The chain coder reads exactly
``precision`` bits per symbol, so at the default preset (W=32, P=24) the
quantiles follow a fixed cycle of four symbols per three words:

    q[4k+0] = w[3k+0] & 0xFFFFFF
    q[4k+1] = w[3k+1] & 0xFFFFFF
    q[4k+2] = w[3k+2] & 0xFFFFFF
    q[4k+3] = (w[3k]>>24)<<16 | (w[3k+1]>>24)<<8 | (w[3k+2]>>24)

(w = compressed words in pop order), and each symbol depends only on its
own quantile and model.  The decode is one quantile extraction and one
batched search; the remainders the scalar chain coder would keep for a
bits-back round trip are not produced.

The symbol search is ``searchsorted(cdf[1:K], q, side="right")``: the
number of inner boundaries at or below q, which is what the JAX package's
compare-sum counts (``chain_jax._searchsorted_sym``) for any sorted CDF.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert

_M24 = 0xFFFFFF


class OutOfCompressedData(ValueError, AssertionError):
    """The data holds fewer quantiles than the symbols asked for.  JAX
    counterpart: ``constriction_tpu.ops.chain.OutOfCompressedData`` (a
    ValueError and, as in the reference, an AssertionError)."""


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


def chain_decode_iid(data, n: int, cdf, xp=torch, device="cpu"):
    """Decode ``n`` i.i.d. symbols from chain-coder data (default preset,
    ``ChainCoderCore.from_compressed`` framing) under the fixed-point
    ``cdf`` (P=24).  With ``xp=torch`` the work runs on ``device`` and
    returns an int32 tensor there; with ``xp=np`` it is numpy throughout.
    JAX counterpart: ``chain_jax.chain_decode_iid``."""
    pop = _pop_words(data, n)
    cuts = np.asarray(cdf, dtype=np.int64)[1:-1]
    if xp is np:
        q = extract_quantiles(np, pop, n).astype(np.int64)
        return np.searchsorted(cuts, q, side="right").astype(np.int32)
    q = extract_quantiles(
        torch, convert.u32_values(convert.u32_to_torch(pop, device)), n)
    return torch.searchsorted(torch.from_numpy(cuts).to(device), q,
                              right=True).to(torch.int32)


def chain_decode_rows(data, rows, xp=torch, device="cpu"):
    """Decode with one categorical model per symbol: ``rows`` is [n, K+1]
    fixed-point CDFs (last column 2^24).  ``xp`` and ``device`` as in
    :func:`chain_decode_iid`.  JAX counterpart:
    ``chain_jax.chain_decode_rows``."""
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
