"""Kernel 24, the TChain-24 encode, as the card runs it: the cluster step of
``csrc/tchain.cu`` (``cluster_tchain_encode_kernel``), whose arithmetic is
held here on the CPU:

- the division of a u64 head by the symbol's probability as a
  multiply-high by its ``DivisionRecord`` (``coder64.division_magic`` /
  ``divide_by_magic``), exact against integer division on the heads a
  TChain-24 encoder divides (below ``prob << 40`` after a refill, and any
  u64), at edge heads and probabilities 1, 2^24, primes and powers of two;
- a step-form model of the kernel (numpy): each step's refills ranked as
  the kernel ranks them, by 32-lane ballots (the exclusive sum of the
  lower groups' popcounts and the popcount below the lane), the division
  by magic, held equal to the plain twin (``tchain24_encode_plain``), the
  numpy oracle (``tchain24_encode_host``) and one interpret-mode call of
  the JAX package's Pallas encoder (``tchain.tchain24_encode_pallas``),
  the one-symbol model included;
- the lane cap: on a CUDA device ``tchain24_encode`` takes at most
  ``coder.MAX_DECODE_LANES`` lanes (a faked device here), CPU tensors any.

Integer coding: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import tchain as ref_tc
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder, coder64
from constriction_tpu_torch.ops import tchain as tc
from constriction_tpu_torch.ops.interleaved import LaneConfig

_M32 = np.uint64(0xFFFFFFFF)
PROBS = [1, 2, 3, 7, 100, 4093, 65521, 65536, 1 << 23, (1 << 24) - 3,
         1 << 24, 16777213]  # powers of two, primes, the extremes


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=24)


def _cdf(K, seed):
    if K == 1:
        return np.array([0, 1 << 24], np.uint64)
    probs = np.random.RandomState(seed).dirichlet(np.full(K, 1.2))
    return ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24).cdf.astype(np.uint64)


# --- the multiply-high division ----------------------------------------------


@pytest.mark.parametrize("prob", PROBS)
def test_division_by_magic_is_exact_on_tchain24_heads(prob):
    magic, l = coder64.division_magic(prob)
    assert 0 < magic < 1 << 64
    top = prob << 40  # a refilled head stays below it
    heads = {0, 1, 255, 256, prob - 1, prob, prob + 1, (prob << 8) - 1,
             prob << 8, (1 << 32) - 1, 1 << 32, (1 << 40) - 1, 1 << 40,
             top - 1, top - prob, (1 << 64) - 1, (1 << 64) - prob}
    rng = np.random.RandomState(prob & 0xFFFF)
    heads |= {int(x) for x in rng.randint(0, 1 << 62, size=200,
                                          dtype=np.int64)}
    heads |= {(int(w) << 32) | int(v) for w, v in zip(
        rng.randint(0, prob << 8 if prob < 1 << 24 else 1 << 32, size=200,
                    dtype=np.int64),
        rng.randint(0, 1 << 32, size=200, dtype=np.int64))}
    for x in sorted(h for h in heads if 0 <= h < 1 << 64):
        assert coder64.divide_by_magic(x, magic, l) == x // prob, (x, prob)


# --- the step form of the kernel ---------------------------------------------


def _mulhi64(a, b):
    """The high 64 bits of a * b for u64 arrays (``__umul64hi``)."""
    a0, a1 = a & _M32, a >> np.uint64(32)
    b0, b1 = b & _M32, b >> np.uint64(32)
    p01, p10 = a0 * b1, a1 * b0
    mid = (a0 * b0 >> np.uint64(32)) + (p01 & _M32) + (p10 & _M32)
    return (a1 * b1 + (p01 >> np.uint64(32)) + (p10 >> np.uint64(32))
            + (mid >> np.uint64(32)))


def _records(cdf):
    """Each symbol's (cum, prob, magic, l), as division_records_kernel
    builds them."""
    cum = cdf[:-1]
    prob = cdf[1:] - cum
    pairs = [coder64.division_magic(int(p)) if p else (0, 0) for p in prob]
    magic = np.array([m for m, _ in pairs], dtype=np.uint64)
    shift = np.array([s for _, s in pairs], dtype=np.uint64)
    return cum, prob, magic, shift


def _step_form(symbols, remainders, heads, cdf, L):
    """The cluster kernel's steps in numpy: refill ranks from 32-lane
    ballots, the word h << 32 | w, q = cum + h - (h / prob) prob with the
    quotient a multiply-high."""
    T = len(symbols) // L
    cum, prob, magic, shift = _records(cdf)
    words = np.asarray(remainders, dtype=np.uint64)
    h = np.asarray(heads, dtype=np.uint64).copy()
    q = np.empty(T * L, dtype=np.uint32)
    base = 0
    one = np.uint64(1)
    for t in range(T - 1, -1, -1):
        s = np.asarray(symbols[t * L:(t + 1) * L], dtype=np.int64)
        refill = h < (prob[s] << np.uint64(8))
        ballots = refill.reshape(L // 32, 32).astype(np.int64)
        counts = ballots.sum(1)
        rank = ((np.cumsum(counts) - counts)[:, None]
                + np.cumsum(ballots, 1) - ballots).reshape(L)
        at = base + rank
        word = np.zeros(L, dtype=np.uint64)
        ok = refill & (at < len(words))
        word[ok] = words[at[ok]]
        h = np.where(refill, (h << np.uint64(32)) | word, h)
        m, sh = magic[s], shift[s]
        up = np.minimum(sh, one)
        tt = _mulhi64(m, h)
        quot = (tt + ((h - tt) >> up)) >> (sh - up)
        q[t * L:(t + 1) * L] = (cum[s] + (h - quot * prob[s])).astype(
            np.uint32)
        h = quot
        base += int(counts.sum())
    return q, h


def _message(K, L, T, seed):
    """A decoded message: (cdf, quantiles, symbols, remainders, heads)."""
    cdf = _cdf(K, seed)
    q = np.random.RandomState(seed).randint(0, 1 << 24, size=L * T).astype(
        np.uint32)
    syms, rem, heads = tc.tchain24_decode_host(q, cdf, _cfg(L))
    return cdf, q, syms, rem, heads


def _twin(syms, rem, heads, cdf, L):
    q, h = tc.tchain24_encode_plain(
        torch.from_numpy(syms), convert.u32_to_torch(rem),
        convert.u64_to_torch(heads), convert.cdf_to_torch(cdf), _cfg(L))
    return convert.u32_from_torch(q), convert.u64_from_torch(h)


@pytest.mark.parametrize("K,L,T", [(100, 128, 6), (100, 1024, 4),
                                   (1, 256, 3), (2, 384, 5), (1000, 512, 3),
                                   (40, 2048, 2)])
def test_step_form_equals_twin_and_host_oracle(K, L, T):
    cdf, q, syms, rem, heads = _message(K, L, T, seed=K + L + T)
    got = _step_form(syms, rem, heads, cdf, L)
    np.testing.assert_array_equal(got[0], q)
    assert np.all(got[1] == 256)
    for want in (tc.tchain24_encode_host(syms, rem, heads, cdf, _cfg(L)),
                 _twin(syms, rem, heads, cdf, L)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("K", [1, 100])
def test_step_form_on_truncated_remainders_and_any_heads(K):
    """Reads past the stream's end give zero words; heads from anywhere in
    u64 divide exactly."""
    L, T = 256, 4
    cdf, _, syms, rem, heads = _message(K, L, T, seed=K)
    cut = rem[: len(rem) // 2]
    rng = np.random.RandomState(K)
    wild = heads.copy()
    wild[:64] = rng.randint(0, 1 << 63, size=64, dtype=np.int64).astype(
        np.uint64) << np.uint64(1)
    for r, h in ((cut, heads), (rem, wild), (np.zeros(0, np.uint32), heads)):
        got = _step_form(syms, r, h, cdf, L)
        want = tc.tchain24_encode_host(syms, r, h, cdf, _cfg(L))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        twin = _twin(syms, r, h, cdf, L)
        np.testing.assert_array_equal(got[0], twin[0])
        np.testing.assert_array_equal(got[1], twin[1])


def test_step_form_equals_the_pallas_encoder_in_interpret_mode():
    L, T = 128, 3
    cdf, q, syms, rem, heads = _message(100, L, T, seed=24)
    got = _step_form(syms, rem, heads, cdf, L)
    ref = ref_tc.tchain24_encode_pallas(syms, rem, heads, cdf,
                                        RefLaneConfig(L, 32, 64, 24))
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0], q)


# --- the wrappers ------------------------------------------------------------


def _tensors(L, T):
    cdf, _, syms, rem, heads = _message(100, L, T, seed=L)
    return (torch.from_numpy(syms), convert.u32_to_torch(rem),
            convert.u64_to_torch(heads), convert.cdf_to_torch(cdf))


def test_lane_cap_on_a_cuda_device(monkeypatch):
    """Past the cluster's reach a CUDA device raises ValueError naming
    num_lanes, before any launch; a CPU tensor runs the twin at any L."""
    L = coder.MAX_DECODE_LANES + 128
    args = _tensors(L, 1)
    before = dict(tc.LAUNCHES)
    q, h = tc.tchain24_encode(*args, _cfg(L))
    assert q.numel() == L and bool((h == 256).all())
    monkeypatch.setattr(tc, "_on_cuda", lambda device: True)
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain24_encode(*args, _cfg(L))
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain24_encode_cluster(*args, 16, _cfg(L))
    assert tc.LAUNCHES == before


def test_forced_cluster_needs_cuda_tensors_and_a_size():
    args = _tensors(256, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tc.tchain24_encode_cluster(*args, 4, _cfg(256))
    with pytest.raises(ValueError, match="multiple of 128"):
        tc.tchain24_encode_cluster(*_tensors(256, 2), 4, _cfg(96))
