"""Kernel 20, the TChain-16 encode, as the card runs it: kernel 24's cluster
step of ``csrc/tchain.cu`` (``cluster_tchain_encode_kernel``) at W=16,
S=32, P=16, whose arithmetic is held here on the CPU:

- the division of a u32 head by the symbol's probability as a
  multiply-high by its ``DivisionRecord32`` (``coder.division_magic32`` /
  ``divide_by_magic32``), exact against integer division on the heads a
  TChain-16 encoder divides (below ``prob << 16`` after a refill, and any
  u32), at edge heads and probabilities 1, 2^16, primes and powers of two;
- a step-form model of the kernel (numpy): each step's refills ranked as
  the kernel ranks them, by 32-lane ballots (the exclusive sum of the
  lower groups' popcounts and the popcount below the lane), a refill word
  keeping its low 16 bits, the division by magic, the quantiles stored as
  planar 16-bit halves; held equal to the plain twin
  (``tchain16_encode_plain``), the numpy oracle (``tchain_encode_host``)
  and one interpret-mode call of the JAX package's Pallas encoder
  (``tchain.tchain_encode_pallas``), the one-symbol model (prob = 2^16)
  and a CDF of 30000 symbols (whose 240 KB of records stay in device
  memory on the card) included;
- the lane cap: on a CUDA device ``tchain16_encode`` takes at most
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
from constriction_tpu_torch.ops import coder
from constriction_tpu_torch.ops import tchain as tc
from constriction_tpu_torch.ops.interleaved import LaneConfig

PROBS = [1, 2, 3, 7, 100, 251, 4093, 32768, 32771, 65521, 65535, 1 << 16]


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=16)


def _cdf(K, seed):
    if K == 1:
        return np.array([0, 1 << 16], np.uint64)
    probs = np.random.RandomState(seed).dirichlet(np.full(K, 1.2))
    return ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 16).cdf.astype(np.uint64)


# --- the multiply-high division ----------------------------------------------


@pytest.mark.parametrize("prob", PROBS)
def test_division_by_magic32_is_exact_on_tchain16_heads(prob):
    magic, l = coder.division_magic32(prob)
    assert 0 < magic < 1 << 32
    top = prob << 16  # a refilled head stays below it
    heads = {0, 1, prob - 1, prob, prob + 1, (1 << 16) - 1, 1 << 16,
             top - 1, top - prob, (1 << 32) - 1, (1 << 32) - prob}
    rng = np.random.RandomState(prob)
    heads |= {int(x) for x in rng.randint(0, top, size=300, dtype=np.int64)}
    heads |= {int(x) for x in rng.randint(0, 1 << 32, size=300,
                                          dtype=np.int64)}
    x = np.array(sorted(h for h in heads if 0 <= h < 1 << 32), np.uint64)
    got = coder.divide_by_magic32(x, np.uint64(magic), np.uint64(l))
    np.testing.assert_array_equal(got, x // np.uint64(prob))


# --- the step form of the kernel ---------------------------------------------


def _records(cdf):
    """Each symbol's (cum, prob, magic, l), as division_records_kernel
    builds its DivisionRecord32."""
    cum = cdf[:-1]
    prob = cdf[1:] - cum
    pairs = [coder.division_magic32(int(p)) if p else (0, 0) for p in prob]
    magic = np.array([m for m, _ in pairs], dtype=np.uint64)
    shift = np.array([s for _, s in pairs], dtype=np.uint64)
    return cum, prob, magic, shift


def _planar_half(L):
    """The u16 half of a step's L/2 words that holds each lane's quantile
    (``PlanarStore<32>``)."""
    lanes = np.arange(L)
    return np.where(lanes < L // 2, 2 * lanes, 2 * (lanes - L // 2) + 1)


def _step_form(symbols, remainders, heads, cdf, L):
    """The cluster kernel's steps in numpy: refill ranks from 32-lane
    ballots, the head h << 16 | (w & 0xFFFF), q = cum + h - (h / prob)
    prob with the quotient a 32-bit multiply-high, each quantile into its
    planar half.  Returns (planar words u32[T * L/2], heads u32[L])."""
    T = len(symbols) // L
    cum, prob, magic, shift = _records(cdf)
    words = np.asarray(remainders, dtype=np.uint64)
    h = np.asarray(heads, dtype=np.uint64).copy()
    halves = np.zeros(T * L, dtype=np.uint16)
    where = _planar_half(L)
    base = 0
    for t in range(T - 1, -1, -1):
        s = np.asarray(symbols[t * L:(t + 1) * L], dtype=np.int64)
        refill = h < prob[s]
        ballots = refill.reshape(L // 32, 32).astype(np.int64)
        counts = ballots.sum(1)
        rank = ((np.cumsum(counts) - counts)[:, None]
                + np.cumsum(ballots, 1) - ballots).reshape(L)
        at = base + rank
        word = np.zeros(L, dtype=np.uint64)
        ok = refill & (at < len(words))
        word[ok] = words[at[ok]] & np.uint64(0xFFFF)
        h = np.where(refill, (h << np.uint64(16)) | word, h)
        assert bool((h < np.uint64(1 << 32)).all())
        quot = coder.divide_by_magic32(h, magic[s], shift[s])
        halves[t * L + where] = (cum[s] + (h - quot * prob[s])).astype(
            np.uint16)
        h = quot
        base += int(counts.sum())
    return halves.view(np.uint32), h.astype(np.uint32)


def _message(K, L, T, seed):
    """A decoded message: (cdf, quantiles, symbols, remainders, heads)."""
    cdf = _cdf(K, seed)
    q = np.random.RandomState(seed).randint(0, 1 << 16, size=L * T).astype(
        np.uint16)
    syms, rem, heads = tc.tchain_decode_host(q, cdf, _cfg(L))
    return cdf, q, syms, rem, heads


def _twin(syms, rem, heads, cdf, L):
    qw, h = tc.tchain16_encode_plain(
        torch.from_numpy(syms), convert.u32_to_torch(rem),
        convert.u32_to_torch(heads), convert.cdf_to_torch(cdf), _cfg(L))
    return convert.u32_from_torch(qw), convert.u32_from_torch(h)


def _planar(q, L):
    return tc.pack_quantiles(q, L).reshape(-1)


@pytest.mark.parametrize("K,L,T", [(100, 256, 6), (100, 1024, 4),
                                   (1, 256, 3), (2, 768, 5), (1000, 512, 3),
                                   (30_000, 256, 2), (40, 2048, 2)])
def test_step_form_equals_twin_and_host_oracle(K, L, T):
    cdf, q, syms, rem, heads = _message(K, L, T, seed=K + L + T)
    got = _step_form(syms, rem, heads, cdf, L)
    np.testing.assert_array_equal(got[0], _planar(q, L))
    assert np.all(got[1] == 1)
    np.testing.assert_array_equal(got[0], _twin(syms, rem, heads, cdf, L)[0])
    q_h, h_h = tc.tchain_encode_host(syms, rem, heads, cdf, _cfg(L))
    np.testing.assert_array_equal(got[0], _planar(q_h, L))
    np.testing.assert_array_equal(got[1], h_h)


def test_one_symbol_model_refills_every_lane_at_every_step():
    """prob = 2^16: the decode flushes every lane at every step (1 * 2^16
    + q >= 2^16), so the encode refills every lane at every step (a head of
    1 is below prob), and the quotient of the 2^16 record is a shift."""
    L, T = 256, 4
    cdf, q, syms, rem, heads = _message(1, L, T, seed=1)
    assert len(rem) == L * T and np.all(heads == 1)
    got = _step_form(syms, rem, heads, cdf, L)
    np.testing.assert_array_equal(got[0], _planar(q, L))
    np.testing.assert_array_equal(got[0], _twin(syms, rem, heads, cdf, L)[0])


def test_steps_with_no_refill_and_with_every_lane_refilling():
    """Heads of 0xFFFF refill no lane at the first step coded (T - 1: every
    prob of this model is below 2^16), heads of 0 every lane there; the
    remainders need not come from a decode."""
    L, T = 256, 3
    cdf = _cdf(100, seed=9)
    rng = np.random.RandomState(9)
    syms = rng.randint(0, 100, size=L * T).astype(np.int32)
    prob = (cdf[1:] - cdf[:-1])[syms]
    syms[prob == 0] = int(np.argmax(cdf[1:] - cdf[:-1]))
    assert bool((cdf[1:] - cdf[:-1] < 1 << 16).all())
    rem = rng.randint(0, 1 << 16, size=4 * L * T).astype(np.uint32)
    for h0 in (0, 0xFFFF):
        heads = np.full(L, h0, np.uint32)
        got = _step_form(syms, rem, heads, cdf, L)
        twin = _twin(syms, rem, heads, cdf, L)
        np.testing.assert_array_equal(got[0], twin[0])
        np.testing.assert_array_equal(got[1], twin[1])
        q_h, h_h = tc.tchain_encode_host(syms, rem, heads, cdf, _cfg(L))
        np.testing.assert_array_equal(got[0], _planar(q_h, L))
        np.testing.assert_array_equal(got[1], h_h)


@pytest.mark.parametrize("K", [1, 100])
def test_step_form_on_truncated_and_wide_remainders(K):
    """Reads past the stream's end give zero words; a word's bits above 16
    are dropped, as the Pallas encoder and the twin drop them."""
    L, T = 256, 4
    cdf, _, syms, rem, heads = _message(K, L, T, seed=K)
    cut = rem[: len(rem) // 2]
    wide = rem | np.uint32(0xABCD0000)
    for r in (cut, np.zeros(0, np.uint32), wide):
        got = _step_form(syms, r, heads, cdf, L)
        twin = _twin(syms, r, heads, cdf, L)
        np.testing.assert_array_equal(got[0], twin[0])
        np.testing.assert_array_equal(got[1], twin[1])
    q_h, h_h = tc.tchain_encode_host(syms, cut, heads, cdf, _cfg(L))
    got = _step_form(syms, cut, heads, cdf, L)
    np.testing.assert_array_equal(got[0], _planar(q_h, L))
    np.testing.assert_array_equal(got[1], h_h)


def test_step_form_equals_the_pallas_encoder_in_interpret_mode():
    L, T = 256, 3
    cdf, q, syms, rem, heads = _message(100, L, T, seed=20)
    wide = rem | np.uint32(0x12340000)
    got = _step_form(syms, wide, heads, cdf, L)
    ref = ref_tc.tchain_encode_pallas(syms, wide, heads, cdf,
                                      RefLaneConfig(L, 16, 32, 16),
                                      interpret=True)
    np.testing.assert_array_equal(got[0], _planar(np.asarray(ref[0]), L))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0], _planar(q, L))


# --- the wrappers ------------------------------------------------------------


def _tensors(L, T):
    cdf, _, syms, rem, heads = _message(100, L, T, seed=L)
    return (torch.from_numpy(syms), convert.u32_to_torch(rem),
            convert.u32_to_torch(heads), convert.cdf_to_torch(cdf))


def test_lane_cap_on_a_cuda_device(monkeypatch):
    """Past the cluster's reach a CUDA device raises ValueError naming
    num_lanes, before any launch; a CPU tensor runs the twin at any L."""
    L = coder.MAX_DECODE_LANES + 256
    args = _tensors(L, 1)
    before = dict(tc.LAUNCHES)
    qw, h = tc.tchain16_encode(*args, _cfg(L))
    assert qw.numel() == L // 2 and bool((h == 1).all())
    monkeypatch.setattr(tc, "_on_cuda", lambda device: True)
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain16_encode(*args, _cfg(L))
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain16_encode_cluster(*args, 16, _cfg(L))
    with pytest.raises(ValueError, match="cluster must be in 1 .. 16"):
        tc.tchain16_encode_cluster(*args, 17, _cfg(L))
    assert tc.LAUNCHES == before


def test_forced_cluster_needs_cuda_tensors_and_a_size():
    args = _tensors(256, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tc.tchain16_encode_cluster(*args, 4, _cfg(256))
    with pytest.raises(ValueError, match="multiple of 256"):
        tc.tchain16_encode_cluster(*args, 4, _cfg(128))
    with pytest.raises(ValueError, match="P=16"):
        tc.tchain16_encode_cluster(*args, 4, LaneConfig(256, 32, 64, 24))
