"""Kernel 23, the TChain-24 decode, as the card runs it: two steps over the
whole grid (``csrc/tchain.cu``), each with a plain PyTorch version in
``constriction_tpu_torch/ops/tchain.py``:

- the head pass, ``tchain24_head_pass_plain``: every quantile's symbol,
  cum and prob (vectorised over all T * L quantiles, as the kernel's lanes
  search theirs ahead of the head chain), then each lane's u64 head
  through steps 0 .. T-1, a head at or above 2^40 flushing its low 32
  bits, the words and flags in reversed rows;
- pass B, the encoders' row-major compaction (``coder.compact_pass_plain``).

Composed, they are held byte for byte equal to the single-loop twin
(``tchain24_decode_plain``), the numpy oracle (``tchain24_decode_host``)
and one interpret-mode call of the JAX package's Pallas decode
(``tchain.tchain24_decode_pallas``), on quantiles drawn by numpy from a
seed: K in {1, 2, 100, 1000, 70000} (70000 CDF words do not fit in shared
memory on the card), L in {128, 384, 1024}, a step where no lane flushes
and steps where every lane does.  The wrappers on CPU tensors run these
plain steps.  Integer coding: the tolerance is exact equality.
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

SHAPES = [(100, 128, 1), (100, 128, 9), (100, 1024, 4), (2, 384, 6),
          (1000, 256, 3), (70_000, 128, 2)]


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=24)


def _cdf(K, seed, skew=1.2):
    if K == 1:
        return np.array([0, 1 << 24], np.uint64)
    probs = np.random.RandomState(seed).dirichlet(np.full(K, skew))
    return ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24).cdf.astype(np.uint64)


def _quantiles(L, T, seed):
    return np.random.RandomState(seed).randint(0, 1 << 24, size=L * T).astype(
        np.uint32)


def _composed(qt, cdf, cfg):
    """The two plain steps in turn: (symbols, stream, heads, flags)."""
    syms, words, flags, heads = tc.tchain24_head_pass_plain(qt, cdf, cfg)
    stream = coder.compact_pass_plain(words, flags)
    return syms, stream, heads, flags


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def _probs(q, cdf_np):
    """Each quantile's probability under the model."""
    sym = np.searchsorted(cdf_np, q, side="right") - 1
    return cdf_np[sym + 1] - cdf_np[sym]


def _check(q, cdf_np, L):
    """The composed passes against the twin and the host oracle; returns
    the flags."""
    cfg = _cfg(L)
    qt, cdf = convert.u32_to_torch(q), convert.cdf_to_torch(cdf_np)
    syms, stream, heads, flags = _composed(qt, cdf, cfg)
    _assert_equal((syms, stream, heads), tc.tchain24_decode_plain(qt, cdf, cfg))
    host = tc.tchain24_decode_host(q, cdf_np, cfg)
    np.testing.assert_array_equal(syms.numpy(), host[0])
    np.testing.assert_array_equal(convert.u32_from_torch(stream), host[1])
    np.testing.assert_array_equal(convert.u64_from_torch(heads), host[2])
    assert int(flags.sum()) == stream.numel()
    return flags


@pytest.mark.parametrize("K,L,T", SHAPES)
def test_composed_passes_equal_twin_and_host(K, L, T):
    _check(_quantiles(L, T, seed=K + L + T), _cdf(K, seed=K), L)


def test_composed_passes_equal_pallas_interpret():
    L, T = 128, 3
    q, cdf_np = _quantiles(L, T, seed=23), _cdf(100, seed=23)
    cfg = _cfg(L)
    syms, stream, heads, _ = _composed(
        convert.u32_to_torch(q), convert.cdf_to_torch(cdf_np), cfg)
    ref = ref_tc.tchain24_decode_pallas(q, cdf_np, RefLaneConfig(L, 32, 64, 24),
                                        interpret=True)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(convert.u32_from_torch(stream),
                                  np.asarray(ref[1]))
    np.testing.assert_array_equal(convert.u64_from_torch(heads),
                                  np.asarray(ref[2]))


@pytest.mark.parametrize("L", [128, 1024])
def test_one_symbol_model_flushes_every_lane_after_the_first_step(L):
    """prob = 2^24: no head flushes at step 0 (256 * 2^24 + q < 2^40), and
    every head flushes at each later step (rows T - 1 - t of the reversed
    flags)."""
    T = 4
    flags = _check(_quantiles(L, T, seed=L), _cdf(1, 0), L)
    assert not bool(flags[T - 1].any())
    assert bool(flags[:T - 1].all())


def test_steps_with_no_flush_and_with_every_lane_flushing():
    """Quantiles in symbols of prob above 2^17 only: step 0 flushes no
    lane, step 1 every lane (256 * 2^17 * 2^17 >= 2^40)."""
    L, T = 256, 3
    cdf_np = np.array([0, 1 << 20, 1 << 22, (1 << 22) + 100, 1 << 24],
                      np.uint64)
    rng = np.random.RandomState(5)
    q = np.where(rng.rand(L * T) < 0.5,
                 rng.randint(0, 1 << 20, size=L * T),
                 rng.randint((1 << 22) + 100, 1 << 24, size=L * T)).astype(
        np.uint32)
    flags = _check(q, cdf_np, L)
    assert bool((_probs(q, cdf_np) > 1 << 17).all())
    assert not bool(flags[T - 1].any())
    assert bool(flags[T - 2].all())


@pytest.mark.parametrize("L,T", [(128, 1), (384, 5)])
def test_wrappers_on_cpu_run_the_plain_steps(L, T):
    """The head pass wrapper on CPU tensors: the plain step, its flags
    packed as ballots; through ``coder.compact_pass`` its stream is the
    decode's; no kernel launch is counted."""
    cfg = _cfg(L)
    qt = convert.u32_to_torch(_quantiles(L, T, seed=3 * L + T))
    cdf = convert.cdf_to_torch(_cdf(100, seed=L))
    before = dict(tc.LAUNCHES)
    syms, words, ballots, heads = tc.tchain24_head_pass(qt, cdf, cfg)
    assert ballots.dtype == torch.int32 and ballots.shape == (T, L // 32)
    assert heads.dtype == torch.int64
    stream = coder.compact_pass(words, ballots)
    _assert_equal((syms, stream, heads), tc.tchain24_decode(qt, cdf, cfg))
    assert tc.LAUNCHES == before


def test_empty_message():
    cdf = convert.cdf_to_torch(_cdf(100, seed=1))
    syms, words, ballots, heads = tc.tchain24_head_pass(
        torch.zeros(0, dtype=torch.int32), cdf, _cfg(128))
    assert syms.numel() == 0 and heads.dtype == torch.int64
    assert words.shape == (0, 128) and ballots.shape == (0, 4)
    assert bool((heads == 256).all())


def test_head_pass_argument_checks():
    cfg = _cfg(128)
    qt = convert.u32_to_torch(_quantiles(128, 2, seed=5))
    cdf = convert.cdf_to_torch(_cdf(100, seed=5))
    with pytest.raises(ValueError, match="multiple of 128"):
        tc.tchain24_head_pass(qt, cdf, _cfg(64))
    with pytest.raises(ValueError, match="q must hold whole steps"):
        tc.tchain24_head_pass(qt[:-1], cdf, cfg)
    with pytest.raises(ValueError, match="24-bit"):
        tc.tchain24_head_pass(qt | (1 << 24), cdf, cfg)
    with pytest.raises(ValueError, match="rise from 0 to 2"):
        tc.tchain24_head_pass(qt, cdf // 2, cfg)
    with pytest.raises(TypeError, match="q must be torch.int32"):
        tc.tchain24_head_pass(qt.long(), cdf, cfg)
    with pytest.raises(TypeError, match="cdf must be torch.int64"):
        tc.tchain24_head_pass(qt, cdf.int(), cfg)
    with pytest.raises(ValueError, match="P=24"):
        tc.tchain24_head_pass(qt, cdf, LaneConfig(128, 16, 32, 16))
