"""Kernel 19, the TChain-16 decode, as the card runs it: two steps over the
whole grid (``csrc/tchain.cu``), each with a plain PyTorch version in
``constriction_tpu_torch/ops/tchain.py``:

- the head pass, ``tchain16_head_pass_plain``: every quantile's symbol,
  cum and prob (vectorised over all T * L quantiles, as the kernel's lanes
  search theirs ahead of the head chain), then each lane's u32 head
  through steps 0 .. T-1, a head at or above 2^16 flushing its low 16
  bits, the words and flags in reversed rows;
- pass B, the encoders' row-major compaction (``coder.compact_pass_plain``).

Composed, they are held byte for byte equal to the single-loop twin
(``tchain16_decode_plain``), the numpy oracle (``tchain_decode_host``) and
one interpret-mode call of the JAX package's Pallas decode
(``tchain.tchain_decode_pallas``), on planar 16-bit quantiles drawn by
numpy from a seed: K in {1, 2, 100, 1000, 60000} (60000 CDF words do not
fit beside the bucket table in shared memory on the card), L in {256,
768, 1024}, a step where no lane flushes and steps where every lane does.
The wrappers on CPU tensors run these plain steps.  Integer coding: the
tolerance is exact equality.
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

SHAPES = [(100, 256, 1), (100, 256, 9), (100, 1024, 4), (2, 768, 6),
          (1000, 256, 3), (60_000, 256, 2), (1, 768, 3)]


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=16)


def _cdf(K, seed):
    if K == 1:
        return np.array([0, 1 << 16], np.uint64)
    probs = np.random.RandomState(seed).dirichlet(np.full(K, 1.2))
    return ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 16).cdf.astype(np.uint64)


def _quantiles(L, T, seed):
    return np.random.RandomState(seed).randint(0, 1 << 16, size=L * T).astype(
        np.uint16)


def _composed(qw, cdf, cfg):
    """The two plain steps in turn: (symbols, stream, heads, flags)."""
    syms, words, flags, heads = tc.tchain16_head_pass_plain(qw, cdf, cfg)
    stream = coder.compact_pass_plain(words, flags)
    return syms, stream, heads, flags


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def _check(q, cdf_np, L):
    """The composed passes against the twin and the host oracle; returns
    the flags."""
    cfg = _cfg(L)
    qw = convert.quantiles16_to_torch(q, L)
    cdf = convert.cdf_to_torch(cdf_np)
    syms, stream, heads, flags = _composed(qw, cdf, cfg)
    _assert_equal((syms, stream, heads), tc.tchain16_decode_plain(qw, cdf, cfg))
    host = tc.tchain_decode_host(q, cdf_np, cfg)
    np.testing.assert_array_equal(syms.numpy(), host[0])
    np.testing.assert_array_equal(convert.u32_from_torch(stream), host[1])
    np.testing.assert_array_equal(convert.u32_from_torch(heads), host[2])
    assert int(flags.sum()) == stream.numel()
    return flags


@pytest.mark.parametrize("K,L,T", SHAPES)
def test_composed_passes_equal_twin_and_host(K, L, T):
    _check(_quantiles(L, T, seed=K + L + T), _cdf(K, seed=K), L)


def test_composed_passes_equal_pallas_interpret():
    L, T = 256, 3
    q, cdf_np = _quantiles(L, T, seed=19), _cdf(100, seed=19)
    syms, stream, heads, _ = _composed(
        convert.quantiles16_to_torch(q, L), convert.cdf_to_torch(cdf_np),
        _cfg(L))
    ref = ref_tc.tchain_decode_pallas(q, cdf_np, RefLaneConfig(L, 16, 32, 16),
                                      interpret=True)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(convert.u32_from_torch(stream),
                                  np.asarray(ref[1]))
    np.testing.assert_array_equal(convert.u32_from_torch(heads),
                                  np.asarray(ref[2]))


@pytest.mark.parametrize("L", [256, 1024])
def test_one_symbol_model_flushes_every_lane_at_every_step(L):
    """prob = 2^16 (held in 32 bits): every head 1 * 2^16 + q flushes at
    every step, step 0 included, and goes back to 1."""
    T = 4
    flags = _check(_quantiles(L, T, seed=L), _cdf(1, 0), L)
    assert bool(flags.all())


def test_steps_with_no_flush_and_with_every_lane_flushing():
    """Probabilities in [2^8, 2^15]: step 0 flushes no lane (1 * prob +
    (q - cum) < 2 prob <= 2^16), step 1 every lane (prob * prob >= 2^16)."""
    L, T = 256, 3
    cdf_np = np.array([0, 1 << 15, (1 << 15) + (1 << 14), (1 << 16) - 256,
                       1 << 16], np.uint64)
    flags = _check(_quantiles(L, T, seed=7), cdf_np, L)
    assert not bool(flags[T - 1].any())
    assert bool(flags[T - 2].all())


@pytest.mark.parametrize("L,T", [(256, 1), (768, 5)])
def test_wrappers_on_cpu_run_the_plain_steps(L, T):
    """The head pass wrapper on CPU tensors: the plain step, its flags
    packed as ballots; through ``coder.compact_pass`` its stream is the
    decode's; no kernel launch is counted."""
    cfg = _cfg(L)
    qw = convert.quantiles16_to_torch(_quantiles(L, T, seed=3 * L + T), L)
    cdf = convert.cdf_to_torch(_cdf(100, seed=L))
    before = dict(tc.LAUNCHES)
    syms, words, ballots, heads = tc.tchain16_head_pass(qw, cdf, cfg)
    assert ballots.dtype == torch.int32 and ballots.shape == (T, L // 32)
    assert heads.dtype == torch.int32
    stream = coder.compact_pass(words, ballots)
    _assert_equal((syms, stream, heads), tc.tchain16_decode(qw, cdf, cfg))
    assert tc.LAUNCHES == before


def test_empty_message():
    cdf = convert.cdf_to_torch(_cdf(100, seed=1))
    syms, words, ballots, heads = tc.tchain16_head_pass(
        torch.zeros(0, dtype=torch.int32), cdf, _cfg(256))
    assert syms.numel() == 0 and heads.dtype == torch.int32
    assert words.shape == (0, 256) and ballots.shape == (0, 8)
    assert bool((heads == 1).all())


def test_head_pass_argument_checks():
    cfg = _cfg(256)
    qw = convert.quantiles16_to_torch(_quantiles(256, 2, seed=5), 256)
    cdf = convert.cdf_to_torch(_cdf(100, seed=5))
    with pytest.raises(ValueError, match="multiple of 256"):
        tc.tchain16_head_pass(qw, cdf, _cfg(128))
    with pytest.raises(ValueError, match="qw must hold whole steps"):
        tc.tchain16_head_pass(qw[:-1], cdf, cfg)
    with pytest.raises(ValueError, match="rise from 0 to 2"):
        tc.tchain16_head_pass(qw, cdf // 2, cfg)
    with pytest.raises(TypeError, match="qw must be torch.int32"):
        tc.tchain16_head_pass(qw.long(), cdf, cfg)
    with pytest.raises(TypeError, match="cdf must be torch.int64"):
        tc.tchain16_head_pass(qw, cdf.int(), cfg)
    with pytest.raises(ValueError, match="P=16"):
        tc.tchain16_head_pass(qw, cdf, LaneConfig(256, 32, 64, 24))
