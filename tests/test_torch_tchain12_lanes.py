"""Kernel 21, the TChain-12 family decode, as the card runs it: three steps
over the whole grid (``csrc/tchain.cu``), each with a plain PyTorch version
in ``constriction_tpu_torch/ops/tchain.py``:

- (a) ``tchain12_invert_pass_plain``: every quantile's symbol through the
  model's bisection, vectorised over all T * L symbols, and its record
  ``(q - cum) | prob << 16``;
- (b) ``tchain12_head_pass_plain``: each lane's head through steps 0 .. T-1
  on the records alone, the flushed words and flags in reversed rows;
- pass B, the encoders' row-major compaction (``coder.compact_pass_plain``).

Composed, they are held byte for byte equal to the single-loop twin
(``tchain12_family_decode_plain``), the numpy oracle
(``tchain12_family_decode_host``) and the JAX package's Pallas decode in
interpret mode (``tchain.tchain12_family_decode_pallas``, one call a
family), on inputs made by numpy from a seed: four families, L in {1024,
2048}, T in {1, 3, 8}, a step where no lane flushes and one where every
lane does.  The wrappers on CPU tensors run these plain steps.  Integer
coding: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import tchain as ref_tc
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import tchain as tc
from constriction_tpu_torch.ops.interleaved import LaneConfig

LO, HI = -100, 100
SHAPES = [(1024, 1), (1024, 3), (1024, 8), (2048, 1), (2048, 3), (2048, 8)]


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)


def _data(L, T, seed, sharp=False):
    """(quantiles, means, scales) drawn by numpy; ``sharp`` puts nearly all
    of every model's mass on symbol 0 and every quantile inside that
    symbol's interval."""
    rng = np.random.RandomState(seed)
    n = L * T
    if sharp:
        q = rng.randint(1024, 3072, size=n).astype(np.uint16)
        return q, np.zeros(n, np.float32), np.full(n, 0.01, np.float32)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.4 + np.abs(rng.randn(n)) * 4).astype(np.float32)
    return rng.randint(0, 1 << 12, size=n).astype(np.uint16), means, scales


def _tensors(q, means, scales, L):
    mt, st = convert.params_to_torch(means, scales, len(q), L)
    return convert.quantiles_to_torch(q, L), mt, st


def _composed(qw, mt, st, family, cfg):
    """The three plain steps in turn: (symbols, stream, heads, records,
    flags)."""
    syms, recs = tc.tchain12_invert_pass_plain(qw, mt, st, family, LO, HI,
                                               cfg)
    words, flags, heads = tc.tchain12_head_pass_plain(recs, cfg)
    stream = coder.compact_pass_plain(words, flags)
    return syms, stream, heads, recs, flags


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,T", SHAPES)
@pytest.mark.parametrize("family", fam.FAMILIES)
def test_composed_passes_equal_twin_and_host(family, L, T):
    cfg = _cfg(L)
    q, means, scales = _data(L, T, seed=L + T + len(family))
    qw, mt, st = _tensors(q, means, scales, L)
    syms, stream, heads, recs, flags = _composed(qw, mt, st, family, cfg)
    _assert_equal((syms, stream, heads),
                  tc.tchain12_family_decode_plain(qw, mt, st, family, LO, HI,
                                                  cfg))
    host = tc.tchain12_family_decode_host(q, means, scales, family, LO, HI,
                                          cfg)
    np.testing.assert_array_equal(syms.numpy(), host[0])
    np.testing.assert_array_equal(convert.u32_from_torch(stream), host[1])
    np.testing.assert_array_equal(convert.u32_from_torch(heads), host[2])
    # a record holds prob <= 2^12 above q - cum < prob
    r = recs.to(torch.int64)
    prob, rem = r >> 16, r & 0xFFFF
    assert bool(((prob >= 1) & (prob <= 1 << 12) & (rem < prob)).all())
    assert int(flags.sum()) == stream.numel()


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_composed_passes_equal_pallas_interpret(family):
    cfg = _cfg(1024)
    q, means, scales = _data(1024, 3, seed=7 * len(family))
    qw, mt, st = _tensors(q, means, scales, 1024)
    syms, stream, heads, _, _ = _composed(qw, mt, st, family, cfg)
    ref = ref_tc.tchain12_family_decode_pallas(
        q, means, scales, family, LO, HI,
        RefLaneConfig(1024, 16, 32, 12), interpret=True)
    np.testing.assert_array_equal(syms.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(convert.u32_from_torch(stream),
                                  np.asarray(ref[1]))
    np.testing.assert_array_equal(convert.u32_from_torch(heads),
                                  np.asarray(ref[2]))


@pytest.mark.parametrize("L", [1024, 2048])
@pytest.mark.parametrize("family", ["gaussian", "cauchy"])
def test_steps_with_no_flush_and_with_every_lane_flushing(family, L):
    """No head flushes at step 0 (16 prob + q - cum < 2^20 for every
    prob <= 2^12); with every quantile in a symbol of prob above 3500
    (3896 gaussian, 3585 cauchy) each head passes 2^20 at step 1, so every
    lane flushes there (rows T - 1 - t of the reversed flags)."""
    T = 3
    cfg = _cfg(L)
    q, means, scales = _data(L, T, seed=L, sharp=True)
    qw, mt, st = _tensors(q, means, scales, L)
    syms, stream, heads, recs, flags = _composed(qw, mt, st, family, cfg)
    assert bool(((recs.to(torch.int64) >> 16) > 3500).all())
    assert not bool(flags[T - 1].any())
    assert bool(flags[T - 2].all())
    _assert_equal((syms, stream, heads),
                  tc.tchain12_family_decode_plain(qw, mt, st, family, LO, HI,
                                                  cfg))
    host = tc.tchain12_family_decode_host(q, means, scales, family, LO, HI,
                                          cfg)
    np.testing.assert_array_equal(convert.u32_from_torch(stream), host[1])
    np.testing.assert_array_equal(convert.u32_from_torch(heads), host[2])


@pytest.mark.parametrize("L,T", [(1024, 1), (2048, 3)])
def test_wrappers_on_cpu_run_the_plain_steps(L, T):
    """The pass wrappers on CPU tensors: the plain steps, the head pass's
    flags packed as ballots; through ``coder.compact_pass`` their stream is
    the decode's; no kernel launch is counted."""
    cfg = _cfg(L)
    q, means, scales = _data(L, T, seed=3 * L + T)
    qw, mt, st = _tensors(q, means, scales, L)
    before = dict(tc.LAUNCHES)
    syms, recs = tc.tchain12_invert_pass(qw, mt, st, "laplace", LO, HI, cfg)
    words, ballots, heads = tc.tchain12_head_pass(recs, cfg)
    assert ballots.dtype == torch.int32 and ballots.shape == (T, L // 32)
    stream = coder.compact_pass(words, ballots)
    _assert_equal((syms, stream, heads),
                  tc.tchain12_family_decode(qw, mt, st, "laplace", LO, HI,
                                            cfg))
    assert tc.LAUNCHES == before


def test_pass_argument_checks():
    cfg = _cfg(1024)
    q, means, scales = _data(1024, 2, seed=5)
    qw, mt, st = _tensors(q, means, scales, 1024)
    recs = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tc.tchain12_invert_pass(qw, mt, st, "gaussian", LO, HI, _cfg(512))
    with pytest.raises(ValueError, match="qw must hold whole steps"):
        tc.tchain12_invert_pass(qw[:-1], mt, st, "gaussian", LO, HI, cfg)
    with pytest.raises(ValueError, match="means must have 2048 entries"):
        tc.tchain12_invert_pass(qw, mt[:1024], st, "gaussian", LO, HI, cfg)
    with pytest.raises(ValueError, match="family must be one of"):
        tc.tchain12_invert_pass(qw, mt, st, "binomial", LO, HI, cfg)
    with pytest.raises(ValueError, match="recs must hold whole steps"):
        tc.tchain12_head_pass(recs[:-1], cfg)
    with pytest.raises(TypeError, match="recs must be torch.int32"):
        tc.tchain12_head_pass(recs.long(), cfg)
    with pytest.raises(ValueError, match="P=12"):
        tc.tchain12_head_pass(recs, LaneConfig(1024, 16, 32, 16))
    with pytest.raises(ValueError, match="multiple of 1024"):
        tc.tchain12_head_pass(recs, _cfg(512))
