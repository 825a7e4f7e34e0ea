"""Kernel 8, the S=32 range encoder's phase B, as the card runs it: a lane
pass over the whole grid (``csrc/ilans2_range.cu``,
``range_resolve_lanes_kernel``) and the encoders' row-major compaction,
each with a plain PyTorch version in the port:

- ``range_enc.resolve_lanes_plain``: each lane's pending carry and delay
  line through steps T-1 .. 0 on its own records, the resolved words
  dense in rows by step, the renorm flags, the points;
- ``coder.compact_pass_plain``: the flagged words in row-major order.

Composed, they are held byte for byte equal to the one-loop twin
(``range_enc.resolve_plain``), the port's numpy host range encoder
(``interleaved2.encode_shared_range``) and one interpret-mode call of the
JAX package's Pallas encoder (``pallas_range_enc.encode_iid_range_pallas``).
The JAX package has no numpy range encoder (its host encoder is C++), so
its numpy decoder (``interleaved2.decode_shared_range_cdf``) must give the
symbols back.  Inputs are made by numpy from a seed: L in {128, 1024}, n
whole, partial and shorter than L, a skewed model with carry runs, a step
where no lane renorms and one where every lane does.  The wrappers on CPU
tensors run these plain passes and launch nothing.  Integer coding: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops import pallas_range_enc as pre
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import coder, range_enc
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host range decoder on its numpy path."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(L, P=12):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)


def _skewed_cdf(P):
    q = np.array([(1 << P) - 3, 1, 1, 1], dtype=np.int64)
    return np.concatenate([[0], np.cumsum(q)]).astype(np.uint32)


def _data(kind, L, n, seed, P=12):
    """(symbols int64, cdf u32).  ``dirichlet``: K=60; ``skewed``: 99.9%
    of the mass on one symbol (long carry runs); ``edges``: the skewed
    model with every lane coding its rarest symbol at steps 0 and 1 (step
    1 renorms every lane) and its likeliest at step 2 (no lane renorms)."""
    rng = np.random.RandomState(seed)
    if kind == "dirichlet":
        probs = rng.dirichlet(np.full(60, 2.0))
        cdf = np.asarray(fast_quantized_cdf(probs, P), dtype=np.uint32)
        return rng.choice(60, size=n, p=probs).astype(np.int64), cdf
    syms = np.where(rng.random_sample(n) < 0.999, 0, rng.randint(1, 4, n))
    if kind == "edges":
        syms[:2 * L] = 3
        syms[2 * L:3 * L] = 0
    return syms.astype(np.int64), _skewed_cdf(P)


def _phase_a(syms, cdf, cfg):
    """Records and seal on CPU tensors (the port's plain phase A)."""
    records, low_f, rng_f = range_enc.record(
        torch.from_numpy(syms.astype(np.int32)), convert.cdf_to_torch(cdf),
        cfg)
    return (records, *range_enc.seal(low_f, rng_f, cfg))


def _lanes_then_compact(records, s0, carry, cfg, n):
    words, flags, points = range_enc.resolve_lanes_plain(records, s0, carry,
                                                         cfg, n)
    return points, coder.compact_pass_plain(words, flags), flags


def _host(syms, cdf, cfg):
    c = cdf.astype(np.uint64)
    return il2.encode_shared_range(c[syms], c[syms + 1] - c[syms], cfg)


def _check(syms, cdf, cfg):
    """The lane pass and the compaction against the one-loop twin, the
    port's numpy encoder and the JAX package's numpy decoder; returns
    (points, stream, flags)."""
    n = len(syms)
    records, s0, carry = _phase_a(syms, cdf, cfg)
    points, stream, flags = _lanes_then_compact(records, s0, carry, cfg, n)
    pts_p, stream_p = range_enc.resolve_plain(records, s0, carry, cfg, n)
    assert torch.equal(points, pts_p) and torch.equal(stream, stream_p)
    pts_h, stream_h = _host(syms, cdf, cfg)
    np.testing.assert_array_equal(convert.states_from_torch(points, cfg),
                                  pts_h)
    np.testing.assert_array_equal(convert.u32_from_torch(stream), stream_h)
    ref_cfg = RefLaneConfig(cfg.num_lanes, 16, 32, cfg.precision)
    np.testing.assert_array_equal(
        ref_il2.decode_shared_range_cdf(pts_h, stream_h, n, cdf, ref_cfg),
        syms)
    return points, stream, flags


@pytest.mark.parametrize("kind", ["dirichlet", "skewed"])
@pytest.mark.parametrize("L,n", [(128, 128 * 40), (128, 128 * 40 - 77),
                                 (128, 100), (1024, 1024 * 9),
                                 (1024, 1024 * 9 + 5), (1024, 1000)])
def test_lane_pass_and_compaction_equal_resolve_and_oracles(kind, L, n):
    _check(*_data(kind, L, n, seed=L + n), _cfg(L))


@pytest.mark.parametrize("L", [128, 1024])
def test_steps_with_no_renorm_and_every_lane_renorming(L):
    syms, cdf = _data("edges", L, L * 30, seed=L)
    _, _, flags = _check(syms, cdf, _cfg(L))
    assert bool(flags[1].all()) and not bool(flags[2].any())


def test_skewed_model_runs_long_carry_chains():
    syms, cdf = _data("skewed", 128, 128 * 400, seed=3)
    records, _, _ = _phase_a(syms, cdf, _cfg(128))
    assert int(((records.long() >> 17) & 1).sum()) > 0  # carries
    _check(syms, cdf, _cfg(128))


@pytest.mark.parametrize("P", [12, 16])
def test_lane_pass_at_both_precisions(P):
    syms, cdf = _data("dirichlet", 128, 128 * 12 + 9, seed=P, P=P)
    _check(syms, cdf, _cfg(128, P))


def test_equals_the_pallas_encoder_in_interpret_mode():
    syms, cdf = _data("dirichlet", 128, 1000, seed=12)  # partial last step
    cfg = _cfg(128)
    points, stream, _ = _check(syms, cdf, cfg)
    ref_pts, ref_words = pre.encode_iid_range_pallas(
        syms, cdf, RefLaneConfig(128, 16, 32, 12))
    np.testing.assert_array_equal(convert.states_from_torch(points, cfg),
                                  np.asarray(ref_pts))
    np.testing.assert_array_equal(convert.u32_from_torch(stream),
                                  np.asarray(ref_words))


def test_cpu_tensors_run_the_plain_passes_and_launch_nothing():
    L, n = 128, 128 * 6 - 3
    cfg = _cfg(L)
    syms, cdf = _data("dirichlet", L, n, seed=5)
    records, s0, carry = _phase_a(syms, cdf, cfg)
    before = dict(range_enc.LAUNCHES), dict(coder.LAUNCHES)
    words, ballots, points = range_enc.resolve_lanes(records, s0, carry, cfg,
                                                     n)
    w_p, f_p, pts_p = range_enc.resolve_lanes_plain(records, s0, carry, cfg, n)
    assert torch.equal(words, w_p) and torch.equal(points, pts_p)
    assert torch.equal(ballots, coder.flag_ballots(f_p))
    assert ballots.shape == (6, L // 32) and ballots.dtype == torch.int32
    stream = coder.compact_pass(words, ballots)
    assert torch.equal(range_enc.resolve(records, s0, carry, cfg, n)[1],
                       stream)
    assert (dict(range_enc.LAUNCHES), dict(coder.LAUNCHES)) == before


def test_lane_pass_checks_its_arguments():
    L, n = 128, 300
    syms, cdf = _data("dirichlet", L, n, seed=7)
    records, s0, carry = _phase_a(syms, cdf, _cfg(L))
    with pytest.raises(ValueError, match="W=16, S=32"):
        range_enc.resolve_lanes(records, s0, carry,
                                LaneConfig(L, 8, 32, 12), n)
    # the S=64 lane pass (kernel 10) takes u64 records
    with pytest.raises(TypeError, match="records must be torch.int64"):
        range_enc.resolve_lanes(records, s0, carry,
                                LaneConfig(L, 32, 64, 24), n)
    with pytest.raises(ValueError, match="records must have 384 entries"):
        range_enc.resolve_lanes(records[:-128], s0, carry, _cfg(L), n)
    with pytest.raises(TypeError, match="s0 must be torch.int32"):
        range_enc.resolve_lanes(records, s0.long(), carry, _cfg(L), n)
