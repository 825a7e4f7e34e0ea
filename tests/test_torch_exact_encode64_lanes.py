"""Kernel 17, the S=64 reference-exact encode over (cum, prob) planes, as
the card runs it: kernel 2's two passes (``csrc/ilans2_wide.cuh``,
``encode_lanes_kernel<32, 64, PlaneLanesModel>`` and the row-major
compaction), each with a plain PyTorch version in the port:

- ``exact_family.encode_lanes_plain``: every lane through steps T-1 .. 0
  over its column of the planes on its own, the emitted words dense in
  rows by step, the renorm flags, the final states;
- ``coder.compact_pass_plain``: the flagged words in row-major order.

Composed, they are held byte for byte equal to the one-loop twin
(``exact_family.encode_tables_plain``), the port's and the JAX package's
numpy encoders (``interleaved2.encode_shared``) and one interpret-mode
call of the JAX package's Pallas encoder
(``exact_family.encode_tables_pallas``).  Inputs are made by numpy from a
seed: gaussian planes from ``exact_ecp`` at L in {128, 1024} with and
without seeds, n whole, partial and shorter than L; planes of prob 1,
where lanes renorm at most steps; planes of prob 2^24 - 1, where none
does.  The step's division is held against integer division up to the
largest state a step codes, prob * 2^(64 - P) - 1, for prob in {1, 2,
2^P - 1} and random ones: the kernel's (an f64 estimate and one correcting
product, ``exact_family.plane_quotient`` / ``plane_correct``) and the
twin's (two base-2^32 digits).  Integer coding: the tolerance is exact
equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu.ops import exact_family as ref_ef
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops.interleaved import LaneConfig as RefCfg
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder, coder64
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig

P = 24


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host encoder on its numpy path."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=P)


def _gaussian_planes(n, seed):
    rng = np.random.RandomState(seed)
    means = rng.randn(n) * 20.0
    scales = np.exp(rng.normal(0.4, 0.6, n))
    syms = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
                   ).astype(np.int64)
    return ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, P)


def _flat_planes(n, prob, seed):
    """Planes of one probability, cums drawn in [0, 2^24 - prob]."""
    rng = np.random.RandomState(seed)
    cums = rng.randint(0, (1 << P) - prob + 1, size=n).astype(np.uint32)
    return cums, np.full(n, prob, dtype=np.uint32)


def _seeds(L, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(1 << 32, (1 << 63) - 1, L, dtype=np.int64).astype(
        np.uint64)


def _check(cums, probs, L, seeds=None):
    """Pass A and the compaction against the one-loop twin and both
    packages' numpy encoders; returns (states, stream, flags)."""
    n, cfg = len(cums), _cfg(L)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L)
    s_t = None if seeds is None else convert.u64_to_torch(seeds)
    words, flags, states = ef.encode_lanes_plain(c_t, p_t, cfg, s_t, n)
    stream = coder.compact_pass_plain(words, flags)
    st_p, w_p = ef.encode_tables_plain(c_t, p_t, cfg, s_t, n)
    assert torch.equal(states, st_p) and torch.equal(stream, w_p)
    for oracle, ocfg in ((il2.encode_shared, cfg),
                         (ref_il2.encode_shared, RefCfg(L, 32, 64, P))):
        st_h, w_h = oracle(cums, probs, ocfg, seeds=seeds)
        np.testing.assert_array_equal(convert.u64_from_torch(states), st_h)
        np.testing.assert_array_equal(convert.u32_from_torch(stream), w_h)
    return states, stream, flags


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("L,n", [(128, 128 * 12), (128, 128 * 12 - 37),
                                 (128, 90), (1024, 1024 * 4),
                                 (1024, 1024 * 4 + 3), (1024, 700)])
def test_lane_pass_and_compaction_equal_twin_and_oracles(L, n, seeded):
    cums, probs = _gaussian_planes(n, seed=L + n)
    _check(cums, probs, L, _seeds(L, n) if seeded else None)


@pytest.mark.parametrize("seeded", [False, True])
def test_planes_of_prob_one_renorm_most_steps(seeded):
    """prob 1: x / prob is x, so a state grows by 2^24 a step and renorms
    at three steps of four; unseeded, every lane renorms at the same
    steps."""
    L, n = 128, 128 * 16
    cums, probs = _flat_planes(n, 1, seed=3)
    _, stream, flags = _check(cums, probs, L, _seeds(L, 4) if seeded else None)
    assert float(flags.float().mean()) >= 0.7
    assert int(stream.numel()) == int(flags.sum())
    if not seeded:
        assert int(flags.all(1).sum()) >= 11


@pytest.mark.parametrize("seeded", [False, True])
def test_planes_of_prob_near_one_never_renorm(seeded):
    """prob 2^24 - 1: a state below prob * 2^40 stays there, so no lane
    ever emits a word."""
    L, n = 128, 128 * 10 - 5
    cums, probs = _flat_planes(n, (1 << P) - 1, seed=5)
    states, stream, flags = _check(cums, probs, L,
                                   _seeds(L, 6) if seeded else None)
    assert not bool(flags.any()) and stream.numel() == 0
    if not seeded:
        assert not bool((states == 1 << 32).all())


@pytest.mark.parametrize("prob", [1, 2, (1 << P) - 1, "random"])
def test_step_division_is_exact_at_the_largest_state(prob):
    """One coding step, (x // prob) << 24 | (cum + x % prob), against
    Python integers for states up to prob * 2^40 - 1 (the largest that a
    step codes without a renorm)."""
    rng = np.random.RandomState(11)
    probs = ([prob] * 64 if prob != "random"
             else rng.randint(1, 1 << P, size=64).tolist())
    xs, cums = [], []
    for k, p in enumerate(probs):
        top = p << 40
        xs.append(top - 1 - (k % 4) * (1 + k * 977) % top)
        cums.append(int(rng.randint(0, (1 << P) - p + 1)))
    x_t = convert.u64_to_torch(np.array(xs, dtype=np.uint64))
    hi, lo = convert.u64_halves(x_t)
    p_t = torch.tensor(probs, dtype=torch.int64)
    c_t = torch.tensor(cums, dtype=torch.int64)
    renorm = coder64._renorms64(hi, p_t, torch.ones(64, dtype=torch.bool), P)
    assert not bool(renorm.any())
    n_hi, n_lo = coder64._code64(hi, lo, c_t, p_t,
                                 torch.ones(64, dtype=torch.bool), renorm, P)
    got = convert.u64_from_torch(convert.u64_join(n_hi, n_lo))
    want = [((x // p) << P) | (c + x % p) for x, p, c in zip(xs, probs, cums)]
    np.testing.assert_array_equal(got, np.array(want, dtype=np.uint64))


def _edge_states(prob, shift, rng):
    """States a step divides by prob at P = 64 - shift: the largest ones
    (prob * 2^shift - 1 and below), the smallest (2^32), ones whose
    quotient sits just below and just above a power of two, and random
    ones."""
    top = prob << shift
    xs = [top - 1, top - 2, top - prob, top - prob - 1, 1 << 32,
          (1 << 32) + 1]
    for k in (32, 33, shift - 1):
        if (prob << k) < top:
            xs += [(prob << k) - 1, prob << k, (prob << k) + prob - 1]
    xs += [int(v) for v in rng.randint(1 << 32, min(top, 1 << 62), 32,
                                        dtype=np.int64)]
    return [x for x in xs if (1 << 32) <= x < top]


@pytest.mark.parametrize("precision", [17, P])
@pytest.mark.parametrize("prob", [1, 2, 3, "top - 1", "top", "random"])
def test_f64_division_is_exact_against_integer_division(precision, prob):
    """Kernel 17's quotient (an f64 estimate, one correcting product:
    ``plane_quotient``) against ``//`` for states below prob *
    2^(64 - P), at the widest and the narrowest wide precision, and its
    correction from every estimate within one, the u64 wrap of q * prob
    at 2^64 included."""
    rng = np.random.RandomState(17)
    top = 1 << precision
    probs = {"top - 1": [top - 1], "top": [top],
             "random": [int(p) for p in rng.randint(1, top, 16)]}.get(
                 prob, [prob])
    for p in probs:
        for x in _edge_states(p, 64 - precision, rng):
            q = x // p
            assert ef.plane_quotient(x, p) == q, (x, p)
            for est in (q - 1, q, q + 1):
                assert ef.plane_correct(est, x, p) == q, (x, p, est)
    # the estimate 2^(64-P) of x = 2^64 - 1 by 2^P: q * prob wraps to 0
    shift = 64 - precision
    assert ef.plane_correct(1 << shift, (1 << 64) - 1, top) == (
        1 << shift) - 1


def test_equals_the_pallas_encoder_in_interpret_mode():
    L, n = 128, 3 * 128 - 5  # partial last step
    cums, probs = _gaussian_planes(n, seed=13)
    states, stream, _ = _check(cums, probs, L)
    r_st, r_w = ref_ef.encode_tables_pallas(cums, probs, RefCfg(L, 32, 64, P),
                                            interpret=True)
    np.testing.assert_array_equal(convert.u64_from_torch(states),
                                  np.asarray(r_st))
    np.testing.assert_array_equal(convert.u32_from_torch(stream),
                                  np.asarray(r_w))


def test_cpu_tensors_run_the_plain_passes_and_launch_nothing():
    L, n = 128, 128 * 6 - 3
    cums, probs = _gaussian_planes(n, seed=5)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L)
    s_t = convert.u64_to_torch(_seeds(L, 7))
    before = dict(ef.LAUNCHES), dict(coder.LAUNCHES)
    states, stream = ef.encode_tables(c_t, p_t, _cfg(L), s_t, n)
    words, flags, st_l = ef.encode_lanes_plain(c_t, p_t, _cfg(L), s_t, n)
    assert words.shape == (6, L) and words.dtype == torch.int32
    assert torch.equal(states, st_l)
    assert torch.equal(stream, coder.compact_pass(words,
                                                  coder.flag_ballots(flags)))
    assert (dict(ef.LAUNCHES), dict(coder.LAUNCHES)) == before
