"""Kernel 12, the device-family rANS encode (W=16, S=32, P=12), as the card
runs it: a tables pass of one thread per symbol, a lane pass and the
encoders' row-major compaction (``csrc/ilans2_family.cu``), whose
arithmetic is held here on the CPU:

- the tables pass's plain version (``family.family_tables_pass_plain``):
  each symbol's (cum, prob) under its model, record for record the port's
  ``family.tables`` and the JAX package's ``pallas_family.
  family_tables_host`` (the pinned ends: cum 0 at min_sym, right 2^12 at
  max_sym), and its ``DivisionRecord32``'s multiply-high reciprocal, built
  by one division (``family.record_magic``), equal to
  ``coder.division_magic32`` for every probability 1 .. 2^16;
- the lane pass's division of a u32 state by that record
  (``family.record_divide``), exact against integer division for every
  probability 1 .. 2^12 on the states a family encode divides;
- the three steps composed (``family.encode_family_lanes_plain``: the
  tables pass, ``family.family_lanes_pass_plain`` and
  ``coder.compact_pass_plain``), held byte for byte against the twin
  ``family.encode_family_plain``, the port's numpy oracle
  (``family_tables_host`` -> ``interleaved2.encode_shared``), the JAX
  package's (the same two functions there) and, for one small case a
  family, the JAX package's Pallas encoder in interpret mode
  (``pallas_family.encode_family_pallas``): the four families, L = 32 and
  1024, a partial last step, symbols pinned at both ends of the support;
- the wrappers (``family_tables_pass``, ``family_lanes_pass``,
  ``encode_family``) on CPU tensors: the plain versions, no launch
  counted, their argument checks.

The JAX package's host functions run their numpy branches (``native.LIB``
set to None).  Integer coding: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops import pallas_family as ref_pf
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig

LO, HI = -100, 100
M32 = (1 << 32) - 1


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host functions take their numpy branches."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)


def _models(n, seed, cauchy=False):
    """Means and scales as the family benchmark row draws them, and symbols
    near the means with about a tenth pinned at each end of the support."""
    rng = np.random.RandomState(seed)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    noise = rng.standard_cauchy(n) if cauchy else rng.randn(n)
    syms = np.clip(np.round(means + noise * scales), LO, HI)
    syms[rng.rand(n) < 0.1] = LO
    syms[rng.rand(n) < 0.1] = HI
    return syms.astype(np.int32), means, scales


def _torch(syms, means, scales, L):
    mu, sg = convert.params_to_torch(means, scales, len(syms), L)
    return torch.from_numpy(syms), mu, sg


# --- the tables pass and its records ----------------------------------------


def test_record_magic_equals_division_magic32_for_every_prob():
    prob = torch.arange(1, (1 << 16) + 1, dtype=torch.int64)
    want = torch.tensor([coder.division_magic32(p)[0]
                         for p in range(1, (1 << 16) + 1)])
    got = fam.record_magic(prob)
    assert torch.equal(got, want)
    assert bool((got >= 1).all() and (got <= M32).all())


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_tables_pass_equals_both_packages_family_tables(family):
    n, L = 3 * 1024 + 17, 1024
    syms, means, scales = _models(n, seed=len(family))
    recs = fam.family_tables_pass_plain(*_torch(syms, means, scales, L),
                                        family, LO, HI)
    assert recs.dtype == torch.int64 and recs.shape == (n,)
    r = recs.numpy().astype(np.uint64)
    magic = r & np.uint64(M32)
    cum = (r >> np.uint64(32)) & np.uint64(0xFFFF)
    prob = (r >> np.uint64(48)) + np.uint64(1)
    want_cum, want_prob = fam.family_tables_host(syms, means, scales, family,
                                                 LO, HI)
    np.testing.assert_array_equal(cum, want_cum)
    np.testing.assert_array_equal(prob, want_prob)
    ref_cum, ref_prob = ref_pf.family_tables_host(syms, means, scales, family,
                                                  LO, HI)
    np.testing.assert_array_equal(cum, ref_cum)
    np.testing.assert_array_equal(prob, ref_prob)
    np.testing.assert_array_equal(
        magic, [coder.division_magic32(int(p))[0] for p in prob])
    assert bool((cum[syms == LO] == 0).all())
    assert bool((cum[syms == HI] + prob[syms == HI] == 1 << 12).all())


# --- the lane pass's division -----------------------------------------------


def test_record_divide_is_exact_for_every_family_prob():
    """Every probability a family record holds (1 .. 2^12), at the states
    the lane pass divides (below prob << 20 after a renorm) and at u32
    edges."""
    prob = torch.arange(1, (1 << 12) + 1, dtype=torch.int64)
    magic = fam.record_magic(prob)
    rng = np.random.RandomState(12)
    top = prob << 20
    edges = torch.stack([torch.zeros_like(prob), prob - 1, prob, prob + 1,
                         (prob << 16) - 1, top - prob, top - 1,
                         torch.full_like(prob, M32), (1 << 32) - prob], 1)
    below = (torch.from_numpy(rng.rand(len(prob), 32)) * top[:, None]
             ).to(torch.int64)
    x = torch.cat([edges, below], 1)
    got = fam.record_divide(x, magic[:, None], prob[:, None])
    assert torch.equal(got, x // prob[:, None])


# --- the three steps against the twin and the oracles ------------------------


CASES = [(L, n) for L in (32, 1024) for n in (L * 5 + 7, L * 3)]


@pytest.mark.parametrize("L,n", CASES)
@pytest.mark.parametrize("family", fam.FAMILIES)
def test_three_steps_equal_twin_and_oracles(family, L, n):
    syms, means, scales = _models(n, seed=L + n,
                                  cauchy=family == "cauchy")
    cfg = _cfg(L)
    args = _torch(syms, means, scales, L)
    st, w = fam.encode_family_lanes_plain(*args, family, LO, HI, cfg)
    st_p, w_p = fam.encode_family_plain(*args, family, LO, HI, cfg)
    assert torch.equal(st, st_p) and torch.equal(w, w_p)
    cums, probs = fam.family_tables_host(syms, means, scales, family, LO, HI)
    st_h, w_h = il2.encode_shared(cums, probs, cfg)
    np.testing.assert_array_equal(convert.u32_from_torch(st), st_h)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_h)
    ref_cfg = RefLaneConfig(L, 16, 32, 12)
    r_st, r_w = ref_il2.encode_shared(
        *ref_pf.family_tables_host(syms, means, scales, family, LO, HI),
        ref_cfg)
    np.testing.assert_array_equal(convert.u32_from_torch(st), r_st)
    np.testing.assert_array_equal(convert.u32_from_torch(w), r_w)


def test_lane_pass_words_and_flags_step_by_step():
    """The lane pass's words and flags against the twin's step loop: a
    lane flags exactly where it emits, its word is the state's low 16
    bits, and a partial last step's lanes neither code nor flag."""
    L, n = 64, 64 * 4 + 9
    syms, means, scales = _models(n, seed=5)
    args = _torch(syms, means, scales, L)
    recs = fam.family_tables_pass_plain(*args, "gaussian", LO, HI)
    words, flags, states = fam.family_lanes_pass_plain(recs, n, _cfg(L))
    assert words.shape == flags.shape == (5, L)
    assert not bool(flags[4, 9:].any()) and not bool(words[4, 9:].any())
    assert not bool(words[~flags].any())
    assert bool((words[flags] >= 0).all() and (words[flags] < 1 << 16).all())
    stream = coder.compact_pass_plain(words, flags)
    st_p, w_p = fam.encode_family_plain(*args, "gaussian", LO, HI, _cfg(L))
    assert torch.equal(states, st_p) and torch.equal(stream, w_p)
    assert stream.numel() == int(flags.sum())


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_three_steps_equal_pallas_interpret(family):
    """One small case a family through the JAX package's Pallas encoder in
    interpret mode: L = 128, a partial last step (300 = 2 * 128 + 44)."""
    L, n = 128, 300
    syms, means, scales = _models(n, seed=7, cauchy=family == "cauchy")
    st, w = fam.encode_family_lanes_plain(*_torch(syms, means, scales, L),
                                          family, LO, HI, _cfg(L))
    r_st, r_w = ref_pf.encode_family_pallas(syms, means, scales, family, LO,
                                            HI, RefLaneConfig(L, 16, 32, 12),
                                            interpret=True)
    np.testing.assert_array_equal(convert.u32_from_torch(st),
                                  np.asarray(r_st))
    np.testing.assert_array_equal(convert.u32_from_torch(w), np.asarray(r_w))


# --- the wrappers on CPU tensors --------------------------------------------


def test_wrappers_on_cpu_run_the_plain_versions():
    L, n = 128, 128 * 3 + 1
    args = _torch(*_models(n, seed=3), L)
    cfg = _cfg(L)
    before = dict(fam.LAUNCHES)
    recs = fam.family_tables_pass(*args, "laplace", LO, HI, cfg)
    assert torch.equal(recs, fam.family_tables_pass_plain(*args, "laplace",
                                                          LO, HI))
    words, ballots, states = fam.family_lanes_pass(recs, cfg)
    w_p, flags, st_p = fam.family_lanes_pass_plain(recs, n, cfg)
    assert torch.equal(words, w_p) and torch.equal(states, st_p)
    assert torch.equal(ballots, coder.flag_ballots(flags))
    assert torch.equal(coder.compact_pass(words, ballots),
                       coder.compact_pass_plain(w_p, flags))
    st, w = fam.encode_family(*args, "laplace", LO, HI, cfg)
    assert torch.equal(st, states)
    assert torch.equal(w, coder.compact_pass_plain(w_p, flags))
    assert fam.LAUNCHES == before


def test_wrapper_argument_checks():
    L, n = 128, 200
    syms, mu, sg = _torch(*_models(n, seed=9), L)
    cfg = _cfg(L)
    with pytest.raises(ValueError, match="symbols must be in"):
        fam.family_tables_pass(syms + 300, mu, sg, "cauchy", LO, HI, cfg)
    with pytest.raises(ValueError, match="num_lanes must be"):
        fam.family_tables_pass(syms, mu, sg, "cauchy", LO, HI, _cfg(96))
    with pytest.raises(ValueError, match="at least one"):
        fam.family_lanes_pass(torch.zeros(0, dtype=torch.int64), cfg)
    with pytest.raises(TypeError):
        fam.family_lanes_pass(torch.zeros(4, dtype=torch.int32), cfg)
    with pytest.raises(ValueError, match="word_bits=16"):
        fam.family_lanes_pass(torch.zeros(4, dtype=torch.int64),
                              LaneConfig(128, 32, 64, 12))
