"""Kernel 22, the TChain-12 family encode, as the card runs it: a tables
pass of one thread per symbol, kernel 20's cluster step at W=16, S=32,
P=12 and a packing pass (``csrc/tchain.cu``), whose arithmetic is held
here on the CPU:

- the tables pass's plain version (``tchain12_tables_pass_plain``): each
  symbol's (cum, prob) under its model, record for record those of the
  port's ``family.tables`` and the JAX package's
  ``pallas_family.family_tables_host`` (the pinned ends: cum 0 at
  min_sym, right 2^12 at max_sym), and its ``DivisionRecord32``'s
  multiply-high reciprocal (``coder.division_magic32``);
- that division of a u32 head by every probability 1 .. 2^12
  (``coder.divide_by_magic32``), exact against integer division on the
  heads a TChain-12 encoder divides (below ``prob << 20`` after a refill)
  and at u32 edges;
- a step-form model of the cluster step (numpy) on those records: each
  step's refills (h < prob << 4) ranked as the kernel ranks them, by
  32-lane ballots, a refill word keeping its low 16 bits, the division by
  magic, the quantiles kept whole and packed afterwards by
  ``_pack_q12_block``, as the packing pass packs them; held equal to the
  plain twin (``tchain12_family_encode_plain``), the numpy oracle
  (``tchain12_family_encode_host``) and one interpret-mode call of the JAX
  package's Pallas encoder (``tchain.tchain12_family_encode_pallas``), for
  the four families, symbols pinned at both ends of the support, steps
  with no refill and with every lane refilling, truncated and wide
  remainders;
- the wrappers: on a CUDA device ``tchain12_family_encode`` takes at most
  ``coder.MAX_DECODE_LANES`` lanes (a faked device here), CPU tensors any;
  a forced cluster size needs CUDA tensors.

Integer coding: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import pallas_family as ref_pf
from constriction_tpu.ops import tchain as ref_tc
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import tchain as tc
from constriction_tpu_torch.ops.interleaved import LaneConfig

LO, HI = -100, 100
M32 = np.uint64(0xFFFFFFFF)


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)


def _models(n, seed):
    """Means and scales as the family benchmark row draws them, and symbols
    near the means with about a tenth pinned at each end of the support."""
    rng = np.random.RandomState(seed)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    syms = np.clip(np.round(means + rng.randn(n) * scales), LO, HI)
    syms[rng.rand(n) < 0.1] = LO
    syms[rng.rand(n) < 0.1] = HI
    return syms.astype(np.int32), means, scales


def _torch(syms, means, scales, L):
    mu, sg = convert.params_to_torch(means, scales, len(syms), L)
    return torch.from_numpy(syms), mu, sg


def _fields(recs):
    """records int64 -> (magic, cum, prob) numpy uint64."""
    r = recs.numpy().astype(np.uint64)
    return (r & M32, (r >> np.uint64(32)) & np.uint64(0xFFFF),
            (r >> np.uint64(48)) + np.uint64(1))


def _magic(prob):
    pairs = [coder.division_magic32(int(p)) for p in prob]
    return (np.array([m for m, _ in pairs], np.uint64),
            np.array([s for _, s in pairs], np.uint64))


# --- the tables pass --------------------------------------------------------


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_tables_pass_equals_family_tables(family):
    L, T = 1024, 3
    syms, means, scales = _models(L * T, seed=len(family))
    recs = tc.tchain12_tables_pass_plain(*_torch(syms, means, scales, L),
                                         family, LO, HI, _cfg(L))
    assert recs.dtype == torch.int64 and recs.shape == (L * T,)
    magic, cum, prob = _fields(recs)
    want_cum, want_prob = fam.tables(np, family, LO, HI, syms, means,
                                     np.float32(1.0) / scales)
    np.testing.assert_array_equal(cum, want_cum)
    np.testing.assert_array_equal(prob, want_prob)
    ref_cum, ref_prob = ref_pf.family_tables_host(syms, means, scales, family,
                                                  LO, HI)
    np.testing.assert_array_equal(cum, ref_cum)
    np.testing.assert_array_equal(prob, ref_prob)
    np.testing.assert_array_equal(magic, _magic(prob)[0])
    assert bool((cum[syms == LO] == 0).all())
    assert bool((cum[syms == HI] + prob[syms == HI] == 1 << 12).all())


def test_tables_pass_wrapper_on_cpu_runs_the_plain_version():
    L, T = 1024, 2
    args = _torch(*_models(L * T, seed=3), L)
    before = dict(tc.LAUNCHES)
    got = tc.tchain12_tables_pass(*args, "laplace", LO, HI, _cfg(L))
    assert torch.equal(got, tc.tchain12_tables_pass_plain(
        *args, "laplace", LO, HI, _cfg(L)))
    assert tc.LAUNCHES == before
    syms, mu, sg = args
    with pytest.raises(ValueError, match="symbols must be in"):
        tc.tchain12_tables_pass(syms + 200, mu, sg, "laplace", LO, HI,
                                _cfg(L))
    with pytest.raises(ValueError, match="symbols must hold whole steps"):
        tc.tchain12_tables_pass(syms[:-1], mu, sg, "laplace", LO, HI,
                                _cfg(L))


# --- the multiply-high division ---------------------------------------------


def test_division_by_magic32_is_exact_for_every_tchain12_prob():
    prob = np.arange(1, (1 << 12) + 1, dtype=np.uint64)
    magic, shift = _magic(prob)
    assert bool((magic > 0).all() and (magic < np.uint64(1 << 32)).all())
    rng = np.random.RandomState(12)
    top = prob << np.uint64(20)  # a refilled head stays below it
    edges = np.stack([np.zeros_like(prob), prob - 1, prob, prob + 1,
                      (prob << np.uint64(16)) - 1, top - prob, top - 1,
                      np.full_like(prob, (1 << 32) - 1),
                      np.uint64(1 << 32) - prob], 1)
    below16 = (rng.rand(len(prob), 24) * (prob << np.uint64(16))[:, None])
    below20 = (rng.rand(len(prob), 24) * top[:, None])
    anywhere = rng.randint(0, 1 << 32, size=(len(prob), 24), dtype=np.int64)
    x = np.concatenate([edges, below16.astype(np.uint64),
                        below20.astype(np.uint64),
                        anywhere.astype(np.uint64)], 1)
    got = coder.divide_by_magic32(x, magic[:, None], shift[:, None])
    np.testing.assert_array_equal(got, x // prob[:, None])


# --- the step form of the cluster step --------------------------------------


def _step_form(recs, remainders, heads, L):
    """Kernel 22's cluster step in numpy on the tables pass's records:
    refill ranks from 32-lane ballots, the head h << 16 | (w & 0xFFFF), q =
    cum + h - (h / prob) prob with the quotient a 32-bit multiply-high,
    the quantiles packed by _pack_q12_block.  Returns (qw u32[T * 3L/8],
    heads u32[L])."""
    magic, cum, prob = _fields(recs)
    shift = _magic(np.arange(1, (1 << 12) + 1))[1][(prob - 1).astype(
        np.int64)]
    T = len(prob) // L
    words = np.asarray(remainders, dtype=np.uint64)
    h = np.asarray(heads, dtype=np.uint64).copy()
    q = np.zeros(T * L, dtype=np.uint64)
    base = 0
    for t in range(T - 1, -1, -1):
        s = slice(t * L, (t + 1) * L)
        refill = h < (prob[s] << np.uint64(4))
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
        q[s] = cum[s] + (h - quot * prob[s])
        h = quot
        base += int(counts.sum())
    qw = tc._pack_q12_block(np, q.reshape(T * L // 128, 128))
    return qw.reshape(-1).astype(np.uint32), h.astype(np.uint32)


def _encode_inputs(family, L, T, seed):
    """A decoded message of uniform quantiles: (quantiles, means, scales,
    symbols, remainders, heads) in numpy."""
    rng = np.random.RandomState(seed)
    _, means, scales = _models(L * T, seed)
    q = rng.randint(0, 1 << 12, size=L * T).astype(np.uint16)
    syms, rem, heads = tc.tchain12_family_decode_host(q, means, scales,
                                                      family, LO, HI, _cfg(L))
    return q, means, scales, syms, rem, heads


def _check(syms, rem, heads, means, scales, family, L):
    """The step form on the plain tables pass's records against the twin
    and the host oracle; returns the step form's (qw, heads)."""
    cfg = _cfg(L)
    s_t, mu, sg = _torch(syms, means, scales, L)
    recs = tc.tchain12_tables_pass_plain(s_t, mu, sg, family, LO, HI, cfg)
    got = _step_form(recs, rem, heads, L)
    twin = tc.tchain12_family_encode_plain(
        s_t, convert.u32_to_torch(rem), convert.u32_to_torch(heads), mu, sg,
        family, LO, HI, cfg)
    np.testing.assert_array_equal(got[0], convert.u32_from_torch(twin[0]))
    np.testing.assert_array_equal(got[1], convert.u32_from_torch(twin[1]))
    if (np.asarray(rem) < 1 << 16).all():  # the oracle ORs whole words in
        q_h, h_h = tc.tchain12_family_encode_host(syms, rem, heads, means,
                                                  scales, family, LO, HI, cfg)
        np.testing.assert_array_equal(got[0],
                                      tc.pack_q12(q_h, L).reshape(-1))
        np.testing.assert_array_equal(got[1], h_h)
    return got


@pytest.mark.parametrize("family", fam.FAMILIES)
@pytest.mark.parametrize("L,T", [(1024, 1), (1024, 4), (2048, 3)])
def test_step_form_equals_twin_and_host_oracle(family, L, T):
    q, means, scales, syms, rem, heads = _encode_inputs(family, L, T,
                                                        seed=L + T)
    got = _check(syms, rem, heads, means, scales, family, L)
    np.testing.assert_array_equal(got[0], tc.pack_q12(q, L).reshape(-1))
    assert bool((got[1] == 16).all())


@pytest.mark.parametrize("family", ["gaussian", "cauchy"])
def test_symbols_pinned_at_both_ends(family):
    """Every symbol of one step at min_sym (cum 0), every symbol of another
    at max_sym (right end 2^12), the rest mixed; heads and remainders need
    not come from a decode."""
    L, T = 1024, 4
    rng = np.random.RandomState(21)
    syms, means, scales = _models(L * T, seed=21)
    syms[:L] = LO
    syms[L:2 * L] = HI
    syms[2 * L:3 * L] = np.where(rng.rand(L) < 0.5, LO, HI)
    heads = rng.randint(16, 1 << 20, size=L).astype(np.uint32)
    rem = rng.randint(0, 1 << 16, size=2 * L * T).astype(np.uint32)
    _check(syms, rem, heads, means, scales, family, L)


def test_steps_with_no_refill_and_with_every_lane_refilling():
    """Heads of 2^20 - 1 refill no lane at the first step coded (prob << 4
    <= 2^16), heads of 0 every lane there."""
    L, T = 1024, 3
    rng = np.random.RandomState(9)
    syms, means, scales = _models(L * T, seed=9)
    rem = rng.randint(0, 1 << 16, size=4 * L * T).astype(np.uint32)
    for h0 in (0, (1 << 20) - 1):
        _check(syms, rem, np.full(L, h0, np.uint32), means, scales,
               "logistic", L)


@pytest.mark.parametrize("family", ["gaussian", "laplace"])
def test_step_form_on_truncated_and_wide_remainders(family):
    """Reads past the stream's end give zero words; a word's bits above 16
    are dropped, as the Pallas encoder and the twin drop them."""
    L, T = 1024, 3
    _, means, scales, syms, rem, heads = _encode_inputs(family, L, T, seed=5)
    for r in (rem[: len(rem) // 2], np.zeros(0, np.uint32),
              rem | np.uint32(0xABCD0000)):
        _check(syms, r, heads, means, scales, family, L)


def test_step_form_equals_the_pallas_encoder_in_interpret_mode():
    L, T = 1024, 2
    q, means, scales, syms, rem, heads = _encode_inputs("gaussian", L, T,
                                                        seed=22)
    wide = rem | np.uint32(0x12340000)
    cfg = _cfg(L)
    recs = tc.tchain12_tables_pass_plain(*_torch(syms, means, scales, L),
                                         "gaussian", LO, HI, cfg)
    got = _step_form(recs, wide, heads, L)
    ref = ref_tc.tchain12_family_encode_pallas(
        syms, wide, heads, means, scales, "gaussian", LO, HI,
        RefLaneConfig(L, 16, 32, 12), interpret=True)
    np.testing.assert_array_equal(
        got[0], tc.pack_q12(np.asarray(ref[0]), L).reshape(-1))
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0], tc.pack_q12(q, L).reshape(-1))


# --- the wrappers -----------------------------------------------------------


def _tensors(L, T):
    _, means, scales, syms, rem, heads = _encode_inputs("gaussian", L, T,
                                                        seed=L)
    s_t, mu, sg = _torch(syms, means, scales, L)
    return (s_t, convert.u32_to_torch(rem), convert.u32_to_torch(heads), mu,
            sg, "gaussian", LO, HI)


def test_lane_cap_on_a_cuda_device(monkeypatch):
    """Past the cluster's reach a CUDA device raises ValueError naming
    num_lanes, before any launch; a CPU tensor runs the twin at any L."""
    L = coder.MAX_DECODE_LANES + 1024
    args = _tensors(L, 1)
    before = dict(tc.LAUNCHES)
    qw, h = tc.tchain12_family_encode(*args, _cfg(L))
    assert qw.numel() == 3 * L // 8 and bool((h == 16).all())
    monkeypatch.setattr(tc, "_on_cuda", lambda device: True)
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain12_family_encode(*args, _cfg(L))
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain12_family_encode_cluster(*args, 16, _cfg(L))
    with pytest.raises(ValueError, match="cluster must be in 1 .. 16"):
        tc.tchain12_family_encode_cluster(*args, 17, _cfg(L))
    assert tc.LAUNCHES == before


def test_forced_cluster_needs_cuda_tensors_and_a_size():
    args = _tensors(1024, 2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tc.tchain12_family_encode_cluster(*args, 4, _cfg(1024))
    with pytest.raises(ValueError, match="multiple of 1024"):
        tc.tchain12_family_encode_cluster(*args, 4, _cfg(512))
    with pytest.raises(ValueError, match="precision must be 12"):
        tc.tchain12_family_encode_cluster(*args, 4,
                                          LaneConfig(1024, 16, 32, 16))
