"""The DEFAULT-preset encoder's two passes (constriction_tpu_torch.ops.
coder64: ``lanes_pass64_plain``, the lane-parallel pass, and
``compact_pass_plain``, the row-major compaction) against the port's
single-loop twin ``encode_iid64_plain``, the JAX package's host oracle
(``interleaved2.encode_shared``) and its Pallas kernel in interpret mode
(as tests/test_pallas64.py runs it).  The CUDA kernels' index math mirrors
the two passes.  Also here: the exactness of the encode kernel's division
(a multiply-high by a per-symbol reciprocal, ``coder64.division_magic``)
against integer division.  Inputs are made from numpy seeds; integer
coding, so the tolerance is exact equality."""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops import pallas_coder64 as pc64
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import coder64
from constriction_tpu_torch.ops.interleaved import LaneConfig


def _model(kind, rng):
    """(precision, cdf u32, symbol sampler) of a named test model."""
    if kind == "p1":  # two symbols of probability 1/2 at P = 1
        return 1, np.array([0, 1, 2], np.uint32), lambda n: rng.randint(0, 2, n)
    if kind == "k1":  # one symbol: no information, no word
        return 24, np.array([0, 1 << 24], np.uint32), lambda n: np.zeros(
            n, np.int64)
    if kind == "skewed":  # 24 bits a symbol: most lanes renorm every step
        return 24, np.array([0, 1, 1 << 24], np.uint32), lambda n: np.zeros(
            n, np.int64)
    if kind == "flat":  # almost no information: a renorm is rare
        return 24, np.array([0, (1 << 24) - 1, 1 << 24], np.uint32), \
            lambda n: np.zeros(n, np.int64)
    P = {"p12": 12, "p24": 24}[kind]
    probs = rng.dirichlet(np.full(100, 2.0))
    return P, fast_quantized_cdf(probs, P), lambda n: rng.choice(
        100, size=n, p=probs)


def _seeds(rng, L):
    """u64 start states over [2^32, 2^64), half of them >= 2^63."""
    hi = rng.randint(1, 1 << 31, size=L).astype(np.uint64)
    hi[::2] |= np.uint64(1 << 31)
    lo = rng.randint(0, 1 << 32, size=L).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def _n(L, size):
    steps = {32: 12, 96: 8, 1024: 3}[L]
    return {"whole": steps * L, "partial": steps * L + L // 3 + 1,
            "short": L // 2 - 1}[size]


def _case(L, size, kind, seeded):
    rng = np.random.RandomState(L + len(size) * 7 + len(kind) + seeded)
    P, cdf, sample = _model(kind, rng)
    n = _n(L, size)
    syms = sample(n).astype(np.int64)
    seeds = _seeds(rng, L) if seeded else None
    return P, cdf, syms, seeds


def _passes(L, P, cdf, syms, seeds):
    cfg = LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=P)
    sym_t = torch.from_numpy(syms.astype(np.int32))
    cdf_t = convert.cdf_to_torch(cdf)
    seeds_t = None if seeds is None else convert.u64_to_torch(seeds)
    words, flags, fin = coder64.lanes_pass64_plain(sym_t, cdf_t, cfg,
                                                   seeds_t)
    stream = coder64.compact_pass_plain(words, flags)
    twin = coder64.encode_iid64_plain(sym_t, cdf_t, cfg, seeds_t)
    return cfg, (words, flags, fin, stream), twin


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("kind", ["p1", "p12", "p24", "k1", "skewed", "flat"])
@pytest.mark.parametrize("size", ["whole", "partial", "short"])
@pytest.mark.parametrize("L", [32, 96, 1024])
def test_two_passes_equal_twin_and_host_oracle(L, size, kind, seeded):
    P, cdf, syms, seeds = _case(L, size, kind, seeded)
    cfg, (words, flags, fin, stream), (st_twin, w_twin) = _passes(
        L, P, cdf, syms, seeds)
    n, T = len(syms), -(-len(syms) // L)
    assert words.shape == flags.shape == (T, L)
    # lanes of a partial last step neither code nor flag
    assert not flags.reshape(-1)[n:].any()
    assert int(flags.sum()) == stream.numel()
    assert torch.equal(fin, st_twin) and torch.equal(stream, w_twin)
    c = cdf.astype(np.uint64)
    ref_cfg = RefLaneConfig(num_lanes=L, word_bits=32, state_bits=64,
                            precision=P)
    st_ref, w_ref = ref_il2.encode_shared(c[syms], c[syms + 1] - c[syms],
                                          ref_cfg, seeds=seeds)
    np.testing.assert_array_equal(convert.u64_from_torch(fin), st_ref)
    np.testing.assert_array_equal(convert.u32_from_torch(stream), w_ref)


def test_renorm_rates_of_the_skewed_and_flat_models():
    """The skewed model renorms most lanes at most steps, the flat one
    almost none: the compaction sees dense and near-empty steps."""
    rates = {}
    for kind in ("skewed", "flat"):
        P, cdf, syms, seeds = _case(1024, "whole", kind, True)
        _, (_, flags, _, _), _ = _passes(1024, P, cdf, syms, seeds)
        rates[kind] = float(flags.float().mean())
    assert rates["skewed"] > 0.6 and rates["flat"] < 0.01


@pytest.mark.parametrize("size,kind,seeded", [
    ("partial", "p24", True), ("whole", "skewed", False),
    ("short", "k1", True)])
def test_two_passes_equal_pallas_interpret(size, kind, seeded):
    L = 1024
    P, cdf, syms, seeds = _case(L, size, kind, seeded)
    cfg, (_, _, fin, stream), _ = _passes(L, P, cdf, syms, seeds)
    ref_cfg = RefLaneConfig(num_lanes=L, word_bits=32, state_bits=64,
                            precision=P)
    ref_st, ref_w = pc64.encode_iid64_pallas(syms.astype(np.int32), cdf,
                                             ref_cfg, seeds=seeds)
    np.testing.assert_array_equal(convert.u64_from_torch(fin),
                                  np.asarray(ref_st, np.uint64))
    np.testing.assert_array_equal(convert.u32_from_torch(stream),
                                  np.asarray(ref_w))


def test_compaction_orders_steps_then_lanes():
    """Hand-made flags: the words come out step by step, lanes ascending
    within a step, across 32-lane groups."""
    T, L = 3, 64
    flags = torch.zeros(T, L, dtype=torch.bool)
    for t, l in [(0, 63), (0, 2), (1, 31), (1, 32), (2, 0), (2, 40)]:
        flags[t, l] = True
    words = torch.arange(T * L, dtype=torch.int32).reshape(T, L)
    out = coder64.compact_pass_plain(words, flags)
    assert out.tolist() == [2, 63, 64 + 31, 64 + 32, 128, 128 + 40]


def test_ballots_pack_and_unpack():
    rng = np.random.RandomState(3)
    flags = torch.from_numpy(rng.random_sample((5, 96)) < 0.5)
    flags[0, 31] = flags[1, 63] = True  # the sign bit of a ballot
    ballots = coder64.flag_ballots(flags)
    assert ballots.dtype == torch.int32 and ballots.shape == (5, 3)
    assert int(convert.u32_values(ballots)[0, 0]) >> 31 == 1
    assert torch.equal(coder64.ballot_flags(ballots), flags)


def test_pass_wrappers_on_cpu_run_the_plain_passes_and_launch_nothing():
    P, cdf, syms, seeds = _case(96, "partial", "p24", True)
    cfg, (words, flags, fin, stream), _ = _passes(96, P, cdf, syms, seeds)
    before = dict(coder64.LAUNCHES)
    w, b, st = coder64.lanes_pass64(
        torch.from_numpy(syms.astype(np.int32)), convert.cdf_to_torch(cdf),
        cfg, seeds=convert.u64_to_torch(seeds))
    assert torch.equal(w, words) and torch.equal(st, fin)
    assert torch.equal(b, coder64.flag_ballots(flags))
    assert torch.equal(coder64.compact_pass(w, b), stream)
    assert coder64.LAUNCHES == before


def _edge_probs():
    ps = {1, 2, 3, 5, 7, 100, 1 << 24}
    for k in range(1, 25):
        ps |= {(1 << k) - 1, 1 << k, min((1 << k) + 1, 1 << 24)}
    rng = np.random.RandomState(8)
    ps |= {int(v) for v in rng.randint(1, (1 << 24) + 1, size=200)}
    return sorted(ps)


def test_multiply_high_division_is_exact_at_edge_states():
    """The encode kernel's division (a multiply-high by a per-symbol
    reciprocal) equals integer division for probabilities 1 .. 2^24 and
    states at 2^32, at 2^63, just below 2^64 and near multiples of the
    probability, and for random 64-bit states."""
    rng = np.random.RandomState(9)
    rand = [int(v) for v in rng.randint(0, 1 << 62, size=40, dtype=np.int64)]
    for p in _edge_probs():
        magic, l = coder64.division_magic(p)
        assert 0 < magic < 1 << 64 and (1 << l) >= p > (1 << l) >> 1
        xs = [1 << 32, (1 << 32) + 1, (1 << 32) + p, (1 << 63) - 1, 1 << 63,
              (1 << 63) + 1, (1 << 64) - 1, (1 << 64) - 2, (1 << 64) - p,
              (1 << 64) - p - 1, p << 40, (p << 40) - 1, p * (1 << 39) + p - 1,
              *rand, *(r << 2 | 3 for r in rand)]
        for x in xs:
            x &= (1 << 64) - 1
            assert coder64.divide_by_magic(x, magic, l) == x // p, (p, x)


def test_division_magic_equals_the_kernels_bit_serial_build():
    """The records kernel builds the reciprocal by 64 steps of shift and
    subtract from 2^l - prob; the same steps in Python give
    division_magic's value."""
    for p in _edge_probs():
        l = (p - 1).bit_length()
        rem, q = (1 << l) - p, 0
        for _ in range(64):
            rem, q = rem << 1, q << 1
            if rem >= p:
                rem, q = rem - p, q | 1
        assert (q + 1, l) == coder64.division_magic(p)
