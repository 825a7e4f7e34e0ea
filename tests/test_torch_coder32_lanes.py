"""The small-preset encoder's two passes (constriction_tpu_torch.ops.coder:
``lanes_pass32_plain``, the lane-parallel pass, and ``compact_pass_plain``,
the row-major compaction) against the port's single-loop twin
``encode_iid_plain``, the JAX package's host oracle
(``interleaved2.encode_shared``) and its Pallas kernel in interpret mode
(as tests/test_torch_coder.py runs it).  The CUDA kernels' index math
mirrors the two passes.  Also here: the exactness of the S=32 encode
kernel's division (a 32-bit multiply-high by a per-symbol reciprocal,
``coder.division_magic32``) against integer division for every
probability the preset takes.  Inputs are made from numpy seeds; integer
coding, so the tolerance is exact equality."""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops import pallas_coder as pc
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import coder
from constriction_tpu_torch.ops.interleaved import LaneConfig


def _model(kind, rng):
    """(precision, cdf u32, symbol sampler) of a named test model."""
    if kind == "p1":  # two symbols of probability 1/2 at P = 1
        return 1, np.array([0, 1, 2], np.uint32), lambda n: rng.randint(0, 2, n)
    if kind == "k1":  # one symbol, prob = 2^P: no information, no word
        return 16, np.array([0, 1 << 16], np.uint32), lambda n: np.zeros(
            n, np.int64)
    if kind == "skewed":  # 16 bits a symbol: every lane renorms every step
        return 16, np.array([0, 1, 1 << 16], np.uint32), lambda n: np.zeros(
            n, np.int64)
    if kind == "flat":  # almost no information: a renorm is rare
        return 16, np.array([0, (1 << 16) - 1, 1 << 16], np.uint32), \
            lambda n: np.zeros(n, np.int64)
    P = {"p12": 12, "p16": 16}[kind]
    probs = rng.dirichlet(np.full(100, 2.0))
    return P, fast_quantized_cdf(probs, P), lambda n: rng.choice(
        100, size=n, p=probs)


def _seeds(rng, L):
    """u32 start states over [2^16, 2^32), half of them >= 2^31."""
    x = rng.randint(1 << 16, 1 << 31, size=L).astype(np.uint32)
    x[::2] |= np.uint32(1 << 31)
    return x


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
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)
    sym_t = torch.from_numpy(syms.astype(np.int32))
    cdf_t = convert.cdf_to_torch(cdf)
    seeds_t = None if seeds is None else convert.u32_to_torch(seeds)
    words, flags, fin = coder.lanes_pass32_plain(sym_t, cdf_t, cfg, seeds_t)
    stream = coder.compact_pass_plain(words, flags)
    twin = coder.encode_iid_plain(sym_t, cdf_t, cfg, seeds_t)
    return cfg, (words, flags, fin, stream), twin


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("kind",
                         ["p1", "p12", "p16", "k1", "skewed", "flat"])
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
    # emitted words are 16-bit
    assert int(convert.u32_values(words).max()) < 1 << 16
    assert torch.equal(fin, st_twin) and torch.equal(stream, w_twin)
    c = cdf.astype(np.uint64)
    ref_cfg = RefLaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                            precision=P)
    st_ref, w_ref = ref_il2.encode_shared(c[syms], c[syms + 1] - c[syms],
                                          ref_cfg, seeds=seeds)
    np.testing.assert_array_equal(convert.u32_from_torch(fin), st_ref)
    np.testing.assert_array_equal(convert.u32_from_torch(stream), w_ref)


def test_renorm_rates_of_the_skewed_and_flat_models():
    """The skewed model renorms every lane at every step, the flat one
    almost none: the compaction sees full and near-empty steps."""
    rates = {}
    for kind in ("skewed", "flat"):
        P, cdf, syms, seeds = _case(1024, "whole", kind, True)
        _, (_, flags, _, _), _ = _passes(1024, P, cdf, syms, seeds)
        rates[kind] = float(flags.float().mean())
    assert rates["skewed"] == 1.0 and rates["flat"] < 0.01


@pytest.mark.parametrize("size,kind,seeded", [
    ("partial", "p12", True), ("whole", "skewed", False)])
def test_two_passes_equal_pallas_interpret(size, kind, seeded):
    L = 1024
    P, cdf, syms, seeds = _case(L, size, kind, seeded)
    cfg, (_, _, fin, stream), _ = _passes(L, P, cdf, syms, seeds)
    ref_cfg = RefLaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                            precision=P)
    ref_st, ref_w = pc.encode_iid_pallas(syms.astype(np.int32), cdf,
                                         ref_cfg, seeds=seeds)
    np.testing.assert_array_equal(convert.u32_from_torch(fin),
                                  np.asarray(ref_st, np.uint32))
    np.testing.assert_array_equal(convert.u32_from_torch(stream),
                                  np.asarray(ref_w))


def test_pass_wrappers_on_cpu_run_the_plain_passes_and_launch_nothing():
    P, cdf, syms, seeds = _case(96, "partial", "p12", True)
    cfg, (words, flags, fin, stream), _ = _passes(96, P, cdf, syms, seeds)
    before = dict(coder.LAUNCHES)
    w, b, st = coder.lanes_pass32(
        torch.from_numpy(syms.astype(np.int32)), convert.cdf_to_torch(cdf),
        cfg, seeds=convert.u32_to_torch(seeds))
    assert torch.equal(w, words) and torch.equal(st, fin)
    assert torch.equal(b, coder.flag_ballots(flags))
    assert torch.equal(coder.compact_pass(w, b), stream)
    assert coder.LAUNCHES == before


def test_cluster_entry_points_need_a_card():
    """A forced cluster size runs only the kernel: CPU tensors raise, and
    no plain version stands in for it."""
    P, cdf, syms, _ = _case(96, "partial", "p12", False)
    cfg = LaneConfig(num_lanes=96, word_bits=16, state_bits=32, precision=P)
    st, w = coder.encode_iid_plain(torch.from_numpy(syms.astype(np.int32)),
                                   convert.cdf_to_torch(cdf), cfg)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        coder.decode_shared_cluster(st, w, convert.cdf_to_torch(cdf), cfg,
                                    len(syms), 4)


# --- the multiply-high division, for every probability 1 .. 2^16 ---------

ALL_PROBS = np.arange(1, (1 << 16) + 1, dtype=np.uint64)


def _magics():
    pairs = [coder.division_magic32(int(p)) for p in ALL_PROBS]
    return (np.array([m for m, _ in pairs], np.uint64),
            np.array([l for _, l in pairs], np.uint64))


def _check_division(x, magic, l, p):
    """divide_by_magic32 on uint64 arrays against x // p, elementwise."""
    x = np.asarray(x, np.uint64)
    got = coder.divide_by_magic32(x, magic, l)
    want = x // p
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, (int(np.broadcast_to(p, x.shape).flat[bad[0]]),
                           int(x.flat[bad[0]]))


def test_magic_fits_32_bits_and_l_is_ceil_log2():
    magic, l = _magics()
    assert (magic >= 1).all() and (magic < np.uint64(1 << 32)).all()
    two_l = np.uint64(1) << l
    assert (two_l >= ALL_PROBS).all() and ((two_l >> np.uint64(1)) < ALL_PROBS).all()


def test_multiply_high_division_is_exact_at_edge_states_for_every_prob():
    """The S=32 encode kernel's division equals integer division for every
    probability 1 .. 2^16 at the states pass A can see and at the edges
    of the 32-bit range: 2^16 (the floor), 2^32 - 1, prob * 2^(32 - P) - 1
    for every P that admits prob (the largest state that codes without a
    renorm), multiples of prob and their neighbours, and random 32-bit
    states."""
    magic, l = _magics()
    p = ALL_PROBS
    top = np.uint64((1 << 32) - 1)
    cols = [np.full_like(p, 1 << 16), np.full_like(p, (1 << 16) - 1),
            np.full_like(p, top), np.full_like(p, top - np.uint64(1)),
            p, p - np.uint64(1), p + np.uint64(1)]
    for k in range(16, 32):  # prob * 2^(32 - P) - 1 for P = 32 - k >= l
        edge = (p << np.uint64(k)) - np.uint64(1)
        cols.append(np.where(edge <= top, edge, top))
    mult = top // p * p  # the largest multiple of prob below 2^32
    cols += [mult, mult - np.uint64(1), np.minimum(mult + np.uint64(1), top),
             mult - p, mult - p + np.uint64(1)]
    rng = np.random.RandomState(12)
    cols += [rng.randint(0, 1 << 32, size=p.size).astype(np.uint64)
             for _ in range(24)]
    x = np.stack(cols)  # [states, probs]
    _check_division(x, magic[None, :], l[None, :], p[None, :])


def test_division_magic32_equals_the_kernels_bit_serial_build():
    """The records kernel builds the reciprocal by 32 steps of shift and
    subtract from 2^l - prob; the same steps on numpy arrays give
    division_magic32's value for every probability."""
    magic, l = _magics()
    p = ALL_PROBS
    rem = (np.uint64(1) << l) - p
    q = np.zeros_like(p)
    for _ in range(32):
        rem <<= np.uint64(1)
        q <<= np.uint64(1)
        take = rem >= p
        rem = np.where(take, rem - p, rem)
        q |= take.astype(np.uint64)
    np.testing.assert_array_equal(q + np.uint64(1), magic)


def test_divide_by_magic32_on_python_integers():
    for p in (1, 2, 3, 7, 100, 4095, 4096, 4097, 65535, 65536):
        magic, l = coder.division_magic32(p)
        for x in (0, 1, p - 1, p, 1 << 16, (1 << 32) - 1, 123456789):
            assert coder.divide_by_magic32(x, magic, l) == x // p, (p, x)
