"""Kernel 14, the S=32 reference-exact encode over (cum, prob) planes, as
the card runs it: kernel 17's two passes at W=16, S=32
(``csrc/ilans2_wide.cuh``, ``encode_lanes_kernel<16, 32,
PlaneLanesModel>`` and the row-major compaction), each with a plain
PyTorch version in the port:

- ``exact_family.encode_lanes_plain`` at S=32 (``coder.lanes32_steps``):
  every lane through steps T-1 .. 0 over its column of the planes on its
  own, the emitted 16-bit words dense in rows by step, the renorm flags,
  the final states;
- ``coder.compact_pass_plain``: the flagged words in row-major order.

Composed, they are held byte for byte equal to the one-loop twin
(``exact_family.encode_tables_plain``), the port's and the JAX package's
numpy encoders (``interleaved2.encode_shared``) and two interpret-mode
calls of the JAX package's Pallas encoder
(``exact_family.encode_tables_pallas``, ``_build_exact_encoder``).
Inputs are made by numpy from a seed: gaussian planes from ``exact_ecp``
at P = 12 and 16, random planes at P = 1, 12 and 16 (every (cum, prob)
with cum + prob <= 2^P), at L in {32, 96, 1024} (the passes take any
multiple of 32), with and without seeds, n whole and with a partial last
step.  The kernel's pass A divides with the card's native u32 division,
exact, so no quotient model stands beside it (kernel 17's f64 estimate,
``exact_family.plane_quotient``, is tested at S=64).  Integer coding: the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu.ops import exact_family as ref_ef
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops.interleaved import LaneConfig as RefCfg
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host encoder on its numpy path."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(L, P):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)


def _gaussian_planes(n, P, seed):
    rng = np.random.RandomState(seed)
    means = rng.randn(n) * 20.0
    scales = np.exp(rng.normal(0.4, 0.6, n))
    syms = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
                   ).astype(np.int64)
    return ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, P)


def _random_planes(n, P, seed):
    """(cum, prob) with 1 <= prob <= 2^P and cum + prob <= 2^P."""
    rng = np.random.RandomState(seed)
    probs = rng.randint(1, (1 << P) + 1, size=n)
    cums = (rng.random_sample(n) * ((1 << P) - probs + 1)).astype(np.int64)
    return cums.astype(np.uint32), probs.astype(np.uint32)


def _seeds(L, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(1 << 16, 1 << 32, L, dtype=np.int64).astype(np.uint32)


def _check(cums, probs, L, P, seeds=None):
    """Pass A and the compaction against the one-loop twin and both
    packages' numpy encoders; returns (states, stream, flags)."""
    n, cfg = len(cums), _cfg(L, P)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L)
    s_t = None if seeds is None else convert.u32_to_torch(seeds)
    words, flags, states = ef.encode_lanes_plain(c_t, p_t, cfg, s_t, n)
    assert states.dtype == torch.int32 and words.shape == (-(-n // L), L)
    stream = coder.compact_pass_plain(words, flags)
    st_p, w_p = ef.encode_tables_plain(c_t, p_t, cfg, s_t, n)
    assert torch.equal(states, st_p) and torch.equal(stream, w_p)
    for oracle, ocfg in ((il2.encode_shared, cfg),
                         (ref_il2.encode_shared, RefCfg(L, 16, 32, P))):
        st_h, w_h = oracle(cums, probs, ocfg, seeds=seeds)
        np.testing.assert_array_equal(convert.u32_from_torch(states), st_h)
        np.testing.assert_array_equal(convert.u32_from_torch(stream), w_h)
    return states, stream, flags


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("P", [12, 16])
@pytest.mark.parametrize("L,n", [(32, 32 * 40), (32, 32 * 40 - 7),
                                 (96, 96 * 13 - 50), (1024, 1024 * 4),
                                 (1024, 1024 * 3 + 5)])
def test_gaussian_planes_equal_twin_and_oracles(L, n, P, seeded):
    cums, probs = _gaussian_planes(n, P, seed=L + n + P)
    _check(cums, probs, L, P, _seeds(L, n) if seeded else None)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("P", [1, 12, 16])
@pytest.mark.parametrize("L,n", [(32, 32 * 24 - 1), (96, 96 * 9),
                                 (1024, 1024 * 2 - 3)])
def test_random_planes_equal_twin_and_oracles(L, n, P, seeded):
    """Every prob from 1 to 2^P: at P = 1 a state doubles or stays put a
    step; at P = 16 a prob of 2^16 codes a state without a renorm."""
    cums, probs = _random_planes(n, P, seed=3 * L + P)
    _, stream, flags = _check(cums, probs, L, P,
                              _seeds(L, P) if seeded else None)
    assert int(stream.numel()) == int(flags.sum())


@pytest.mark.parametrize("P,planes", [(12, "gaussian"), (16, "random")])
def test_equals_the_pallas_encoder_in_interpret_mode(P, planes):
    L, n = 128, 2 * 128 - 9  # partial last step
    make = _gaussian_planes if planes == "gaussian" else _random_planes
    cums, probs = make(n, P, seed=13 + P)
    states, stream, _ = _check(cums, probs, L, P)
    r_st, r_w = ref_ef.encode_tables_pallas(cums, probs, RefCfg(L, 16, 32, P),
                                            interpret=True)
    np.testing.assert_array_equal(convert.u32_from_torch(states),
                                  np.asarray(r_st))
    np.testing.assert_array_equal(convert.u32_from_torch(stream),
                                  np.asarray(r_w))


def test_cpu_tensors_run_the_plain_passes_and_launch_nothing():
    L, n, P = 128, 128 * 6 - 3, 12
    cums, probs = _gaussian_planes(n, P, seed=5)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L)
    s_t = convert.u32_to_torch(_seeds(L, 7))
    before = dict(ef.LAUNCHES), dict(coder.LAUNCHES)
    states, stream = ef.encode_tables(c_t, p_t, _cfg(L, P), s_t, n)
    words, flags, st_l = ef.encode_lanes_plain(c_t, p_t, _cfg(L, P), s_t, n)
    assert words.shape == (6, L) and words.dtype == torch.int32
    assert torch.equal(states, st_l)
    assert torch.equal(stream, coder.compact_pass(words,
                                                  coder.flag_ballots(flags)))
    assert (dict(ef.LAUNCHES), dict(coder.LAUNCHES)) == before
