"""Kernel 11, the family rANS decode on the cluster step of
``csrc/ilans2_wide.cuh``, on the CPU, exactly.

Its plain PyTorch version (``family.decode_family_plain``: what a CPU
tensor runs, and what the card tests in ``tests/test_torch_cuda.py`` hold
the kernel against) runs at the shapes those tests force on the kernel
(L = 32, 96, 4096; n = 1, L - 5, 2L + 7, so a partial last step whose
lanes read the padded parameters; all four families) against the port's
numpy host oracle and the JAX package's family decode: its numpy oracle
in every case, its Pallas kernel in interpret mode in four (the Pallas
kernel takes L % 128 == 0 only).  So every card case has an expected
output checked here.  Also the wrappers' paths on CPU tensors.
"""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import pallas_family as pf
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig

LO, HI = -100, 100
SHAPES = [(L, n) for L in (32, 96, 4096) for n in (1, L - 5, 2 * L + 7)]
# the cases that also run the JAX package's Pallas decode in interpret mode
# (seconds each)
INTERPRET = {("gaussian", 4096, 2 * 4096 + 7), ("cauchy", 4096, 2 * 4096 + 7),
             ("laplace", 4096, 4096 - 5), ("logistic", 4096, 4096 - 5)}


def _cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)


def _message(L, n, family):
    """The card tests' message (``_family_host_pair``): seeded means,
    scales and symbols, coded by the numpy host coder."""
    rng = np.random.RandomState(L + n)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    noise = rng.standard_cauchy(n) if family == "cauchy" else rng.randn(n)
    symbols = np.clip(np.round(means + noise * scales), LO, HI).astype(
        np.int32)
    cums, probs = fam.family_tables_host(symbols, means, scales, family, LO,
                                         HI)
    states, stream = il2.encode_shared(cums, probs, _cfg(L))
    return means, scales, symbols, states, stream


@pytest.mark.parametrize("L,n", SHAPES)
@pytest.mark.parametrize("family", fam.FAMILIES)
def test_plain_decode_matches_host_oracles_and_jax(family, L, n):
    cfg = _cfg(L)
    means, scales, symbols, states, stream = _message(L, n, family)
    mu, sg = convert.params_to_torch(means, scales, n, L)
    out, fin = fam.decode_family_plain(
        convert.u32_to_torch(states), convert.u32_to_torch(stream), mu, sg,
        family, LO, HI, cfg, n, return_final_states=True)
    out = out.numpy()
    np.testing.assert_array_equal(out, symbols)
    np.testing.assert_array_equal(convert.u32_from_torch(fin),
                                  np.full(L, 1 << 16))
    np.testing.assert_array_equal(
        out, fam.decode_family_host(states, stream, means, scales, family,
                                    LO, HI, cfg, n))
    ref_cfg = RefLaneConfig(L, 16, 32, 12)
    np.testing.assert_array_equal(
        out, pf.decode_family_host(states, stream, means, scales, family, LO,
                                   HI, ref_cfg, n))
    if (family, L, n) in INTERPRET:
        ref = pf.decode_family_pallas(states, stream, means, scales, family,
                                      LO, HI, ref_cfg, n, interpret=True)
        np.testing.assert_array_equal(out, np.asarray(ref))


def test_truncated_stream_plain_decode_matches_host_oracles():
    """The card tests' truncated stream (L = 32768 there; 4096 here): reads
    past the end give zero words in all three decodes."""
    L, n = 4096, 3 * 4096 - 11
    cfg = _cfg(L)
    means, scales, _, states, stream = _message(L, n, "cauchy")
    cut = stream[: len(stream) // 3]
    mu, sg = convert.params_to_torch(means, scales, n, L)
    out = fam.decode_family_plain(
        convert.u32_to_torch(states), convert.u32_to_torch(cut), mu, sg,
        "cauchy", LO, HI, cfg, n).numpy()
    host = fam.decode_family_host(states, cut, means, scales, "cauchy", LO,
                                  HI, cfg, n)
    np.testing.assert_array_equal(out, host)
    np.testing.assert_array_equal(
        out, pf.decode_family_host(states, cut, means, scales, "cauchy", LO,
                                   HI, RefLaneConfig(L, 16, 32, 12), n))


def test_cpu_tensors_run_the_plain_decode():
    """``decode_family`` on CPU tensors is the plain decode (no reach
    check: that applies to a card's launch), the forced cluster size
    needs CUDA tensors, and the cluster size must be 1 .. 16."""
    L, n = 128, 300
    cfg = _cfg(L)
    means, scales, symbols, states, stream = _message(L, n, "logistic")
    mu, sg = convert.params_to_torch(means, scales, n, L)
    st, w = convert.u32_to_torch(states), convert.u32_to_torch(stream)
    before = dict(fam.LAUNCHES)
    out = fam.decode_family(st, w, mu, sg, "logistic", LO, HI, cfg, n)
    np.testing.assert_array_equal(out.numpy(), symbols)
    assert fam.LAUNCHES == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fam.decode_family_cluster(st, w, mu, sg, "logistic", LO, HI, cfg, n,
                                  4)
    cfg32 = _cfg(32)
    m32, s32, _, st32, w32 = _message(32, 40, "gaussian")
    mu32, sg32 = convert.params_to_torch(m32, s32, 40, 32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fam.decode_family_cluster(convert.u32_to_torch(st32),
                                  convert.u32_to_torch(w32), mu32, sg32,
                                  "gaussian", LO, HI, cfg32, 40, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        fam.decode_family(convert.u32_to_torch(st32),
                          convert.u32_to_torch(w32), mu32, sg32, "gaussian",
                          LO, HI, cfg32, 40)
    assert coder.MAX_DECODE_LANES % 128 == 0


def test_cpu_tensors_run_the_plain_segment_decode():
    """Kernel 16's forced cluster size needs CUDA tensors as well; its
    CPU path is the plain table decode."""
    L = 128
    cfg = LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=24)
    states = torch.full((L,), 1 << 32, dtype=torch.int64)
    stream = torch.zeros(4, dtype=torch.int32)
    tabs = torch.zeros((1, 4, L), dtype=torch.int32)
    base = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ef.decode_tables_seg_cluster(states, stream, tabs, base, cfg, -100,
                                     100, 100, 4)
