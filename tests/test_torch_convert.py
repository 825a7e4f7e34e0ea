"""constriction_tpu_torch.convert: lossless round trips of the integer data
that crosses between the JAX package and the port."""

import numpy as np
import pytest
import torch

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops.interleaved import LaneConfig
from constriction_tpu_torch import convert

CFG32 = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
CFG64 = LaneConfig(num_lanes=128, word_bits=32, state_bits=64, precision=24)


def _u64(rng, n):
    hi = rng.randint(0, 1 << 32, size=n).astype(np.uint64)
    lo = rng.randint(0, 1 << 32, size=n).astype(np.uint64)
    x = (hi << np.uint64(32)) | lo
    x[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    return x


def test_u64_states_round_trip_including_top_bit():
    x = _u64(np.random.RandomState(0), 128)
    t = convert.states_to_torch(x, CFG64)
    assert t.dtype == torch.int64
    assert int(t[2]) == -(1 << 63)  # 2^63 reads as the most negative int64
    back = convert.states_from_torch(t, CFG64)
    assert back.dtype == np.uint64
    np.testing.assert_array_equal(back, x)


def test_u64_halves_and_join_are_inverse():
    x = _u64(np.random.RandomState(1), 1000)
    hi, lo = convert.u64_halves(convert.u64_to_torch(x))
    np.testing.assert_array_equal(hi.numpy().astype(np.uint64),
                                  x >> np.uint64(32))
    np.testing.assert_array_equal(lo.numpy().astype(np.uint64),
                                  x & np.uint64(0xFFFFFFFF))
    np.testing.assert_array_equal(
        convert.u64_from_torch(convert.u64_join(hi, lo)), x)


def test_u32_words_and_states_round_trip():
    rng = np.random.RandomState(2)
    w = rng.randint(0, 1 << 32, size=1000).astype(np.uint32)
    w[:3] = [0, (1 << 31), (1 << 32) - 1]
    t = convert.u32_to_torch(w)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(convert.u32_from_torch(t), w)
    v = convert.u32_values(t)
    np.testing.assert_array_equal(v.numpy(), w.astype(np.int64))
    np.testing.assert_array_equal(convert.u32_from_torch(convert.u32_bits(v)),
                                  w)
    st = convert.states_to_torch(w[:128], CFG32)
    np.testing.assert_array_equal(convert.states_from_torch(st, CFG32),
                                  w[:128])


@pytest.mark.parametrize("P", [12, 24])
def test_cdf_to_torch(P):
    probs = np.random.RandomState(P).dirichlet(np.full(50, 2.0))
    cdf = ContiguousCategoricalEntropyModel \
        .from_floating_point_probabilities_fast(probs, P).cdf
    t = convert.cdf_to_torch(cdf)
    assert t.dtype == torch.int64 and int(t[-1]) == 1 << P
    np.testing.assert_array_equal(t.numpy(), cdf.astype(np.int64))


@pytest.mark.parametrize("cfg", [CFG32, CFG64], ids=["S32", "S64"])
def test_range_planes_round_trip(cfg):
    """Checkpoint planes as the JAX package's build_checkpoints_range
    returns them (u32 rows at S=32, u64 at S=64) -> the port's tensors and
    back, bit for bit."""
    rng = np.random.RandomState(cfg.state_bits)
    if cfg.state_bits == 64:
        planes = tuple(_u64(rng, 128) for _ in range(3))
        dtype = torch.int64
    else:
        planes = tuple(rng.randint(0, 1 << 32, size=128).astype(np.uint32)
                       for _ in range(3))
        dtype = torch.int32
    ts = convert.planes_to_torch(planes, cfg)
    assert len(ts) == 3 and all(t.dtype == dtype for t in ts)
    for a, b in zip(convert.planes_from_torch(ts, cfg), planes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
