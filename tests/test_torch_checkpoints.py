"""Random access in the port against the JAX package, on the CPU:
``build_checkpoints`` / ``decode_from_checkpoint`` for v1 and v2 containers
at both presets.  Offsets, snapshot states, start symbols and suffixes must
equal the JAX package's (its decode runs the Pallas kernels in interpret
mode, so those cases are few), and a decode seeded with a snapshot must
give the message's suffix.  The JAX package's host paths prefer its C++
library where that is loaded; every test here takes its numpy path
(``native.LIB`` set to None), so none depends on that build.
"""

import numpy as np
import pytest
import torch

import constriction_tpu.tpu as ctpu
from constriction_tpu import native
from constriction_tpu.models.categorical import fast_quantized_cdf
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import cuda as ctt
from constriction_tpu_torch.ops import framing
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host code on its numpy path."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(S, L, P):
    return LaneConfig(num_lanes=L, word_bits=S // 2, state_bits=S,
                      precision=P)


def _ref_cfg(cfg):
    return RefLaneConfig(cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                         cfg.precision)


def _data(P, n, seed, K=100):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = np.asarray(fast_quantized_cdf(probs, P), dtype=np.uint32)
    return cdf, rng.choice(K, size=n, p=probs).astype(np.int64)


def _host_stream(symbols, cdf, cfg):
    c = cdf.astype(np.uint64)
    cums = c[symbols]
    return il2.encode_shared(cums, c[symbols + 1] - cums, cfg)


# --- the host layer


@pytest.mark.parametrize("S,P,L,n,interval", [
    (32, 12, 128, 3000, 4),
    (32, 16, 256, 5000, 1),
    (64, 24, 128, 3000, 5),
    (64, 18, 384, 4000, 3),
    (32, 12, 200, 2500, 2),   # a config the kernels do not take
    (32, 12, 128, 100, 4),    # one step: no checkpoint
])
def test_build_checkpoints_equals_the_jax_package(S, P, L, n, interval):
    cfg = _cfg(S, L, P)
    cdf, symbols = _data(P, n, seed=S + n)
    states, stream = _host_stream(symbols, cdf, cfg)
    ref_off, ref_st = ref_il2.build_checkpoints(states, stream, n, cdf,
                                                _ref_cfg(cfg), interval)
    off, st = il2.build_checkpoints(states, stream, n, cdf, cfg, interval)
    assert off.dtype == ref_off.dtype and st.dtype == ref_st.dtype
    assert st.shape == ref_st.shape
    np.testing.assert_array_equal(off, ref_off)
    np.testing.assert_array_equal(st, ref_st)
    T = -(-n // L)
    assert len(off) == max(-(-T // interval) - 1, 0)
    for c in range(len(off)):
        start, out = il2.decode_from_checkpoint(c, off, st, stream, n, cdf,
                                                cfg, interval, device="cpu")
        ref_start, ref_out = ref_il2.decode_from_checkpoint(
            c, ref_off, ref_st, stream, n, cdf, _ref_cfg(cfg), interval)
        assert start == ref_start == (c + 1) * interval * L
        np.testing.assert_array_equal(out, ref_out)
        np.testing.assert_array_equal(out, symbols[start:])


def test_truncated_stream_and_bad_interval():
    cfg = _cfg(32, 128, 12)
    cdf, symbols = _data(12, 3000, seed=4)
    states, stream = _host_stream(symbols, cdf, cfg)
    cut = stream[: len(stream) // 2]
    ref = ref_il2.build_checkpoints(states, cut, 3000, cdf, _ref_cfg(cfg), 4)
    got = il2.build_checkpoints(states, cut, 3000, cdf, cfg, 4)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    with pytest.raises(ValueError, match="interval must be positive"):
        il2.build_checkpoints(states, stream, 3000, cdf, cfg, 0)


def test_checkpoint_past_the_end_gives_an_empty_suffix():
    cfg = _cfg(32, 128, 12)
    cdf, symbols = _data(12, 1000, seed=6)
    states, stream = _host_stream(symbols, cdf, cfg)
    off, st = il2.build_checkpoints(states, stream, 1000, cdf, cfg, 2)
    k = len(off) + 3  # starts past the last symbol
    start, out = il2.decode_from_checkpoint(k, off, st, stream, 1000, cdf,
                                            cfg, 2, device="cpu")
    ref = ref_il2.decode_from_checkpoint(k, off, st, stream, 1000, cdf,
                                         _ref_cfg(cfg), 2)
    assert start == ref[0] and len(out) == len(ref[1]) == 0
    assert out.dtype == ref[1].dtype


# --- through the facades (the JAX side decodes with Pallas in interpret mode)


@pytest.mark.parametrize("P,compact", [(24, True), (24, False), (12, True),
                                       (12, False)])
def test_facade_checkpoints_equal_the_jax_facade(P, compact):
    cdf, symbols = _data(P, 20_000, seed=P + compact)
    data = ctt.encode_iid(symbols, cdf, compact=compact, device="cpu")
    interval = 3
    ref = ctpu.build_checkpoints(data, cdf, interval)
    got = ctt.build_checkpoints(data, cdf, interval)
    assert got[0].dtype == ref[0].dtype and got[1].dtype == ref[1].dtype
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert len(got[0]) >= 3
    full = ctt.decode_iid(data, cdf, device="cpu")
    c = len(got[0]) // 2
    ref_start, ref_out = ctpu.decode_from_checkpoint(data, cdf, interval, c,
                                                     *ref)
    for k in {0, c, len(got[0]) - 1}:
        start, out = ctt.decode_from_checkpoint(data, cdf, interval, k, *got,
                                                device="cpu")
        np.testing.assert_array_equal(out, full[start:])
        if k == c:
            assert start == ref_start
            np.testing.assert_array_equal(out, np.asarray(ref_out))
    if compact:  # the suffix runs through region B to the end of the message
        assert framing.parse_v2(data).k_B > 0
        assert start + len(out) == len(symbols)


def test_v2_checkpoint_beyond_region_a_raises():
    cdf, symbols = _data(24, 20_000, seed=8)
    data = ctt.encode_iid(symbols, cdf, device="cpu")
    off, st = ctt.build_checkpoints(data, cdf, 3)
    k = len(off) + 5
    with pytest.raises(ValueError) as a:
        ctpu.decode_from_checkpoint(data, cdf, 3, k, off, st)
    with pytest.raises(ValueError, match="beyond region A") as b:
        ctt.decode_from_checkpoint(data, cdf, 3, k, off, st, device="cpu")
    assert str(b.value) == str(a.value)


def test_facade_checks_the_cdf_and_the_device(monkeypatch):
    cdf24, symbols = _data(24, 5000, seed=2)
    cdf12, _ = _data(12, 10, seed=2)
    data = ctt.encode_iid(symbols, cdf24, device="cpu")
    ckpt = ctt.build_checkpoints(data, cdf24, 2)
    with pytest.raises(ValueError) as a:
        ctpu.build_checkpoints(data, cdf12, 2)
    with pytest.raises(ValueError) as b:
        ctt.build_checkpoints(data, cdf12, 2)
    assert str(b.value) == str(a.value)
    with pytest.raises(ValueError, match="precision"):
        ctt.decode_from_checkpoint(data, cdf12, 2, 0, *ckpt, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.decode_from_checkpoint(data, cdf24, 2, 0, *ckpt)
