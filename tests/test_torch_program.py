"""The port's block program (``parallel.container``: upload, launch, gather)
on lists of CPU devices, where the launch half runs the plain PyTorch
twins.

Every container the program writes equals the port's numpy host coders
(``parallel.encode_host``) and, for rANS, the JAX package's host loop
(``container.encode(..., device=False)``), byte for byte, for any device
list.  The gather reads back a fixed number of times per device, whatever
the block count; corrupt range data raises once, after every block was
launched; the legs return what the per-call lane wrappers return.  The
card tests (``tests/test_torch_cuda.py``) put the launch half under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import re

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu import parallel as jpar
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert, parallel
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig
from constriction_tpu_torch.parallel import container

CFGS = {32: LaneConfig(num_lanes=128, word_bits=16, state_bits=32,
                       precision=12),
        64: LaneConfig(num_lanes=128, word_bits=32, state_bits=64,
                       precision=24)}
CONTAINERS = [("rans", False), ("rans", True), ("range", False)]


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host code on its numpy path."""
    monkeypatch.setattr(native, "LIB", None)


@pytest.fixture
def transfers(monkeypatch):
    """Counts of the program's host <-> device transfers (the uploads and
    the gather's read-backs), by kind."""
    counts = {"up": 0, "back": 0}
    up, back = convert.upload, convert.to_host

    def counted_upload(tensors, device):
        counts["up"] += 1
        return up(tensors, device)

    def counted_back(t):
        counts["back"] += 1
        return back(t)

    monkeypatch.setattr(convert, "upload", counted_upload)
    monkeypatch.setattr(convert, "to_host", counted_back)
    return counts


def _workload(n, P, seed, K=37):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(K))
    return (rng.choice(K, size=n, p=probs).astype(np.int64),
            fast_quantized_cdf(probs, P))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("coder,compact", CONTAINERS)
def test_program_bytes_equal_host_coders(coder, compact, S, B, k):
    """At n = 10007 and B = 8 the compact container has a pooled tail."""
    cfg = CFGS[S]
    syms, cdf = _workload(10007, cfg.precision, seed=B + 10 * k + S)
    devices = ["cpu"] * k
    got = parallel.encode(syms, cdf, cfg=cfg, num_blocks=B, device=devices,
                          coder=coder, compact=compact)
    want = parallel.encode_host(syms, cdf, cfg, B, coder, compact)
    np.testing.assert_array_equal(got, want)
    if coder == "rans":
        ref = RefLaneConfig(cfg.num_lanes, cfg.word_bits, cfg.state_bits,
                            cfg.precision)
        np.testing.assert_array_equal(
            got, jpar.encode(syms, cdf, cfg=ref, num_blocks=B, device=False,
                             compact=compact))
    out = parallel.decode(got, cdf, device=devices)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, syms)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("coder", ["rans", "range"])
def test_read_backs_per_call_are_a_constant_times_devices(coder, k,
                                                          transfers):
    """One upload a device; the encode's gather reads back twice a device
    (the ends, then the streams and states), the decode's once (the
    symbols, with the range flags); none of it grows with B."""
    cfg = CFGS[32]
    syms, cdf = _workload(3001, cfg.precision, seed=k)
    devices = ["cpu"] * k
    for B in (1, 3, 8):
        D = container._pick_device_count(B, k)
        transfers.update(up=0, back=0)
        cont = parallel.encode(syms, cdf, cfg=cfg, num_blocks=B,
                               device=devices, coder=coder)
        assert transfers == {"up": D, "back": 2 * D}, (B, transfers)
        transfers.update(up=0, back=0)
        parallel.decode(cont, cdf, device=devices)
        assert transfers == {"up": D, "back": D}, (B, transfers)


def test_lane_wrappers_transfer_a_fixed_number_of_times(transfers):
    """The per-call wrappers are one block of the same program."""
    cfg = CFGS[64]
    syms, cdf = _workload(700, cfg.precision, seed=3)
    st, sw = il2.encode_lanes(syms, cdf, cfg, "cpu")
    assert transfers == {"up": 1, "back": 2}
    il2.decode_lanes(st, sw, len(syms), cdf, cfg, "cpu")
    assert transfers == {"up": 2, "back": 3}
    pt, rw = il2.encode_range_lanes(syms, cdf, cfg, "cpu")
    il2.decode_range_lanes(pt, rw, len(syms), cdf, cfg, "cpu")
    assert transfers == {"up": 4, "back": 6}


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("S", [32, 64])
def test_corrupt_range_block_raises_after_every_launch(S, k, monkeypatch):
    """Block 0 of 3 holds data the model cannot have written: the decode
    raises the host oracle's ValueError for that block, naming the same
    symbol, from the gather half, after all three blocks were launched."""
    cfg = CFGS[S]
    syms, cdf = _workload(2000, cfg.precision, seed=25 + S)
    cont = parallel.encode(syms, cdf, cfg=cfg, num_blocks=3, device="cpu",
                           coder="range")
    states, streams, n, block_len, cfg2, coder = parallel.unpack_sharded(cont)
    states = states.copy()
    states[0, ::3] = np.iinfo(states.dtype).max
    bad = parallel.pack_sharded(states, streams, n, block_len, cfg2, coder)
    with pytest.raises(ValueError) as want:
        il2.decode_shared_range_cdf(states[0], streams[0], block_len, cdf,
                                    cfg)
    launched, real = [], container.launch

    def recorded(step, programs):
        out = real(step, programs)
        launched.extend(b for dev in out for b in dev)
        return out

    monkeypatch.setattr(container, "launch", recorded)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        parallel.decode(bad, cdf, device=["cpu"] * k)
    assert len(launched) == 3
    leg = (parallel.shard_decode_range64_cuda if S == 64
           else parallel.shard_decode_range_cuda)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        leg(states, streams, cdf, cfg, block_len, device=["cpu"] * k)


def _blocks(B, block_len, seed, K=16):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(K))
    syms = rng.choice(K, size=B * block_len, p=probs).astype(np.int64)
    return rng, probs, [syms[b * block_len:(b + 1) * block_len]
                        for b in range(B)]


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("S", [32, 64])
def test_rans_and_range_legs_return_the_lane_wrappers_results(S, k):
    """Each block's result, type included, is the per-call wrapper's."""
    cfg = CFGS[S]
    rng, probs, blocks = _blocks(3, 300, seed=S + k)
    cdf = fast_quantized_cdf(probs, cfg.precision)
    devices = ["cpu"] * k
    seeds = [il2.encode_lanes(blk, cdf, cfg, "cpu")[0] for blk in blocks]
    coded = parallel.shard_encode2_cuda(blocks, cdf, cfg, device=devices,
                                        seeds=seeds)
    ranged = [il2.encode_range_lanes(blk, cdf, cfg, "cpu") for blk in blocks]
    decode, range_decode = (
        (parallel.shard_decode64_cuda, parallel.shard_decode_range64_cuda)
        if S == 64 else
        (parallel.shard_decode2_cuda, parallel.shard_decode_range_cuda))
    out = decode([c[0] for c in coded], [c[1] for c in coded], cdf, cfg, 300,
                 device=devices)
    out_r = range_decode([r[0] for r in ranged], [r[1] for r in ranged], cdf,
                         cfg, 300, device=devices)
    for b, blk in enumerate(blocks):
        for g, w in zip(coded[b], il2.encode_lanes(blk, cdf, cfg, "cpu",
                                                   seeds=seeds[b])):
            _same(g, w)
        want, fin = il2.decode_lanes(*coded[b], 300, cdf, cfg, "cpu")
        _same(out[b], want)
        _same(fin, seeds[b])
        _same(out_r[b], il2.decode_range_lanes(*ranged[b], 300, cdf, cfg,
                                               "cpu"))


@pytest.mark.parametrize("k", [1, 3])
def test_family_leg_returns_the_per_call_decode(k):
    """Three blocks of kernel 11's leg against ``family.decode_family``;
    a non-finite mean in any block raises before anything is uploaded."""
    rng, _, blocks = _blocks(3, 300, seed=7 + k)
    cfg = CFGS[32]
    L = cfg.num_lanes
    states, params, streams = [], [], []
    for blk in blocks:
        means = rng.uniform(-30, 30, size=300)
        scales = rng.uniform(0.5, 12.0, size=300)
        st, sw = il2.encode_shared(*fam.family_tables_host(
            blk - 8, means, scales, "gaussian", -50, 50), cfg)
        states.append(convert.u32_to_torch(st))
        streams.append(convert.u32_to_torch(sw))
        params.append(convert.params_to_torch(means, scales, 300, L))
    out = parallel.shard_decode_family_cuda(states, params, streams,
                                            "gaussian", -50, 50, cfg, 300,
                                            device=["cpu"] * k)
    for got, st, (mu, sd), sw, blk in zip(out, states, params, streams,
                                          blocks):
        _same(got, fam.decode_family(st, sw, mu, sd, "gaussian", -50, 50,
                                     cfg, 300).numpy())
        _same(got, (blk - 8).astype(np.int32))
    mu, sd = params[2]
    mu = mu.clone()
    mu[5] = float("nan")
    params[2] = (mu, sd)
    with pytest.raises(ValueError, match="means must be finite"):
        parallel.shard_decode_family_cuda(states, params, streams,
                                          "gaussian", -50, 50, cfg, 300,
                                          device=["cpu"] * k)


def test_upload_and_read_back_keep_dtypes_and_shapes():
    ts = [torch.arange(5, dtype=torch.int32),
          torch.tensor([1.5, -2.5], dtype=torch.float32),
          torch.arange(6, dtype=torch.int64).reshape(2, 3) - 7,
          torch.zeros(0, dtype=torch.int32),
          torch.tensor([9], dtype=torch.int64)[0:1].expand(1)]
    up = convert.upload(ts, "cpu")
    for t, u in zip(ts, up):
        assert u.dtype == t.dtype and torch.equal(u, t)
    buf = torch.arange(10, dtype=torch.int32)
    got = convert.read_back([up[2], (buf, torch.tensor([7])), up[1], up[3]])
    _same(got[0], ts[2].numpy())
    _same(got[1], np.array([7, 8, 9], np.int32))
    _same(got[2], ts[1].numpy())
    _same(got[3], np.zeros(0, np.int32))
    assert convert.read_back([]) == []
