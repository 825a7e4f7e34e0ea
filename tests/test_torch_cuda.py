"""The port's CUDA kernels against their plain PyTorch twins and the host
oracles, on the card: the rANS kernels against the JAX package's
(``interleaved2.encode_shared`` / ``decode_shared_cdf``, numpy and C++), the
range kernels against the port's numpy range coder, the device-family and
TChain-12 kernels (and their integer CDF, value by value) against the
port's numpy family oracles, the TChain-16 and TChain-24 kernels against
the port's numpy TChain oracles, the chain decode on the card against
its numpy path, and the reference-exact family kernels (encoders over
planes at S=64 and S=32, wide and narrow table decoders, grouped segment
decoder, window evaluator) against their twins and the port's numpy
exact-family oracles (the CPU tests hold the port's oracles against the
JAX package's).

Every test here needs a CUDA device and skips without one.  The file
imports no JAX (the oracle's modules import none), so on a machine with a
card and no JAX it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(tests/conftest.py imports jax).  Integer coding: tolerance is equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu_torch import convert
from constriction_tpu_torch import cuda as ctt
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import _build, coder, coder64, range_enc
from constriction_tpu_torch.ops import chain as ch
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import exact_tables as et
from constriction_tpu_torch.ops import family as fam
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops import tchain as tc
from constriction_tpu_torch.ops.interleaved import LaneConfig

from _range64_data import carry_through_ones

pytestmark = pytest.mark.cuda

PRESETS = {
    64: (coder64.encode_iid64, coder64.decode_shared64,
         coder64.encode_iid64_plain, coder64.decode_shared64_plain,
         coder64.LAUNCHES),
    32: (coder.encode_iid, coder.decode_shared, coder.encode_iid_plain,
         coder.decode_shared_plain, coder.LAUNCHES),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(S, L, P):
    W = S // 2
    return LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)


def _cdf(K, P, seed):
    probs = np.random.RandomState(seed).dirichlet(np.full(K, 2.0))
    return fast_quantized_cdf(probs, P), probs


def _seeds(rng, cfg, dev):
    S, W, L = cfg.state_bits, cfg.word_bits, cfg.num_lanes
    x = rng.randint(0, 1 << 32, size=L).astype(np.uint64)
    if S == 64:
        x = (x << np.uint64(32)) | rng.randint(0, 1 << 32, size=L).astype(
            np.uint64)
    x = np.maximum(x, np.uint64(1 << (S - W)))
    return convert.states_to_torch(x, cfg, dev)


def _check_oracle(cfg, syms, cdf, seeds, st, w, out, fin):
    """The kernels' states, stream, symbols and final states against the
    reference's host coder on the same inputs."""
    syms_np = syms.cpu().numpy().astype(np.int64)
    cdf_np = cdf.cpu().numpy().astype(np.uint64)
    cums = cdf_np[syms_np]
    seeds_np = None if seeds is None else convert.states_from_torch(seeds, cfg)
    st_r, w_r = ref_il2.encode_shared(cums, cdf_np[syms_np + 1] - cums, cfg,
                                      seeds=seeds_np)
    np.testing.assert_array_equal(convert.states_from_torch(st, cfg), st_r)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_r)
    out_r, fin_r = ref_il2.decode_shared_cdf(st_r, w_r, len(syms_np), cdf_np,
                                             cfg, return_final_states=True)
    np.testing.assert_array_equal(out.cpu().numpy(), out_r)
    np.testing.assert_array_equal(convert.states_from_torch(fin, cfg), fin_r)


def _check_pair(S, cfg, syms, cdf, seeds):
    """Kernel and twin on the same CUDA tensors, both directions, and the
    kernels against the reference's host oracle."""
    enc, dec, enc_p, dec_p, launches = PRESETS[S]
    before = dict(launches)
    st, w = enc(syms, cdf, cfg, seeds=seeds)
    st_p, w_p = enc_p(syms, cdf, cfg, seeds=seeds)
    assert torch.equal(st, st_p) and torch.equal(w, w_p)
    n = syms.numel()
    out, fin = dec(st, w, cdf, cfg, n, return_final_states=True)
    out_p, fin_p = dec_p(st, w, cdf, cfg, n, return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    assert torch.equal(out, syms)
    start = seeds if seeds is not None else torch.full_like(
        st, 1 << (cfg.state_bits - cfg.word_bits))
    assert torch.equal(fin, start)
    _check_oracle(cfg, syms, cdf, seeds, st, w, out, fin)
    if n:
        assert launches["encode"] == before["encode"] + 1
        assert launches["decode"] == before["decode"] + 1
    return st, w


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("S,P", [(64, 24), (64, 18), (32, 12), (32, 16)])
@pytest.mark.parametrize("L,n", [(128, 1), (256, 5000), (384, 1000),
                                 (1024, 1024 * 9), (2048, 30_001)])
def test_kernel_matches_twin(dev, S, P, L, n, seeded):
    rng = np.random.RandomState(L + n + P)
    cdf_np, probs = _cdf(100, P, seed=P)
    cfg = _cfg(S, L, P)
    syms = torch.from_numpy(
        rng.choice(100, size=n, p=probs).astype(np.int32)).to(dev)
    seeds = _seeds(rng, cfg, dev) if seeded else None
    _check_pair(S, cfg, syms, convert.cdf_to_torch(cdf_np, dev), seeds)


@pytest.mark.parametrize("S,P,K", [(64, 24, 70_000), (32, 16, 60_000)])
def test_large_alphabet_reads_cdf_from_device_memory(dev, S, P, K):
    """A CDF above the shared-memory budget stays in device memory."""
    rng = np.random.RandomState(K)
    cdf_np, probs = _cdf(K, P, seed=1)
    cfg = _cfg(S, 512, P)
    syms = torch.from_numpy(
        rng.choice(K, size=20_000, p=probs).astype(np.int32)).to(dev)
    _check_pair(S, cfg, syms, convert.cdf_to_torch(cdf_np, dev),
                _seeds(rng, cfg, dev))


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
def test_truncated_stream_zero_fills(dev, S, P):
    rng = np.random.RandomState(5)
    cdf_np, probs = _cdf(100, P, seed=2)
    cfg = _cfg(S, 256, P)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    syms = torch.from_numpy(
        rng.choice(100, size=4000, p=probs).astype(np.int32)).to(dev)
    enc, dec, _, dec_p, _ = PRESETS[S]
    st, w = enc(syms, cdf, cfg)
    cut = w[: w.numel() // 3].clone()
    out, fin = dec(st, cut, cdf, cfg, 4000, return_final_states=True)
    out_p, fin_p = dec_p(st, cut, cdf, cfg, 4000, return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    # the port's numpy host coder zero-fills the same way
    out_h, fin_h = il2.decode_shared_cdf(
        convert.states_from_torch(st, cfg), convert.u32_from_torch(cut), 4000,
        cdf_np, cfg, return_final_states=True)
    np.testing.assert_array_equal(out.cpu().numpy(), out_h)
    np.testing.assert_array_equal(convert.states_from_torch(fin, cfg), fin_h)


@pytest.mark.parametrize("P", [24, 12])
@pytest.mark.parametrize("compact", [True, False])
def test_facade_cuda_matches_cpu(dev, P, compact):
    cdf, probs = _cdf(100, P, seed=3)
    symbols = np.random.RandomState(4).choice(100, size=50_000, p=probs)
    data = ctt.encode_iid(symbols, cdf, compact=compact, device="cuda")
    ref = ctt.encode_iid(symbols, cdf, compact=compact, device="cpu")
    np.testing.assert_array_equal(data, ref)
    np.testing.assert_array_equal(ctt.decode_iid(data, cdf, device="cuda"),
                                  symbols)


def test_wrapper_rejects_mixed_devices(dev):
    cdf, _ = _cdf(100, 24, seed=4)
    cfg = _cfg(64, 128, 24)
    syms = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="is on cpu"):
        coder64.encode_iid64(syms, convert.cdf_to_torch(cdf), cfg)


# --- the DEFAULT preset's redesigned pair: the cluster decode (kernel 1) and
# the two-pass encode (kernel 2), csrc/ilans2_wide.cuh ----------------------


def _wide_model(kind, rng):
    """(cdf u32, symbol sampler): K=100 Dirichlet(2) at P=24, two symbols
    at P=1, or one symbol (K=1) at P=24."""
    if kind == "p1":
        return np.array([0, 1, 2], np.uint32), lambda n: rng.randint(0, 2, n)
    if kind == "k1":
        return np.array([0, 1 << 24], np.uint32), lambda n: np.zeros(
            n, np.int64)
    cdf, probs = _cdf(100, 24, seed=9)
    return cdf, lambda n: rng.choice(100, size=n, p=probs)


def _wide_encode(syms, cdf, cfg, seeds):
    """Kernel 2 at any L that is a multiple of 32 (the wrapper takes
    multiples of 128)."""
    states = coder._encode_args(syms, cdf, cfg, seeds, torch.int64)
    states, buf, end = coder._launch_encode("w32s64", syms, cdf, cfg, states)
    return states, coder.trim(buf, end)


def _wide_pair(L, n, kind, seeded, dev, seed):
    """Kernels 1 and 2 against their twins and the JAX package's host
    oracle; returns (cfg, cdf, states, stream)."""
    rng = np.random.RandomState(seed)
    cdf_np, sample = _wide_model(kind, rng)
    P = int(cdf_np[-1]).bit_length() - 1
    cfg = _cfg(64, L, P)
    syms = torch.from_numpy(sample(n).astype(np.int32)).to(dev)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    seeds = _seeds(rng, cfg, dev) if seeded else None
    st, w = _wide_encode(syms, cdf, cfg, seeds)
    st_p, w_p = coder64.encode_iid64_plain(syms, cdf, cfg, seeds)
    assert torch.equal(st, st_p) and torch.equal(w, w_p)
    out, fin = coder._launch_decode("w32s64", st, w, cdf, cfg, n)
    out_p, fin_p = coder64.decode_shared64_plain(st, w, cdf, cfg, n,
                                                 return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    assert torch.equal(out, syms)
    _check_oracle(cfg, syms, cdf, seeds, st, w, out, fin)
    return cfg, cdf, st, w


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("size", ["one", "short", "steps"])
@pytest.mark.parametrize("L", [32, 96, 128, 1024, 4096, 32768, 65536])
def test_wide_kernels_match_twins_and_oracle(dev, L, size, seeded):
    n = {"one": 1, "short": L // 2 + 1, "steps": 3 * L + L // 3 + 5}[size]
    _wide_pair(L, n, "p24", seeded, dev, seed=L + n)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("kind", ["p1", "k1"])
def test_wide_kernels_at_p1_and_one_symbol(dev, kind, seeded):
    _wide_pair(1024, 5 * 1024 - 77, kind, seeded, dev, seed=31)


def test_wide_decode_runs_as_a_cluster_at_bench_lanes(dev):
    for L in (32768, 65536):
        geo = coder64.geometry(L, 100, dev)
        assert geo["cluster"] > 1 and geo["max_active_clusters"] >= 1
        assert geo["lanes_per_thread"] * geo["threads_per_cta"] // 32 \
            >= geo["groups_per_cta"]
        assert geo["encode_blocks"] * geo["encode_threads"] >= L


@pytest.mark.parametrize("L,cluster", [
    (128, 16), (96, 4), (2080, 16), (32000, 16), (4096, 2), (32768, 1),
    (32768, 8), (65536, 16)])
def test_cluster_partitions_match_twin(dev, L, cluster):
    """Forced cluster sizes: groups that do not divide evenly over the
    CTAs, CTAs left with no lanes (128/16, 96/4, 2080/16), one CTA holding
    32 lanes a thread (32768/1)."""
    geo = coder64.geometry(L, 100, dev, cluster=cluster)
    assert geo["cluster"] == cluster
    busy = -(-(L // 32) // geo["groups_per_cta"])
    if (L, cluster) in ((128, 16), (96, 4), (2080, 16)):
        assert busy < cluster
    for n in (1, L - 5, 2 * L + 7):
        cfg, cdf, st, w = _wide_pair(L, n, "p24", True, dev, seed=L + n)
        out, fin = coder64.decode_shared64_cluster(st, w, cdf, cfg, n,
                                                   cluster)
        out_p, fin_p = coder64.decode_shared64_plain(
            st, w, cdf, cfg, n, return_final_states=True)
        assert torch.equal(out, out_p) and torch.equal(fin, fin_p)


@pytest.mark.parametrize("L", [4096, 32768])
def test_wide_decode_truncated_stream_zero_fills(dev, L):
    n = 3 * L + 11
    cfg, cdf, st, w = _wide_pair(L, n, "p24", True, dev, seed=L)
    cut = w[: w.numel() // 3].clone()
    out, fin = coder64.decode_shared64(st, cut, cdf, cfg, n,
                                       return_final_states=True)
    out_p, fin_p = coder64.decode_shared64_plain(st, cut, cdf, cfg, n,
                                                 return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    out_h, fin_h = il2.decode_shared_cdf(
        convert.states_from_torch(st, cfg), convert.u32_from_torch(cut), n,
        cdf.cpu().numpy(), cfg, return_final_states=True)
    np.testing.assert_array_equal(out.cpu().numpy(), out_h)
    np.testing.assert_array_equal(convert.states_from_torch(fin, cfg), fin_h)


@pytest.mark.parametrize("L,T,seeded", [(96, 50, True), (4096, 20, True),
                                        (32768, 6, False)])
def test_encode_passes_match_plain_passes(dev, L, T, seeded):
    """Pass A's final states, ballots and the words it flags, and pass B's
    stream, each against the plain pass on the same inputs."""
    rng = np.random.RandomState(L + T)
    cdf_np, sample = _wide_model("p24", rng)
    cfg = _cfg(64, L, 24)
    n = T * L - L // 3
    syms = torch.from_numpy(sample(n).astype(np.int32)).to(dev)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    seeds = _seeds(rng, cfg, dev) if seeded else None
    before, compacts = dict(coder64.LAUNCHES), coder.LAUNCHES["compact"]
    words, ballots, st = coder64.lanes_pass64(syms, cdf, cfg, seeds)
    w_p, f_p, st_p = coder64.lanes_pass64_plain(syms, cdf, cfg, seeds)
    assert torch.equal(st, st_p)
    assert torch.equal(ballots, coder64.flag_ballots(f_p))
    assert torch.equal(words[f_p], w_p[f_p])
    stream_p = coder64.compact_pass_plain(w_p, f_p)
    assert torch.equal(coder64.compact_pass(words, ballots), stream_p)
    assert torch.equal(coder64.compact_pass(w_p, ballots), stream_p)
    assert torch.equal(stream_p, coder64.encode_iid64_plain(
        syms, cdf, cfg, seeds)[1])
    assert coder64.LAUNCHES["encode_lanes"] == before["encode_lanes"] + 1
    assert coder.LAUNCHES["compact"] == compacts + 2


def test_compaction_spans_many_tiles_a_block(dev):
    """2.25M ballots: each compaction block scans two tiles."""
    T, L = 1100, 65536
    rng = np.random.RandomState(21)
    flags = torch.from_numpy(rng.random_sample((T, L)) < 0.2).to(dev)
    words = torch.from_numpy(
        rng.randint(-(1 << 31), 1 << 31, size=(T, L), dtype=np.int64)
        .astype(np.int32)).to(dev)
    out = coder64.compact_pass(words, coder64.flag_ballots(flags))
    assert torch.equal(out, coder64.compact_pass_plain(words, flags))


# --- the small preset's pair on the same design: the cluster decode (kernel
# 4) and the two-pass encode with a 32-bit reciprocal (kernel 3) ----------


def _wide32_model(P, K, rng):
    """(cdf u32, symbol sampler) at S=32: K=1 (prob = 2^P), two symbols at
    P=1, else K Dirichlet(2) symbols at P."""
    if K == 1:
        return np.array([0, 1 << P], np.uint32), lambda n: np.zeros(
            n, np.int64)
    if P == 1:
        return np.array([0, 1, 2], np.uint32), lambda n: rng.randint(0, 2, n)
    cdf, probs = _cdf(K, P, seed=P + K)
    return cdf, lambda n: rng.choice(K, size=n, p=probs)


def _wide32_pair(L, n, P, seeded, dev, seed, K=100):
    """Kernels 3 and 4 at any L that is a multiple of 32 against their
    twins and the JAX package's host oracle; returns (cfg, cdf, states,
    stream)."""
    rng = np.random.RandomState(seed)
    cdf_np, sample = _wide32_model(P, K, rng)
    cfg = _cfg(32, L, P)
    syms = torch.from_numpy(sample(n).astype(np.int32)).to(dev)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    seeds = _seeds(rng, cfg, dev) if seeded else None
    states = coder._encode_args(syms, cdf, cfg, seeds, torch.int32)
    before = dict(coder.LAUNCHES)
    st, buf, end = coder._launch_encode("w16s32", syms, cdf, cfg, states)
    w = coder.trim(buf, end)
    st_p, w_p = coder.encode_iid_plain(syms, cdf, cfg, seeds)
    assert torch.equal(st, st_p) and torch.equal(w, w_p)
    out, fin = coder._launch_decode("w16s32", st, w, cdf, cfg, n)
    out_p, fin_p = coder.decode_shared_plain(st, w, cdf, cfg, n,
                                             return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    assert torch.equal(out, syms)
    _check_oracle(cfg, syms, cdf, seeds, st, w, out, fin)
    assert coder.LAUNCHES == before  # the launch helpers count nothing
    return cfg, cdf, st, w


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("size", ["one", "steps"])
@pytest.mark.parametrize("P", [1, 8, 12, 16])
@pytest.mark.parametrize("L", [32, 96, 4096, 32768, 65536])
def test_wide32_kernels_match_twins_and_oracle(dev, L, P, size, seeded):
    n = {"one": 1, "steps": 3 * L + L // 3 + 5}[size]
    _wide32_pair(L, n, P, seeded, dev, seed=L + n + P)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("P", [12, 16])
def test_wide32_kernels_at_one_symbol(dev, P, seeded):
    """K=1: prob = 2^P, the largest probability the division takes."""
    _wide32_pair(1024, 5 * 1024 - 77, P, seeded, dev, seed=41, K=1)


@pytest.mark.parametrize("seeded", [False, True])
def test_wide32_large_alphabet_misses_shared_memory(dev, seeded):
    """60000 symbols at P=16: the CDF stays in device memory behind the
    bucket table, the 480 KB of division records too."""
    geo = coder.geometry(4096, 60_000, 16, dev)
    assert geo["cdf_in_smem"] == 0 and geo["lut_bits"] == 12
    _wide32_pair(4096, 20_000, 16, seeded, dev, seed=43, K=60_000)


def test_wide32_decode_runs_as_a_cluster_at_bench_lanes(dev):
    for L in (32768, 65536):
        for P in (12, 16):
            geo = coder.geometry(L, 100, P, dev)
            assert geo["cluster"] > 1 and geo["max_active_clusters"] >= 1
            assert geo["lut_bits"] == 12 and geo["cdf_in_smem"] == 1
            assert geo["lanes_per_thread"] * geo["threads_per_cta"] // 32 \
                >= geo["groups_per_cta"]
            assert geo["encode_blocks"] * geo["encode_threads"] >= L
    assert coder.geometry(32768, 100, 8, dev)["lut_bits"] == 8


@pytest.mark.parametrize("L,cluster", [
    (128, 16), (96, 4), (2080, 16), (32000, 16), (4096, 2), (32768, 1),
    (32768, 8), (65536, 16)])
def test_cluster32_partitions_match_twin(dev, L, cluster):
    """Forced cluster sizes at S=32: groups that do not divide evenly over
    the CTAs, CTAs left with no lanes (128/16, 96/4, 2080/16), one CTA
    holding 32 lanes a thread (32768/1)."""
    geo = coder.geometry(L, 100, 12, dev, cluster=cluster)
    assert geo["cluster"] == cluster
    busy = -(-(L // 32) // geo["groups_per_cta"])
    if (L, cluster) in ((128, 16), (96, 4), (2080, 16)):
        assert busy < cluster
    for n in (1, L - 5, 2 * L + 7):
        cfg, cdf, st, w = _wide32_pair(L, n, 12, True, dev, seed=L + n)
        before = coder.LAUNCHES["decode"]
        out, fin = coder.decode_shared_cluster(st, w, cdf, cfg, n, cluster)
        assert coder.LAUNCHES["decode"] == before + 1
        out_p, fin_p = coder.decode_shared_plain(st, w, cdf, cfg, n,
                                                 return_final_states=True)
        assert torch.equal(out, out_p) and torch.equal(fin, fin_p)


@pytest.mark.parametrize("L,P", [(4096, 12), (32768, 16)])
def test_wide32_decode_truncated_stream_zero_fills(dev, L, P):
    n = 3 * L + 11
    cfg, cdf, st, w = _wide32_pair(L, n, P, True, dev, seed=L)
    cut = w[: w.numel() // 3].clone()
    out, fin = coder.decode_shared(st, cut, cdf, cfg, n,
                                   return_final_states=True)
    out_p, fin_p = coder.decode_shared_plain(st, cut, cdf, cfg, n,
                                             return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    out_h, fin_h = il2.decode_shared_cdf(
        convert.states_from_torch(st, cfg), convert.u32_from_torch(cut), n,
        cdf.cpu().numpy(), cfg, return_final_states=True)
    np.testing.assert_array_equal(out.cpu().numpy(), out_h)
    np.testing.assert_array_equal(convert.states_from_torch(fin, cfg), fin_h)


@pytest.mark.parametrize("L,T,P,seeded", [
    (96, 50, 12, True), (4096, 20, 16, True), (32768, 6, 12, False),
    (32768, 4, 1, True)])
def test_encode32_passes_match_plain_passes(dev, L, T, P, seeded):
    """Pass A's final states, ballots and the words it flags, and pass B's
    stream, each against the plain pass on the same inputs."""
    rng = np.random.RandomState(L + T + P)
    cdf_np, sample = _wide32_model(P, 100, rng)
    cfg = _cfg(32, L, P)
    n = T * L - L // 3
    syms = torch.from_numpy(sample(n).astype(np.int32)).to(dev)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    seeds = _seeds(rng, cfg, dev) if seeded else None
    before = dict(coder.LAUNCHES)
    words, ballots, st = coder.lanes_pass32(syms, cdf, cfg, seeds)
    w_p, f_p, st_p = coder.lanes_pass32_plain(syms, cdf, cfg, seeds)
    assert torch.equal(st, st_p)
    assert torch.equal(ballots, coder.flag_ballots(f_p))
    assert torch.equal(words[f_p], w_p[f_p])
    stream_p = coder.compact_pass_plain(w_p, f_p)
    assert torch.equal(coder.compact_pass(words, ballots), stream_p)
    assert torch.equal(stream_p, coder.encode_iid_plain(
        syms, cdf, cfg, seeds)[1])
    assert coder.LAUNCHES["encode_lanes"] == before["encode_lanes"] + 1
    assert coder.LAUNCHES["compact"] == before["compact"] + 1


def test_compaction32_spans_many_tiles_a_block(dev):
    """2.25M ballots of 16-bit words at S=32's emit rate: each compaction
    block scans two tiles."""
    T, L = 1100, 65536
    rng = np.random.RandomState(22)
    flags = torch.from_numpy(rng.random_sample((T, L)) < 0.38).to(dev)
    words = torch.from_numpy(
        rng.randint(0, 1 << 16, size=(T, L)).astype(np.int32)).to(dev)
    out = coder.compact_pass(words, coder.flag_ballots(flags))
    assert torch.equal(out, coder.compact_pass_plain(words, flags))


@pytest.mark.parametrize("S", [32, 64])
def test_decode_lanes_at_and_past_the_cluster_reach(dev, S):
    """16 CTAs x 1024 threads x 32 lanes a thread is the decode's reach:
    L = 524288 decodes like the twin, 128 more lanes raise with the limit
    named, and launch nothing."""
    enc, dec, _, dec_p, launches = PRESETS[S]
    P = 12 if S == 32 else 24
    cdf_np, probs = _cdf(100, P, seed=5)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    rng = np.random.RandomState(S)
    L = coder.MAX_DECODE_LANES
    syms = torch.from_numpy(
        rng.choice(100, size=L + 99, p=probs).astype(np.int32)).to(dev)
    cfg = _cfg(S, L, P)
    st, w = enc(syms, cdf, cfg)
    out, fin = dec(st, w, cdf, cfg, syms.numel(), return_final_states=True)
    out_p, fin_p = dec_p(st, w, cdf, cfg, syms.numel(),
                         return_final_states=True)
    assert torch.equal(out, syms) and torch.equal(out, out_p)
    assert torch.equal(fin, fin_p)
    cfg = _cfg(S, L + 128, P)
    st, w = enc(syms, cdf, cfg)
    before = dict(launches)
    with pytest.raises(ValueError, match=f"at most {L} lanes"):
        dec(st, w, cdf, cfg, syms.numel())
    assert launches == before


# --- the range coder (ILANS2-R): phase A, phase B and decode kernels -------

RANGE = {64: coder64.decode_shared_range64, 32: coder.decode_shared_range}
RANGE_PLAIN = {64: coder64.decode_shared_range64_plain,
               32: coder.decode_shared_range_plain}


def _range_symbols(rng, K, P, n, skewed):
    """Symbols and CDF; ``skewed`` puts 99.9% of the mass on one symbol
    (long runs of deferred carries)."""
    if skewed:
        q = np.array([(1 << P) - 3, 1, 1, 1], dtype=np.int64)
        cdf = np.concatenate([[0], np.cumsum(q)]).astype(np.uint32)
        syms = np.where(rng.random_sample(n) < 0.999, 0, rng.randint(1, 4, n))
        return syms.astype(np.int64), cdf
    cdf, probs = _cdf(K, P, seed=K + P)
    return rng.choice(K, size=n, p=probs).astype(np.int64), cdf


def _range_host(cfg, syms, cdf):
    c = cdf.astype(np.uint64)
    return il2.encode_shared_range(c[syms], c[syms + 1] - c[syms], cfg)


def _check_range(S, cfg, syms_np, cdf_np, dev):
    """Each range kernel against its twin on the same CUDA tensors, and the
    encoder's output against the port's numpy host encoder."""
    syms = torch.from_numpy(syms_np.astype(np.int32)).to(dev)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    n = len(syms_np)
    key = "64" if S == 64 else ""
    before = dict(range_enc.LAUNCHES), dict(PRESETS[S][4])
    rec = range_enc.record(syms, cdf, cfg)
    rec_p = range_enc.record_plain(syms, cdf, cfg)
    assert all(torch.equal(a, b) for a, b in zip(rec, rec_p))
    s0, carry = range_enc.seal(rec[1], rec[2], cfg)
    pts, words = range_enc.resolve(rec[0], s0, carry, cfg, n)
    pts_p, words_p = range_enc.resolve_plain(rec[0], s0, carry, cfg, n)
    assert torch.equal(pts, pts_p) and torch.equal(words, words_p)
    pts_h, words_h = _range_host(cfg, syms_np, cdf_np)
    np.testing.assert_array_equal(convert.states_from_torch(pts, cfg), pts_h)
    np.testing.assert_array_equal(convert.u32_from_torch(words), words_h)
    out, fin = RANGE[S](pts, words, cdf, cfg, n, return_final_states=True)
    out_p, fin_p = RANGE_PLAIN[S](pts, words, cdf, cfg, n,
                                  return_final_states=True)
    assert torch.equal(out, out_p)
    assert all(torch.equal(a, b) for a, b in zip(fin, fin_p))
    assert torch.equal(out, syms)
    if n:
        assert range_enc.LAUNCHES["record" + key] == before[0]["record" + key] + 1
        assert range_enc.LAUNCHES["resolve" + key] == before[0]["resolve" + key] + 1
        assert PRESETS[S][4]["range_decode"] == before[1]["range_decode"] + 1
    return pts, words, cdf


@pytest.mark.parametrize("S,P", [(64, 24), (64, 18), (32, 12), (32, 16)])
@pytest.mark.parametrize("L,n", [(128, 1), (256, 5000), (384, 1000),
                                 (1024, 1024 * 9), (2048, 30_001),
                                 (65536, 65536 * 3 + 5)])
def test_range_kernels_match_twins(dev, S, P, L, n):
    rng = np.random.RandomState(L + n + P)
    syms, cdf = _range_symbols(rng, 100, P, n, skewed=False)
    _check_range(S, _cfg(S, L, P), syms, cdf, dev)


@pytest.mark.parametrize("S,P,K", [(64, 24, 70_000), (32, 16, 60_000)])
def test_range_large_alphabet_reads_cdf_from_device_memory(dev, S, P, K):
    rng = np.random.RandomState(K)
    syms, cdf = _range_symbols(rng, K, P, 20_000, skewed=False)
    _check_range(S, _cfg(S, 512, P), syms, cdf, dev)


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
def test_range_skewed_model_carry_runs(dev, S, P):
    rng = np.random.RandomState(13)
    syms, cdf = _range_symbols(rng, 4, P, 200_000, skewed=True)
    _check_range(S, _cfg(S, 256, P), syms, cdf, dev)


# --- the range encoder's phase A (kernels 7 and 9, range_record_ring_kernel:
# each lane's symbols loaded `depth` steps ahead) at its edges --------------


def _record_geometry(S, L, K, dev):
    return range_enc.record_geometry(_cfg(S, L, 12), K, dev)


def _check_record(S, cfg, syms_np, cdf_np, dev):
    """Phase A's kernel against record_plain and the tiles walk at the
    kernel's own depth, on the same CUDA tensors; one launch counted."""
    syms = torch.from_numpy(syms_np.astype(np.int32)).to(dev)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    key = "record64" if S == 64 else "record"
    before = range_enc.LAUNCHES[key]
    got = range_enc.record(syms, cdf, cfg)
    assert range_enc.LAUNCHES[key] == before + 1
    depth = range_enc.record_geometry(cfg, len(cdf_np) - 1, dev)["depth"]
    for want in (range_enc.record_plain(syms, cdf, cfg),
                 range_enc.record_tiles_plain(syms, cdf, cfg, depth)):
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))
    return got


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
@pytest.mark.parametrize("L", [128, 384])
@pytest.mark.parametrize("dT", [-1, 0, 1])
@pytest.mark.parametrize("kind", ["whole", "partial", "short"])
def test_range_record_edges_of_the_ring(dev, S, P, L, dT, kind):
    """T one below, at and one past a multiple of the ring's depth; n whole,
    with a partial last step, and shorter than one step."""
    depth = _record_geometry(S, L, 100, dev)["depth"]
    T = 2 * depth + dT
    n = {"whole": T * L, "partial": (T - 1) * L + 5, "short": L - 5}[kind]
    rng = np.random.RandomState(L + T + P)
    syms, cdf = _range_symbols(rng, 100, P, n, skewed=False)
    _check_record(S, _cfg(S, L, P), syms, cdf, dev)


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
def test_range_record_at_65536_lanes(dev, S, P):
    L = 65536
    rng = np.random.RandomState(P)
    syms, cdf = _range_symbols(rng, 100, P, 3 * L + 5, skewed=False)
    geo = _record_geometry(S, L, 100, dev)
    assert geo["blocks"] * geo["lanes_per_block"] == L
    _check_record(S, _cfg(S, L, P), syms, cdf, dev)


@pytest.mark.parametrize("S,P,K", [(64, 24, 70_000), (32, 16, 60_000)])
def test_range_record_cdf_in_device_memory(dev, S, P, K):
    assert _record_geometry(S, 512, K, dev)["cdf_in_smem"] == 0
    assert _record_geometry(S, 512, 100, dev)["cdf_in_smem"] == 1
    rng = np.random.RandomState(K + 1)
    syms, cdf = _range_symbols(rng, K, P, 512 * 40 + 9, skewed=False)
    _check_record(S, _cfg(S, 512, P), syms, cdf, dev)


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
def test_range_record_skewed_model(dev, S, P):
    rng = np.random.RandomState(31)
    syms, cdf = _range_symbols(rng, 4, P, 256 * 300 + 17, skewed=True)
    _check_record(S, _cfg(S, 256, P), syms, cdf, dev)


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
@pytest.mark.parametrize("L,n", [(96, 95), (96, 96 * 40 + 7),
                                 (160, 160 * 33)])
def test_range_record_entry_at_lanes_of_32(dev, S, P, L, n):
    """The C entry takes any L that is a multiple of 32 (the wrappers,
    multiples of 128): a block's last warps past L do nothing."""
    rng = np.random.RandomState(L + n)
    syms_np, cdf_np = _range_symbols(rng, 100, P, n, skewed=False)
    cfg = _cfg(S, L, P)
    syms = torch.from_numpy(syms_np.astype(np.int32)).to(dev)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    dtype = torch.int64 if S == 64 else torch.int32
    T = -(-n // L)
    out = (torch.full((T * L,), 7, dtype=dtype, device=dev),
           torch.zeros(L, dtype=dtype, device=dev),
           torch.full((L,), -1, dtype=dtype, device=dev))
    _build.call(f"ctt_ilans2_range_record_w{S // 2}s{S}", dev, syms, n,
                cdf.to(torch.int32), len(cdf_np) - 1, *out, L, P)
    want = range_enc.record_plain(syms, cdf, cfg)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
def test_range_record_symbols_at_any_offset(dev, S, P):
    """A view of the symbols at an odd offset (not 16-byte aligned) codes
    as its aligned copy: the ring's loads are one int32 a lane."""
    rng = np.random.RandomState(S)
    syms_np, cdf_np = _range_symbols(rng, 100, P, 128 * 70 + 3, skewed=False)
    cfg = _cfg(S, 128, P)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    padded = torch.from_numpy(
        np.concatenate([[0], syms_np]).astype(np.int32)).to(dev)
    view = padded[1:]
    assert view.data_ptr() % 16 != 0
    got = range_enc.record(view, cdf, cfg)
    want = range_enc.record(view.clone(), cdf, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
def test_range_seeded_decode_from_checkpoint(dev, S, P):
    rng = np.random.RandomState(21)
    cfg = _cfg(S, 1024, P)
    syms, cdf = _range_symbols(rng, 100, P, 1024 * 12 + 77, skewed=False)
    pts, words = _range_host(cfg, syms, cdf)
    ckpt = il2.build_checkpoints_range(pts, words, len(syms), cdf, cfg, 4)
    for c in range(len(ckpt[0])):
        start, out = il2.decode_range_from_checkpoint(
            c, *ckpt, words, len(syms), cdf, cfg, 4, device=dev)
        np.testing.assert_array_equal(out, syms[start:])
        lo, rn, pt = convert.planes_to_torch(
            (ckpt[1][c], ckpt[2][c], ckpt[3][c]), cfg, dev)
        sub = convert.u32_to_torch(words[ckpt[0][c]:], dev)
        cdf_t = convert.cdf_to_torch(cdf, dev)
        k = RANGE[S](pt, sub, cdf_t, cfg, len(syms) - start, lows=lo, rngs=rn,
                     return_final_states=True)
        p = RANGE_PLAIN[S](pt, sub, cdf_t, cfg, len(syms) - start, lows=lo,
                           rngs=rn, return_final_states=True)
        assert torch.equal(k[0], p[0])
        assert all(torch.equal(a, b) for a, b in zip(k[1], p[1]))


@pytest.mark.parametrize("S,P", [(64, 24), (32, 12)])
def test_range_invalid_data_and_truncated_stream(dev, S, P):
    """Garbage points raise the host oracle's error, naming the same
    symbol; a truncated stream zero-fills as the oracle does (its decode
    or its error)."""
    rng = np.random.RandomState(31)
    cfg = _cfg(S, 256, P)
    syms, cdf = _range_symbols(rng, 100, P, 5000, skewed=False)
    pts, words = _range_host(cfg, syms, cdf)
    cdf_t = convert.cdf_to_torch(cdf, dev)
    bad = pts.copy()
    bad[::3] = rng.randint(0, 1 << 31, size=len(bad[::3])).astype(bad.dtype) \
        << bad.dtype.type(S - 31)
    bad[7] = np.iinfo(bad.dtype).max  # outside every interval: an error
    for p_np, w_np in ((bad, words), (pts, words[: len(words) // 3])):
        args = (convert.states_to_torch(p_np, cfg, dev),
                convert.u32_to_torch(w_np, dev), cdf_t, cfg, len(syms))
        outcome = []
        for fn in (lambda: il2.decode_shared_range_cdf(p_np, w_np, len(syms),
                                                       cdf, cfg),
                   lambda: RANGE[S](*args).cpu().numpy(),
                   lambda: RANGE_PLAIN[S](*args).cpu().numpy()):
            try:
                outcome.append(fn())
            except ValueError as e:
                outcome.append(str(e))
        for o in outcome[1:]:
            if isinstance(o, str) or isinstance(outcome[0], str):
                assert o == outcome[0]
            else:
                np.testing.assert_array_equal(o, outcome[0])


@pytest.mark.parametrize("P", [24, 12])
def test_range_facade_cuda_matches_cpu(dev, P):
    cdf, probs = _cdf(100, P, seed=3)
    symbols = np.random.RandomState(4).choice(100, size=50_000, p=probs)
    pts, words = ctt.encode_iid_range(symbols, cdf, device="cuda")
    pts_c, words_c = ctt.encode_iid_range(symbols, cdf, device="cpu")
    np.testing.assert_array_equal(pts, pts_c)
    np.testing.assert_array_equal(words, words_c)
    np.testing.assert_array_equal(
        ctt.decode_iid_range(pts, words, cdf, len(symbols), device="cuda"),
        symbols)


# --- the S=64 range decode on the cluster step (kernel 5,
# csrc/ilans2_wide.cuh cluster_range_decode_kernel) ------------------------


def _range64_case(L, n, seed, dev):
    """Points, stream and CDF on the card of n symbols at W=32/S=64/P=24
    (the host encoder, any L that is a multiple of 32), and the symbols."""
    rng = np.random.RandomState(seed)
    cfg = _cfg(64, L, 24)
    syms, cdf = _range_symbols(rng, 100, 24, n, skewed=False)
    pts, words = _range_host(cfg, syms, cdf)
    return (cfg, syms, convert.states_to_torch(pts, cfg, dev),
            convert.u32_to_torch(words, dev), convert.cdf_to_torch(cdf, dev))


def test_range_decode_runs_as_a_cluster_at_bench_lanes(dev):
    for L in (32768, 65536):
        geo = coder64.range_geometry(L, 100, 24, dev)
        assert geo["cluster"] > 1 and geo["max_active_clusters"] >= 1
        assert geo["lut_bits"] == 12 and geo["cdf_in_smem"] == 1
        assert geo["lanes_per_thread"] * geo["threads_per_cta"] // 32 \
            >= geo["groups_per_cta"]


@pytest.mark.parametrize("L,cluster", [
    (128, 16), (96, 4), (2080, 16), (32000, 16), (4096, 2), (32768, 1),
    (32768, 8), (65536, 16)])
def test_range_cluster_partitions_match_twin(dev, L, cluster):
    """Forced cluster sizes: groups that do not divide evenly over the
    CTAs, CTAs left with no lanes (128/16, 96/4, 2080/16), one CTA holding
    32 lanes a thread (32768/1); partial last steps and n < L."""
    geo = coder64.range_geometry(L, 100, 24, dev, cluster=cluster)
    assert geo["cluster"] == cluster
    for n in (1, L - 5, 2 * L + 7):
        cfg, syms, pts, words, cdf = _range64_case(L, n, L + n, dev)
        before = coder64.LAUNCHES["range_decode"]
        out, fin = coder64.decode_shared_range64_cluster(
            pts, words, cdf, cfg, n, cluster)
        assert coder64.LAUNCHES["range_decode"] == before + 1
        out_p, fin_p = coder64.decode_shared_range64_plain(
            pts, words, cdf, cfg, n, return_final_states=True)
        assert torch.equal(out, out_p)
        assert all(torch.equal(a, b) for a, b in zip(fin, fin_p))
        np.testing.assert_array_equal(out.cpu().numpy(), syms)


def test_range_decode_lanes_at_and_past_the_cluster_reach(dev):
    """16 CTAs x 1024 threads x 32 lanes a thread is the range decode's
    reach too: L = 524288 decodes like the twin, 128 more lanes raise with
    the limit named, and launch nothing."""
    L = coder.MAX_DECODE_LANES
    cfg, syms, pts, words, cdf = _range64_case(L, L + 99, 3, dev)
    out, fin = coder64.decode_shared_range64(pts, words, cdf, cfg, L + 99,
                                             return_final_states=True)
    out_p, fin_p = coder64.decode_shared_range64_plain(
        pts, words, cdf, cfg, L + 99, return_final_states=True)
    assert torch.equal(out, out_p)
    assert all(torch.equal(a, b) for a, b in zip(fin, fin_p))
    np.testing.assert_array_equal(out.cpu().numpy(), syms)
    cfg = _cfg(64, L + 128, 24)
    pts = torch.zeros(L + 128, dtype=torch.int64, device=dev)
    before = dict(coder64.LAUNCHES)
    with pytest.raises(ValueError, match=f"at most {L} lanes"):
        coder64.decode_shared_range64(pts, words, cdf, cfg, 1000)
    assert coder64.LAUNCHES == before


@pytest.mark.parametrize("cluster", [0, 3, 16])
def test_range_cluster_invalid_planes_and_truncated_stream(dev, cluster):
    """Garbage points, checkpoint planes with ranges below 2^P (scale 0),
    and a truncated stream: the kernel raises the twin's error (naming the
    same first bad symbol) or returns its symbols and planes."""
    L, n = 1024, 5 * 1024 + 33
    cfg, syms, pts, words, cdf = _range64_case(L, n, 61, dev)
    rng = np.random.RandomState(62)
    garbage = pts.clone()
    garbage[::5] = torch.from_numpy(rng.randint(
        -(1 << 62), 1 << 62, size=garbage[::5].numel())).to(dev)
    garbage[L - 9] = -1  # 2^64 - 1: the quantile 2^P, outside every interval
    # every third lane's range below 2^P: scale 0, quantile 0, a refill
    # every step, and the other lanes' words shifted
    lows = torch.zeros(L, dtype=torch.int64, device=dev)
    rngs = torch.full((L,), -1, dtype=torch.int64, device=dev)
    rngs[::3] = torch.from_numpy(rng.randint(0, 1 << 24, size=rngs[::3]
                                             .numel())).to(dev)
    cases = [(garbage, words, None, None),
             (pts, words[: words.numel() // 3].clone(), None, None),
             (pts, words, lows, rngs)]
    for p, w, lo, rg in cases:
        outcome = []
        for fn in (
            lambda: coder64.decode_shared_range64_plain(
                p, w, cdf, cfg, n, lo, rg, return_final_states=True),
            lambda: (coder64.decode_shared_range64_cluster(
                p, w, cdf, cfg, n, cluster, lo, rg)
                if cluster else coder64.decode_shared_range64(
                    p, w, cdf, cfg, n, lo, rg, return_final_states=True))):
            try:
                outcome.append(fn())
            except ValueError as e:
                outcome.append(str(e))
        if isinstance(outcome[0], str) or isinstance(outcome[1], str):
            assert outcome[0] == outcome[1]
        else:
            assert torch.equal(outcome[0][0], outcome[1][0])
            assert all(torch.equal(a, b)
                       for a, b in zip(outcome[0][1], outcome[1][1]))


# --- the S=32 range decode on the cluster step (kernel 6, the same
# cluster_range_decode_kernel at W=16/S=32) -----------------------------


def _range32_case(L, n, P, seed, dev):
    """Points, stream and CDF on the card of n symbols at W=16/S=32, and the
    symbols."""
    rng = np.random.RandomState(seed)
    cfg = _cfg(32, L, P)
    syms, cdf = _range_symbols(rng, 100, P, n, skewed=False)
    pts, words = _range_host(cfg, syms, cdf)
    return (cfg, syms, convert.states_to_torch(pts, cfg, dev),
            convert.u32_to_torch(words, dev), convert.cdf_to_torch(cdf, dev))


@pytest.mark.parametrize("P", [12, 16])
def test_range32_decode_runs_as_a_cluster(dev, P):
    for L in (32768, 65536):
        geo = coder.range_geometry(L, 100, P, dev)
        assert geo["cluster"] > 1 and geo["max_active_clusters"] >= 1
        assert geo["lut_bits"] == 12 and geo["cdf_in_smem"] == 1
        assert geo["lanes_per_thread"] * geo["threads_per_cta"] // 32 \
            >= geo["groups_per_cta"]


@pytest.mark.parametrize("P", [12, 16])
@pytest.mark.parametrize("L,cluster", [
    (32768, 0), (65536, 0), (32768, 3), (65536, 16), (128, 16), (2080, 16),
    (4096, 1)])
def test_range32_cluster_matches_twin(dev, P, L, cluster):
    """Kernel 6 at the facade's lane counts and at forced cluster sizes
    (uneven partitions, CTAs with no lanes, one CTA), with partial last
    steps: symbols and the final three planes equal the twin's, the
    symbols the message."""
    for n in (1, 2 * L + 7):
        cfg, syms, pts, words, cdf = _range32_case(L, n, P, L + n + P, dev)
        before = coder.LAUNCHES["range_decode"]
        if cluster:
            out, fin = coder.decode_shared_range_cluster(pts, words, cdf, cfg,
                                                         n, cluster)
        else:
            out, fin = coder.decode_shared_range(pts, words, cdf, cfg, n,
                                                 return_final_states=True)
        assert coder.LAUNCHES["range_decode"] == before + 1
        out_p, fin_p = coder.decode_shared_range_plain(
            pts, words, cdf, cfg, n, return_final_states=True)
        assert torch.equal(out, out_p)
        assert all(torch.equal(a, b) for a, b in zip(fin, fin_p))
        np.testing.assert_array_equal(out.cpu().numpy(), syms)


@pytest.mark.parametrize("P", [12, 16])
@pytest.mark.parametrize("L", [32768, 65536])
def test_range32_cluster_resumes_from_checkpoint(dev, P, L):
    """A decode resumed from non-default (lows, rngs, pts) planes (a host
    checkpoint) equals the twin's, planes and symbols, and the suffix."""
    n = 6 * L + 11
    cfg, syms, _, _, cdf = _range32_case(L, n, P, 7 + P, dev)
    c64 = cdf.cpu().numpy().astype(np.uint64)
    pts_h, words_h = _range_host(cfg, syms, c64.astype(np.uint32))
    off, lows, rngs, pps = il2.build_checkpoints_range(
        pts_h, words_h, n, c64.astype(np.uint32), cfg, 2)
    c = 1
    start = (c + 1) * 2 * L
    lo, rn, pt = convert.planes_to_torch((lows[c], rngs[c], pps[c]), cfg, dev)
    sub = convert.u32_to_torch(words_h[off[c]:], dev)
    k = coder.decode_shared_range(pt, sub, cdf, cfg, n - start, lows=lo,
                                  rngs=rn, return_final_states=True)
    p = coder.decode_shared_range_plain(pt, sub, cdf, cfg, n - start,
                                        lows=lo, rngs=rn,
                                        return_final_states=True)
    assert torch.equal(k[0], p[0])
    assert all(torch.equal(a, b) for a, b in zip(k[1], p[1]))
    np.testing.assert_array_equal(k[0].cpu().numpy(), syms[start:])


@pytest.mark.parametrize("cluster", [0, 5])
def test_range32_cluster_invalid_planes_and_corrupt_stream(dev, cluster):
    """Garbage points, checkpoint planes with scale 0, a truncated stream
    and stream words with bits above 16 (which the reference ORs into the
    shifted point): the kernel raises the twin's error (the same first bad
    symbol) or returns its symbols and planes."""
    L, n, P = 1024, 5 * 1024 + 33, 12
    cfg, syms, pts, words, cdf = _range32_case(L, n, P, 71, dev)
    rng = np.random.RandomState(72)
    garbage = pts.clone()
    garbage[::5] = torch.from_numpy(rng.randint(
        -(1 << 31), 1 << 31, size=garbage[::5].numel()).astype(np.int32)).to(
            dev)
    lows = torch.zeros(L, dtype=torch.int32, device=dev)
    rngs = torch.full((L,), -1, dtype=torch.int32, device=dev)
    rngs[::3] = torch.from_numpy(rng.randint(0, 1 << 12, size=rngs[::3]
                                             .numel()).astype(np.int32)).to(dev)
    wide, tail = words.clone(), words.clone()
    wide[::7] |= torch.from_numpy(rng.randint(
        1, 1 << 15, size=wide[::7].numel()).astype(np.int32) << 16).to(dev)
    tail[-40:] |= 0x2BCD0000  # consumed last: a decode, not an error
    cases = [(garbage, words, None, None),
             (pts, words[: words.numel() // 3].clone(), None, None),
             (pts, words, lows, rngs), (pts, wide, None, None),
             (pts, tail, None, None)]
    for p, w, lo, rg in cases:
        outcome = []
        for fn in (
            lambda: coder.decode_shared_range_plain(
                p, w, cdf, cfg, n, lo, rg, return_final_states=True),
            lambda: (coder.decode_shared_range_cluster(
                p, w, cdf, cfg, n, cluster, lo, rg)
                if cluster else coder.decode_shared_range(
                    p, w, cdf, cfg, n, lo, rg, return_final_states=True))):
            try:
                outcome.append(fn())
            except ValueError as e:
                outcome.append(str(e))
        if isinstance(outcome[0], str) or isinstance(outcome[1], str):
            assert outcome[0] == outcome[1]
        else:
            assert torch.equal(outcome[0][0], outcome[1][0])
            assert all(torch.equal(a, b)
                       for a, b in zip(outcome[0][1], outcome[1][1]))


def test_range32_decode_lanes_past_the_cluster_reach(dev):
    L = coder.MAX_DECODE_LANES
    cfg = _cfg(32, L + 128, 12)
    pts = torch.zeros(L + 128, dtype=torch.int32, device=dev)
    words = torch.zeros(16, dtype=torch.int32, device=dev)
    cdf = convert.cdf_to_torch(_cdf(100, 12, seed=1)[0], dev)
    before = dict(coder.LAUNCHES)
    with pytest.raises(ValueError, match=f"at most {L} lanes"):
        coder.decode_shared_range(pts, words, cdf, cfg, 1000)
    assert coder.LAUNCHES == before


# which kernels ptxas must compile without spilling, at 2 and 4 lanes a
# thread (L = 32768 and 65536): the range decodes at both presets, the
# exact table decodes (kernel 15; kernel 16, its Seg instance; kernel 13 at
# S=32), the family decode (kernel 11, each family) and the TChain encodes
# (kernels 20, 24 and 22's cluster step); and the lane passes of kernels 8
# and 10, kernel 17's, kernel 14's and kernel 12's pass A, kernel 23's and
# kernel 19's head passes, the family tables pass of kernels 22 and 12 (one
# lane a thread), the range encode's phase A (kernels 7 and 9) and the
# window evaluator (kernel 18, each family)
NO_SPILL = {
    "range S=64": r"cluster_range_decode_kernelILi32ELi64ELi{R}E",
    "range S=32": r"cluster_range_decode_kernelILi16ELi32ELi{R}E",
    "exact S=64": r"cluster_decode_kernelILi32ELi64ELi{R}E.*TableModel",
    "exact seg S=64":
        r"cluster_decode_kernelILi32ELi64ELi{R}E.*TableModelELb1E",
    "exact S=32": r"cluster_decode_kernelILi16ELi32ELi{R}E.*NarrowTableModel",
    **{f"family {name}":
       rf"cluster_decode_kernelILi16ELi32ELi{{R}}E.*FamilyModelILi{k}EE"
       for k, name in enumerate(fam.FAMILIES)},
    "tchain24 encode": r"cluster_tchain_encode_kernelILi32ELi64ELi24ELi{R}E",
    "tchain16 encode": r"cluster_tchain_encode_kernelILi16ELi32ELi16ELi{R}E",
    "tchain12 encode": r"cluster_tchain_encode_kernelILi16ELi32ELi12ELi{R}E",
    "tchain24 heads": r"tchain_heads_kernelILi32ELi64ELi24E",
    "tchain16 heads": r"tchain_heads_kernelILi16ELi32ELi16E",
    "tchain12 tables": r"family_tables_kernel",
    "family encode lanes":
        r"encode_lanes_kernelILi16ELi32E.*RecordLanesModel",
    "range resolve lanes": r"range_resolve_lanes_kernel",
    "range resolve lanes S=64": r"range_resolve_lanes_kernelILi32ELi64E",
    "range record S=32": r"range_record_ring_kernelILi16ELi32E",
    "range record S=64": r"range_record_ring_kernelILi32ELi64E",
    "exact encode lanes S=64":
        r"encode_lanes_kernelILi32ELi64E.*PlaneLanesModel",
    "exact encode lanes S=32":
        r"encode_lanes_kernelILi16ELi32E.*PlaneLanesModel",
    **{f"eval window {name}": rf"exact_eval_window_kernelILi{k}E"
       for k, name in enumerate(ef.DEVICE_FAMILIES)},
}


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("kernel", sorted(NO_SPILL))
def test_cluster_decodes_do_not_spill(dev, kernel, R):
    import re

    spills = _build.ptxas_spills(_build.ptxas_log())
    pattern = re.compile(NO_SPILL[kernel].format(R=R))
    found = {k: v for k, v in spills.items() if pattern.search(k)}
    assert found, f"ptxas reported no {kernel} kernel at R={R}"
    assert all(v == (0, 0) for v in found.values()), found


# --- the device families: integer CDF, rANS pair, TChain-12 bits-back pair

LO, HI = -100, 100


def _family_cfg(L):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)


def _family_data(rng, n, cauchy=False):
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    noise = rng.standard_cauchy(n) if cauchy else rng.randn(n)
    symbols = np.clip(np.round(means + noise * scales), LO, HI)
    return means, scales, symbols.astype(np.int32)


def _left_case(name):
    rng = np.random.RandomState(41)
    if name == "every_t_fix":  # x = 0, scale = 1: t_fix is exactly t
        t = np.arange(-fam.T_CLAMP, fam.T_CLAMP, dtype=np.int64)
        return np.zeros(len(t)), -(0.5 + t / 4096.0), np.ones(len(t))
    if name == "random":
        n = 1 << 20
        return (rng.randint(LO + 1, HI + 2, size=n), rng.randn(n) * 30,
                np.exp(rng.randn(n) * 3))
    g = np.array([(x, m, s) for m in (-500.0, -100.0, 0.0, 99.7, 500.0)
                  for s in (1e-6, 0.01, 1.0, 1e4, 1e6)
                  for x in range(LO + 1, HI + 2)], dtype=np.float64)
    return g[:, 0], g[:, 1], g[:, 2]


@pytest.mark.parametrize("case", ["every_t_fix", "random", "extreme_grid"])
@pytest.mark.parametrize("family", fam.FAMILIES)
def test_family_left_matches_plain_arithmetic(dev, family, case):
    x, mean, scale = _left_case(case)
    x = x.astype(np.int32)
    mean, scale = mean.astype(np.float32), scale.astype(np.float32)
    xt, mt, st = (torch.from_numpy(a).to(dev) for a in (x, mean, scale))
    got = fam.family_left(xt, mt, st, family, LO, HI)
    assert torch.equal(got, fam.left(torch, family, LO, HI, xt, mt, 1.0 / st))
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        fam.left(np, family, LO, HI, x, mean, np.float32(1.0) / scale))


def _check_family(cfg, family, means, scales, symbols, dev, lo=LO, hi=HI):
    n, L = len(symbols), cfg.num_lanes
    mu, sg = convert.params_to_torch(means, scales, n, L, dev)
    syms = torch.from_numpy(symbols).to(dev)
    before = dict(fam.LAUNCHES)
    st, w = fam.encode_family(syms, mu, sg, family, lo, hi, cfg)
    st_p, w_p = fam.encode_family_plain(syms, mu, sg, family, lo, hi, cfg)
    assert torch.equal(st, st_p) and torch.equal(w, w_p)
    cums, probs = fam.family_tables_host(symbols, means, scales, family, lo,
                                         hi)
    st_h, w_h = il2.encode_shared(cums, probs, cfg)
    np.testing.assert_array_equal(convert.u32_from_torch(st), st_h)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_h)
    out, fin = fam.decode_family(st, w, mu, sg, family, lo, hi, cfg, n,
                                 return_final_states=True)
    out_p, fin_p = fam.decode_family_plain(st, w, mu, sg, family, lo, hi, cfg,
                                           n, return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    assert torch.equal(out, syms)
    assert torch.equal(fin, torch.full_like(fin, 1 << 16))
    if n:
        assert fam.LAUNCHES["encode"] == before["encode"] + 1
        assert fam.LAUNCHES["decode"] == before["decode"] + 1
    return st, w, mu, sg


@pytest.mark.parametrize("family", fam.FAMILIES)
@pytest.mark.parametrize("L,n", [(128, 1), (128, 3000), (384, 1000),
                                 (1024, 1024 * 9), (32768, 32768 * 3 + 5),
                                 (65536, 65536 * 2 + 77)])
def test_family_kernels_match_twins(dev, family, L, n):
    rng = np.random.RandomState(L + n)
    means, scales, symbols = _family_data(rng, n, cauchy=family == "cauchy")
    _check_family(_family_cfg(L), family, means, scales, symbols, dev)


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_family_extreme_parameters_round_trip(dev, family):
    rng = np.random.RandomState(11)
    cases = [(m, s) for m in (-500.0, -100.0, 0.0, 99.7, 500.0)
             for s in (1e-6, 0.01, 1.0, 1e4, 1e6)]
    means = np.array([c[0] for c in cases] * 8, np.float32)
    scales = np.array([c[1] for c in cases] * 8, np.float32)
    symbols = rng.randint(LO, HI + 1, size=len(means)).astype(np.int32)
    _check_family(_family_cfg(128), family, means, scales, symbols, dev)


def test_family_other_supports(dev):
    """The widest support the precision allows, and the narrowest."""
    rng = np.random.RandomState(3)
    means, scales, _ = _family_data(rng, 5000)
    wide = rng.randint(0, 2048, 5000).astype(np.int32)
    _check_family(_family_cfg(256), "laplace", means + 1000, scales * 40,
                  wide, dev, lo=0, hi=2047)
    narrow = rng.randint(7, 9, 5000).astype(np.int32)
    _check_family(_family_cfg(256), "gaussian", means, scales, narrow, dev,
                  lo=7, hi=8)


def test_family_truncated_stream_zero_fills(dev):
    rng = np.random.RandomState(5)
    cfg = _family_cfg(256)
    means, scales, symbols = _family_data(rng, 4000)
    st, w, mu, sg = _check_family(cfg, "gaussian", means, scales, symbols,
                                  dev)
    cut = w[: w.numel() // 3].clone()
    out, fin = fam.decode_family(st, cut, mu, sg, "gaussian", LO, HI, cfg,
                                 4000, return_final_states=True)
    out_p, fin_p = fam.decode_family_plain(st, cut, mu, sg, "gaussian", LO,
                                           HI, cfg, 4000,
                                           return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    np.testing.assert_array_equal(
        out.cpu().numpy(), fam.decode_family_host(
            convert.u32_from_torch(st), convert.u32_from_torch(cut), means,
            scales, "gaussian", LO, HI, cfg, 4000))


def _family_host_pair(L, n, family, seed):
    """A family message coded by the numpy host coder at any L (a multiple
    of 32): (cfg, means, scales, symbols, states, stream) as numpy."""
    cfg = _family_cfg(L)
    rng = np.random.RandomState(seed)
    means, scales, symbols = _family_data(rng, n, cauchy=family == "cauchy")
    cums, probs = fam.family_tables_host(symbols, means, scales, family, LO,
                                         HI)
    states, stream = il2.encode_shared(cums, probs, cfg)
    return cfg, means, scales, symbols, states, stream


def test_family_decode_runs_as_a_cluster(dev):
    """Kernel 11 at the family row's L = 32768: 16 CTAs, 2 lanes a
    thread, for every family."""
    for family in fam.FAMILIES:
        geo = fam.geometry(32768, family, dev)
        assert geo["cluster"] == 16 and geo["max_active_clusters"] >= 1
        assert geo["lanes_per_thread"] == 2
        assert geo["lanes_per_thread"] * geo["threads_per_cta"] // 32 \
            >= geo["groups_per_cta"]


@pytest.mark.parametrize("family", fam.FAMILIES)
@pytest.mark.parametrize("L,cluster", [
    (32, 1), (32, 16), (96, 4), (96, 5), (4096, 3), (4096, 16), (32768, 1),
    (32768, 8)])
def test_family_cluster_partitions_match_twin(dev, family, L, cluster):
    """Forced cluster sizes: groups that do not divide evenly over the CTAs
    (4096/3), CTAs left with no lanes (32/16, 96/4, 96/5), one CTA holding
    32 lanes a thread (32768/1); a partial last step whose lanes read the
    padded parameters.  Against the twin and the numpy host oracle."""
    geo = fam.geometry(L, family, dev, cluster=cluster)
    assert geo["cluster"] == cluster
    for n in (1, L - 5, 2 * L + 7):
        cfg, means, scales, symbols, st_h, w_h = _family_host_pair(
            L, n, family, seed=L + n + cluster)
        mu, sg = convert.params_to_torch(means, scales, n, L, dev)
        st = convert.u32_to_torch(st_h, dev)
        w = convert.u32_to_torch(w_h, dev)
        before = fam.LAUNCHES["decode"]
        out, fin = fam.decode_family_cluster(st, w, mu, sg, family, LO, HI,
                                             cfg, n, cluster)
        assert fam.LAUNCHES["decode"] == before + 1
        out_p, fin_p = fam.decode_family_plain(st, w, mu, sg, family, LO, HI,
                                               cfg, n,
                                               return_final_states=True)
        assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
        np.testing.assert_array_equal(out.cpu().numpy(), symbols)
        np.testing.assert_array_equal(
            out.cpu().numpy(), fam.decode_family_host(
                st_h, w_h, means, scales, family, LO, HI, cfg, n))
        assert bool((fin == 1 << 16).all())


def test_family_decode_lanes_at_and_past_the_cluster_reach(dev):
    """16 CTAs x 1024 threads x 32 lanes a thread: L = 524288 decodes like
    the twin and the host oracle; 128 lanes more raise with the limit named
    and launch nothing.  (The message comes from the host coder: the
    single-block encoder's shared memory holds 4 L / 32 + 32 words, more
    than a block has at this L.)"""
    L = coder.MAX_DECODE_LANES
    n = L + 99
    cfg, means, scales, symbols, st_h, w_h = _family_host_pair(
        L, n, "gaussian", seed=17)
    mu, sg = convert.params_to_torch(means, scales, n, L, dev)
    st = convert.u32_to_torch(st_h, dev)
    w = convert.u32_to_torch(w_h, dev)
    out, fin = fam.decode_family(st, w, mu, sg, "gaussian", LO, HI, cfg, n,
                                 return_final_states=True)
    out_p, fin_p = fam.decode_family_plain(st, w, mu, sg, "gaussian", LO, HI,
                                           cfg, n, return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    np.testing.assert_array_equal(out.cpu().numpy(), symbols)
    cfg = _family_cfg(L + 128)
    mu, sg = convert.params_to_torch(means, scales, n, L + 128, dev)
    st = torch.full((L + 128,), 1 << 16, dtype=torch.int32, device=dev)
    before = dict(fam.LAUNCHES)
    with pytest.raises(ValueError, match=f"at most {L} lanes"):
        fam.decode_family(st, w, mu, sg, "gaussian", LO, HI, cfg, n)
    assert fam.LAUNCHES == before


@pytest.mark.parametrize("family", fam.FAMILIES)
@pytest.mark.parametrize("L,n", [(128, 1), (128, 128 * 7 + 3),
                                 (1024, 1024 * 5), (32768, 32768 * 2 + 11),
                                 (coder.MAX_DECODE_LANES,
                                  coder.MAX_DECODE_LANES + 99)])
def test_family_encode_passes_match_plain(dev, family, L, n):
    """Kernel 12's three launches: the tables pass, pass A and pass B, each
    alone against its plain version on the same tensors, and the C entry
    against the twin, the three-step twin and the numpy host oracle; L up
    to coder.MAX_DECODE_LANES (the grid passes take any L), partial last
    steps, symbols pinned at both ends of the support."""
    rng = np.random.RandomState(L + n + len(family))
    means, scales, symbols = _family_data(rng, n, cauchy=family == "cauchy")
    symbols[rng.rand(n) < 0.1] = LO
    symbols[rng.rand(n) < 0.1] = HI
    cfg = _family_cfg(L)
    mu, sg = convert.params_to_torch(means, scales, n, L, dev)
    syms = torch.from_numpy(symbols).to(dev)
    before = dict(fam.LAUNCHES)
    recs = fam.family_tables_pass(syms, mu, sg, family, LO, HI, cfg)
    assert torch.equal(recs, fam.family_tables_pass_plain(
        syms, mu, sg, family, LO, HI))
    words, ballots, states = fam.family_lanes_pass(recs, cfg)
    words_p, flags_p, states_p = fam.family_lanes_pass_plain(recs, n, cfg)
    assert torch.equal(ballots, coder.flag_ballots(flags_p))
    assert torch.equal(words[flags_p], words_p[flags_p])
    assert torch.equal(states, states_p)
    stream = coder.compact_pass(words, ballots)
    assert torch.equal(stream, coder.compact_pass_plain(words_p, flags_p))
    st, w = fam.encode_family(syms, mu, sg, family, LO, HI, cfg)
    assert fam.LAUNCHES["tables"] == before["tables"] + 1
    assert fam.LAUNCHES["encode_lanes"] == before["encode_lanes"] + 1
    assert fam.LAUNCHES["encode"] == before["encode"] + 1
    assert torch.equal(st, states) and torch.equal(w, stream)
    st_p, w_p = fam.encode_family_plain(syms, mu, sg, family, LO, HI, cfg)
    assert torch.equal(st, st_p) and torch.equal(w, w_p)
    st_l, w_l = fam.encode_family_lanes_plain(syms, mu, sg, family, LO, HI,
                                              cfg)
    assert torch.equal(st, st_l) and torch.equal(w, w_l)
    cums, probs = fam.family_tables_host(symbols, means, scales, family, LO,
                                         HI)
    st_h, w_h = il2.encode_shared(cums, probs, cfg)
    np.testing.assert_array_equal(convert.u32_from_torch(st), st_h)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_h)


def test_failed_call_leaves_no_error_behind(dev):
    """A C entry whose launch the runtime refuses (the family tables pass
    over 2^39 symbols asks for a grid of 2^31 blocks, one past the card's
    limit; the tensors are never read) raises, and the next call does not
    report that failure as its own."""
    syms = torch.zeros(32, dtype=torch.int32, device=dev)
    params = torch.ones(32, dtype=torch.float32, device=dev)
    recs = torch.empty(32, dtype=torch.int64, device=dev)
    with pytest.raises(RuntimeError, match="ctt_family_tables_pass failed"):
        _build.call("ctt_family_tables_pass", dev, syms, params, params, recs,
                    1 << 39, 0, LO, HI)
    rng = np.random.RandomState(29)
    means, scales, symbols = _family_data(rng, 1000)
    _check_family(_family_cfg(128), "gaussian", means, scales, symbols, dev)


@pytest.mark.parametrize("cluster", [0, 16])
def test_family_cluster_truncated_stream_zero_fills(dev, cluster):
    """Kernel 11 at L = 32768 on a stream cut to a third: the reads past its
    end give zero words, as in the twin and the numpy host oracle."""
    L, n = 32768, 3 * 32768 - 11
    cfg, means, scales, symbols, st_h, w_h = _family_host_pair(
        L, n, "cauchy", seed=23)
    cut_h = w_h[: len(w_h) // 3]
    mu, sg = convert.params_to_torch(means, scales, n, L, dev)
    st = convert.u32_to_torch(st_h, dev)
    cut = convert.u32_to_torch(cut_h, dev)
    if cluster:
        out, fin = fam.decode_family_cluster(st, cut, mu, sg, "cauchy", LO,
                                             HI, cfg, n, cluster)
    else:
        out, fin = fam.decode_family(st, cut, mu, sg, "cauchy", LO, HI, cfg,
                                     n, return_final_states=True)
    out_p, fin_p = fam.decode_family_plain(st, cut, mu, sg, "cauchy", LO, HI,
                                           cfg, n, return_final_states=True)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    np.testing.assert_array_equal(
        out.cpu().numpy(), fam.decode_family_host(
            st_h, cut_h, means, scales, "cauchy", LO, HI, cfg, n))


@pytest.mark.parametrize("family", fam.FAMILIES)
@pytest.mark.parametrize("L,T", [(1024, 1), (1024, 5), (3072, 3),
                                 (32768, 2)])
def test_tchain12_kernels_match_twins(dev, family, L, T):
    rng = np.random.RandomState(L + T)
    cfg = _family_cfg(L)
    n = L * T
    means, scales, _ = _family_data(rng, n)
    q = rng.randint(0, 1 << 12, size=n).astype(np.uint16)
    mu, sg = convert.params_to_torch(means, scales, n, L, dev)
    qw = convert.quantiles_to_torch(q, L, dev)
    before = dict(tc.LAUNCHES)
    got = tc.tchain12_family_decode(qw, mu, sg, family, LO, HI, cfg)
    twin = tc.tchain12_family_decode_plain(qw, mu, sg, family, LO, HI, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, twin))
    host = tc.tchain12_family_decode_host(q, means, scales, family, LO, HI,
                                          cfg)
    np.testing.assert_array_equal(got[0].cpu().numpy(), host[0])
    np.testing.assert_array_equal(convert.u32_from_torch(got[1]), host[1])
    np.testing.assert_array_equal(convert.u32_from_torch(got[2]), host[2])
    back = tc.tchain12_family_encode(*got, mu, sg, family, LO, HI, cfg)
    back_p = tc.tchain12_family_encode_plain(*got, mu, sg, family, LO, HI,
                                             cfg)
    assert all(torch.equal(a, b) for a, b in zip(back, back_p))
    assert torch.equal(back[0], qw)
    assert torch.equal(back[1], torch.full_like(back[1], 16))
    assert tc.LAUNCHES["decode12_family"] == before["decode12_family"] + 1
    assert tc.LAUNCHES["encode12_family"] == before["encode12_family"] + 1
    # truncated remainders read as zero words, as in the host oracle
    cut = got[1][: got[1].numel() // 2].clone()
    a = tc.tchain12_family_encode(got[0], cut, got[2], mu, sg, family, LO, HI,
                                  cfg)
    b = tc.tchain12_family_encode_plain(got[0], cut, got[2], mu, sg, family,
                                        LO, HI, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("family", fam.FAMILIES)
@pytest.mark.parametrize("L,T", [(1024, 1), (3072, 3), (32768, 9)])
def test_tchain12_decode_passes_match_plain(dev, family, L, T):
    """Kernel 21's three steps launched alone, each against its plain
    version on the same CUDA tensors: the inversion pass (symbols and
    records), the head pass (the flushed words where flagged, the ballots
    and the heads) and pass B (the stream); composed, the twin's decode."""
    rng = np.random.RandomState(3 * L + T)
    cfg = _family_cfg(L)
    n = L * T
    means, scales, _ = _family_data(rng, n)
    q = rng.randint(0, 1 << 12, size=n).astype(np.uint16)
    q[:L] = 0xFFF  # the first step's top quantiles: every head grows most
    mu, sg = convert.params_to_torch(means, scales, n, L, dev)
    qw = convert.quantiles_to_torch(q, L, dev)
    before = dict(tc.LAUNCHES)
    syms, recs = tc.tchain12_invert_pass(qw, mu, sg, family, LO, HI, cfg)
    syms_p, recs_p = tc.tchain12_invert_pass_plain(qw, mu, sg, family, LO,
                                                   HI, cfg)
    assert torch.equal(syms, syms_p) and torch.equal(recs, recs_p)
    words, ballots, heads = tc.tchain12_head_pass(recs, cfg)
    words_p, flags_p, heads_p = tc.tchain12_head_pass_plain(recs, cfg)
    assert torch.equal(ballots, coder.flag_ballots(flags_p))
    assert torch.equal(words[flags_p], words_p[flags_p])
    assert torch.equal(heads, heads_p)
    stream = coder.compact_pass(words, ballots)
    assert torch.equal(stream, coder.compact_pass_plain(words_p, flags_p))
    twin = tc.tchain12_family_decode_plain(qw, mu, sg, family, LO, HI, cfg)
    assert torch.equal(syms, twin[0]) and torch.equal(stream, twin[1])
    assert torch.equal(heads, twin[2])
    assert tc.LAUNCHES["invert12_family"] == before["invert12_family"] + 1
    assert tc.LAUNCHES["heads12_family"] == before["heads12_family"] + 1
    assert tc.LAUNCHES["decode12_family"] == before["decode12_family"]


def test_family_facade_cuda_matches_cpu(dev):
    rng = np.random.RandomState(8)
    means, scales, symbols = _family_data(rng, 50_000)
    got = ctt.encode_family(symbols, means, scales, "gaussian", LO, HI,
                            device="cuda")
    ref = ctt.encode_family(symbols, means, scales, "gaussian", LO, HI,
                            device="cpu")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(
        ctt.decode_family(*got, means, scales, "gaussian", LO, HI,
                          len(symbols), device="cuda"), symbols)
    n = 2 * 32768
    q = rng.randint(0, 1 << 12, size=n).astype(np.uint16)
    means, scales, _ = _family_data(rng, n)
    got = ctt.bits_back_decode_family(q, means, scales, "logistic", LO, HI,
                                      device="cuda")
    ref = ctt.bits_back_decode_family(q, means, scales, "logistic", LO, HI,
                                      device="cpu")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    q2, h2 = ctt.bits_back_encode_family(*got, means, scales, "logistic", LO,
                                         HI, device="cuda")
    np.testing.assert_array_equal(q2, q)
    assert np.all(h2 == 16)


@pytest.mark.parametrize("P,compact", [(24, True), (24, False), (12, True),
                                       (12, False), (16, True)])
def test_decode_from_checkpoint_on_the_card(dev, P, compact):
    cdf, probs = _cdf(100, P, seed=6)
    symbols = np.random.RandomState(7).choice(100, size=60_000, p=probs)
    data = ctt.encode_iid(symbols, cdf, compact=compact, device="cuda")
    ckpt = ctt.build_checkpoints(data, cdf, 3)
    assert len(ckpt[0]) >= 2
    for c in range(len(ckpt[0])):
        start, out = ctt.decode_from_checkpoint(data, cdf, 3, c, *ckpt,
                                                device="cuda")
        np.testing.assert_array_equal(out, symbols[start:])


def test_family_wrapper_rejects_mixed_devices(dev):
    rng = np.random.RandomState(2)
    means, scales, symbols = _family_data(rng, 256)
    mu, sg = convert.params_to_torch(means, scales, 256, 128, dev)
    with pytest.raises(ValueError, match="is on cuda"):
        fam.encode_family(torch.from_numpy(symbols), mu, sg, "gaussian", LO,
                          HI, _family_cfg(128))


# --- TChain-16 and TChain-24: categorical bits-back ------------------------

CAT = {  # P: decode, encode, their twins, their host oracles, the seed
    16: (tc.tchain16_decode, tc.tchain16_encode, tc.tchain16_decode_plain,
         tc.tchain16_encode_plain, tc.tchain_decode_host,
         tc.tchain_encode_host, 1),
    24: (tc.tchain24_decode, tc.tchain24_encode, tc.tchain24_decode_plain,
         tc.tchain24_encode_plain, tc.tchain24_decode_host,
         tc.tchain24_encode_host, 256),
}


def _cat_cfg(P, L):
    if P == 16:
        return LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                          precision=16)
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=24)


def _cat_cdf(K, P, seed):
    if K == 1:
        return np.array([0, 1 << P], np.uint64)
    return _cdf(K, P, seed)[0]


def _q_to_torch(P, q, L, dev):
    if P == 16:
        return convert.quantiles16_to_torch(q, L, dev)
    return convert.u32_to_torch(q, dev)


def _q_from_torch(P, t, L):
    if P == 16:
        return convert.quantiles16_from_torch(t, L)
    return convert.u32_from_torch(t)


def _heads_np(P, t):
    return convert.u32_from_torch(t) if P == 16 else convert.u64_from_torch(t)


def _check_cat(P, L, T, K, dev, seed):
    dec, enc, dec_p, enc_p, dec_h, enc_h, seed_head = CAT[P]
    cfg = _cat_cfg(P, L)
    rng = np.random.RandomState(seed)
    cdf_np = _cat_cdf(K, P, seed)
    q = rng.randint(0, 1 << P, size=L * T).astype(
        np.uint16 if P == 16 else np.uint32)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    qt = _q_to_torch(P, q, L, dev)
    before = dict(tc.LAUNCHES)
    got = dec(qt, cdf, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, dec_p(qt, cdf, cfg)))
    host = dec_h(q, cdf_np, cfg)
    np.testing.assert_array_equal(got[0].cpu().numpy(), host[0])
    np.testing.assert_array_equal(convert.u32_from_torch(got[1]), host[1])
    np.testing.assert_array_equal(_heads_np(P, got[2]), host[2])
    back = enc(*got, cdf, cfg)
    assert all(torch.equal(a, b) for a, b in zip(back, enc_p(*got, cdf, cfg)))
    assert torch.equal(back[0], qt)
    assert bool((back[1] == seed_head).all())
    q_h, h_h = enc_h(*host, cdf_np, cfg)
    np.testing.assert_array_equal(_q_from_torch(P, back[0], L), q_h)
    np.testing.assert_array_equal(_heads_np(P, back[1]), h_h)
    if T:
        assert tc.LAUNCHES[f"decode{P}"] == before[f"decode{P}"] + 1
        assert tc.LAUNCHES[f"encode{P}"] == before[f"encode{P}"] + 1
    # truncated remainders read as zero words, as in the host oracle
    cut = got[1][: got[1].numel() // 2].clone()
    a = enc(got[0], cut, got[2], cdf, cfg)
    assert all(torch.equal(x, y)
               for x, y in zip(a, enc_p(got[0], cut, got[2], cdf, cfg)))
    q_h, h_h = enc_h(host[0], convert.u32_from_torch(cut), host[2], cdf_np,
                     cfg)
    np.testing.assert_array_equal(_q_from_torch(P, a[0], L), q_h)
    np.testing.assert_array_equal(_heads_np(P, a[1]), h_h)
    return got, cdf, qt


@pytest.mark.parametrize("P", [16, 24])
@pytest.mark.parametrize("L,T,K", [(256, 1, 16), (256, 7, 2), (512, 5, 100),
                                   (768, 3, 1), (1280, 9, 40),
                                   (32768, 3, 100), (32768, 2, 1000),
                                   (512, 0, 16)])
def test_tchain_cat_kernels_match_twins(dev, P, L, T, K):
    _check_cat(P, L, T, K, dev, seed=L + T + K)


@pytest.mark.parametrize("P,K", [(16, 60_000), (24, 70_000)])
def test_tchain_cat_large_alphabet_reads_cdf_from_device_memory(dev, P, K):
    _check_cat(P, 512, 4, K, dev, seed=K)


@pytest.mark.parametrize("P", [16, 24])
def test_tchain_cat_encoder_writes_every_quantile(dev, P):
    """The encoder stores each quantile (TChain-16: its 16-bit half of a
    planar word); an output buffer full of ones comes back exact."""
    L, T = 512, 3
    got, cdf, qt = _check_cat(P, L, T, 100, dev, seed=11)
    out = torch.full_like(qt, -1)
    heads = got[2].clone()
    cdf32 = cdf.to(torch.int32)
    K = cdf32.numel() - 1
    # kernels 20 and 24 take a scratch for their K division records
    _build.call(f"ctt_tchain{P}_encode", dev, heads, got[0], cdf32, K,
                got[1], got[1].numel(), out,
                coder._records(cdf32, _cat_cfg(P, L)), L, T)
    assert torch.equal(out, qt)


# --- kernels 24 and 20 on the cluster step ---------------------------------

# P: the cluster encode and its forced-size form
CLUSTER_ENCODE = {
    16: (tc.tchain16_encode, tc.tchain16_encode_cluster),
    24: (tc.tchain24_encode, tc.tchain24_encode_cluster),
}


def _cat_message(P, L, T, K, dev, seed):
    """A TChain-16 or TChain-24 decode on the card, checked against the
    host oracle: (cfg, cdf, CUDA tensors of the CDF, quantiles and the
    decode, the host's decode, P)."""
    cfg = _cat_cfg(P, L)
    cdf_np = _cat_cdf(K, P, seed)
    q = np.random.RandomState(seed).randint(0, 1 << P, size=L * T).astype(
        np.uint16 if P == 16 else np.uint32)
    cdf = convert.cdf_to_torch(cdf_np, dev)
    qt = _q_to_torch(P, q, L, dev)
    got = CAT[P][0](qt, cdf, cfg)
    host = CAT[P][4](q, cdf_np, cfg)
    np.testing.assert_array_equal(convert.u32_from_torch(got[1]), host[1])
    return cfg, cdf_np, cdf, qt, got, host, P


def _check_cluster_encode(cfg, cdf_np, cdf, qt, got, host, P, cluster):
    enc, enc_cluster = CLUSTER_ENCODE[P]
    enc_p, enc_h, seed = CAT[P][3], CAT[P][5], CAT[P][6]
    L = cfg.num_lanes
    before = tc.LAUNCHES[f"encode{P}"]
    back = (enc_cluster(*got, cdf, cluster, cfg) if cluster
            else enc(*got, cdf, cfg))
    assert tc.LAUNCHES[f"encode{P}"] == before + 1
    plain = enc_p(*got, cdf, cfg)
    assert torch.equal(back[0], plain[0]) and torch.equal(back[1], plain[1])
    assert torch.equal(back[0], qt) and bool((back[1] == seed).all())
    q_h, h_h = enc_h(*host, cdf_np, cfg)
    np.testing.assert_array_equal(_q_from_torch(P, back[0], L), q_h)
    np.testing.assert_array_equal(_heads_np(P, back[1]), h_h)
    # truncated remainders read as zero words
    cut = got[1][: got[1].numel() // 3].clone()
    a = (enc_cluster(got[0], cut, got[2], cdf, cluster, cfg) if cluster
         else enc(got[0], cut, got[2], cdf, cfg))
    a_p = enc_p(got[0], cut, got[2], cdf, cfg)
    assert torch.equal(a[0], a_p[0]) and torch.equal(a[1], a_p[1])


@pytest.mark.parametrize("cluster", list(range(1, 17)))
@pytest.mark.parametrize("L,T", [(128, 5), (32768, 3), (65536, 2)])
def test_tchain24_cluster_encode_matches_twin(dev, L, T, cluster):
    """Every forced cluster size at 128 lanes (CTAs left with no lanes),
    the facade's 32768 and 65536 (up to 32 lanes a thread on one CTA; at
    65536 one CTA would need 64, past the kernel's reach, and raises)."""
    args = _cat_message(24, L, T, 100, dev, L + T)
    if L // 32 > cluster * 32 * 32:
        with pytest.raises(RuntimeError, match="invalid argument"):
            tc.tchain24_encode_cluster(*args[4], args[2], cluster, args[0])
        return
    _check_cluster_encode(*args, cluster)


@pytest.mark.parametrize("K", [1, 100, 70_000])
@pytest.mark.parametrize("L,T", [(384, 7), (32768, 3), (65536, 2)])
def test_tchain24_encode_records_in_shared_or_device_memory(dev, L, T, K):
    """K=70000 division records (1.1 MB) stay in device memory; the
    one-symbol model divides by 2^24."""
    geo = tc.geometry24(L, K, dev)
    assert geo["records_in_smem"] == (K < 70_000)
    _check_cluster_encode(*_cat_message(24, L, T, K, dev, K + L), 0)


def test_tchain24_encode_runs_as_a_cluster_and_caps_its_lanes(dev):
    geo = tc.geometry24(32768, 100, dev)
    assert geo["cluster"] == 16 and geo["lanes_per_thread"] == 2
    assert geo["max_active_clusters"] >= 1
    geo = tc.geometry24(coder.MAX_DECODE_LANES, 100, dev)
    assert geo["lanes_per_thread"] == 32
    L = coder.MAX_DECODE_LANES + 128
    cfg = _cat_cfg(24, L)
    cdf = convert.cdf_to_torch(_cat_cdf(100, 24, 3), dev)
    syms = torch.zeros(L, dtype=torch.int32, device=dev)
    heads = torch.full((L,), 256, dtype=torch.int64, device=dev)
    words = torch.zeros(0, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain24_encode(syms, words, heads, cdf, cfg)


@pytest.mark.parametrize("cluster", list(range(1, 17)))
@pytest.mark.parametrize("L,T", [(256, 5), (32768, 3), (65536, 2)])
def test_tchain16_cluster_encode_matches_twin(dev, L, T, cluster):
    """Kernel 20 at every forced cluster size: 256 lanes (CTAs left with no
    lanes), the facade's 32768 and 65536 (past one CTA's reach at 65536,
    which raises)."""
    args = _cat_message(16, L, T, 100, dev, L + T)
    if L // 32 > cluster * 32 * 32:
        with pytest.raises(RuntimeError, match="invalid argument"):
            tc.tchain16_encode_cluster(*args[4], args[2], cluster, args[0])
        return
    _check_cluster_encode(*args, cluster)


@pytest.mark.parametrize("K", [1, 100, 60_000])
@pytest.mark.parametrize("L,T", [(768, 7), (32768, 3), (65536, 2)])
def test_tchain16_encode_records_in_shared_or_device_memory(dev, L, T, K):
    """K=60000 division records (480 KB) stay in device memory; the
    one-symbol model divides by 2^16 and refills every lane at every
    step."""
    geo = tc.geometry16(L, K, dev)
    assert geo["records_in_smem"] == (K < 60_000)
    _check_cluster_encode(*_cat_message(16, L, T, K, dev, K + L), 0)


def test_tchain16_encode_runs_as_a_cluster_and_caps_its_lanes(dev):
    geo = tc.geometry16(32768, 100, dev)
    assert geo["cluster"] == 16 and geo["lanes_per_thread"] == 2
    assert geo["max_active_clusters"] >= 1
    assert tc.geometry16(coder.MAX_DECODE_LANES, 100,
                         dev)["lanes_per_thread"] == 32
    L = coder.MAX_DECODE_LANES + 256
    cfg = _cat_cfg(16, L)
    cdf = convert.cdf_to_torch(_cat_cdf(100, 16, 3), dev)
    syms = torch.zeros(L, dtype=torch.int32, device=dev)
    heads = torch.ones(L, dtype=torch.int32, device=dev)
    words = torch.zeros(0, dtype=torch.int32, device=dev)
    before = dict(tc.LAUNCHES)
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain16_encode(syms, words, heads, cdf, cfg)
    assert tc.LAUNCHES == before


# --- kernel 23: the TChain-24 decode as two steps over the grid ------------


@pytest.mark.parametrize("K", [1, 2, 100, 70_000])
@pytest.mark.parametrize("L,T", [(128, 1), (384, 9), (32768, 5)])
def test_tchain24_decode_passes_match_plain(dev, L, T, K):
    """Kernel 23's two steps launched alone, each against its plain version
    on the same CUDA tensors: the head pass (symbols, the flushed words
    where flagged, the ballots and the heads; K=70000: the CDF in device
    memory) and pass B (the stream); composed, the twin's decode, which
    the whole call equals."""
    cfg = _cat_cfg(24, L)
    rng = np.random.RandomState(K + L + T)
    cdf = convert.cdf_to_torch(_cat_cdf(K, 24, K + L), dev)
    q = rng.randint(0, 1 << 24, size=L * T).astype(np.uint32)
    q[:L] = (1 << 24) - 1  # the first step's top quantiles
    qt = convert.u32_to_torch(q, dev)
    before = dict(tc.LAUNCHES)
    syms, words, ballots, heads = tc.tchain24_head_pass(qt, cdf, cfg)
    syms_p, words_p, flags_p, heads_p = tc.tchain24_head_pass_plain(qt, cdf,
                                                                    cfg)
    assert torch.equal(syms, syms_p)
    assert torch.equal(ballots, coder.flag_ballots(flags_p))
    assert torch.equal(words[flags_p], words_p[flags_p])
    assert torch.equal(heads, heads_p)
    stream = coder.compact_pass(words, ballots)
    assert torch.equal(stream, coder.compact_pass_plain(words_p, flags_p))
    twin = tc.tchain24_decode_plain(qt, cdf, cfg)
    assert torch.equal(syms, twin[0]) and torch.equal(stream, twin[1])
    assert torch.equal(heads, twin[2])
    assert tc.LAUNCHES["heads24"] == before["heads24"] + 1
    assert tc.LAUNCHES["decode24"] == before["decode24"]
    whole = tc.tchain24_decode(qt, cdf, cfg)
    assert all(torch.equal(a, b) for a, b in zip(whole, twin))
    assert tc.LAUNCHES["decode24"] == before["decode24"] + 1


def test_tchain24_head_pass_on_the_main_path_shape(dev):
    """The TChain-24 row's shape, 2^24 quantiles at L=32768 (T=512): the
    head pass against its plain version."""
    L = 32768
    cfg = _cat_cfg(24, L)
    cdf = convert.cdf_to_torch(_cat_cdf(100, 24, 5), dev)
    qt = convert.u32_to_torch(np.random.RandomState(5).randint(
        0, 1 << 24, size=1 << 24).astype(np.uint32), dev)
    syms, words, ballots, heads = tc.tchain24_head_pass(qt, cdf, cfg)
    syms_p, words_p, flags_p, heads_p = tc.tchain24_head_pass_plain(qt, cdf,
                                                                    cfg)
    assert torch.equal(syms, syms_p) and torch.equal(heads, heads_p)
    assert torch.equal(ballots, coder.flag_ballots(flags_p))
    assert torch.equal(words[flags_p], words_p[flags_p])


# --- kernel 19: the TChain-16 decode as two steps over the grid ------------


@pytest.mark.parametrize("K", [1, 2, 100, 60_000])
@pytest.mark.parametrize("L,T", [(256, 1), (768, 9), (32768, 5)])
def test_tchain16_decode_passes_match_plain(dev, L, T, K):
    """Kernel 19's two steps launched alone, each against its plain version
    on the same CUDA tensors: the head pass (symbols, the flushed words
    where flagged, the ballots and the heads; K=60000: the CDF in device
    memory; K=1: every lane flushes at every step) and pass B (the
    stream); composed, the twin's decode, which the whole call equals."""
    cfg = _cat_cfg(16, L)
    rng = np.random.RandomState(K + L + T)
    cdf = convert.cdf_to_torch(_cat_cdf(K, 16, K + L), dev)
    q = rng.randint(0, 1 << 16, size=L * T).astype(np.uint16)
    q[:L] = (1 << 16) - 1  # the first step's top quantiles
    qw = convert.quantiles16_to_torch(q, L, dev)
    before = dict(tc.LAUNCHES)
    syms, words, ballots, heads = tc.tchain16_head_pass(qw, cdf, cfg)
    syms_p, words_p, flags_p, heads_p = tc.tchain16_head_pass_plain(qw, cdf,
                                                                    cfg)
    assert torch.equal(syms, syms_p)
    assert torch.equal(ballots, coder.flag_ballots(flags_p))
    assert torch.equal(words[flags_p], words_p[flags_p])
    assert torch.equal(heads, heads_p)
    stream = coder.compact_pass(words, ballots)
    assert torch.equal(stream, coder.compact_pass_plain(words_p, flags_p))
    twin = tc.tchain16_decode_plain(qw, cdf, cfg)
    assert torch.equal(syms, twin[0]) and torch.equal(stream, twin[1])
    assert torch.equal(heads, twin[2])
    assert tc.LAUNCHES["heads16"] == before["heads16"] + 1
    assert tc.LAUNCHES["decode16"] == before["decode16"]
    whole = tc.tchain16_decode(qw, cdf, cfg)
    assert all(torch.equal(a, b) for a, b in zip(whole, twin))
    assert tc.LAUNCHES["decode16"] == before["decode16"] + 1


def test_tchain16_head_pass_on_the_main_path_shape(dev):
    """The TChain-16 row's shape, 2^24 quantiles at L=32768 (T=512): the
    head pass against its plain version."""
    L = 32768
    cfg = _cat_cfg(16, L)
    cdf = convert.cdf_to_torch(_cat_cdf(100, 16, 5), dev)
    qw = convert.quantiles16_to_torch(np.random.RandomState(5).randint(
        0, 1 << 16, size=1 << 24).astype(np.uint16), L, dev)
    syms, words, ballots, heads = tc.tchain16_head_pass(qw, cdf, cfg)
    syms_p, words_p, flags_p, heads_p = tc.tchain16_head_pass_plain(qw, cdf,
                                                                    cfg)
    assert torch.equal(syms, syms_p) and torch.equal(heads, heads_p)
    assert torch.equal(ballots, coder.flag_ballots(flags_p))
    assert torch.equal(words[flags_p], words_p[flags_p])


# --- kernel 22: the TChain-12 encode as a tables pass and the cluster step -


def _tchain12_message(L, T, family, dev, seed):
    """A TChain-12 decode on the card of uniform quantiles: (cfg, means,
    scales, quantile words, the decode)."""
    rng = np.random.RandomState(seed)
    cfg = _family_cfg(L)
    n = L * T
    means, scales, _ = _family_data(rng, n)
    q = rng.randint(0, 1 << 12, size=n).astype(np.uint16)
    mu, sg = convert.params_to_torch(means, scales, n, L, dev)
    qw = convert.quantiles_to_torch(q, L, dev)
    return cfg, mu, sg, qw, tc.tchain12_family_decode(qw, mu, sg, family, LO,
                                                      HI, cfg)


@pytest.mark.parametrize("cluster", [1, 2, 16])
@pytest.mark.parametrize("L,T", [(1024, 5), (32768, 3), (65536, 2)])
def test_tchain12_cluster_encode_matches_twin(dev, L, T, cluster):
    """Kernel 22 at forced cluster sizes: 1024 lanes (CTAs left with no
    lanes at 16), the facade's 32768 and 65536 (past one CTA's reach at
    65536, which raises); truncated remainders read as zero words."""
    cfg, mu, sg, qw, got = _tchain12_message(L, T, "gaussian", dev, L + T)
    args = (mu, sg, "gaussian", LO, HI)
    if L // 32 > cluster * 32 * 32:
        with pytest.raises(RuntimeError, match="invalid argument"):
            tc.tchain12_family_encode_cluster(*got, *args, cluster, cfg)
        return
    before = tc.LAUNCHES["encode12_family"]
    back = tc.tchain12_family_encode_cluster(*got, *args, cluster, cfg)
    assert tc.LAUNCHES["encode12_family"] == before + 1
    plain = tc.tchain12_family_encode_plain(*got, *args, cfg)
    assert torch.equal(back[0], plain[0]) and torch.equal(back[1], plain[1])
    assert torch.equal(back[0], qw) and bool((back[1] == 16).all())
    cut = got[1][: got[1].numel() // 3].clone()
    a = tc.tchain12_family_encode_cluster(got[0], cut, got[2], *args,
                                          cluster, cfg)
    a_p = tc.tchain12_family_encode_plain(got[0], cut, got[2], *args, cfg)
    assert torch.equal(a[0], a_p[0]) and torch.equal(a[1], a_p[1])


@pytest.mark.parametrize("family", fam.FAMILIES)
def test_tchain12_encode_passes_match_plain(dev, family):
    """Kernel 22's tables pass launched alone against its plain version
    (symbols pinned at both ends of the support among them), and its
    cluster step and packing pass (the C entry) on those records, whose
    quantiles and heads equal the whole encode's and the twin's; the heads
    and remainders need not come from a decode."""
    L, T = 3072, 4
    cfg = _family_cfg(L)
    rng = np.random.RandomState(40 + len(family))
    n = L * T
    means, scales, symbols = _family_data(rng, n)
    symbols[rng.rand(n) < 0.2] = LO
    symbols[rng.rand(n) < 0.2] = HI
    mu, sg = convert.params_to_torch(means, scales, n, L, dev)
    syms = torch.from_numpy(symbols).to(dev)
    heads = torch.from_numpy(rng.randint(16, 1 << 20, size=L).astype(
        np.int32)).to(dev)
    rem = convert.u32_to_torch(rng.randint(0, 1 << 32, size=2 * n,
                                           dtype=np.int64).astype(np.uint32),
                               dev)
    before = dict(tc.LAUNCHES)
    recs = tc.tchain12_tables_pass(syms, mu, sg, family, LO, HI, cfg)
    assert torch.equal(recs, tc.tchain12_tables_pass_plain(
        syms, mu, sg, family, LO, HI, cfg))
    assert tc.LAUNCHES["tables12_family"] == before["tables12_family"] + 1
    whole = tc.tchain12_family_encode(syms, rem, heads, mu, sg, family, LO,
                                      HI, cfg)
    twin = tc.tchain12_family_encode_plain(syms, rem, heads, mu, sg, family,
                                           LO, HI, cfg)
    assert torch.equal(whole[0], twin[0]) and torch.equal(whole[1], twin[1])
    h_buf = heads.clone()
    q_buf = torch.full_like(whole[0], -1)
    q16 = torch.empty(n // 2, dtype=torch.int32, device=dev)
    _build.call("ctt_tchain12_encode_step", dev, h_buf, recs, rem,
                rem.numel(), q16, q_buf, L, T)
    assert torch.equal(q_buf, whole[0]) and torch.equal(h_buf, whole[1])


def test_tchain12_encode_runs_as_a_cluster_and_caps_its_lanes(dev):
    geo = tc.geometry12(32768, dev)
    assert geo["cluster"] == 16 and geo["lanes_per_thread"] == 2
    assert geo["max_active_clusters"] >= 1 and geo["smem_bytes"] == 0
    assert tc.geometry12(coder.MAX_DECODE_LANES, dev)[
        "lanes_per_thread"] == 32
    L = coder.MAX_DECODE_LANES + 1024
    cfg = _family_cfg(L)
    syms = torch.zeros(L, dtype=torch.int32, device=dev)
    mu = torch.zeros(L, dtype=torch.float32, device=dev)
    sg = torch.ones(L, dtype=torch.float32, device=dev)
    heads = torch.full((L,), 16, dtype=torch.int32, device=dev)
    words = torch.zeros(0, dtype=torch.int32, device=dev)
    before = dict(tc.LAUNCHES)
    with pytest.raises(ValueError, match=f"num_lanes={L}"):
        tc.tchain12_family_encode(syms, words, heads, mu, sg, "gaussian", LO,
                                  HI, cfg)
    assert tc.LAUNCHES == before


# --- kernel 8: the S=32 range resolve as a lane pass and the compaction ----


def _resolve32_case(L, n, seed, dev, skewed):
    """Phase A's records and the seal for L lanes (any multiple of 32: the
    plain phase A on the CPU, moved to the card)."""
    rng = np.random.RandomState(seed)
    syms, cdf = _range_symbols(rng, 100, 12, n, skewed)
    cfg = _cfg(32, L, 12)
    rec, low_f, rng_f = range_enc.record_plain(
        torch.from_numpy(syms.astype(np.int32)), convert.cdf_to_torch(cdf),
        cfg)
    s0, carry = range_enc.seal(low_f, rng_f, cfg)
    return cfg, rec.to(dev), s0.to(dev), carry.to(dev)


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("L,n", [(32, 3000), (96, 96 * 50 - 7), (160, 100),
                                 (1184, 1184 * 20 + 3), (32800, 32800 * 3)])
def test_range_resolve32_entries_match_twin(dev, L, n, skewed):
    """Kernel 8's C entries at lane counts the wrappers do not take
    (multiples of 32, not of 128), with carry runs: the whole resolve and
    its lane pass alone against the plain passes."""
    cfg, rec, s0, carry = _resolve32_case(L, n, L + n, dev, skewed)
    T = -(-n // L)
    pts_p, stream_p = range_enc.resolve_plain(rec, s0, carry, cfg, n)
    words_p, flags_p, lpts_p = range_enc.resolve_lanes_plain(rec, s0, carry,
                                                             cfg, n)
    words = torch.empty(T * L, dtype=torch.int32, device=dev)
    flags = torch.empty(T * L // 32, dtype=torch.int32, device=dev)
    offsets = torch.empty(coder.SCAN_BLOCKS, dtype=torch.int64, device=dev)
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    pts = torch.empty(L, dtype=torch.int32, device=dev)
    _build.call("ctt_ilans2_range_resolve_w16s32", dev, rec, s0, carry, buf,
                n, end, pts, words, flags, offsets, L, T)
    assert torch.equal(pts, pts_p)
    assert torch.equal(buf[int(end.item()):], stream_p)
    words.fill_(-1)
    pts.fill_(-1)
    _build.call("ctt_ilans2_range_resolve_lanes_w16s32", dev, rec, s0, carry,
                words, flags, pts, L, T)
    f = flags_p.reshape(-1)
    assert torch.equal(flags.view(T, L // 32), coder.flag_ballots(flags_p))
    assert torch.equal(words[f], words_p.reshape(-1)[f])
    assert torch.equal(pts, lpts_p)


@pytest.mark.parametrize("L,n", [(128, 1), (128, 5000), (32768, 1 << 20),
                                 (65536, 3 * 65536 + 5)])
def test_range_resolve32_wrappers_match_twin(dev, L, n):
    cfg, rec, s0, carry = _resolve32_case(L, n, n, dev, skewed=False)
    before = dict(range_enc.LAUNCHES)
    pts, stream = range_enc.resolve(rec, s0, carry, cfg, n)
    assert range_enc.LAUNCHES["resolve"] == before["resolve"] + 1
    pts_p, stream_p = range_enc.resolve_plain(rec, s0, carry, cfg, n)
    assert torch.equal(pts, pts_p) and torch.equal(stream, stream_p)
    words, ballots, lpts = range_enc.resolve_lanes(rec, s0, carry, cfg, n)
    assert range_enc.LAUNCHES["resolve_lanes"] == before["resolve_lanes"] + 1
    assert torch.equal(lpts, pts)
    assert torch.equal(coder.compact_pass(words, ballots), stream)


# --- kernel 10: the S=64 range resolve, kernel 8's lane pass at W=32 -------


def _resolve64_case(L, n, seed, dev, kind):
    """Phase A's records and the seal at W=32/S=64/P=24 for L lanes (any
    multiple of 32: the plain phase A on the CPU, moved to the card):
    ``kind`` dirichlet, skewed (carries) or ones (words of 0xFFFFFFFF
    that take a carry)."""
    if kind == "ones":
        syms, cdf = carry_through_ones(L, n, seed)
    else:
        syms, cdf = _range_symbols(np.random.RandomState(seed), 100, 24, n,
                                   kind == "skewed")
    cfg = _cfg(64, L, 24)
    rec, low_f, rng_f = range_enc.record_plain(
        torch.from_numpy(syms.astype(np.int32)), convert.cdf_to_torch(cdf),
        cfg)
    s0, carry = range_enc.seal(low_f, rng_f, cfg)
    return cfg, rec.to(dev), s0.to(dev), carry.to(dev)


@pytest.mark.parametrize("kind,L,n", [
    *((k, L, n) for k in ("dirichlet", "skewed")
      for L, n in ((32, 3000), (96, 96 * 50 - 7), (160, 100),
                   (1184, 1184 * 20 + 3), (32800, 32800 * 3))),
    ("ones", 1184, 1184 * 20 + 3), ("ones", 32768, 32768 * 16 - 5)])
def test_range_resolve64_entries_match_twin(dev, kind, L, n):
    """Kernel 10's C entries at lane counts the wrappers do not take
    (multiples of 32, not of 128), with carries and words of 0xFFFFFFFF
    that take one: the whole resolve and its lane pass alone against the
    plain passes."""
    cfg, rec, s0, carry = _resolve64_case(L, n, L + n, dev, kind)
    T = -(-n // L)
    pts_p, stream_p = range_enc.resolve_plain(rec, s0, carry, cfg, n)
    words_p, flags_p, lpts_p = range_enc.resolve_lanes_plain(rec, s0, carry,
                                                             cfg, n)
    words = torch.empty(T * L, dtype=torch.int32, device=dev)
    flags = torch.empty(T * L // 32, dtype=torch.int32, device=dev)
    offsets = torch.empty(coder.SCAN_BLOCKS, dtype=torch.int64, device=dev)
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    pts = torch.empty(L, dtype=torch.int64, device=dev)
    _build.call("ctt_ilans2_range_resolve_w32s64", dev, rec, s0, carry, buf,
                n, end, pts, words, flags, offsets, L, T)
    assert torch.equal(pts, pts_p)
    assert torch.equal(buf[int(end.item()):], stream_p)
    words.fill_(-1)
    pts.fill_(-1)
    _build.call("ctt_ilans2_range_resolve_lanes_w32s64", dev, rec, s0, carry,
                words, flags, pts, L, T)
    f = flags_p.reshape(-1)
    assert torch.equal(flags.view(T, L // 32), coder.flag_ballots(flags_p))
    assert torch.equal(words[f], words_p.reshape(-1)[f])
    assert torch.equal(pts, lpts_p)


@pytest.mark.parametrize("kind,L,n", [("dirichlet", 128, 1),
                                      ("dirichlet", 128, 5000),
                                      ("dirichlet", 32768, 32768 * 5 - 77),
                                      ("ones", 32768, 32768 * 16 - 5),
                                      ("skewed", 65536, 3 * 65536 + 5)])
def test_range_resolve64_wrappers_match_twin(dev, kind, L, n):
    cfg, rec, s0, carry = _resolve64_case(L, n, n, dev, kind)
    before = dict(range_enc.LAUNCHES)
    pts, stream = range_enc.resolve(rec, s0, carry, cfg, n)
    assert range_enc.LAUNCHES["resolve64"] == before["resolve64"] + 1
    pts_p, stream_p = range_enc.resolve_plain(rec, s0, carry, cfg, n)
    assert torch.equal(pts, pts_p) and torch.equal(stream, stream_p)
    words, ballots, lpts = range_enc.resolve_lanes(rec, s0, carry, cfg, n)
    assert range_enc.LAUNCHES["resolve_lanes"] == before["resolve_lanes"] + 1
    assert torch.equal(lpts, pts)
    assert torch.equal(coder.compact_pass(words, ballots), stream)


@pytest.mark.parametrize("P", [16, 24])
def test_bits_back_facade_cuda_matches_cpu(dev, P):
    n = 2 * 32768
    rng = np.random.RandomState(P)
    cdf = _cdf(100, P, seed=P)[0]
    q = rng.randint(0, 1 << P, size=n).astype(
        np.uint16 if P == 16 else np.uint32)
    decode = ctt.bits_back_decode if P == 16 else ctt.bits_back_decode24
    encode = ctt.bits_back_encode if P == 16 else ctt.bits_back_encode24
    got = decode(q, cdf, device="cuda")
    ref = decode(q, cdf, device="cpu")
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    q2, h2 = encode(*got, cdf, device="cuda")
    assert q2.dtype == q.dtype
    np.testing.assert_array_equal(q2, q)
    assert np.all(h2 == (1 if P == 16 else 256))


def test_chain_decode_on_the_card(dev):
    rng = np.random.RandomState(3)
    n = 100_003
    data = rng.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    data[-1] |= 0x8000_0000
    cdf = _cdf(100, 24, seed=5)[0]
    got = ctt.decode_chain_iid(data, n, cdf, device="cuda")
    np.testing.assert_array_equal(got, ch.chain_decode_iid(data, n, cdf, np))
    probs = rng.dirichlet(np.ones(16), size=20_000)
    rows = np.stack([fast_quantized_cdf(p, 24) for p in probs])
    got = ctt.decode_chain_rows(data, rows, device="cuda")
    np.testing.assert_array_equal(got, ch.chain_decode_rows(data, rows, np))
    with pytest.raises(ch.OutOfCompressedData):
        ctt.decode_chain_iid(data[:1000], n, cdf, device="cuda")


# ---------------------------------------------------------------------------
# reference-exact families (W=32, S=64, P=24)
# ---------------------------------------------------------------------------


def _exact_data(n, seed, spread=20.0):
    rng = np.random.RandomState(seed)
    means = rng.randn(n) * spread
    scales = np.exp(rng.normal(0.4, 0.6, n))
    syms = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
                   ).astype(np.int64)
    return means, scales, syms


def _exact_cfg(L, P=24):
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=P)


@pytest.mark.parametrize("L,n,seeded", [(128, 1, False), (256, 3000, False),
                                        (256, 3000, True),
                                        (32768, 3 * 32768 - 99, False),
                                        (32768, 3 * 32768 - 99, True)])
def test_exact_encode_kernel_matches_twin(dev, L, n, seeded):
    cfg = _exact_cfg(L)
    means, scales, syms = _exact_data(n, seed=n + L)
    cums, probs = ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, 24)
    rng = np.random.RandomState(L)
    seeds = (rng.randint(1 << 32, (1 << 63) - 1, L, dtype=np.int64).astype(
        np.uint64) if seeded else None)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L, dev)
    s_t = None if seeds is None else convert.u64_to_torch(seeds, dev)
    before = ef.LAUNCHES["encode64"]
    st, w = ef.encode_tables(c_t, p_t, cfg, s_t, n)
    assert ef.LAUNCHES["encode64"] == before + 1
    st_p, w_p = ef.encode_tables_plain(c_t, p_t, cfg, s_t, n)
    assert torch.equal(st, st_p) and torch.equal(w, w_p)
    st_h, w_h = il2.encode_shared(cums, probs, cfg, seeds=seeds)
    np.testing.assert_array_equal(convert.u64_from_torch(st), st_h)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_h)


@pytest.mark.parametrize("L,n,seeded,P", [(96, 96 * 40 - 7, True, 24),
                                          (32768, 32768 * 4 - 99, False, 24),
                                          (32768, 32768 * 4 - 99, True, 24),
                                          (4096, 4096 * 6 - 5, True, 17)])
def test_exact_encode64_passes_match_plain_passes(dev, L, n, seeded, P):
    """Kernel 17's C entries (L a multiple of 32, not of 128, too; P=17,
    where quotients reach 2^47): both passes on preallocated scratch
    against the one-loop twin, and pass A alone (final states, ballots and
    the words it flags) against ``encode_lanes_plain``."""
    cfg = _exact_cfg(L, P)
    means, scales, syms = _exact_data(n, seed=n + L)
    cums, probs = ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, P)
    rng = np.random.RandomState(L)
    seeds = (rng.randint(1 << 32, (1 << 63) - 1, L, dtype=np.int64).astype(
        np.uint64) if seeded else np.full(L, 1 << 32, dtype=np.uint64))
    c_t, p_t = convert.ecp_to_torch(cums, probs, L, dev)
    s_t = convert.u64_to_torch(seeds, dev)
    T = -(-n // L)
    st_p, w_p = ef.encode_tables_plain(c_t, p_t, cfg, s_t, n)
    words_p, flags_p, lst_p = ef.encode_lanes_plain(c_t, p_t, cfg, s_t, n)
    words = torch.empty(T * L, dtype=torch.int32, device=dev)
    flags = torch.empty(T * L // 32, dtype=torch.int32, device=dev)
    offsets = torch.empty(coder.SCAN_BLOCKS, dtype=torch.int64, device=dev)
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    states = s_t.clone()
    _build.call("ctt_exact_encode64", dev, states, c_t, p_t, n, buf, n, end,
                words, flags, offsets, L, P)
    assert torch.equal(states, st_p)
    assert torch.equal(buf[int(end.item()):], w_p)
    words.fill_(-1)
    states = s_t.clone()
    _build.call("ctt_exact_encode_lanes64", dev, states, c_t, p_t, n, words,
                flags, L, P)
    f = flags_p.reshape(-1)
    assert torch.equal(states, lst_p)
    assert torch.equal(flags.view(T, L // 32), coder.flag_ballots(flags_p))
    assert torch.equal(words[f], words_p.reshape(-1)[f])


def _host_tables(means, scales, family, cfg, n, dev):
    L = cfg.num_lanes
    T = -(-n // L)
    pm, ps = ef._pad_params(means, scales, T * L, family, 100)
    nc = ef.exact_ncore(pm, ps, family, -100, 100, cfg.precision)
    tabs4, _ = ef.packed_tables_device(pm, ps, family, -100, 100,
                                       cfg.precision, int(nc.max()), T,
                                       L // 128)
    return convert.exact_tables_to_torch(tabs4, dev)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
@pytest.mark.parametrize("L,n", [(128, 700), (1024, 5 * 1024 - 3)])
def test_exact_decode_kernel_matches_twin(dev, family, L, n, monkeypatch):
    cfg = _exact_cfg(L)
    means, scales, syms = _exact_data(n, seed=L + n)
    states, stream = ef.encode_family_exact(syms, means, scales, family,
                                            -100, 100, cfg, dev)
    tabs = _host_tables(means, scales, family, cfg, n, dev)
    before = ef.LAUNCHES["decode64"]
    out, fin = ef.decode_tables(states, stream, tabs, cfg, -100, 100, n,
                                return_final_states=True)
    assert ef.LAUNCHES["decode64"] == before + 1
    out_p, fin_p, _ = ef.decode_tables_plain(states, stream, tabs, cfg, -100,
                                             100, n)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    np.testing.assert_array_equal(out.cpu().numpy(), syms)
    assert bool((fin == 1 << 32).all())
    # the other search mode of the kernel decodes alike
    for planes in (0, 1 << 30):
        monkeypatch.setattr(ef, "BISECT_FROM_PLANES", planes)
        got = ef.decode_tables(states, stream, tabs, cfg, -100, 100, n)
        assert torch.equal(got, out)
    # a truncated stream decodes as the numpy oracle does (zero words)
    cut = stream[: stream.numel() // 2]
    got = ef.decode_tables(states, cut, tabs, cfg, -100, 100, n)
    host = ef.decode_family_exact_host(
        convert.u64_from_torch(states), convert.u32_from_torch(cut), means,
        scales, family, -100, 100, cfg, n)
    np.testing.assert_array_equal(got.cpu().numpy(), host)


def test_exact_decode_runs_as_a_cluster(dev):
    """Kernels 15 and 16 at the bench lane counts: 16 CTAs."""
    for L in (32768, 65536):
        for seg in (False, True):
            geo = ef.geometry(L, dev, seg=seg)
            assert geo["cluster"] == 16 and geo["max_active_clusters"] >= 1
            assert geo["lanes_per_thread"] * geo["threads_per_cta"] // 32 \
                >= geo["groups_per_cta"]


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
@pytest.mark.parametrize("L,n", [(32000, 2 * 32000 + 7), (32768, 32768 - 5),
                                 (65536, 65536 * 2 + 999)])
def test_exact_cluster_decode_matches_twin(dev, family, L, n, monkeypatch):
    """Kernel 15 on its cluster at the bench lane counts and at L = 32000
    (groups split unevenly, the last CTA's last warps past L), over tables
    built on the card; the binary search and the scan alike, a partial
    last step and n < L."""
    cfg = _exact_cfg(L)
    means, scales, syms = _exact_data(n, seed=L + n)
    states, stream = ef.encode_family_exact(syms, means, scales, family,
                                            -100, 100, cfg, dev)
    T = -(-n // L)
    pm, ps = ef._pad_params(means, scales, T * L, family, 100)
    nc = ef.exact_ncore(pm, ps, family, -100, 100, 24)
    (tabs, _), = et.packed_tables_on_device_batch(
        [(pm, ps, min(255, int(nc.max())), T)], family, -100, 100, 24, L,
        dev)
    out_p, fin_p, _ = ef.decode_tables_plain(states, stream, tabs, cfg, -100,
                                             100, n)
    np.testing.assert_array_equal(out_p.cpu().numpy(), syms)
    for planes in (0, 1 << 30):
        monkeypatch.setattr(ef, "BISECT_FROM_PLANES", planes)
        before = ef.LAUNCHES["decode64"]
        out, fin = ef.decode_tables(states, stream, tabs, cfg, -100, 100, n,
                                    return_final_states=True)
        assert ef.LAUNCHES["decode64"] == before + 1
        assert torch.equal(out, out_p) and torch.equal(fin, fin_p)


def test_exact_decode_past_the_cluster_reach_raises(dev):
    L = coder.MAX_DECODE_LANES + 128
    cfg = _exact_cfg(L)
    states = torch.full((L,), 1 << 32, dtype=torch.int64, device=dev)
    stream = torch.zeros(4, dtype=torch.int32, device=dev)
    tabs = torch.zeros((1, 4, L), dtype=torch.int32, device=dev)
    before = dict(ef.LAUNCHES)
    with pytest.raises(ValueError, match=f"at most {L - 128} lanes"):
        ef.decode_tables(states, stream, tabs, cfg, -100, 100, 1000)
    assert ef.LAUNCHES == before


@pytest.mark.parametrize("L,cluster", [(256, 0), (2176, 1), (2176, 4),
                                       (2176, 16)])
def test_exact_segment_kernel_chains_offsets(dev, monkeypatch, L, cluster):
    """Three kernel-16 launches over one grouped stream: symbols, states
    and the word offset equal the twin's after every segment, with the
    search each width picks, the scan and the binary search alike; on the
    cluster it picks from L and on 1, 4 and 16 CTAs (L = 2176: 68 groups,
    uneven over 4 CTAs, two CTAs of 16 without lanes)."""
    n = 9 * L - 31
    cfg = _exact_cfg(L)
    means, scales, syms = _exact_data(n, seed=7)
    means[:40] *= 0.01
    scales[:300] *= 4.0
    perm, segs = ef.group_plan(means, scales, "gaussian", -100, 100, 24, L,
                               n, max_segments=3)
    assert len(segs) == 3
    states, stream = ef.encode_family_exact_grouped(
        syms, means, scales, "gaussian", -100, 100, cfg, dev, max_segments=3)
    T = -(-n // L)
    pm, ps = ef._pad_params(means[perm], scales[perm], T * L, "gaussian", 100)
    tables = []
    for t0, ns, cm in segs:
        tabs4, _ = ef.packed_tables_device(
            pm[t0 * L:(t0 + ns) * L], ps[t0 * L:(t0 + ns) * L], "gaussian",
            -100, 100, 24, cm, ns, L // 128)
        tables.append((convert.exact_tables_to_torch(tabs4, dev),
                       min(ns * L, n - t0 * L)))
    for planes in (ef.BISECT_FROM_PLANES, 0, 1 << 30):
        monkeypatch.setattr(ef, "BISECT_FROM_PLANES", planes)
        base = torch.zeros(1, dtype=torch.int64, device=dev)
        st = st_p = states
        base_p = base
        outs = []
        for tabs, k in tables:
            before = ef.LAUNCHES["decode64_seg"]
            if cluster:
                out, st, base = ef.decode_tables_seg_cluster(
                    st, stream, tabs, base, cfg, -100, 100, k, cluster)
            else:
                out, st, base = ef.decode_tables_seg(st, stream, tabs, base,
                                                     cfg, -100, 100, k)
            assert ef.LAUNCHES["decode64_seg"] == before + 1
            out_p, st_p, base_p = ef.decode_tables_plain(
                st_p, stream, tabs, cfg, -100, 100, k, base_p)
            assert torch.equal(out, out_p) and torch.equal(st, st_p)
            assert torch.equal(base, base_p)
            outs.append(out.cpu().numpy())
        assert int(base) == stream.numel()
        np.testing.assert_array_equal(np.concatenate(outs), syms[perm])


def test_exact_segment_decode_past_the_cluster_reach_raises(dev):
    L = coder.MAX_DECODE_LANES + 128
    cfg = _exact_cfg(L)
    states = torch.full((L,), 1 << 32, dtype=torch.int64, device=dev)
    stream = torch.zeros(4, dtype=torch.int32, device=dev)
    tabs = torch.zeros((1, 4, L), dtype=torch.int32, device=dev)
    base = torch.zeros(1, dtype=torch.int64, device=dev)
    before = dict(ef.LAUNCHES)
    with pytest.raises(ValueError, match=f"at most {L - 128} lanes"):
        ef.decode_tables_seg(states, stream, tabs, base, cfg, -100, 100,
                             1000)
    assert ef.LAUNCHES == before


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_eval_window_kernel_matches_oracle(dev, family):
    """Every entry the kernel calls unambiguous equals the host oracle; the
    twin on the card agrees on every entry both call unambiguous."""
    rng = np.random.RandomState(len(family))
    n, W = 4096, 48 if family != "cauchy" else 218
    means = rng.uniform(-110, 110, n)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(12.0), n))
    CL = ef._EST_C[family][0]
    ws = (np.full(n, -99, np.int64) if np.isinf(CL) else np.clip(
        np.ceil(means - CL * scales) - 3.0, -99, 100).astype(np.int64))
    m_t, s_t = convert.params64_to_torch(means, scales, dev)
    ws_t = torch.from_numpy(ws.astype(np.int32)).to(dev)
    before = ef.LAUNCHES["eval_window"]
    tv, amb = et.eval_window(m_t, s_t, ws_t, family, -100, 100, 24, W)
    assert ef.LAUNCHES["eval_window"] == before + 1
    tv_p, amb_p = et.eval_window_plain(m_t, s_t, ws_t, family, -100, 100, 24,
                                       W)
    both = ~amb & ~amb_p
    assert torch.equal(tv[both], tv_p[both])
    tv, amb = tv.cpu().numpy().reshape(-1), amb.cpu().numpy().reshape(-1)
    svals = (ws[:, None] + np.arange(W)[None, :]).reshape(-1)
    sym_i = np.repeat(np.arange(n), W)
    live = svals <= 100
    exact = np.full(n * W, (1 << 24) - 1 - 200, np.int64)
    exact[live] = et.exact_tv_at(family, -100, 100, 24, means, scales,
                                 sym_i[live], svals[live])
    assert not np.any(~amb & (tv != exact))
    assert amb.mean() < 0.2


def _eval_rows(family, n, W, seed):
    """Window rows of kernel 18: the builder's windows of random models,
    a block of rows far past t* (a whole tile saturated) and rows past the
    support."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-110, 110, n)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(12.0), n))
    CL = ef._EST_C[family][0]
    ws = (np.full(n, -99, np.int64) if np.isinf(CL) else np.clip(
        np.ceil(means - CL * scales) - 3.0, -99, 100).astype(np.int64))
    sat = slice(32, min(n, 96))  # blocks of 32 rows: one all saturated
    means[sat], scales[sat], ws[sat] = -100.0, 1e-14, 90
    ws[n // 2:n // 2 + 5] = 101
    return means, scales, ws


@pytest.mark.parametrize("W", [1, 31, 32, 33, 271])
@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_eval_window_kernel_equals_twin_everywhere(dev, family, W):
    """Kernel 18 against ``eval_window_plain`` on every entry and every
    flag, through its C entry (outputs pre-filled with junk) and its
    wrapper: n not a multiple of a block's 32 rows, a block of rows all
    saturated (live end 0, ``live_ends_plain``), rows past the support."""
    n = 1000 + W
    means, scales, ws = _eval_rows(family, n, W, seed=W + len(family))
    m_t, s_t = convert.params64_to_torch(means, scales, dev)
    ws_t = torch.from_numpy(ws.astype(np.int32)).to(dev)
    t_star, eps, has_star = et._band(family)
    tv = torch.full((n, W), -7, dtype=torch.int32, device=dev)
    amb = torch.ones((n, W), dtype=torch.bool, device=dev)
    _build.call("ctt_exact_eval_window", dev, m_t, s_t, ws_t, n, W,
                ef.DEVICE_FAMILIES.index(family), -100, 100, 24, t_star, eps,
                int(has_star), tv, amb)
    tv_p, amb_p = et.eval_window_plain(m_t, s_t, ws_t, family, -100, 100, 24,
                                       W)
    assert torch.equal(tv, tv_p) and torch.equal(amb, amb_p)
    ends = et.live_ends_plain(m_t, s_t, ws_t, family, 100, W)
    assert bool((ends[32:64] == 0).all())
    before = ef.LAUNCHES["eval_window"]
    tv_w, amb_w = et.eval_window(m_t, s_t, ws_t, family, -100, 100, 24, W)
    assert ef.LAUNCHES["eval_window"] == before + 1
    assert torch.equal(tv_w, tv_p) and torch.equal(amb_w, amb_p)


def test_exact_canaries_on_the_card(dev):
    et.eval_window_canary(dev)
    et.builder_canary(dev)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_device_tables_equal_host_tables(dev, family):
    rng = np.random.RandomState(77)
    L, nsteps = 256, 3
    n = nsteps * L
    means = rng.randn(n) * 30
    scales = np.exp(rng.normal(0.3, 0.9, size=n))
    means[:8] = [-108.3, 108.3, -99.9999, 99.9999, 0.0, -50.0, 1e-6, 3e4]
    nc = ef.exact_ncore(means, scales, family, -100, 100, 24)
    cmax = min(max(int(nc.max()), 1), 255)
    host, ch_ = ef.packed_tables_device(means, scales, family, -100, 100, 24,
                                        cmax, nsteps, L // 128)
    (tabs, cd), = et.packed_tables_on_device_batch(
        [(means, scales, cmax, nsteps)], family, -100, 100, 24, L, dev)
    assert tabs.device.type == "cuda" and cd == ch_
    np.testing.assert_array_equal(convert.exact_tables_from_torch(tabs), host)


def test_exact_facade_on_the_card(dev):
    n = 5 * 4096 + 17
    means, scales, syms = _exact_data(n, seed=12)
    st, w = ctt.encode_family_exact(syms, means, scales, "gaussian", -100,
                                    100, grouped=True)
    st_c, w_c = ctt.encode_family_exact(syms, means, scales, "gaussian",
                                        -100, 100, grouped=True, device="cpu")
    np.testing.assert_array_equal(st, st_c)
    np.testing.assert_array_equal(w, w_c)
    out = ctt.decode_family_exact(st, w, means, scales, "gaussian", -100, 100,
                                  n, grouped=True)
    np.testing.assert_array_equal(out, syms)
    data = ctt.encode_family_exact_container(syms, means, scales, "laplace",
                                             -100, 100)
    np.testing.assert_array_equal(
        data, ctt.encode_family_exact_container(
            syms, means, scales, "laplace", -100, 100, device="cpu"))
    np.testing.assert_array_equal(
        ctt.decode_family_exact_container(data, means, scales, "laplace",
                                          -100, 100), syms)


@pytest.mark.parametrize("family", ["gaussian", "cauchy"])
def test_exact_facade_ungrouped_on_the_card(dev, family):
    """The facade's ungrouped pair at the DEFAULT preset: kernel 17, then
    kernel 15 over tables sized by ``cmax=None`` (built on the card by
    default); equal to the ``device="cpu"`` result (host-built tables) and
    to the symbols."""
    n, cfg = 3 * 1024 - 5, _exact_cfg(1024)
    means, scales, syms = _exact_data(n, seed=21)
    st, w = ctt.encode_family_exact(syms, means, scales, family, -100, 100,
                                    cfg=cfg)
    st_c, w_c = ctt.encode_family_exact(syms, means, scales, family, -100,
                                        100, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(st, st_c)
    np.testing.assert_array_equal(w, w_c)
    before = ef.LAUNCHES["decode64"]
    out = ctt.decode_family_exact(st, w, means, scales, family, -100, 100, n,
                                  cfg=cfg)
    assert ef.LAUNCHES["decode64"] == before + 1
    out_c = ctt.decode_family_exact(st, w, means, scales, family, -100, 100,
                                    n, cfg=cfg, device="cpu")
    assert out.dtype == out_c.dtype
    np.testing.assert_array_equal(out, out_c)
    np.testing.assert_array_equal(out, syms)


def test_exact_ungrouped_decode_builds_tables_on_the_card(dev):
    """The ungrouped S=64 decode picks the on-card builder by default (as
    the grouped decode does), and decodes as with the host builder."""
    n, cfg = 4 * 1024 - 7, _exact_cfg(1024)
    means, scales, syms = _exact_data(n, seed=23)
    st, w = ef.encode_family_exact(syms, means, scales, "laplace", -100, 100,
                                   cfg, dev)
    before = ef.LAUNCHES["eval_window"]
    out = ef.decode_family_exact(st, w, means, scales, "laplace", -100, 100,
                                 cfg, n)
    assert ef.LAUNCHES["eval_window"] > before
    host = ef.decode_family_exact(st, w, means, scales, "laplace", -100, 100,
                                  cfg, n, device_tables=False)
    assert ef.LAUNCHES["eval_window"] > before
    assert torch.equal(out, host)
    np.testing.assert_array_equal(out.cpu().numpy(), syms)


# ---------------------------------------------------------------------------
# reference-exact families at W=16, S=32 (kernels 13 and 14)
# ---------------------------------------------------------------------------


def _exact32_cfg(L, P=12):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)


@pytest.mark.parametrize("P", [12, 16])
@pytest.mark.parametrize("L,n,seeded", [(128, 1, False), (256, 3000, False),
                                        (256, 3000, True),
                                        (32768, 3 * 32768 - 99, True)])
def test_exact32_encode_kernel_matches_twin(dev, P, L, n, seeded):
    cfg = _exact32_cfg(L, P)
    means, scales, syms = _exact_data(n, seed=n + L + P)
    cums, probs = ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, P)
    rng = np.random.RandomState(L)
    seeds = (rng.randint(1 << 16, 1 << 32, L, dtype=np.int64).astype(
        np.uint32) if seeded else None)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L, dev)
    s_t = None if seeds is None else convert.u32_to_torch(seeds, dev)
    before = ef.LAUNCHES["encode32"]
    st, w = ef.encode_tables(c_t, p_t, cfg, s_t, n)
    assert ef.LAUNCHES["encode32"] == before + 1
    st_p, w_p = ef.encode_tables_plain(c_t, p_t, cfg, s_t, n)
    assert torch.equal(st, st_p) and torch.equal(w, w_p)
    st_h, w_h = il2.encode_shared(cums, probs, cfg, seeds=seeds)
    np.testing.assert_array_equal(convert.u32_from_torch(st), st_h)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_h)


def _planes32(L, n, P, seed):
    """(cum, prob) planes at S=32: exact_ecp's at P = 12 and 16, random
    ones (every prob 1 .. 2^P) at P = 1."""
    rng = np.random.RandomState(seed)
    if P == 1:
        probs = rng.randint(1, 3, size=n)
        cums = (rng.random_sample(n) * (3 - probs)).astype(np.int64)
        return cums.astype(np.uint32), probs.astype(np.uint32)
    means, scales, syms = _exact_data(n, seed=seed)
    return ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, P)


@pytest.mark.parametrize("P", [1, 12, 16])
@pytest.mark.parametrize("L", [32, 1024, 32768, coder.MAX_DECODE_LANES])
def test_exact32_encode_passes_match_plain_passes(dev, L, P):
    """Kernel 14's C entries at any L a multiple of 32, seeded, with a
    partial last step: both passes on preallocated scratch against the
    one-loop twin and the numpy oracle, and pass A alone (final states,
    ballots and the words it flags) against ``encode_lanes_plain``."""
    T = 3 if L < coder.MAX_DECODE_LANES else 2
    n = T * L - 7
    cfg = _exact32_cfg(L, P)
    cums, probs = _planes32(L, n, P, seed=L + P)
    rng = np.random.RandomState(L)
    seeds = rng.randint(1 << 16, 1 << 32, L, dtype=np.int64).astype(np.uint32)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L, dev)
    s_t = convert.u32_to_torch(seeds, dev)
    st_p, w_p = ef.encode_tables_plain(c_t, p_t, cfg, s_t, n)
    words_p, flags_p, lst_p = ef.encode_lanes_plain(c_t, p_t, cfg, s_t, n)
    words, flags, offsets = coder.compaction_scratch(T, L, dev)
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    states = s_t.clone()
    _build.call("ctt_exact_encode32", dev, states, c_t, p_t, n, buf, n, end,
                words, flags, offsets, L, P)
    assert torch.equal(states, st_p)
    assert torch.equal(buf[int(end.item()):], w_p)
    st_h, w_h = il2.encode_shared(cums, probs, cfg, seeds=seeds)
    np.testing.assert_array_equal(convert.u32_from_torch(states), st_h)
    np.testing.assert_array_equal(
        convert.u32_from_torch(buf[int(end.item()):]), w_h)
    words.fill_(-1)
    states = s_t.clone()
    _build.call("ctt_exact_encode_lanes32", dev, states, c_t, p_t, n, words,
                flags, L, P)
    f = flags_p.reshape(-1)
    assert torch.equal(states, lst_p)
    assert torch.equal(flags.view(T, L // 32), coder.flag_ballots(flags_p))
    assert torch.equal(words[f], words_p.reshape(-1)[f])


def _exact32_case(family, n, seed):
    """(means, scales, symbols, lo, hi, P): the continuous families and
    binomial at P=12, and a flat P=16 gaussian whose run of top symbols
    steers quantiles into the top interval."""
    if family == "binomial":
        rng = np.random.RandomState(seed)
        ps = rng.uniform(0.02, 0.98, n)
        return np.full(n, 60.0), ps, rng.binomial(60, ps), 0, 60, 12
    if family == "flat16":
        rng = np.random.RandomState(seed)
        syms = rng.randint(-50, 51, n)
        syms[n // 5:2 * n // 5] = 50
        return np.zeros(n), np.full(n, 500.0), syms, -50, 50, 16
    return (*_exact_data(n, seed), -100, 100, 12)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy",
                                    "binomial", "flat16"])
@pytest.mark.parametrize("L,n", [(128, 700), (1024, 5 * 1024 - 3)])
def test_exact32_decode_kernel_matches_twin(dev, family, L, n, monkeypatch):
    means, scales, syms, lo, hi, P = _exact32_case(family, n, seed=L + n)
    fam_name = "gaussian" if family == "flat16" else family
    cfg = _exact32_cfg(L, P)
    states, stream = ef.encode_family_exact(syms, means, scales, fam_name, lo,
                                            hi, cfg, dev)
    T = -(-n // L)
    pm, ps = ef._pad_params(means, scales, T * L, fam_name, hi)
    tabs4, _ = ef.narrow_tables(pm, ps, fam_name, lo, hi, P, None, T,
                                L // 128)
    tabs = convert.exact_tables_to_torch(tabs4, dev)
    before = ef.LAUNCHES["decode32"]
    out, fin = ef.decode_tables(states, stream, tabs, cfg, lo, hi, n,
                                return_final_states=True)
    assert ef.LAUNCHES["decode32"] == before + 1
    out_p, fin_p, _ = ef.decode_tables_plain(states, stream, tabs, cfg, lo,
                                             hi, n)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    np.testing.assert_array_equal(out.cpu().numpy(), syms)
    assert bool((fin == 1 << 16).all())
    # the scan and the binary search both, whatever the threshold says
    for planes in (0, 1 << 30):
        monkeypatch.setattr(ef, "BISECT_FROM_PLANES_NARROW", planes)
        got = ef.decode_tables(states, stream, tabs, cfg, lo, hi, n)
        assert torch.equal(got, out)
    # a truncated stream decodes as the numpy oracle does (zero words)
    cut = stream[: stream.numel() // 2]
    got = ef.decode_tables(states, cut, tabs, cfg, lo, hi, n)
    host = ef.decode_family_exact_host(
        convert.u32_from_torch(states), convert.u32_from_torch(cut), means,
        scales, fam_name, lo, hi, cfg, n)
    np.testing.assert_array_equal(got.cpu().numpy(), host)


def _tiled_narrow_message(L, n, dev, seed):
    """A message of n symbols at L lanes whose models repeat 1024 base
    models (symbol i has model i mod 1024), so that a large L costs no
    host table build: the host builder's narrow tables and ``exact_ecp``'s
    planes of the base models, tiled, and the numpy host coder's states and
    stream.  Returns (cfg, symbols, states, stream, tabs int32 [T, CP1, L]
    on the card)."""
    B = 1024
    means, scales, base = _exact_data(B, seed)
    tabs4, _ = ef.narrow_tables(means, scales, "gaussian", -100, 100, 12,
                                None, 1, B // 128)
    cols = convert.exact_tables_to_torch(tabs4)[0]
    cums, probs = ef.exact_ecp(base, means, scales, "gaussian", -100, 100, 12)
    T = -(-n // L)
    idx = np.arange(T * L) % B
    tabs = cols[:, torch.from_numpy(idx)].reshape(-1, T, L).permute(1, 0, 2)
    cfg = _exact32_cfg(L)
    st, w = il2.encode_shared(cums[idx[:n]], probs[idx[:n]], cfg)
    return (cfg, base[idx[:n]], convert.u32_to_torch(st, dev),
            convert.u32_to_torch(w, dev), tabs.contiguous().to(dev))


@pytest.mark.parametrize("bisect", [False, True])
@pytest.mark.parametrize("L", [32, 1024, 32768, coder.MAX_DECODE_LANES])
def test_exact32_cluster_decode_matches_twin(dev, L, bisect):
    """Kernel 13 on the cluster step, the scan and the binary search
    forced, at the fewest lanes, the exact suite's L and the cluster's
    reach: against the twin decoding the same way, the symbols and the
    final states; through ``decode_tables`` too where L is a multiple of
    128."""
    n = 2 * L + 7 if L < coder.MAX_DECODE_LANES else L + 99
    cfg, syms, st, w, tabs = _tiled_narrow_message(L, n, dev, seed=L)
    before = ef.LAUNCHES["decode32"]
    out, fin = ef.decode_tables32_cluster(st, w, tabs, cfg, -100, 100, n,
                                          bisect=bisect)
    assert ef.LAUNCHES["decode32"] == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), syms)
    assert bool((fin == 1 << 16).all())
    out_p, fin_p, _ = ef.decode_tables_plain(st, w, tabs, cfg, -100, 100, n,
                                             bisect=bisect)
    assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
    if L % 128 == 0:
        got, fin_w = ef.decode_tables(st, w, tabs, cfg, -100, 100, n,
                                      return_final_states=True)
        assert torch.equal(got, out) and torch.equal(fin_w, fin)


@pytest.mark.parametrize("bisect", [False, True])
@pytest.mark.parametrize("L,cluster", [(32, 1), (32, 16), (96, 5),
                                       (4096, 3), (4096, 16), (32768, 1),
                                       (32768, 8)])
def test_exact32_cluster_partitions_match_twin(dev, L, cluster, bisect):
    """Forced cluster sizes: groups that do not divide evenly over the CTAs
    (4096/3), CTAs left with no lanes (32/16, 96/5), one CTA holding 32
    lanes a thread (32768/1); partial last steps."""
    for n in (1, L - 5, 2 * L + 7):
        cfg, syms, st, w, tabs = _tiled_narrow_message(L, n, dev,
                                                       seed=L + cluster)
        out, fin = ef.decode_tables32_cluster(st, w, tabs, cfg, -100, 100, n,
                                              cluster, bisect)
        out_p, fin_p, _ = ef.decode_tables_plain(st, w, tabs, cfg, -100, 100,
                                                 n, bisect=bisect)
        assert torch.equal(out, out_p) and torch.equal(fin, fin_p)
        np.testing.assert_array_equal(out.cpu().numpy(), syms)


def test_exact32_decode_runs_as_a_cluster(dev):
    """Kernel 13 at L = 32768: 16 CTAs, 2 lanes a thread; at the reach,
    16 CTAs of 32 lanes a thread."""
    geo = ef.geometry(32768, dev, narrow=True)
    assert geo["cluster"] == 16 and geo["max_active_clusters"] >= 1
    assert geo["lanes_per_thread"] == 2
    geo = ef.geometry(coder.MAX_DECODE_LANES, dev, narrow=True)
    assert geo["cluster"] == 16 and geo["lanes_per_thread"] == 32


def test_exact32_decode_lanes_past_the_cluster_reach(dev):
    """128 lanes past coder.MAX_DECODE_LANES raise ValueError with the limit
    named and launch nothing; the CPU twin takes them."""
    L = coder.MAX_DECODE_LANES + 128
    cfg = _exact32_cfg(L)
    states = torch.full((L,), 1 << 16, dtype=torch.int32, device=dev)
    stream = torch.zeros(8, dtype=torch.int32, device=dev)
    tabs = torch.zeros((1, 2, L), dtype=torch.int32, device=dev)
    before = dict(ef.LAUNCHES)
    with pytest.raises(ValueError, match=f"at most {L - 128} lanes"):
        ef.decode_tables(states, stream, tabs, cfg, -100, 100, 10)
    with pytest.raises(ValueError, match=f"at most {L - 128} lanes"):
        ef.decode_tables32_cluster(states, stream, tabs, cfg, -100, 100, 10,
                                   16)
    assert ef.LAUNCHES == before
    out = ef.decode_tables(states.cpu(), stream.cpu(), tabs.cpu(), cfg, -100,
                           100, 10)
    assert out.shape == (10,)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_exact32_facade_default_on_the_card(dev, family):
    """The facade's default call (no cfg: W=16, S=32, P=12): kernel 14,
    then kernel 13; equal to the ``device="cpu"`` result and the
    symbols."""
    n = 5 * 4096 + 17
    means, scales, syms = _exact_data(n, seed=31)
    before = dict(ef.LAUNCHES)
    st, w = ctt.encode_family_exact(syms, means, scales, family, -100, 100)
    st_c, w_c = ctt.encode_family_exact(syms, means, scales, family, -100,
                                        100, device="cpu")
    assert st.dtype == np.uint32
    np.testing.assert_array_equal(st, st_c)
    np.testing.assert_array_equal(w, w_c)
    out = ctt.decode_family_exact(st, w, means, scales, family, -100, 100, n)
    assert ef.LAUNCHES["encode32"] == before["encode32"] + 1
    assert ef.LAUNCHES["decode32"] == before["decode32"] + 1
    out_c = ctt.decode_family_exact(st, w, means, scales, family, -100, 100,
                                    n, device="cpu")
    assert out.dtype == out_c.dtype == np.int32
    np.testing.assert_array_equal(out, out_c)
    np.testing.assert_array_equal(out, syms)


# --- block-sharded containers and block legs (parallel/)


def _sharded_data(P, n, seed):
    cdf_np, probs = _cdf(100, P, seed=P)
    rng = np.random.RandomState(seed)
    return cdf_np, rng.choice(100, size=n, p=probs).astype(np.int64)


@pytest.mark.parametrize("P", [12, 24])
@pytest.mark.parametrize("coder_name,compact", [("rans", False),
                                                ("rans", True),
                                                ("range", False)])
def test_sharded_containers_on_the_card_equal_cpu(dev, P, coder_name,
                                                  compact):
    """Eight blocks, the last one short; at this size the compact container
    has a pooled tail.  The card's bytes are the twins' and the numpy host
    coders'; each block launched its kernels once."""
    from constriction_tpu_torch import parallel

    W = 32 if P == 24 else 16
    cfg = LaneConfig(num_lanes=256, word_bits=W, state_bits=2 * W,
                     precision=P)
    cdf_np, syms = _sharded_data(P, 29_001, seed=P + compact)
    counters = (coder64.LAUNCHES if P == 24 else coder.LAUNCHES,
                range_enc.LAUNCHES)
    before = [dict(c) for c in counters]
    cont = parallel.encode(syms, cdf_np, cfg=cfg, num_blocks=8, device=dev,
                           coder=coder_name, compact=compact)
    if coder_name == "rans":
        key, c = "encode", 0
    else:
        key, c = "record64" if P == 24 else "record", 1
    assert counters[c][key] - before[c][key] >= 8
    kw = {"cfg": cfg, "num_blocks": 8, "coder": coder_name,
          "compact": compact}
    np.testing.assert_array_equal(
        cont, parallel.encode(syms, cdf_np, device="cpu", **kw))
    np.testing.assert_array_equal(
        cont, parallel.encode_host(syms, cdf_np, cfg, 8, coder_name, compact))
    if compact:
        assert parallel.unpack_sharded_v2(cont)[5] > 0
    np.testing.assert_array_equal(parallel.decode(cont, cdf_np, device=dev),
                                  syms)
    # blocks split over the card and the CPU give the same bytes
    np.testing.assert_array_equal(
        cont, parallel.encode(syms, cdf_np, device=[dev, "cpu"], **kw))
    np.testing.assert_array_equal(
        parallel.decode(cont, cdf_np, device=["cpu", dev]), syms)


@pytest.mark.parametrize("P", [12, 24])
@pytest.mark.parametrize("coder_name", ["rans", "range"])
def test_sharded_block_seek_on_the_card(dev, P, coder_name):
    from constriction_tpu_torch import parallel

    cdf_np, syms = _sharded_data(P, 40_003, seed=3)
    W = 32 if P == 24 else 16
    cfg = LaneConfig(num_lanes=512, word_bits=W, state_bits=2 * W,
                     precision=P)
    cont = parallel.encode(syms, cdf_np, cfg=cfg, num_blocks=4, device=dev,
                           coder=coder_name)
    offsets, states = parallel.build_block_checkpoints(cont, cdf_np, 4)
    block_len = parallel.unpack_sharded(cont)[3]
    for block in (0, 3):
        c = offsets.shape[1] // 2
        start, suffix = parallel.decode_block_from_checkpoint(
            cont, cdf_np, 4, block, c, offsets, states, device=dev)
        assert start == block * block_len + (c + 1) * 4 * 512
        np.testing.assert_array_equal(
            suffix, syms[start:min((block + 1) * block_len, len(syms))])


def test_dryrun_on_the_card(dev):
    from constriction_tpu_torch import parallel

    for devices in ([dev], [dev, dev]):
        legs = parallel.dryrun(devices)
        assert len(legs) == 10
        assert all(leg["blocks"] == len(devices) for leg in legs.values())


@pytest.fixture
def strict_launch(dev, monkeypatch):
    """Runs every launch half of the block program (``container.launch``)
    under ``torch.cuda.set_sync_debug_mode("error")``, where any read-back
    or other host synchronisation raises; records each window's block
    count."""
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.parallel import container

    _build.library()  # built before any window
    real, windows = container.launch, []

    def strict(step, programs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(step, programs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        windows.append(sum(len(blocks) for blocks in programs))
        return out

    monkeypatch.setattr(container, "launch", strict)
    return windows


@pytest.mark.parametrize("P", [12, 24])
@pytest.mark.parametrize("coder_name,compact", [("rans", False),
                                                ("rans", True),
                                                ("range", False)])
def test_program_launch_window_has_no_sync(dev, strict_launch, P, coder_name,
                                          compact):
    """Every container kind: the launch halves of encode and decode read
    nothing back, and device lists that repeat the card give the bytes of
    the card alone, which are the host coders'."""
    from constriction_tpu_torch import parallel

    W = 32 if P == 24 else 16
    cfg = LaneConfig(num_lanes=256, word_bits=W, state_bits=2 * W,
                     precision=P)
    cdf_np, syms = _sharded_data(P, 29_001, seed=P + compact)
    kw = {"cfg": cfg, "num_blocks": 8, "coder": coder_name,
          "compact": compact}
    one = parallel.encode(syms, cdf_np, device=[dev], **kw)
    np.testing.assert_array_equal(
        one, parallel.encode_host(syms, cdf_np, cfg, 8, coder_name, compact))
    for k in (2, 8):
        np.testing.assert_array_equal(
            parallel.encode(syms, cdf_np, device=[dev] * k, **kw), one)
        np.testing.assert_array_equal(
            parallel.decode(one, cdf_np, device=[dev] * k), syms)
    assert strict_launch == [8] * 5


def test_legs_launch_window_has_no_sync(dev, strict_launch):
    """The dry run's three containers and eight legs on two entries of the
    card: each launch half reads nothing back."""
    from constriction_tpu_torch import parallel

    legs = parallel.dryrun([dev, dev])
    assert len(legs) == 10
    assert len(strict_launch) == 3 * 2 + 8


def test_launch_window_check_catches_a_read_back(dev, strict_launch):
    """The check of the two tests above: a step that reads a value back
    raises in the window."""
    from constriction_tpu_torch.parallel import container

    with pytest.raises(RuntimeError):
        container.launch(lambda t: t.sum().item(),
                         [[[torch.ones(4, device=dev)]]])
