"""The port's CUDA kernels against their plain PyTorch twins and the host
oracles, on the card: the rANS kernels against the JAX package's
(``interleaved2.encode_shared`` / ``decode_shared_cdf``, numpy and C++), the
range kernels against the port's numpy range coder (the CPU tests hold that
one against the JAX package's).

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
from constriction_tpu_torch.ops import coder, coder64, range_enc
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig

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
