"""The port's CUDA kernels against their plain PyTorch twins and the JAX
package's host oracle (``interleaved2.encode_shared`` /
``decode_shared_cdf``, numpy and C++), on the card.

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
from constriction_tpu_torch.ops import coder, coder64
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
