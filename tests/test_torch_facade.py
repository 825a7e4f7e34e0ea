"""The port's facade (constriction_tpu_torch.cuda) against the JAX facade
(constriction_tpu.tpu, Pallas in interpret mode) and the host oracle:
containers, family streams and bits-back outputs must be byte-identical,
decode each other's output, and raise the same errors.  (The checkpoint
entry points: tests/test_torch_checkpoints.py.)"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import constriction_tpu.tpu as ctpu
from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import framing
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu_torch import cuda as ctt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(P, n, seed, K=100):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = ContiguousCategoricalEntropyModel \
        .from_floating_point_probabilities_fast(probs, P).cdf
    return cdf, rng.choice(K, size=n, p=probs).astype(np.int64)


# --- against the JAX facade (interpret mode; ~1-2 s a call)


@pytest.mark.parametrize("P,compact,with_alphabet", [
    (24, True, False),
    (24, False, True),
    (12, True, True),
    (12, False, False),
])
def test_containers_identical_to_jax_facade(P, compact, with_alphabet):
    cdf, idx = _data(P, 3000, seed=P + compact)
    alphabet = None
    symbols = idx
    if with_alphabet:  # non-contiguous symbols, coded as their indices
        alphabet = np.sort(
            np.random.RandomState(1).choice(10_000, size=len(cdf) - 1,
                                            replace=False) - 5_000
        )
        symbols = alphabet[idx]
    ref = ctpu.encode_iid(symbols, cdf, alphabet=alphabet, compact=compact)
    data = ctt.encode_iid(symbols, cdf, alphabet=alphabet, compact=compact,
                          device="cpu")
    np.testing.assert_array_equal(data, np.asarray(ref))
    # the port decodes the JAX-made container
    out = ctt.decode_iid(np.asarray(ref), cdf, alphabet=alphabet,
                         device="cpu")
    np.testing.assert_array_equal(out, symbols)


def test_jax_facade_decodes_port_container():
    cdf, symbols = _data(24, 2500, seed=9)
    data = ctt.encode_iid(symbols, cdf, device="cpu")
    np.testing.assert_array_equal(np.asarray(ctpu.decode_iid(data, cdf)),
                                  symbols)


# --- against the host oracle (C++), at sizes that split off region B


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("P", [24, 20, 16, 12])
def test_containers_identical_to_host_oracle(P, compact):
    cdf, symbols = _data(P, 60_000, seed=P)
    cdf64 = cdf.astype(np.float64)
    bits = -np.log2((cdf64[symbols + 1] - cdf64[symbols]) / cdf64[-1])
    cfg = ctt._pick_cfg(len(symbols), None, cdf, est_bits=float(bits.sum()))
    data = ctt.encode_iid(symbols, cdf, compact=compact, device="cpu")
    if compact:
        ref = framing.encode_iid_v2(symbols, cdf, cfg, device=False)
        assert framing.parse_v2(data).k_B > 0  # region B rides in the seeds
    else:
        ref = il2.encode_iid_categorical2(symbols, cdf, cfg, device=False)
    np.testing.assert_array_equal(data, ref)
    np.testing.assert_array_equal(ctt.decode_iid(data, cdf, device="cpu"),
                                  symbols)


def test_explicit_and_ineligible_configs():
    """An explicit cfg is used as given; a config the kernels do not take
    (lanes not a multiple of 128) is coded by the host coder, as in the
    JAX package."""
    from constriction_tpu.ops.interleaved import LaneConfig

    cdf, symbols = _data(24, 20_000, seed=3)
    for L in (1024, 200):
        cfg = LaneConfig(num_lanes=L, word_bits=32, state_bits=64,
                         precision=24)
        for compact in (True, False):
            data = ctt.encode_iid(symbols, cdf, cfg=cfg, compact=compact,
                                  device="cpu")
            ref = (framing.encode_iid_v2(symbols, cdf, cfg) if compact
                   else il2.encode_iid_categorical2(symbols, cdf, cfg))
            np.testing.assert_array_equal(data, ref)
            np.testing.assert_array_equal(
                ctt.decode_iid(data, cdf, device="cpu"), symbols)


def test_empty_message():
    cdf, _ = _data(12, 10, seed=2)
    for compact in (True, False):
        data = ctt.encode_iid(np.zeros(0, np.int64), cdf, compact=compact,
                              device="cpu")
        ref = ctpu.encode_iid(np.zeros(0, np.int64), cdf, compact=compact)
        np.testing.assert_array_equal(data, np.asarray(ref))
        assert len(ctt.decode_iid(data, cdf, device="cpu")) == 0


def _same_error(fn_jax, fn_port):
    with pytest.raises(ValueError) as a:
        fn_jax()
    with pytest.raises(ValueError) as b:
        fn_port()
    assert str(b.value) == str(a.value)


def test_errors_match_jax_facade():
    cdf24, symbols = _data(24, 500, seed=4)
    cdf12, _ = _data(12, 10, seed=4)
    data = ctt.encode_iid(symbols, cdf24, device="cpu")
    # container decoded with a CDF of another precision
    _same_error(lambda: ctpu.decode_iid(data, cdf12),
                lambda: ctt.decode_iid(data, cdf12, device="cpu"))
    # symbols outside the model
    bad = symbols.copy()
    bad[17] = 100
    _same_error(lambda: ctpu.encode_iid(bad, cdf24),
                lambda: ctt.encode_iid(bad, cdf24, device="cpu"))
    # a symbol missing from the alphabet
    alphabet = np.arange(100) * 3
    _same_error(
        lambda: ctpu.encode_iid(np.array([0, 4]), cdf24, alphabet=alphabet),
        lambda: ctt.encode_iid(np.array([0, 4]), cdf24, alphabet=alphabet,
                               device="cpu"),
    )
    # a CDF total that is not a power of two
    odd = cdf24.copy()
    odd[-1] += 1
    _same_error(lambda: ctpu.encode_iid(symbols, odd),
                lambda: ctt.encode_iid(symbols, odd, device="cpu"))


# --- the device families and the TChain-12 bits-back pair


def _family_data(n, seed):
    rng = np.random.RandomState(seed)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    symbols = np.clip(np.round(means + rng.randn(n) * scales), -100, 100)
    return symbols.astype(np.int32), means, scales


@pytest.mark.parametrize("family", ["gaussian", "laplace", "logistic",
                                    "cauchy"])
def test_family_streams_identical_to_jax_facade(family):
    """The facade picks the lane count (2500 symbols: L=256, a partial last
    step); states and stream equal the JAX facade's, the port decodes the
    JAX-made stream, and (one family: the bytes are equal) the JAX facade
    decodes the port's."""
    sym, mu, sigma = _family_data(2500, seed=len(family))
    ref = ctpu.encode_family(sym, mu, sigma, family, -100, 100)
    states, stream = ctt.encode_family(sym, mu, sigma, family, -100, 100,
                                       device="cpu")
    assert states.dtype == stream.dtype == np.uint32
    assert len(states) == ctt._pick_cfg(len(sym), None).num_lanes == 256
    np.testing.assert_array_equal(states, np.asarray(ref[0]))
    np.testing.assert_array_equal(stream, np.asarray(ref[1]))
    out = ctt.decode_family(np.asarray(ref[0]), np.asarray(ref[1]), mu, sigma,
                            family, -100, 100, len(sym), device="cpu")
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, sym)
    if family == "gaussian":
        np.testing.assert_array_equal(
            np.asarray(ctpu.decode_family(states, stream, mu, sigma, family,
                                          -100, 100, len(sym))), sym)


def test_family_explicit_config_lists_and_empty_message():
    from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    sym, mu, sigma = _family_data(700, seed=3)
    cfg = LaneConfig(num_lanes=384, word_bits=16, state_bits=32, precision=12)
    ref = ctpu.encode_family(sym, mu, sigma, "logistic", -100, 100,
                             cfg=RefLaneConfig(384, 16, 32, 12))
    # plain Python lists and float64 parameters are cast as the JAX side does
    states, stream = ctt.encode_family(
        sym.tolist(), mu.astype(np.float64), sigma.tolist(), "logistic", -100,
        100, cfg=cfg, device="cpu")
    np.testing.assert_array_equal(states, np.asarray(ref[0]))
    np.testing.assert_array_equal(stream, np.asarray(ref[1]))
    np.testing.assert_array_equal(
        ctt.decode_family(states, stream, mu, sigma, "logistic", -100, 100,
                          700, cfg=cfg, device="cpu"), sym)
    none = np.zeros(0, np.float32)
    states, stream = ctt.encode_family(np.zeros(0, np.int32), none, none,
                                       "gaussian", -100, 100, device="cpu")
    ref = ctpu.encode_family(np.zeros(0, np.int32), none, none, "gaussian",
                             -100, 100)
    np.testing.assert_array_equal(states, np.asarray(ref[0]))
    assert len(stream) == 0 == len(ctt.decode_family(
        states, stream, none, none, "gaussian", -100, 100, 0, device="cpu"))


def test_family_facade_errors():
    sym, mu, sigma = _family_data(300, seed=5)
    bad = sym.copy()
    bad[3] = 101
    with pytest.raises(ValueError, match=r"symbols must be in \[min_sym"):
        ctt.encode_family(bad, mu, sigma, "gaussian", -100, 100, device="cpu")
    zero = sigma.copy()
    zero[7] = 0.0
    with pytest.raises(ValueError, match="scales must be positive"):
        ctt.encode_family(sym, mu, zero, "gaussian", -100, 100, device="cpu")
    nan = mu.copy()
    nan[0] = np.nan
    with pytest.raises(ValueError, match="means must be finite"):
        ctt.decode_family(np.zeros(128, np.uint32), np.zeros(3, np.uint32),
                          nan, sigma, "gaussian", -100, 100, 300,
                          device="cpu")
    with pytest.raises(ValueError, match="family must be one of"):
        ctt.encode_family(sym, mu, sigma, "binomial", -100, 100, device="cpu")
    with pytest.raises(ValueError, match="means must have 300 entries"):
        ctt.encode_family(sym, mu[:-1], sigma, "gaussian", -100, 100,
                          device="cpu")


def test_bits_back_family_identical_to_jax_facade():
    """One step of the fixed 32768 lanes through both facades."""
    rng = np.random.RandomState(12)
    n = 32768
    _, mu, sigma = _family_data(n, seed=6)
    q = rng.randint(0, 1 << 12, size=n).astype(np.uint16)
    ref = ctpu.bits_back_decode_family(q, mu, sigma, "gaussian", -100, 100)
    got = ctt.bits_back_decode_family(q, mu, sigma, "gaussian", -100, 100,
                                      device="cpu")
    for a, b in zip(got, ref):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    ref2 = ctpu.bits_back_encode_family(*ref, mu, sigma, "gaussian", -100,
                                        100)
    got2 = ctt.bits_back_encode_family(*got, mu, sigma, "gaussian", -100, 100,
                                       device="cpu")
    for a, b in zip(got2, ref2):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got2[0], q)
    assert np.all(got2[1] == 16)


def test_bits_back_family_errors_and_empty_message():
    _, mu, sigma = _family_data(32768, seed=7)
    q = np.zeros(32768, np.uint16)
    q[5] = 1 << 12
    with pytest.raises(ValueError) as a:
        ctpu.bits_back_decode_family(q, mu, sigma, "gaussian", -100, 100)
    with pytest.raises(ValueError) as b:
        ctt.bits_back_decode_family(q, mu, sigma, "gaussian", -100, 100,
                                    device="cpu")
    assert str(b.value) == str(a.value) == "quantiles must be 12-bit values"
    with pytest.raises(ValueError, match="multiple of 32768"):
        ctt.bits_back_decode_family(q[:1000] & 0xFFF, mu[:1000], sigma[:1000],
                                    "gaussian", -100, 100, device="cpu")
    none = np.zeros(0, np.float32)
    got = ctt.bits_back_decode_family(np.zeros(0, np.uint16), none, none,
                                      "cauchy", -100, 100, device="cpu")
    ref = ctpu.bits_back_decode_family(np.zeros(0, np.uint16), none, none,
                                       "cauchy", -100, 100)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    q2, h2 = ctt.bits_back_encode_family(*got, none, none, "cauchy", -100,
                                         100, device="cpu")
    assert len(q2) == 0 and q2.dtype == np.uint16
    np.testing.assert_array_equal(h2, got[2])


def test_cuda_without_a_card_raises(monkeypatch):
    cdf, symbols = _data(12, 100, seed=5)
    data = ctt.encode_iid(symbols, cdf, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.encode_iid(symbols, cdf)  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.decode_iid(data, cdf, device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        ctt.encode_iid(symbols, cdf, device="meta")
    sym, mu, sigma = _family_data(200, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.encode_family(sym, mu, sigma, "gaussian", -100, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.decode_family(np.zeros(128, np.uint32), np.zeros(1, np.uint32),
                          mu, sigma, "gaussian", -100, 100, 200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.bits_back_decode_family(np.zeros(0, np.uint16), mu[:0],
                                    sigma[:0], "gaussian", -100, 100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.bits_back_encode_family(np.zeros(0, np.int32),
                                    np.zeros(0, np.uint32),
                                    np.full(32768, 16, np.uint32), mu[:0],
                                    sigma[:0], "gaussian", -100, 100)
    mu64, sigma64 = mu.astype(np.float64), sigma.astype(np.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.encode_family_exact(sym, mu64, sigma64, "gaussian", -100, 100,
                                grouped=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.decode_family_exact(np.full(128, 1 << 32, np.uint64),
                                np.zeros(1, np.uint32), mu64, sigma64,
                                "gaussian", -100, 100, 200, grouped=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.encode_family_exact_container(sym, mu64, sigma64, "gaussian",
                                          -100, 100)
    container = ctt.encode_family_exact_container(
        sym, mu64, sigma64, "gaussian", -100, 100, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.decode_family_exact_container(container, mu64, sigma64,
                                          "gaussian", -100, 100)


def test_port_imports_no_jax():
    """Neither jax nor any module of the JAX package is imported by the
    port, the host API included, and the README's quick start runs on the
    port.  conftest imports jax in this process, so the check runs in a
    fresh interpreter."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import constriction_tpu_torch as constriction\n"
        "message = np.array([6, 10, -4, 2, 5, 2, 1, 0, 2], dtype=np.int32)\n"
        "entropy_model = constriction.stream.model.QuantizedGaussian(\n"
        "    -50, 50, 3.2, 9.6)\n"
        "encoder = constriction.stream.stack.AnsCoder()\n"
        "encoder.encode_reverse(message, entropy_model)\n"
        "compressed = encoder.get_compressed()\n"
        "decoder = constriction.stream.stack.AnsCoder(compressed)\n"
        "assert np.all(decoder.decode(entropy_model, 9) == message)\n"
        "import constriction_tpu_torch.stream, constriction_tpu_torch.symbol\n"
        "import constriction_tpu_torch.backends\n"
        "import constriction_tpu_torch.ops.ans, constriction_tpu_torch.ops.range\n"
        "import constriction_tpu_torch.ops.bitstream\n"
        "import constriction_tpu_torch, constriction_tpu_torch.cuda\n"
        "import constriction_tpu_torch.convert, constriction_tpu_torch.models\n"
        "import constriction_tpu_torch.utils.special\n"
        "import constriction_tpu_torch.native\n"
        "from constriction_tpu_torch.native import build\n"
        "constriction_tpu_torch.native.library()\n"
        "from constriction_tpu_torch.ops import (_build, coder, coder64,\n"
        "    chain, exact_family, exact_tables, family, framing,\n"
        "    framing_family, interleaved, interleaved2, range_enc, tables,\n"
        "    tchain)\n"
        "import constriction_tpu_torch.parallel\n"
        "from constriction_tpu_torch.parallel import (container, dryrun,\n"
        "    sharding)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'constriction_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
