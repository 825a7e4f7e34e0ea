"""The port's facade (constriction_tpu_torch.cuda) against the JAX facade
(constriction_tpu.tpu, Pallas in interpret mode) and the host oracle:
containers must be byte-identical, decode each other's output, and raise
the same errors."""

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


def test_port_imports_no_jax():
    """Neither jax nor any module of the JAX package is imported by the
    port.  conftest imports jax in this process, so the check runs in a
    fresh interpreter."""
    code = (
        "import sys\n"
        "import constriction_tpu_torch, constriction_tpu_torch.cuda\n"
        "import constriction_tpu_torch.convert, constriction_tpu_torch.models\n"
        "from constriction_tpu_torch.ops import (_build, coder, coder64,\n"
        "    framing, interleaved, interleaved2, range_enc)\n"
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
