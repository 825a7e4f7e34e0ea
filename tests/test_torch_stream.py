"""The port's stream coders (``constriction_tpu_torch.stream``) and their
scalar coder cores (``ops.ans``, ``ops.range``, ``ops.chain``) against the
JAX package's, on the CPU.

- ``AnsCoder``, ``RangeEncoder`` / ``RangeDecoder`` and ``ChainCoder``
  write the JAX package's words for every model of the host API, in the
  three call forms (scalar, i.i.d., per-symbol parameters), at n = 10 and
  n = 300 (below and above the host codec's 64-symbol gate); each
  package decodes the other's words; ``seal`` / ``unseal``, ``pos`` /
  ``seek`` (a position taken in one package seeks in the other),
  ``num_bits``, ``maybe_exhausted`` and the error texts agree.
- The cores' host-codec routes (``encode_reverse_tables``,
  ``decode_iid_symbols``, ``decode_symbols``, ``encode_tables``) against
  their ``*_plain`` Python loops at n = 300 and 4096: words, symbols and
  the whole coder state after the call, also where the data run out.
- The golden vectors of ``tests/test_golden_reference.py`` (values copied
  from the reference's test suite) on the port.

The JAX package's ``native.LIB`` is None here, so its Python loops are
the oracle.  Integer coding: tolerance is equality.
"""

import numpy as np
import pytest
import scipy.stats

import constriction_tpu as ref
import constriction_tpu_torch as ctt
from constriction_tpu import native as ref_native
from constriction_tpu_torch.models import (
    ContiguousCategoricalEntropyModel,
    ContiguousLookupDecoderModel,
    LazyContiguousCategoricalEntropyModel,
    NonContiguousLookupDecoderModel,
    QuantizedFamily,
)
from constriction_tpu_torch.ops.ans import AnsCoderCore
from constriction_tpu_torch.ops.chain import (
    ChainCoderCore,
    OutOfCompressedData,
)
from constriction_tpu_torch.ops.range import (
    InvalidData,
    RangeDecoderCore,
    RangeEncoderCore,
)

PKGS = (ref, ctt)


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host paths take their Python loops."""
    monkeypatch.setattr(ref_native, "LIB", None)


def _norm_cdf(x, m, s):
    return scipy.stats.norm.cdf(x, m, s)


def _norm_ppf(q, m, s):
    return scipy.stats.norm.ppf(q, m, s)


def _case(pkg, name: str, n: int):
    """(model, params, symbols) of case ``name``; the same seeded inputs
    in either package."""
    sm = pkg.stream.model
    rng = np.random.RandomState(n * 7 + len(name))
    means = rng.uniform(-60, 60, n)
    stds = np.exp(rng.uniform(np.log(0.3), np.log(30.0), n))
    near = np.clip(np.round(means + rng.randn(n) * stds), -100, 100).astype(np.int32)
    probs = rng.dirichlet(np.full(13, 0.8))
    cat = rng.choice(13, size=n, p=probs).astype(np.int32)
    if name == "gaussian_iid":
        return (sm.QuantizedGaussian(-100, 100, 3.2, 9.6), (),
                np.clip(np.round(3.2 + 9.6 * rng.randn(n)), -100, 100).astype(np.int32))
    if name == "gaussian_family":
        return sm.QuantizedGaussian(-100, 100), (means, stds), near
    if name == "gaussian_std_fixed":
        return sm.QuantizedGaussian(-100, 100, std=7.5), (means,), near
    if name == "laplace_family":
        return sm.QuantizedLaplace(-100, 100), (means, stds), near
    if name == "cauchy_mean_fixed":
        return sm.QuantizedCauchy(-100, 100, 4.0), (stds,), near
    if name == "binomial_family":
        ns = rng.randint(1, 40, n).astype(np.int32)
        ps = rng.uniform(0, 1, n)
        return sm.Binomial(), (ns, ps), rng.binomial(ns, ps).astype(np.int32)
    if name == "binomial_n":
        ps = rng.uniform(0, 1, n)
        return sm.Binomial(30), (ps,), rng.binomial(30, ps).astype(np.int32)
    if name == "bernoulli_family":
        ps = rng.uniform(0.05, 0.95, n)
        return sm.Bernoulli(perfect=False), (ps,), (rng.uniform(0, 1, n) < ps).astype(np.int32)
    if name == "uniform_iid":
        return sm.Uniform(37), (), rng.randint(0, 37, n).astype(np.int32)
    if name == "uniform_family":
        sizes = rng.randint(2, 1000, n).astype(np.int32)
        return sm.Uniform(), (sizes,), (rng.uniform(0, 1, n) * sizes).astype(np.int32)
    if name == "categorical_perfect_iid":
        return sm.Categorical(probs, perfect=True), (), cat
    if name == "categorical_fast_iid":
        return sm.Categorical(probs.astype(np.float32), perfect=False), (), cat
    if name == "categorical_lazy_iid":
        return sm.Categorical(probs, lazy=True), (), cat
    if name == "categorical_family":
        rows = rng.dirichlet(np.full(6, 0.6), size=n).astype(np.float32)
        return (sm.Categorical(perfect=False), (rows,),
                np.array([rng.choice(6, p=r / r.sum()) for r in rows.astype(np.float64)],
                         dtype=np.int32))
    if name == "categorical_perfect_family":
        rows = rng.dirichlet(np.full(5, 0.6), size=n)
        return (sm.Categorical(perfect=True), (rows,),
                np.array([rng.choice(5, p=r) for r in rows], dtype=np.int32))
    if name == "custom_family":
        return (sm.CustomModel(_norm_cdf, _norm_ppf, -100, 100), (means, stds), near)
    if name == "scipy_iid":
        return (sm.ScipyModel(scipy.stats.norm(1.2, 4.9), -30, 30), (),
                np.clip(np.round(1.2 + 4.9 * rng.randn(n)), -30, 30).astype(np.int32))
    raise KeyError(name)


FAST = ("gaussian_iid", "gaussian_family", "gaussian_std_fixed",
        "laplace_family", "cauchy_mean_fixed", "bernoulli_family",
        "uniform_iid", "uniform_family", "categorical_perfect_iid",
        "categorical_fast_iid", "categorical_lazy_iid",
        "categorical_family", "categorical_perfect_family", "scipy_iid")
# per-symbol Python callbacks in every decode step: 300 symbols would
# cost seconds, so these run above the gate at 80
SLOW = ("binomial_family", "binomial_n", "custom_family")
CASES = ([(name, n) for name in FAST for n in (10, 300)]
         + [(name, n) for name in SLOW for n in (10, 80)])


def _decode(coder, model, params, n):
    return coder.decode(model, *params) if params else coder.decode(model, n)


@pytest.mark.parametrize("name,n", CASES)
def test_ans_coder_equals_reference(name, n):
    out = []
    for pkg in PKGS:
        model, params, sym = _case(pkg, name, n)
        coder = pkg.stream.stack.AnsCoder()
        coder.encode_reverse(sym, model, *params)
        out.append((coder.get_compressed(), coder.num_bits(),
                    coder.num_valid_bits(), coder.pos()))
    (wr, *rest_r), (wp, *rest_p) = out
    assert wp.dtype == wr.dtype == np.uint32
    np.testing.assert_array_equal(wp, wr)
    assert rest_p == rest_r
    for dec_pkg, words in ((ctt, wr), (ref, wp)):
        model, params, sym = _case(dec_pkg, name, n)
        dec = dec_pkg.stream.stack.AnsCoder(words)
        got = _decode(dec, model, params, n)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, sym)
        assert dec.is_empty()


@pytest.mark.parametrize("name,n", CASES)
def test_range_coder_equals_reference(name, n):
    out = []
    for pkg in PKGS:
        model, params, sym = _case(pkg, name, n)
        enc = pkg.stream.queue.RangeEncoder()
        enc.encode(sym, model, *params)
        out.append((enc.get_compressed(), enc.num_bits(), enc.pos()))
    (wr, *rest_r), (wp, *rest_p) = out
    np.testing.assert_array_equal(wp, wr)
    assert rest_p == rest_r
    for dec_pkg, words in ((ctt, wr), (ref, wp)):
        model, params, sym = _case(dec_pkg, name, n)
        dec = dec_pkg.stream.queue.RangeDecoder(words)
        np.testing.assert_array_equal(_decode(dec, model, params, n), sym)
        assert dec.maybe_exhausted()


@pytest.mark.parametrize("name,n", CASES)
def test_chain_coder_equals_reference(name, n):
    """Bits-back: decode seeded data, then encode the symbols back onto
    the remainders; each package's remainders re-encode in the other."""
    data = np.random.RandomState(n).randint(
        0, 1 << 32, size=n + 8, dtype=np.uint32)
    out = []
    for pkg in PKGS:
        model, params, _ = _case(pkg, name, n)
        dec = pkg.stream.chain.ChainCoder(data, seal=True)
        sym = _decode(dec, model, params, n)
        out.append((sym, dec.get_remainders()))
    (sr, (pre_r, suf_r)), (sp, (pre_p, suf_p)) = out
    np.testing.assert_array_equal(sp, sr)
    np.testing.assert_array_equal(pre_p, pre_r)
    np.testing.assert_array_equal(suf_p, suf_r)
    for pkg in PKGS:
        model, params, _ = _case(pkg, name, n)
        enc = pkg.stream.chain.ChainCoder(suf_r, is_remainders=True)
        enc.encode_reverse(sr, model, *params)
        prefix, suffix = enc.get_data(unseal=True)
        assert len(prefix) == 0
        np.testing.assert_array_equal(np.concatenate([pre_r, suffix]), data)


@pytest.mark.parametrize("name", ["gaussian_iid", "categorical_lazy_iid",
                                  "uniform_iid", "scipy_iid"])
def test_scalar_call_form_equals_reference(name):
    """``encode(symbol, model)`` / ``decode(model)`` one symbol a call."""
    n = 12
    for kind in ("stack", "queue"):
        words = []
        for pkg in PKGS:
            model, _, sym = _case(pkg, name, n)
            if kind == "stack":
                coder = pkg.stream.stack.AnsCoder()
                for s in sym[::-1]:
                    coder.encode_reverse(int(s), model)
            else:
                coder = pkg.stream.queue.RangeEncoder()
                for s in sym:
                    coder.encode(s, model)
            words.append(coder.get_compressed())
        np.testing.assert_array_equal(words[1], words[0])
        model, _, sym = _case(ctt, name, n)
        dec = (ctt.stream.stack.AnsCoder(words[0]) if kind == "stack"
               else ctt.stream.queue.RangeDecoder(words[0]))
        got = [dec.decode(model) for _ in range(n)]
        assert all(isinstance(s, int) for s in got)
        assert got == [int(s) for s in sym]
    data = np.random.RandomState(1).randint(1, 1 << 32, 40, dtype=np.uint32)
    got = []
    for pkg in PKGS:
        model, _, _ = _case(pkg, name, n)
        dec = pkg.stream.chain.ChainCoder(data, seal=True)
        got.append([dec.decode(model) for _ in range(n)])
    assert got[0] == got[1]


def test_seal_unseal_equals_reference():
    data = np.random.RandomState(5).randint(1, 1 << 32, 50, dtype=np.uint32)
    out = []
    for pkg in PKGS:
        model = pkg.stream.model.Categorical(
            np.array([0.1, 0.6, 0.3]), perfect=False)
        coder = pkg.stream.stack.AnsCoder(data, seal=True)
        sym = coder.decode(model, 100)
        mid = coder.get_compressed()
        coder.encode_reverse(sym, model)
        out.append((sym, mid, coder.get_compressed(unseal=True)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[1][2], data)
    with pytest.raises(ValueError, match="Need compressed data to seal"):
        ctt.stream.stack.AnsCoder(seal=True)


def test_pos_seek_across_packages():
    """A position taken while encoding in one package seeks the other
    package's decoder: ANS (stack) and range (queue)."""
    rng = np.random.RandomState(11)
    p1, p2 = rng.randint(0, 13, 300), rng.randint(0, 13, 200)
    for enc_pkg, dec_pkg in ((ref, ctt), (ctt, ref)):
        model_e = enc_pkg.stream.model.Categorical(
            np.full(13, 1 / 13), perfect=False)
        model_d = dec_pkg.stream.model.Categorical(
            np.full(13, 1 / 13), perfect=False)
        ans = enc_pkg.stream.stack.AnsCoder()
        ans.encode_reverse(p2.astype(np.int32), model_e)
        pos = ans.pos()
        ans.encode_reverse(p1.astype(np.int32), model_e)
        dec = dec_pkg.stream.stack.AnsCoder(ans.get_compressed())
        dec.decode(model_d, 5)
        dec.seek(*pos)
        np.testing.assert_array_equal(dec.decode(model_d, 200), p2)
        rng_enc = enc_pkg.stream.queue.RangeEncoder()
        rng_enc.encode(p1.astype(np.int32), model_e)
        pos = rng_enc.pos()
        rng_enc.encode(p2.astype(np.int32), model_e)
        rdec = dec_pkg.stream.queue.RangeDecoder(rng_enc.get_compressed())
        rdec.seek(*pos)
        np.testing.assert_array_equal(rdec.decode(model_d, 200), p2)
        assert rdec.maybe_exhausted()


def _gauss_family(pkg):
    return pkg.stream.model.QuantizedGaussian(-100, 100)


STREAM_ERRORS = {
    "trailing_zero": lambda pkg: pkg.stream.stack.AnsCoder(np.array([5, 0], np.uint32)),
    "seek_past_end": lambda pkg: pkg.stream.stack.AnsCoder().seek(3, 1 << 40),
    "scalar_with_params": lambda pkg: pkg.stream.stack.AnsCoder().encode_reverse(
        5, _gauss_family(pkg), np.array([1.0]), np.array([2.0])),
    "wrong_length": lambda pkg: pkg.stream.queue.RangeEncoder().encode(
        np.array([1, 2, 3], np.int32), _gauss_family(pkg), np.ones(2), np.ones(2)),
    "no_params": lambda pkg: pkg.stream.stack.AnsCoder().encode_reverse(
        np.array([1, 2], np.int32), _gauss_family(pkg)),
    "impossible": lambda pkg: pkg.stream.stack.AnsCoder().encode_reverse(
        np.full(100, 200, np.int32), pkg.stream.model.QuantizedGaussian(-100, 100, 0.0, 5.0)),
    "float_symbols": lambda pkg: pkg.stream.stack.AnsCoder().encode_reverse(
        np.ones(3), pkg.stream.model.Uniform(4)),
    "words_overflow": lambda pkg: pkg.stream.queue.RangeDecoder(np.array([-1, 3])),
    "garbage_range": lambda pkg: pkg.stream.queue.RangeDecoder(
        np.full(300, 0xFFFFFFFF, np.uint32)).decode(
            pkg.stream.model.QuantizedGaussian(-100, 100, 0.0, 1.0), 200),
    "chain_out_of_data": lambda pkg: pkg.stream.chain.ChainCoder(
        np.array([1, 2, 3, 4], np.uint32)).decode(pkg.stream.model.Uniform(10), 100),
    "chain_seal_remainders": lambda pkg: pkg.stream.chain.ChainCoder(
        np.array([1, 2], np.uint32), is_remainders=True, seal=True),
    "chain_too_little": lambda pkg: pkg.stream.chain.ChainCoder(np.array([3, 0], np.uint32)),
    "chain_fractional": lambda pkg: pkg.stream.chain.ChainCoder(
        np.array([7, 9, 11, 13], np.uint32)).get_data(unseal=True),
    "unseal_fractional": lambda pkg: pkg.stream.stack.AnsCoder(
        np.array([7, 9], np.uint32)).get_compressed(unseal=True),
}


@pytest.mark.parametrize("case", sorted(STREAM_ERRORS))
def test_stream_errors_equal_reference(case):
    caught = []
    for pkg in PKGS:
        with pytest.raises(Exception) as info:
            STREAM_ERRORS[case](pkg)
        caught.append(info.value)
    want, got = caught
    assert [c.__name__ for c in type(got).__mro__] == [
        c.__name__ for c in type(want).__mro__]
    assert str(got) == str(want)


# ---------------------------------------------------------------------------
# the cores' host-codec routes against their *_plain loops
# ---------------------------------------------------------------------------


def _core_model(kind: str):
    rng = np.random.RandomState(len(kind))
    probs = rng.dirichlet(np.full(40, 0.6))
    if kind == "cdf24":
        return ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(probs, 24)
    if kind == "lazy24":
        return LazyContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
            probs, 24)
    if kind == "lookup12":
        return ContiguousLookupDecoderModel.from_floating_point_probabilities_fast(probs, 12)
    if kind == "lookup16":
        return ContiguousLookupDecoderModel.from_floating_point_probabilities_perfect(probs, 16)
    if kind == "noncontiguous12":
        base = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(probs, 12)
        return NonContiguousLookupDecoderModel.from_symbols_and_nonzero_fixed_point_probabilities(
            list(range(-40, 40, 2)), np.diff(base.cdf.astype(np.int64)), 12)
    raise KeyError(kind)


def _core_symbols(model, n: int, seed: int):
    rng = np.random.RandomState(seed)
    table = list(model.symbol_table())
    return np.asarray([table[i][0] for i in rng.randint(0, len(table), n)])


def _ans_state(core):
    return core.get_compressed().tolist(), core.state, len(core.bulk)


@pytest.mark.parametrize("n", [300, 4096])
@pytest.mark.parametrize("kind", ["cdf24", "lazy24", "lookup12", "noncontiguous12"])
def test_ans_core_route_equals_plain(kind, n):
    model = _core_model(kind)
    sym = _core_symbols(model, n, n)
    cums, probs = (model.ecp_array(sym) if hasattr(model, "ecp_array")
                   else np.array([model.ecp(int(s)) for s in sym]).T)
    routed, plain = AnsCoderCore(), AnsCoderCore()
    routed.encode_reverse_tables(cums, probs, model.precision)
    plain.encode_reverse_tables_plain(cums, probs, model.precision)
    assert _ans_state(routed) == _ans_state(plain)
    words = routed.get_compressed()
    a, b = AnsCoderCore.from_compressed(words), AnsCoderCore.from_compressed(words)
    # decode all but a tail, so that the state after the call is mid-stream
    got = a.decode_iid_symbols(n - 5, model)
    want = b.decode_iid_symbols_plain(n - 5, model)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sym[:n - 5])
    assert _ans_state(a) == _ans_state(b)


@pytest.mark.parametrize("n", [300, 4096])
@pytest.mark.parametrize("kind", ["gaussian", "laplace", "cauchy"])
def test_family_core_routes_equal_plain(kind, n):
    """``ctpu_ans_decode_quantized`` / ``ctpu_range_decode_quantized``
    against the per-symbol loops, and the encodes of the same tables."""
    rng = np.random.RandomState(n)
    a = rng.uniform(-80, 80, n)
    b = np.exp(rng.uniform(np.log(0.2), np.log(20.0), n))
    sym = np.clip(np.round(a + rng.randn(n) * b), -100, 100).astype(np.int64)
    fam = QuantizedFamily(kind, -100, 100, a, b, 24)
    ans_r, ans_p = AnsCoderCore(), AnsCoderCore()
    ans_r.encode_symbols_reverse(sym, fam)
    ans_p.encode_reverse_tables_plain(*fam.ecp_all_plain(sym), 24)
    assert _ans_state(ans_r) == _ans_state(ans_p)
    d_r = AnsCoderCore.from_compressed(ans_r.get_compressed())
    d_p = AnsCoderCore.from_compressed(ans_r.get_compressed())
    np.testing.assert_array_equal(d_r.decode_symbols(fam), sym)
    np.testing.assert_array_equal(d_p.decode_symbols_plain(fam), sym)
    assert _ans_state(d_r) == _ans_state(d_p)
    rng_r, rng_p = RangeEncoderCore(), RangeEncoderCore()
    rng_r.encode_symbols(sym, fam)
    rng_p.encode_tables_plain(*fam.ecp_all_plain(sym), 24)
    words = rng_r.get_compressed()
    np.testing.assert_array_equal(words, rng_p.get_compressed())
    r_r, r_p = RangeDecoderCore.from_compressed(words), RangeDecoderCore.from_compressed(words)
    np.testing.assert_array_equal(r_r.decode_symbols(fam), sym)
    np.testing.assert_array_equal(r_p.decode_symbols_plain(fam), sym)
    assert _range_state(r_r) == _range_state(r_p)


def _range_state(core):
    return core.lower, core.range, core.point, core.cursor, core.pos()


@pytest.mark.parametrize("n", [300, 4096])
@pytest.mark.parametrize("kind", ["cdf24", "lookup12", "noncontiguous12"])
def test_range_core_route_equals_plain(kind, n):
    model = _core_model(kind)
    sym = _core_symbols(model, n, n + 1)
    cums, probs = (model.ecp_array(sym) if hasattr(model, "ecp_array")
                   else np.array([model.ecp(int(s)) for s in sym]).T)
    routed, plain = RangeEncoderCore(), RangeEncoderCore()
    routed.encode_tables(cums[:n // 2], probs[:n // 2], model.precision)
    plain.encode_tables_plain(cums[:n // 2], probs[:n // 2], model.precision)
    # a second call starts from a mid-stream state, held-back words included
    routed.encode_tables(cums[n // 2:], probs[n // 2:], model.precision)
    plain.encode_tables_plain(cums[n // 2:], probs[n // 2:], model.precision)
    assert (routed.lower, routed.range, routed.inverted) == (
        plain.lower, plain.range, plain.inverted)
    words = routed.get_compressed()
    np.testing.assert_array_equal(words, plain.get_compressed())
    a, b = RangeDecoderCore.from_compressed(words), RangeDecoderCore.from_compressed(words)
    got = a.decode_iid_symbols(n - 3, model)
    np.testing.assert_array_equal(got, b.decode_iid_symbols_plain(n - 3, model))
    np.testing.assert_array_equal(got, sym[:n - 3])
    assert _range_state(a) == _range_state(b)


def test_range_route_on_garbage_ends_in_plain_state():
    """After InvalidData the routed decode leaves the state the loop
    leaves."""
    model = _core_model("lookup12")
    garbage = np.full(300, 0xFFFFFFFF, dtype=np.uint64)
    states = []
    for decode in ("decode_iid_symbols", "decode_iid_symbols_plain"):
        dec = RangeDecoderCore.from_compressed(garbage)
        with pytest.raises(InvalidData):
            getattr(dec, decode)(200, model)
        states.append(_range_state(dec))
    assert states[0] == states[1]


def _chain_state(core):
    return (core.compressed.tolist(), core.remainders.tolist(),
            core.head_compressed, core.head_remainders)


@pytest.mark.parametrize("n", [300, 4096])
def test_chain_core_route_equals_plain(n):
    """``ctpu_chain_decode_lookup`` (a lookup model at the coder's P <=
    16) and ``ctpu_chain_encode_reverse`` against the loops."""
    model = _core_model("lookup16")
    data = np.random.RandomState(n).randint(0, 1 << 32, n // 2 + 8,
                                            dtype=np.uint32)
    a = ChainCoderCore.from_binary(data, 32, 64, 16)
    b = ChainCoderCore.from_binary(data, 32, 64, 16)
    got = a.decode_iid_symbols(n, model)
    np.testing.assert_array_equal(got, b.decode_iid_symbols_plain(n, model))
    assert _chain_state(a) == _chain_state(b)
    cums, probs = model.inner.ecp_array(got) if hasattr(model, "inner") else (
        model.cdf[got], model.cdf[got + 1] - model.cdf[got])
    a.encode_reverse_tables(cums, probs)
    b.encode_reverse_tables_plain(cums, probs)
    assert _chain_state(a) == _chain_state(b)
    np.testing.assert_array_equal(a.into_binary()[1], data)


def test_chain_route_out_of_data_ends_in_plain_state():
    model = _core_model("lookup16")
    data = np.random.RandomState(3).randint(0, 1 << 32, 40, dtype=np.uint32)
    states = []
    for decode in ("decode_iid_symbols", "decode_iid_symbols_plain"):
        dec = ChainCoderCore.from_binary(data, 32, 64, 16)
        with pytest.raises(OutOfCompressedData):
            getattr(dec, decode)(200, model)
        states.append(_chain_state(dec))
    assert states[0] == states[1]


def test_chain_family_encode_route_equals_plain():
    rng = np.random.RandomState(4)
    n = 500
    fam = QuantizedFamily("gaussian", -100, 100, rng.uniform(-50, 50, n),
                          rng.uniform(1, 10, n), 24)
    data = rng.randint(0, 1 << 32, 600, dtype=np.uint32)
    dec = ChainCoderCore.from_binary(data)
    sym = dec.decode_symbols(fam)
    prefix, suffix = dec.into_remainders()
    a = ChainCoderCore.from_remainders(suffix)
    b = ChainCoderCore.from_remainders(suffix)
    a.encode_symbols_reverse(sym, fam)
    b.encode_reverse_tables_plain(*fam.ecp_all_plain(sym))
    assert _chain_state(a) == _chain_state(b)
    np.testing.assert_array_equal(
        np.concatenate([prefix, a.into_binary()[1]]), data)


# ---------------------------------------------------------------------------
# golden vectors (values copied from tests/test_golden_reference.py, which
# copies them from the reference's test suite)
# ---------------------------------------------------------------------------

GOLD_SYMBOLS = np.array([23, -15, 78, 43, -69], dtype=np.int32)
GOLD_MEANS = np.array([35.2, -1.7, 30.1, 71.2, -75.1], dtype=np.float64)
GOLD_STDS = np.array([10.1, 25.3, 23.8, 35.4, 3.9], dtype=np.float64)


def test_golden_queue_gaussian():
    encoder = ctt.stream.queue.RangeEncoder()
    model = ctt.stream.model.QuantizedGaussian(-100, 100)
    encoder.encode(GOLD_SYMBOLS, model, GOLD_MEANS, GOLD_STDS)
    assert encoder.num_bits() == 64
    compressed = encoder.get_compressed()
    np.testing.assert_array_equal(
        compressed, np.array([473034731, 2276733146], dtype=np.uint32))
    decoder1 = ctt.stream.queue.RangeDecoder(compressed)
    np.testing.assert_array_equal(decoder1.decode(model, GOLD_MEANS, GOLD_STDS), GOLD_SYMBOLS)
    assert decoder1.maybe_exhausted()
    decoder2 = encoder.get_decoder()
    np.testing.assert_array_equal(decoder2.decode(model, GOLD_MEANS, GOLD_STDS), GOLD_SYMBOLS)
    assert decoder2.maybe_exhausted()


def test_golden_stack_gaussian():
    encoder = ctt.stream.stack.AnsCoder()
    model = ctt.stream.model.QuantizedGaussian(-100, 100)
    encoder.encode_reverse(GOLD_SYMBOLS, model, GOLD_MEANS, GOLD_STDS)
    assert encoder.num_bits() == 64
    assert encoder.num_valid_bits() == 51
    compressed = encoder.get_compressed()
    np.testing.assert_array_equal(
        compressed, np.array([1109163715, 757457], dtype=np.uint32))
    decoder1 = ctt.stream.stack.AnsCoder(compressed)
    np.testing.assert_array_equal(decoder1.decode(model, GOLD_MEANS, GOLD_STDS), GOLD_SYMBOLS)
    assert decoder1.is_empty()
    np.testing.assert_array_equal(encoder.decode(model, GOLD_MEANS, GOLD_STDS), GOLD_SYMBOLS)
    assert encoder.is_empty()


def test_golden_chain_gaussian():
    rng = np.random.RandomState(123)
    original_data = rng.randint(2**32, size=100, dtype=np.uint32)
    decoder = ctt.stream.chain.ChainCoder(original_data, seal=True)
    model = ctt.stream.model.QuantizedGaussian(-100, 100)
    means = np.arange(50, dtype=np.float64)
    stds = np.array([10.0] * 50, dtype=np.float64)
    symbols = decoder.decode(model, means, stds)
    remainders_prefix, remainders_suffix = decoder.get_remainders()
    assert len(remainders_prefix) + len(remainders_suffix) < len(original_data)
    encoder1 = ctt.stream.chain.ChainCoder(remainders_suffix, is_remainders=True)
    encoder1.encode_reverse(symbols, model, means, stds)
    recovered_prefix1, recovered_suffix1 = encoder1.get_data(unseal=True)
    assert len(recovered_prefix1) == 0
    np.testing.assert_array_equal(
        np.concatenate((remainders_prefix, recovered_suffix1)), original_data)
    remainders = np.concatenate((remainders_prefix, remainders_suffix))
    encoder2 = ctt.stream.chain.ChainCoder(remainders, is_remainders=True)
    encoder2.encode_reverse(symbols, model, means, stds)
    np.testing.assert_array_equal(
        np.concatenate(encoder2.get_data(unseal=True)), original_data)
    decoder.encode_reverse(symbols, model, means, stds)
    recovered_prefix3, recovered_suffix3 = decoder.get_data(unseal=True)
    assert len(recovered_prefix3) == 0
    np.testing.assert_array_equal(recovered_suffix3, original_data)


def test_golden_chain_independence():
    data = np.array([0x80D1_4131, 0xDDA9_7C6C, 0x5017_A640, 0x0117_0A3E], np.uint32)
    probabilities = np.array(
        [[0.1, 0.7, 0.1, 0.1], [0.2, 0.2, 0.1, 0.5], [0.2, 0.1, 0.4, 0.3]])
    model = ctt.stream.model.Categorical(perfect=False)
    assert ctt.stream.stack.AnsCoder(data, True).decode(model, probabilities).tolist() == [0, 0, 2]
    probabilities[0, :] = np.array([0.09, 0.71, 0.1, 0.1])
    assert ctt.stream.stack.AnsCoder(data, True).decode(model, probabilities).tolist() == [1, 0, 0]
    probabilities[0, :] = np.array([0.1, 0.7, 0.1, 0.1])
    chain = ctt.stream.chain.ChainCoder(data, False, True)
    assert chain.decode(model, probabilities).tolist() == [0, 3, 3]
    probabilities[0, :] = np.array([0.09, 0.71, 0.1, 0.1])
    chain = ctt.stream.chain.ChainCoder(data, False, True)
    assert chain.decode(model, probabilities).tolist() == [1, 3, 3]


def test_golden_custom_model_exact_compressed():
    symbols = np.array([3, 2, 6, -51, -19, 5, 87], dtype=np.int32)
    model_py = scipy.stats.norm(1.2, 4.9)
    model_iid = ctt.stream.model.CustomModel(model_py.cdf, model_py.ppf, -100, 100)
    params_iid1 = np.array([1.2] * len(symbols), dtype=np.float64)
    params_iid2 = np.array([4.9] * len(symbols), dtype=np.float64)
    params1 = symbols.astype(np.float64)
    params2 = np.array([4.9] * len(symbols), dtype=np.float64)
    model = ctt.stream.model.CustomModel(
        lambda x, loc, scale: scipy.stats.norm.cdf(x, loc, scale),
        scipy.stats.norm.ppf, -100, 100)
    for coder, Decoder, expected_iid, expected in (
        ("stack", ctt.stream.stack.AnsCoder, [3187671595, 2410106987, 48580],
         [3397926478, 6042]),
        ("queue", ctt.stream.queue.RangeDecoder, [2789142295, 3128556965, 414280666],
         [2147484271]),
    ):
        def encode(*args):
            if coder == "stack":
                enc = ctt.stream.stack.AnsCoder()
                enc.encode_reverse(symbols, *args)
            else:
                enc = ctt.stream.queue.RangeEncoder()
                enc.encode(symbols, *args)
            return enc.get_compressed()

        compressed = encode(model_iid)
        np.testing.assert_array_equal(compressed, np.array(expected_iid, np.uint32))
        np.testing.assert_array_equal(Decoder(compressed).decode(model_iid, 7), symbols)
        compressed = encode(model, params_iid1, params_iid2)
        np.testing.assert_array_equal(compressed, np.array(expected_iid, np.uint32))
        np.testing.assert_array_equal(
            Decoder(compressed).decode(model, params_iid1, params_iid2), symbols)
        compressed = encode(model, params1, params2)
        np.testing.assert_array_equal(compressed, np.array(expected, np.uint32))
        np.testing.assert_array_equal(Decoder(compressed).decode(model, params1, params2), symbols)


def test_golden_doc_examples_stack():
    probabilities = np.array([0.1, 0.6, 0.3], dtype=np.float32)
    model = ctt.stream.model.Categorical(probabilities, perfect=False)
    symbols = np.array([0, 2, 1, 2, 0, 2, 0, 2, 1], dtype=np.int32)
    coder = ctt.stream.stack.AnsCoder()
    coder.encode_reverse(symbols, model)
    assert coder.get_compressed().tolist() == [1276732052, 172]
    compressed = np.array([2514924296, 114], dtype=np.uint32)
    assert ctt.stream.stack.AnsCoder(compressed).decode(model) == 2
    assert ctt.stream.stack.AnsCoder(compressed).decode(model, 9).tolist() == [
        2, 0, 0, 1, 2, 2, 1, 2, 2]
    model_family = ctt.stream.model.QuantizedGaussian(-100, 100)
    means = np.array([10.3, -4.7, 20.5], dtype=np.float32)
    stds = np.array([5.2, 24.2, 3.1], dtype=np.float32)
    coder = ctt.stream.stack.AnsCoder()
    coder.encode_reverse(np.array([12, -13, 25], dtype=np.int32), model_family, means, stds)
    assert coder.get_compressed().tolist() == [597775281, 3]
    coder = ctt.stream.stack.AnsCoder(np.array([597775281, 3], dtype=np.uint32))
    assert coder.decode(model_family, means, stds).tolist() == [12, -13, 25]
    probabilities = np.array(
        [[0.1, 0.2, 0.3, 0.1, 0.3], [0.3, 0.2, 0.2, 0.2, 0.1]], dtype=np.float32)
    model_family = ctt.stream.model.Categorical(perfect=False)
    coder = ctt.stream.stack.AnsCoder()
    coder.encode_reverse(np.array([3, 1], dtype=np.int32), model_family, probabilities)
    assert coder.get_compressed().tolist() == [45298482]
    coder = ctt.stream.stack.AnsCoder(np.array([2142112014, 31], dtype=np.uint32))
    assert coder.decode(model_family, probabilities).tolist() == [3, 1]


def test_golden_quick_start_and_stack_seek():
    """README's quick start, and the reference's seek example."""
    message = np.array([6, 10, -4, 2, 5, 2, 1, 0, 2], dtype=np.int32)
    entropy_model = ctt.stream.model.QuantizedGaussian(-50, 50, 3.2, 9.6)
    encoder = ctt.stream.stack.AnsCoder()
    encoder.encode_reverse(message, entropy_model)
    decoder = ctt.stream.stack.AnsCoder(encoder.get_compressed())
    np.testing.assert_array_equal(decoder.decode(entropy_model, 9), message)
    probabilities = np.array([0.2, 0.4, 0.1, 0.3], dtype=np.float32)
    model = ctt.stream.model.Categorical(probabilities, perfect=False)
    part1 = np.array([1, 2, 0, 3, 2, 3, 0], dtype=np.int32)
    part2 = np.array([2, 2, 0, 1, 3], dtype=np.int32)
    coder = ctt.stream.stack.AnsCoder()
    coder.encode_reverse(part2, model)
    position, state = coder.pos()
    coder.encode_reverse(part1, model)
    assert coder.decode(model) == 1
    coder.seek(position, state)
    np.testing.assert_array_equal(coder.decode(model, 5), part2)
