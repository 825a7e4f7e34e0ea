"""The port's symbol codes (``constriction_tpu_torch.symbol``), word
backends (``backends``) and public surface against the JAX package's, on
the CPU.

- ``StackCoder``, ``QueueEncoder`` / ``QueueDecoder`` with Huffman and
  Exp-Golomb codebooks write the JAX package's bits (words and bit
  counts), each package decodes the other's, and the reference's Huffman
  golden vectors (copied from ``tests/test_golden_reference.py``) hold.
- The cases of ``tests/test_backends.py`` on the port: ``WordBuffer`` with
  fixed capacity and its ``CapacityError``, ``CallbackSink``, the two
  iterator readers, the (W, S, P) grid over them; the bulk words of each
  backend equal the JAX package's.
- Each public name (no leading underscore) of ``stream.*``, ``symbol.*``,
  ``models.*`` and ``backends`` is the JAX counterpart's.

The JAX package's ``native.LIB`` is None here, so its Python loops are
the oracle.  Integer coding: tolerance is equality.
"""

import importlib

import numpy as np
import pytest

import constriction_tpu as ref
import constriction_tpu_torch as ctt
from constriction_tpu import native as ref_native
from constriction_tpu.ops.ans import AnsCoderCore as RefAns
from constriction_tpu.ops.range import RangeEncoderCore as RefRange
from constriction_tpu_torch.backends import (
    CallbackSink,
    CapacityError,
    StackIterReader,
    WordBuffer,
)
from constriction_tpu_torch.models import ContiguousCategoricalEntropyModel
from constriction_tpu_torch.ops.ans import AnsCoderCore
from constriction_tpu_torch.ops.chain import ChainCoderCore
from constriction_tpu_torch.ops.range import RangeDecoderCore, RangeEncoderCore

PKGS = (ref, ctt)


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    monkeypatch.setattr(ref_native, "LIB", None)


def _codebooks(pkg, kind: str, probs):
    if kind == "huffman":
        h = pkg.symbol.huffman
        return h.EncoderHuffmanTree(probs), h.DecoderHuffmanTree(probs)
    eg = pkg.symbol.exp_golomb.ExpGolomb()
    return eg, eg


@pytest.mark.parametrize("n", [1, 100, 1 << 12])
@pytest.mark.parametrize("kind", ["huffman", "exp_golomb"])
def test_symbol_codes_equal_reference(kind, n):
    rng = np.random.RandomState(n)
    probs = rng.dirichlet(np.full(11, 0.5)).astype(np.float32)
    syms = (rng.choice(11, size=n, p=probs / probs.sum(dtype=np.float64))
            if kind == "huffman" else rng.geometric(0.05, size=n) - 1)
    syms = [int(s) for s in syms]
    if kind == "exp_golomb":
        syms[0] = (1 << 32) - 1  # the wrapping codeword
    out = []
    for pkg in PKGS:
        enc_book, _ = _codebooks(pkg, kind, probs)
        q = pkg.symbol.QueueEncoder()
        for s in syms:
            q.encode_symbol(s, enc_book)
        st = pkg.symbol.StackCoder()
        for s in reversed(syms):
            st.encode_symbol(s, enc_book)
        out.append((q.get_compressed_and_bitrate(), st.get_compressed()))
    (qr, sr), (qp, sp) = out
    for a, b in ((qr, qp), (sr, sp)):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == b[0].dtype == np.uint32 and a[1] == b[1]
    for pkg in PKGS:
        _, dec_book = _codebooks(pkg, kind, probs)
        qd = pkg.symbol.QueueDecoder(qr[0])
        assert [qd.decode_symbol(dec_book) for _ in syms] == syms
        assert qd.maybe_exhausted()
        sd = pkg.symbol.StackCoder(sp[0])
        assert [sd.decode_symbol(dec_book) for _ in syms] == syms


def test_symbol_errors_equal_reference():
    cases = [
        lambda pkg: pkg.symbol.QueueDecoder(np.zeros(0, np.uint32)).decode_symbol(
            pkg.symbol.huffman.DecoderHuffmanTree(np.array([0.5, 0.5]))),
        lambda pkg: pkg.symbol.huffman.EncoderHuffmanTree(np.array([0.5, np.nan])),
        lambda pkg: pkg.symbol.StackCoder(np.array([7, 0], np.uint32)),
        lambda pkg: pkg.symbol.QueueDecoder(np.zeros(3, np.uint32)).decode_symbol(
            pkg.symbol.exp_golomb.ExpGolomb()),
        lambda pkg: pkg.symbol.QueueEncoder().encode_symbol(
            9, pkg.symbol.huffman.EncoderHuffmanTree(np.array([0.5, 0.5]))),
    ]
    for case in cases:
        caught = []
        for pkg in PKGS:
            with pytest.raises(Exception) as info:
                case(pkg)
            caught.append(info.value)
        want, got = caught
        assert [c.__name__ for c in type(got).__mro__] == [
            c.__name__ for c in type(want).__mro__]
        assert str(got) == str(want)


def test_golden_huffman():
    """The reference's Huffman vectors (values copied)."""
    probabilities = np.array([0.3, 0.28, 0.12, 0.1, 0.2], dtype=np.float64)
    symbols = [1, 3, 2, 4, 0, 1, 4, 0, 2, 1]
    encoder = ctt.symbol.QueueEncoder()
    book = ctt.symbol.huffman.EncoderHuffmanTree(probabilities)
    for symbol in symbols:
        encoder.encode_symbol(symbol, book)
    compressed, compressed_len = encoder.get_compressed()
    assert compressed_len == 23 and compressed.tolist() == [3873993]
    decoder = encoder.get_decoder()
    dbook = ctt.symbol.huffman.DecoderHuffmanTree(probabilities)
    assert [decoder.decode_symbol(dbook) for _ in symbols] == symbols

    probabils = np.array([0.3, 0.2, 0.4, 0.1], dtype=np.float32)
    message = [1, 3, 2, 3, 0, 1, 3, 0, 2, 1, 1, 3, 3, 1, 2, 0, 1, 3, 1]
    encoder = ctt.symbol.QueueEncoder()
    book = ctt.symbol.huffman.EncoderHuffmanTree(probabils)
    for symbol in message:
        encoder.encode_symbol(symbol, book)
    compressed, bitrate = encoder.get_compressed_and_bitrate()
    assert compressed.tolist() == [3756389791, 61358] and bitrate == 48
    decoder = ctt.symbol.QueueDecoder(compressed)
    dbook = ctt.symbol.huffman.DecoderHuffmanTree(probabils)
    assert [decoder.decode_symbol(dbook) for _ in message] == message
    coder = ctt.symbol.StackCoder()
    for symbol in reversed(message):
        coder.encode_symbol(symbol, book)
    compressed, bitrate = coder.get_compressed_and_bitrate()
    assert compressed.tolist() == [2818274807, 129455] and bitrate == 48
    assert [coder.decode_symbol(dbook) for _ in message] == message


# ---------------------------------------------------------------------------
# backends (the cases of tests/test_backends.py, on the port)
# ---------------------------------------------------------------------------


def _model(precision=24, K=50, seed=0):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(K))
    return (ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, precision), rng.choice(K, size=500, p=probs).astype(np.int64))


def test_word_buffer_protocol():
    b = WordBuffer()
    for i in range(100):
        b.append(i)
    assert len(b) == 100 and b[99] == 99 and b.pop() == 99 and len(b) == 99
    b.extend([7, 8, 9])
    assert b.tolist()[-3:] == [7, 8, 9]
    b.truncate(5)
    assert b.tolist() == [0, 1, 2, 3, 4]
    c = b.copy()
    c.append(77)
    assert len(b) == 5 and len(c) == 6
    assert b == [0, 1, 2, 3, 4] and b + [5] == [0, 1, 2, 3, 4, 5]
    np.testing.assert_array_equal(np.asarray(b, dtype=np.uint32),
                                  np.arange(5, dtype=np.uint32))
    with pytest.raises(IndexError, match="pop from empty WordBuffer"):
        WordBuffer().pop()


def test_fixed_capacity_overflow_and_copy():
    b = WordBuffer(capacity=4, fixed=True)
    for i in range(4):
        b.append(i)
    with pytest.raises(CapacityError, match=r"fixed-capacity buffer full \(4 words\)"):
        b.append(4)
    with pytest.raises(CapacityError):
        b.extend([5, 6])
    with pytest.raises(CapacityError, match="capacity 2 < initial length 3"):
        WordBuffer([1, 2, 3], capacity=2)
    wb = WordBuffer(capacity=100, fixed=True)
    for i in range(10):
        wb.append(i)
    c = wb.copy()
    for i in range(90):
        c.append(i)  # the clone kept the headroom
    with pytest.raises(CapacityError):
        c.append(1)


@pytest.mark.parametrize("coder", ["ans", "range", "chain"])
def test_encode_into_preallocated(coder):
    """The routed encodes into a fixed-capacity WordBuffer write the
    growable buffer's words; a buffer too small raises instead of
    growing."""
    model, symbols = _model()
    if coder == "chain":
        data = np.random.RandomState(3).randint(1, 1 << 32, 200, dtype=np.uint32)
        dec = ChainCoderCore.from_binary(data)
        syms = dec.decode_iid_symbols(100, model)
        _, suffix = dec.into_remainders()
        ref_c = ChainCoderCore.from_remainders(suffix)
        ref_c.encode_iid_symbols_reverse(syms, model)
        want = ref_c.into_binary()
        enc = ChainCoderCore.from_remainders(suffix)
        enc.compressed = WordBuffer(capacity=len(want[1]) + 2, fixed=True)
        enc.encode_iid_symbols_reverse(syms, model)
        for a, b in zip(enc.into_binary(), want):
            np.testing.assert_array_equal(a, b)
        return
    Core = AnsCoderCore if coder == "ans" else RangeEncoderCore
    encode = ("encode_iid_symbols_reverse" if coder == "ans"
              else "encode_iid_symbols")
    growable = Core()
    getattr(growable, encode)(symbols, model)
    want = growable.get_compressed()
    fixed = Core.with_write_backend(WordBuffer(capacity=len(want) + 2, fixed=True))
    getattr(fixed, encode)(symbols, model)
    np.testing.assert_array_equal(fixed.get_compressed(), want)
    tiny = Core.with_write_backend(WordBuffer(capacity=2, fixed=True))
    with pytest.raises(CapacityError):
        getattr(tiny, encode)(symbols, model)


def test_callback_sinks_equal_reference():
    """A CallbackSink takes the Python loop (no bulk to hand the codec)
    and sees the JAX package's words."""
    model, symbols = _model()
    seen, seen_ref = [], []
    ans = AnsCoderCore.with_write_backend(CallbackSink(seen.append))
    ans.encode_iid_symbols_reverse(symbols, model)
    rans = RefAns.with_write_backend(ref.backends.CallbackSink(seen_ref.append))
    rans.encode_iid_symbols_reverse(symbols, model)
    assert seen == seen_ref and ans.state == rans.state
    grown = AnsCoderCore()
    grown.encode_iid_symbols_reverse(symbols, model)
    assert seen == list(grown.bulk)
    words, words_ref = [], []
    enc = RangeEncoderCore.with_write_backend(CallbackSink(words.append))
    enc.encode_iid_symbols(symbols, model)
    renc = RefRange.with_write_backend(ref.backends.CallbackSink(words_ref.append))
    renc.encode_iid_symbols(symbols, model)
    assert words == words_ref
    grown = RangeEncoderCore()
    grown.encode_iid_symbols(symbols, model)
    np.testing.assert_array_equal(
        np.array(words + enc._seal_words(), dtype=np.uint64),
        grown.get_compressed().astype(np.uint64))
    with pytest.raises(ValueError, match="write-only"):
        enc.clone()
    with pytest.raises(TypeError, match="CallbackSink is write-only"):
        CallbackSink(print).pop()


def test_iterator_readers():
    model, symbols = _model()
    enc = RangeEncoderCore()
    enc.encode_iid_symbols(symbols, model)
    comp = enc.get_compressed()
    dec = RangeDecoderCore.from_word_iterator(iter(int(w) for w in comp))
    first = dec.decode_iid_symbols(100, model)
    pos, state = dec.pos()
    rest = dec.decode_iid_symbols(len(symbols) - 100, model)
    dec.seek(pos, state)  # back within the memoized prefix
    np.testing.assert_array_equal(dec.decode_iid_symbols(len(symbols) - 100, model), rest)
    np.testing.assert_array_equal(np.concatenate([first, rest]), symbols)
    ans = AnsCoderCore()
    ans.encode_iid_symbols_reverse(symbols, model)
    words = ans.get_compressed()
    dec = AnsCoderCore.from_reversed_compressed_iterator(int(w) for w in reversed(words))
    np.testing.assert_array_equal(dec.decode_iid_symbols(len(symbols), model), symbols)
    with pytest.raises(TypeError, match="StackIterReader is read-only"):
        StackIterReader([1]).append(2)


@pytest.mark.parametrize("W,S,P", [(32, 64, 24), (16, 32, 12), (16, 64, 16), (8, 16, 8)])
def test_grid_over_backends_equals_reference(W, S, P):
    """The (W, S, P) grid with fixed-capacity write backends and iterator
    read sources; the words equal the JAX package's."""
    K = min(50, (1 << P) - 1)
    model, symbols = _model(precision=P, K=K, seed=W * 100 + P)
    symbols = symbols[:200]
    want = RefAns(W, S)
    want.encode_iid_symbols_reverse(symbols, model)
    want = want.get_compressed()
    coder = AnsCoderCore.with_write_backend(
        WordBuffer(capacity=len(want) + 4, fixed=True), W, S)
    coder.encode_iid_symbols_reverse(symbols, model)
    np.testing.assert_array_equal(coder.get_compressed(), want)
    dec = AnsCoderCore.from_reversed_compressed_iterator(
        (int(w) for w in reversed(want)), W, S)
    np.testing.assert_array_equal(dec.decode_iid_symbols(len(symbols), model), symbols)
    rwant = RefRange(W, S)
    rwant.encode_iid_symbols(symbols, model)
    rwant = rwant.get_compressed()
    renc = RangeEncoderCore(W, S)
    renc.encode_iid_symbols(symbols, model)
    np.testing.assert_array_equal(renc.get_compressed(), rwant)
    rdec = RangeDecoderCore.from_word_iterator((int(w) for w in rwant), W, S)
    np.testing.assert_array_equal(rdec.decode_iid_symbols(len(symbols), model), symbols)


def test_range_batch_encode_with_pending_inverted_run():
    """A long held-back (inverted) run before a routed batch encode: the
    words equal the per-symbol path's."""
    model, symbols = _model()

    def build(batch: bool):
        enc = RangeEncoderCore()
        for _ in range(1000):
            enc._encode_cp((1 << 24) - 1, 1, 24)
        assert enc.inverted is not None and enc.inverted[0] > 100
        if batch:
            enc.encode_iid_symbols(symbols, model)
        else:
            for s in symbols:
                enc.encode_symbol(int(s), model)
        return enc.get_compressed()

    np.testing.assert_array_equal(build(True), build(False))


def test_coder_rejects_incompatible_model_precision():
    model, symbols = _model(precision=24)
    with pytest.raises(ValueError, match="incompatible"):
        AnsCoderCore(16, 32).encode_iid_symbols_reverse(symbols[:5], model)
    with pytest.raises(ValueError, match="incompatible"):
        RangeEncoderCore(16, 32).encode_iid_symbols(symbols[:5], model)


def test_range_decoder_pos_seek_short_stream():
    model, _ = _model(precision=12, K=4, seed=3)
    enc = RangeEncoderCore()
    enc.encode_symbol(1, model)
    dec = RangeDecoderCore.from_compressed(enc.get_compressed())
    p, st = dec.pos()
    assert p >= 0
    first = dec.decode_symbol(model)
    dec.seek(p, st)
    assert dec.decode_symbol(model) == first


# ---------------------------------------------------------------------------
# the public surface
# ---------------------------------------------------------------------------

SURFACE = ("backends", "stream", "stream.model", "stream.stack",
           "stream.queue", "stream.chain", "symbol", "symbol.huffman",
           "symbol.exp_golomb", "models", "models.base",
           "models.categorical", "models.quantized", "models.uniform")


@pytest.mark.parametrize("name", SURFACE)
def test_public_names_equal_reference(name):
    port = importlib.import_module(f"constriction_tpu_torch.{name}")
    jax_side = importlib.import_module(f"constriction_tpu.{name}")

    def public(mod):
        return sorted(n for n in dir(mod) if not n.startswith("_"))

    assert public(port) == public(jax_side)
    assert getattr(port, "__all__", None) == getattr(jax_side, "__all__", None)
    for n in public(port):
        a, b = getattr(port, n), getattr(jax_side, n)
        assert type(a).__name__ == type(b).__name__, n
