"""The port's host codec (``constriction_tpu_torch/native``) on the CPU.

Every host function the port routes through the C++ codec is held bit for
bit against its ``*_plain`` numpy version and against the JAX package's
numpy branch (``native.LIB`` of the JAX package set to None, so no case
needs that package's build): the exact-family tables (``exact_ecp``,
``exact_ncore``, ``exact_boundary_tables`` / ``narrow_tables``,
``packed_tables_device``, ``exact_tv_at``), erf / erfc, and the
shared-stream coders (``encode_shared``, ``decode_shared_cdf``,
``build_checkpoints``, ``encode_shared_range``,
``decode_shared_range_cdf``).  Below the codec's size gates the routed
functions take the plain versions, as the JAX package does; the sizes here
sit on both sides of them.  The loader: two processes building into one
empty build root at once, a compiler that does not exist, a library that
does not load; and no source of the port reads an environment variable.
The bindings: every entry of ``native.SIGNATURES``, and the ten coder
entries of the host API and the examples (the nine of the scalar coder
cores, ``ctpu_ilans2_decode_quantized``) and the three state structs
typed as the JAX package binds them.  The per-symbol family decode
(``decode_shared_quantized``) against its plain version (the exact
family's host decode, the port's and the JAX package's) and the round
trip.
Integer coding and f64 special functions: tolerance is equality.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from constriction_tpu import native as ref_native
from constriction_tpu.ops import exact_family as ref_ef
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops.interleaved import LaneConfig as RefCfg
from constriction_tpu.utils import special as ref_special
from constriction_tpu_torch import native
from constriction_tpu_torch.models import (
    BinomialFamily,
    QuantizedFamily,
    fast_quantized_cdf,
)
from constriction_tpu_torch.native import build
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import exact_tables as et
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig
from constriction_tpu_torch.utils import special

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("gaussian", "laplace", "cauchy", "binomial")
NT = 60  # binomial trials: support [0, NT]


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host functions take their numpy branches."""
    monkeypatch.setattr(ref_native, "LIB", None)


def _same(a, b):
    """Equal arrays (or tuples of arrays), dtype and bytes."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if np.isscalar(a) or np.isscalar(b):
        assert a == b
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _models(family, n, seed):
    """(means, scales, min_sym, max_sym) of n models."""
    rng = np.random.RandomState(seed)
    if family == "binomial":
        return (np.full(n, float(NT)), rng.uniform(0.02, 0.98, n), 0, NT)
    means = rng.randn(n) * 30.0
    scales = np.exp(rng.normal(0.4, 0.9, n))
    return means, scales, -100, 100


def _one_flat(n):
    """Sharp gaussians but one flat one, at n // 2, whose core spans the
    support [-100, 100]."""
    means = np.random.RandomState(n).uniform(-50.0, 50.0, n)
    scales = np.full(n, 0.3)
    scales[n // 2] = 400.0
    return means, scales


def _symbols(means, scales, lo, hi, seed):
    rng = np.random.RandomState(seed)
    return np.clip(np.round(means + scales * rng.randn(len(means))), lo, hi
                   ).astype(np.int64)


# ---------------------------------------------------------------------------
# erf / erfc
# ---------------------------------------------------------------------------


def test_erf_native_equals_plain_and_jax():
    rng = np.random.RandomState(3)
    x = np.concatenate([rng.uniform(-7.0, 7.0, 20000),
                        rng.uniform(-0.9, 0.9, 4000),
                        np.array([0.0, -0.0, 1e-300, -1e-300, 30.0, -30.0])])
    with np.errstate(all="ignore"):
        for nat, plain, ref in ((special.erf_native, special.erf_plain,
                                 ref_special.erf),
                                (special.erfc_native, special.erfc_plain,
                                 ref_special.erfc)):
            _same(nat(x), plain(x))
            _same(nat(x), ref(x))
            _same(nat(x.reshape(4001, 6)), plain(x).reshape(4001, 6))
    assert special.ERF in ("scipy", "native")
    _same(special.erf(x), special.erf_plain(x))


# ---------------------------------------------------------------------------
# exact-family host tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("P", [12, 16, 24])
@pytest.mark.parametrize("n", [63, 64, 1000])
def test_exact_ecp_three_way(family, P, n):
    means, scales, lo, hi = _models(family, n, 10 * P + n)
    syms = _symbols(means, scales, lo, hi, n)
    syms[:2] = (lo, hi)  # both support ends
    got = ef.exact_ecp(syms, means, scales, family, lo, hi, P)
    _same(got, ef.exact_ecp_plain(syms, means, scales, family, lo, hi, P))
    _same(got, ref_ef.exact_ecp(syms, means, scales, family, lo, hi, P))


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
@pytest.mark.parametrize("n", [63, 200])
def test_exact_ecp_degenerate_models(family, n):
    """A NaN mean and a zero scale give the same planes on all three paths;
    a negative scale (a decreasing CDF) raises the same ValueError."""
    syms = np.arange(n) % 21 - 10
    for means, scales in ((np.full(n, np.nan), np.ones(n)),
                          (np.zeros(n), np.zeros(n))):
        with np.errstate(all="ignore"):
            got = ef.exact_ecp(syms, means, scales, family, -10, 10, 12)
            _same(got, ef.exact_ecp_plain(syms, means, scales, family, -10,
                                          10, 12))
            _same(got, ref_ef.exact_ecp(syms, means, scales, family, -10, 10,
                                        12))
    for fn in (ef.exact_ecp, ef.exact_ecp_plain, ref_ef.exact_ecp):
        with pytest.raises(ValueError,
                           match="invalid underlying continuous"):
            fn(syms, np.zeros(n), -np.ones(n), family, -10, 10, 12)
        with pytest.raises(ValueError, match="symbol outside support"):
            fn(syms + 30, np.zeros(n), np.ones(n), family, -10, 10, 12)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("P", [12, 24])
def test_exact_ncore_three_way(family, P):
    means, scales, lo, hi = _models(family, 3000, P)
    got = ef.exact_ncore(means, scales, family, lo, hi, P)
    _same(got, ef.exact_ncore_plain(means, scales, family, lo, hi, P))
    _same(got, ref_ef.exact_ncore(means, scales, family, lo, hi, P))
    # repeated (mean, scale) pairs: the codec probes each pair once
    rep = np.arange(4096) % 97
    _same(ef.exact_ncore(means[rep], scales[rep], family, lo, hi, P),
          ef.exact_ncore_plain(means[rep], scales[rep], family, lo, hi, P))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("P", [12, 16, 24])
@pytest.mark.parametrize("cmax", [None, 220])
def test_exact_boundary_tables_three_way(family, P, cmax):
    """cmax=None sizes the width to the largest core; 220 is above any core
    of the 201-symbol support."""
    means, scales, lo, hi = _models(family, 700, P)
    args = (means, scales, family, lo, hi, P, cmax)
    got = ef.exact_boundary_tables(*args)
    _same(got, ef.exact_boundary_tables_plain(*args))
    _same(got, ref_ef.exact_boundary_tables(*args))


@pytest.mark.parametrize("family", ["gaussian", "laplace", "binomial"])
def test_narrow_tables_three_way(family):
    """narrow_tables (S=32 decode tables, host built) equals the plain
    boundary tables and the JAX package's, packed and transposed."""
    P, nsteps, R = 12, 3, 2
    n = nsteps * R * 128
    means, scales, lo, hi = _models(family, n, 7)
    for cmax in (None, 204):
        tabs4, cm = ef.narrow_tables(means, scales, family, lo, hi, P, cmax,
                                     nsteps, R)
        for builder in (ef.exact_boundary_tables_plain,
                        ref_ef.exact_boundary_tables):
            aux, core = builder(means, scales, family, lo, hi, P, cm)
            rows, _ = ef.pack_decode_tables(aux, core, P)
            want = rows.reshape(nsteps, R, 128, -1).transpose(0, 3, 1, 2)
            _same(tabs4, np.ascontiguousarray(want))


@pytest.mark.parametrize("P", [12, 24])
def test_boundary_tables_past_cmax_raise(P):
    """A flat model whose core exceeds cmax raises ValueError on all three
    paths (the codec's message names the symbol)."""
    means, scales = _one_flat(300)
    for fn in (ef.exact_boundary_tables, ef.exact_boundary_tables_plain,
               ref_ef.exact_boundary_tables):
        with pytest.raises(ValueError, match="cmax"):
            fn(means, scales, "gaussian", -100, 100, P, 20)
    with pytest.raises(ValueError, match="core of symbol 150 needs more"):
        ef.exact_boundary_tables(means, scales, "gaussian", -100, 100, P, 20)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy",
                                    "binomial"])
@pytest.mark.parametrize("repeated", [False, True])
def test_packed_tables_device_three_way(family, repeated):
    """Unique pairs take the codec's fused fill + transpose, repeated pairs
    the deduplicated rows and the codec's transpose; a cmax well above the
    tight width is refilled at it on every path."""
    nsteps, R = 2, 2
    n = nsteps * R * 128
    means, scales, lo, hi = _models(family, n, 11)
    if repeated:
        idx = np.arange(n) % 37
        means, scales = means[idx], scales[idx]
    tight = int(ef.exact_ncore(means, scales, family, lo, hi, 24).max())
    for cmax in (tight, min(255, tight + 13)):
        args = (means, scales, family, lo, hi, 24, cmax, nsteps, R)
        got = ef.packed_tables_device(*args)
        assert got[1] == ef._tight(tight)
        _same(got, ef.packed_tables_device_plain(*args))
        _same(got, ref_ef.packed_tables_device(*args))
        rows = ef._packed_table_rows(means, scales, family, lo, hi, 24, cmax)
        _same(rows, ef._packed_table_rows_plain(means, scales, family, lo,
                                                hi, 24, cmax))
        _same(rows, ref_ef._packed_table_rows(means, scales, family, lo, hi,
                                              24, cmax))


def test_packed_tables_past_cmax_raise():
    means, scales = _one_flat(256)
    for fn in (ef.packed_tables_device, ef.packed_tables_device_plain,
               ref_ef.packed_tables_device):
        with pytest.raises(ValueError, match="cmax"):
            fn(means, scales, "gaussian", -100, 100, 24, 20, 1, 2)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy",
                                    "binomial"])
def test_exact_tv_at_three_way(family):
    means, scales, lo, hi = _models(family, 500, 13)
    rng = np.random.RandomState(14)
    sym_i = rng.randint(0, 500, 6000)
    svals = rng.randint(lo, hi + 1, 6000)
    got = et.exact_tv_at(family, lo, hi, 24, means, scales, sym_i, svals)
    assert got.dtype == np.uint32
    _same(got, et.exact_tv_at_plain(family, lo, hi, 24, means, scales,
                                    sym_i, svals))
    free = float((1 << 24) - 1 - (hi - lo))
    ref = ref_ef._trunc(free * ref_ef._cdf(
        family, svals.astype(np.float64) - 0.5, means[sym_i],
        scales[sym_i])).astype(np.uint32)
    _same(got, ref)
    with pytest.raises(ValueError, match="past the models"):
        et.exact_tv_at(family, lo, hi, 24, means, scales, [500], [0])


# ---------------------------------------------------------------------------
# shared-stream coders
# ---------------------------------------------------------------------------


def _stream_data(P, n, seed, K=60):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, 0.7))
    cdf = np.asarray(fast_quantized_cdf(probs, P), dtype=np.uint32)
    syms = rng.choice(K, size=n, p=probs)
    c = cdf.astype(np.uint64)
    return cdf, syms, c[syms], c[syms + 1] - c[syms]


PRESETS = [(16, 32, 12), (32, 64, 24)]


@pytest.mark.parametrize("W,S,P", PRESETS)
@pytest.mark.parametrize("n", [255, 256, 5000])
@pytest.mark.parametrize("seeded", [False, True])
def test_encode_decode_shared_three_way(W, S, P, n, seeded):
    cfg = LaneConfig(128, W, S, P)
    rcfg = RefCfg(128, W, S, P)
    cdf, syms, cums, probs = _stream_data(P, n, n + S)
    seeds = None
    if seeded:
        rng = np.random.RandomState(n)
        seeds = (np.uint64(1 << (S - W)) + rng.randint(
            0, 1 << 30, 128).astype(np.uint64)).astype(
                np.uint64 if S > 32 else np.uint32)
    enc = il2.encode_shared(cums, probs, cfg, seeds)
    _same(enc, il2.encode_shared_plain(cums, probs, cfg, seeds))
    _same(enc, ref_il2.encode_shared(cums, probs, rcfg, seeds))
    states, stream = enc
    dec = il2.decode_shared_cdf(states, stream, n, cdf, cfg,
                                return_final_states=True)
    _same(dec, il2.decode_shared_cdf_plain(states, stream, n, cdf, cfg,
                                           return_final_states=True))
    _same(dec, ref_il2.decode_shared_cdf(states, stream, n, cdf, rcfg,
                                         return_final_states=True))
    assert np.array_equal(dec[0], syms)
    if seeded:
        assert np.array_equal(dec[1], seeds)


@pytest.mark.parametrize("W,S,P", PRESETS + [(8, 32, 8)])
def test_truncated_stream_zero_fills(W, S, P):
    """Reads past the end of a cut stream give zero words on the codec's
    path too, as in the plain versions (and the kernels); the checkpoint
    offsets run on past the end alike, and a cut range stream decodes, or
    fails its model check at the same symbol, alike."""
    cfg = LaneConfig(128, W, S, P)
    cdf, _, cums, probs = _stream_data(P, 4000, 3)
    states, stream = il2.encode_shared(cums, probs, cfg)
    cut = stream[:len(stream) // 3]
    _same(il2.decode_shared_cdf(states, cut, 4000, cdf, cfg,
                                return_final_states=True),
          il2.decode_shared_cdf_plain(states, cut, 4000, cdf, cfg,
                                      return_final_states=True))
    _same(il2.build_checkpoints(states, cut, 4000, cdf, cfg, 2),
          il2.build_checkpoints_plain(states, cut, 4000, cdf, cfg, 2))
    points, rstream = il2.encode_shared_range(cums, probs, cfg)
    for cut_len in (len(rstream) // 3, len(rstream) - 5):
        rcut = rstream[:cut_len]
        got, want = (_outcome(fn, points, rcut, 4000, cdf, cfg)
                     for fn in (il2.decode_shared_range_cdf,
                                il2.decode_shared_range_cdf_plain))
        assert got[0] == want[0]
        _same(got[1], want[1])


def _outcome(fn, *args):
    """("ok", result) or ("error", message) of a call."""
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "error", str(e)


def test_decode_shared_leaves_states_alone():
    """The codec writes final states back into its input: the caller's
    array must not change."""
    cfg = LaneConfig(128, 16, 32, 12)
    cdf, _, cums, probs = _stream_data(12, 3000, 1)
    states, stream = il2.encode_shared(cums, probs, cfg)
    before = states.copy()
    il2.decode_shared_cdf(states, stream, 3000, cdf, cfg)
    _same(states, before)


def test_encode_shared_zero_prob_raises():
    cfg = LaneConfig(128, 16, 32, 12)
    _, _, cums, probs = _stream_data(12, 3000, 2)
    probs[7] = 0
    with pytest.raises(ValueError, match="probs must be positive"):
        il2.encode_shared(cums, probs, cfg)


@pytest.mark.parametrize("W,S,P,interval", [(16, 32, 12, 3), (16, 32, 16, 1),
                                            (8, 32, 8, 5), (32, 64, 24, 2)])
def test_build_checkpoints_three_way(W, S, P, interval):
    cfg = LaneConfig(256, W, S, P)
    cdf, _, cums, probs = _stream_data(P, 7000, P + interval)
    states, stream = il2.encode_shared(cums, probs, cfg)
    got = il2.build_checkpoints(states, stream, 7000, cdf, cfg, interval)
    assert len(got[0]) == -(-(-(-7000 // 256)) // interval) - 1
    _same(got, il2.build_checkpoints_plain(states, stream, 7000, cdf, cfg,
                                           interval))
    _same(got, ref_il2.build_checkpoints(states, stream, 7000, cdf,
                                         RefCfg(256, W, S, P), interval))


@pytest.mark.parametrize("W,S,P", PRESETS)
@pytest.mark.parametrize("n", [100, 256, 6000])
def test_encode_shared_range_presets(W, S, P, n):
    """At the presets the codec's range encoder equals the plain two-phase
    encoder; the decoders agree with each other and the JAX package's."""
    cfg = LaneConfig(128, W, S, P)
    cdf, syms, cums, probs = _stream_data(P, n, n + W)
    enc = il2.encode_shared_range(cums, probs, cfg)
    _same(enc, il2.encode_shared_range_plain(cums, probs, cfg))
    dec = il2.decode_shared_range_cdf(*enc, n, cdf, cfg)
    _same(dec, il2.decode_shared_range_cdf_plain(*enc, n, cdf, cfg))
    _same(dec, ref_il2.decode_shared_range_cdf(*enc, n, cdf,
                                               RefCfg(128, W, S, P)))
    assert np.array_equal(dec, syms)


@pytest.mark.parametrize("W,S,P", [(8, 32, 8), (16, 64, 16)])
def test_encode_shared_range_other_configs(W, S, P):
    """A (W, S) the plain encoder does not take: the codec's stream
    round-trips through the port's plain decoder and the JAX package's
    numpy one."""
    n = 5000
    cfg = LaneConfig(128, W, S, P)
    cdf, syms, cums, probs = _stream_data(P, n, W + S)
    points, stream = il2.encode_shared_range(cums, probs, cfg)
    assert points.dtype == (np.uint64 if S > 32 else np.uint32)
    with pytest.raises(ValueError, match="covers"):
        il2.encode_shared_range_plain(cums, probs, cfg)
    for dec in (il2.decode_shared_range_cdf(points, stream, n, cdf, cfg),
                il2.decode_shared_range_cdf_plain(points, stream, n, cdf,
                                                  cfg),
                ref_il2.decode_shared_range_cdf(points, stream, n, cdf,
                                                RefCfg(128, W, S, P))):
        assert np.array_equal(dec, syms)


def test_range_decode_corrupt_raises_alike():
    cfg = LaneConfig(128, 16, 32, 12)
    cdf, _, cums, probs = _stream_data(12, 4000, 9)
    points, stream = il2.encode_shared_range(cums, probs, cfg)
    bad = np.full_like(points, 0xFFFFFFFF)
    for fn in (il2.decode_shared_range_cdf,
               il2.decode_shared_range_cdf_plain):
        with pytest.raises(ValueError, match="inconsistent"):
            fn(bad, stream, 4000, cdf, cfg)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

_CHILD = """
import sys
import numpy as np
from constriction_tpu_torch import native
from constriction_tpu_torch.native import build
lib = native.load(build.build(root=sys.argv[1]))
x = np.linspace(-6.0, 6.0, 4097)
out = np.empty_like(x)
lib.ctpu_erf_array(x, out, x.size)
print(build.library_path(root=sys.argv[1]), out.tobytes().hex()[:4096])
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Two processes building into one empty root at once both load a
    working library and compute the same values."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "2"
    root = str(tmp_path / "root")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, root], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    path = outs[0][0].split()[0]
    assert os.path.exists(path)
    leftovers = [f for f in os.listdir(os.path.dirname(path))
                 if f.endswith((".tmp", ".o"))]
    assert not leftovers


def test_missing_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot run the C"):
        build.build(root=str(tmp_path), cxx=str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="failed"):
        build.build(root=str(tmp_path), cxx="false")
    assert not any(f.endswith(".so") for _, _, fs in os.walk(tmp_path)
                   for f in fs)


def test_load_failure_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="cannot load the host codec"):
        native.load(str(tmp_path / "missing.so"))

    def broken(*a, **k):
        raise RuntimeError("no compiler here")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "build", broken)
    means, scales, lo, hi = _models("gaussian", 200, 1)
    syms = _symbols(means, scales, lo, hi, 1)
    with pytest.raises(RuntimeError, match="no compiler here"):
        ef.exact_ecp(syms, means, scales, "gaussian", lo, hi, 12)
    cfg = LaneConfig(128, 16, 32, 12)
    with pytest.raises(RuntimeError, match="no compiler here"):
        il2.encode_shared_range(np.zeros(10, np.uint32),
                                np.ones(10, np.uint32), cfg)


def test_port_reads_no_environment():
    """No source of the port (Python, C++, CUDA) reads an environment
    variable: nothing switches a path or finds a tool through one."""
    pkg = os.path.join(REPO, "constriction_tpu_torch")
    hits = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith((".py", ".cpp", ".cu", ".cuh")):
                continue
            with open(os.path.join(root, name)) as f:
                for i, line in enumerate(f, 1):
                    if any(k in line for k in ("os.environ", "getenv",
                                               "environ[")):
                        hits.append(f"{name}:{i}: {line.strip()}")
    assert not hits, hits


# the coder entries the host API's cores and the examples' host family
# decode call, and the JAX package's argument types for them
# (constriction_tpu/native/__init__.py's _bind)
CODER_ENTRIES = (
    "ctpu_ans_encode_reverse", "ctpu_ans_decode_lookup",
    "ctpu_ans_decode_cdf", "ctpu_ans_decode_quantized", "ctpu_range_encode",
    "ctpu_range_decode_lookup", "ctpu_range_decode_quantized",
    "ctpu_chain_decode_lookup", "ctpu_chain_encode_reverse",
    "ctpu_ilans2_decode_quantized")


def _ctype_name(t) -> str:
    """A ctypes type by name: ndpointers by dtype, pointers by target."""
    if hasattr(t, "_dtype_"):
        return f"ndpointer({t._dtype_})"
    if hasattr(t, "_type_") and isinstance(t._type_, type):
        return f"POINTER({t._type_.__name__})"
    return t.__name__ if t is not None else "None"


class _Recorder:
    """Stands in for a ctypes library: each entry is a namespace that keeps
    the restype and argtypes set on it."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_signatures_bind_every_entry():
    lib = native.library()
    for name, (restype, argtypes) in native.SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.argtypes == argtypes and fn.restype == restype
    assert native.DIST_KIND == ref_native.DIST_KIND
    # the ten coder entries, typed as the JAX package binds them: its
    # _bind run on a recorder instead of its library
    ref_lib = ref_native._bind(_Recorder())
    for name in CODER_ENTRIES:
        restype, argtypes = native.SIGNATURES[name]
        want = getattr(ref_lib, name)
        assert _ctype_name(restype) == _ctype_name(want.restype), name
        assert [_ctype_name(t) for t in argtypes] == [
            _ctype_name(t) for t in want.argtypes], name
    for struct in ("RangeEncState", "RangeDecState", "ChainState"):
        assert [(f, t.__name__) for f, t in getattr(native, struct)._fields_] == [
            (f, t.__name__) for f, t in getattr(ref_native, struct)._fields_]


# ---------------------------------------------------------------------------
# the per-symbol family decode (ctpu_ilans2_decode_quantized)
# ---------------------------------------------------------------------------

QUANTIZED_LANES = 16


def _family(family, n, P, seed):
    """(the port's family model, its symbols, the exact family's host
    decode arguments (means, scales, family, min_sym, max_sym)) of n
    seeded models."""
    means, scales, lo, hi = _models(family, n, seed)
    if family == "binomial":
        syms = np.random.RandomState(seed + 1).binomial(NT, scales)
        fam = BinomialFamily(np.full(n, NT), scales, P)
    else:
        syms = _symbols(means, scales, lo, hi, seed + 1)
        fam = QuantizedFamily(family, lo, hi, means, scales, P)
    return fam, syms, (means, scales, family, lo, hi)


def _plain_decodes(states, stream, n, args, cfg):
    """The plain version of ``decode_shared_quantized``: the port's exact
    family host decode, held against the JAX package's."""
    W, S, P = cfg.word_bits, cfg.state_bits, cfg.precision
    plain = ef.decode_family_exact_host(states, stream, *args, cfg, n)
    _same(plain, ref_ef.decode_family_exact_host(
        states, stream, *args, RefCfg(cfg.num_lanes, W, S, P), n))
    return plain.astype(np.int32)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [63, 64, 1000])
@pytest.mark.parametrize("P", [12, 16])
def test_decode_shared_quantized_two_way(family, n, P):
    """The codec's decode equals its plain version (the exact family's
    host decode, the port's and the JAX package's), and both give back
    the symbols the family's own (cum, prob) encoded."""
    cfg = LaneConfig(QUANTIZED_LANES, 16, 32, P)
    fam, syms, args = _family(family, n, P, n + P)
    states, stream = il2.encode_shared(*fam.ecp_all(syms), cfg)
    got = il2.decode_shared_quantized(states, stream, n, fam, cfg)
    _same(got, _plain_decodes(states, stream, n, args, cfg))
    _same(got, syms.astype(np.int32))


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_decode_shared_quantized_cut_stream(family):
    """With the stream cut short, reads past its end give zero words in
    the codec and in the plain version: the same symbols, not the
    message."""
    n = 1000
    cfg = LaneConfig(QUANTIZED_LANES, 16, 32, 12)
    fam, syms, args = _family(family, n, 12, 5)
    states, stream = il2.encode_shared(*fam.ecp_all(syms), cfg)
    cut = stream[:len(stream) // 2]
    got = il2.decode_shared_quantized(states, cut, n, fam, cfg)
    _same(got, _plain_decodes(states, cut, n, args, cfg))
    assert not np.array_equal(got, syms)


def test_decode_shared_quantized_checks():
    fam, syms, _ = _family("gaussian", 100, 12, 0)
    cfg = LaneConfig(QUANTIZED_LANES, 16, 32, 12)
    states, stream = il2.encode_shared(*fam.ecp_all(syms), cfg)
    decode = il2.decode_shared_quantized
    with pytest.raises(ValueError, match="S=32"):
        decode(states, stream, 100, fam, LaneConfig(QUANTIZED_LANES, 32, 64,
                                                    12))
    with pytest.raises(ValueError, match="precision"):
        decode(states, stream, 100, fam, LaneConfig(QUANTIZED_LANES, 16, 32,
                                                    16))
    with pytest.raises(ValueError, match="num_lanes"):
        decode(states[:-1], stream, 100, fam, cfg)
    with pytest.raises(ValueError, match="models"):
        decode(states, stream, 99, fam, cfg)
    with pytest.raises(ValueError, match="one trial count"):
        decode(states, stream, 100,
               BinomialFamily(np.arange(100) + 1, np.full(100, 0.5), 12),
               cfg)
