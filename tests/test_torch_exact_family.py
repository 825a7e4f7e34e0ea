"""The port's reference-exact family path against the JAX package's, exactly.

Held here, on inputs made with numpy from a seed: the copy of
``utils/special.py`` (bit for bit), the host tables (``exact_ecp``,
``exact_ncore``, ``exact_boundary_tables``, ``pack_decode_tables``,
``packed_tables_device``) and the grouping plan, the on-card builder's
window evaluation (every entry it calls unambiguous equals the host
oracle), ``derive_pack`` and the whole builder pipeline on the CPU, the
kernel twins against the numpy oracles, one interpret-mode run each of the
JAX package's S=64 segment decoder and encoder, and the facade at
``device="cpu"``.  The JAX package's host functions run their numpy
branches (``native.LIB`` set to None), so none depends on its C++ build.
Integer coding: tolerance is equality.
"""

import math

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu.ops import exact_family as ref_ef
from constriction_tpu.ops import exact_tables_jax as etj
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops.interleaved import LaneConfig as RefCfg
from constriction_tpu.utils import special as ref_special
from constriction_tpu_torch import convert
from constriction_tpu_torch import cuda as ctt
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import exact_tables as et
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig
from constriction_tpu_torch.utils import special

CONT = ("gaussian", "laplace", "cauchy")


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host functions take their numpy branches."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(L, P=24):
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=P)


def _ref_cfg(L, P=24):
    return RefCfg(num_lanes=L, word_bits=32, state_bits=64, precision=P)


def _data(n, seed, spread=20.0, mu=0.4, sd=0.6):
    rng = np.random.RandomState(seed)
    means = rng.randn(n) * spread
    scales = np.exp(rng.normal(mu, sd, n))
    syms = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
                   ).astype(np.int64)
    return means, scales, syms


def _edge_params(n, seed):
    """Wide spread with sharp, flat and support-edge models (cores that
    touch max_sym, sharp steps, means far outside the support)."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n) * 40.0
    scales = np.exp(rng.normal(0.3, 1.1, n))
    means[:10] = [-108.3, 108.3, -99.9999, 99.9999, 0.0, -50.0, 1e-6, 3e4,
                  100.0, -100.0]
    scales[:10] = [0.02, 0.02, 1e-3, 5e-4, 1e-4, 60.0, 0.01, 5.0, 0.3, 0.3]
    return means, scales


def _binomial_params(n, seed, NT=60):
    ps = np.random.RandomState(seed).uniform(0.02, 0.98, n)
    return np.full(n, float(NT)), ps


# ---------------------------------------------------------------------------
# utils/special.py
# ---------------------------------------------------------------------------


def _probe_args():
    rng = np.random.RandomState(99)
    return np.concatenate([
        rng.uniform(-6.5, 6.5, 4096), rng.uniform(-0.9, 0.9, 1024),
        np.linspace(-30.0, 30.0, 257), rng.uniform(-700.0, 700.0, 2048),
        rng.standard_cauchy(2048),
        np.array([0.0, -0.0, 1e-300, -1e-300, 0.84375, 1.25, 2.857, 6.0,
                  709.7, -745.0]),
    ])


def test_special_functions_bit_identical():
    x = _probe_args()
    with np.errstate(over="ignore", under="ignore"):
        for name in ("erf", "erfc", "_exp", "_atan"):
            a = getattr(special, name)(x)
            b = getattr(ref_special, name)(x)
            assert a.tobytes() == b.tobytes(), name
    assert special.PICKED["erf"] in ("scipy", "math")
    erf_ref = np.asarray([math.erf(v) for v in x[:512]])
    assert special.erf(x[:512]).tobytes() == erf_ref.tobytes()


@pytest.mark.parametrize("fn", ["gaussian_cdf", "laplace_cdf", "cauchy_cdf"])
def test_continuous_cdfs_bit_identical(fn):
    rng = np.random.RandomState(len(fn))
    x = rng.uniform(-150, 150, 20000)
    mean = rng.uniform(-110, 110, 20000)
    scale = np.exp(rng.uniform(np.log(1e-3), np.log(60.0), 20000))
    a = getattr(special, fn)(x, mean, scale)
    b = getattr(ref_special, fn)(x, mean, scale)
    assert a.tobytes() == b.tobytes()


def test_binomial_cdf_bit_identical():
    rng = np.random.RandomState(5)
    nt = rng.randint(1, 255, 3000).astype(np.float64)
    p = np.concatenate([rng.uniform(0, 1, 2990), [0.0, 1.0, 1e-9, 1 - 1e-9,
                                                   0.5, 0.5, 0.25, 0.75,
                                                   0.999, 0.001]])
    x = rng.uniform(-3, 260, 3000)
    a = special.binomial_cdf(x, nt, p)
    b = ref_special.binomial_cdf(x, nt, p)
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# host tables and the grouping plan
# ---------------------------------------------------------------------------


TABLE_CASES = [
    ("gaussian", -100, 100, 24), ("laplace", -100, 100, 24),
    ("cauchy", -100, 100, 24), ("gaussian", -100, 100, 17),
    ("laplace", -30, 60, 17), ("binomial", 0, 60, 24),
    ("binomial", 0, 60, 17),
]


def _case_params(family, n, seed):
    if family == "binomial":
        return _binomial_params(n, seed)
    return _edge_params(n, seed)


@pytest.mark.parametrize("family,lo,hi,P", TABLE_CASES)
def test_host_tables_match(family, lo, hi, P):
    n = 384
    means, scales = _case_params(family, n, seed=P + hi)
    nc = ef.exact_ncore(means, scales, family, lo, hi, P)
    np.testing.assert_array_equal(
        nc, ref_ef.exact_ncore(means, scales, family, lo, hi, P))
    rng = np.random.RandomState(P)
    syms = rng.randint(lo, hi + 1, n)
    got = ef.exact_ecp(syms, means, scales, family, lo, hi, P)
    ref = ref_ef.exact_ecp(syms, means, scales, family, lo, hi, P)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    aux, core = ef.exact_boundary_tables(means, scales, family, lo, hi, P)
    r_aux, r_core = ref_ef.exact_boundary_tables(means, scales, family, lo,
                                                 hi, P)
    np.testing.assert_array_equal(aux, r_aux)
    np.testing.assert_array_equal(core, r_core)
    tabs, cm = ef.pack_decode_tables(aux, core, P)
    r_tabs, r_cm = ref_ef.pack_decode_tables(r_aux, r_core, P)
    assert cm == r_cm
    np.testing.assert_array_equal(tabs, r_tabs)
    cmax = int(nc.max()) + 5
    got4 = ef.packed_tables_device(means, scales, family, lo, hi, P, cmax, 3,
                                   1)
    ref4 = ref_ef.packed_tables_device(means, scales, family, lo, hi, P, cmax,
                                       3, 1)
    assert got4[1] == ref4[1]
    np.testing.assert_array_equal(got4[0], ref4[0])
    # round trip through the port's tensor layout
    t = convert.exact_tables_to_torch(ref4[0])
    assert t.shape == (3, ref4[0].shape[1], 128) and t.dtype == torch.int32
    np.testing.assert_array_equal(convert.exact_tables_from_torch(t),
                                  ref4[0])


def test_converters_round_trip():
    rng = np.random.RandomState(12)
    means, scales = rng.randn(300) * 1e3, np.exp(rng.randn(300))
    m_t, s_t = convert.params64_to_torch(means, scales)
    assert m_t.dtype == s_t.dtype == torch.float64
    back = convert.params64_from_torch(m_t, s_t)
    assert back[0].tobytes() == means.tobytes()
    assert back[1].tobytes() == scales.tobytes()
    cums = rng.randint(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    probs = rng.randint(1, 1 << 24, 300).astype(np.uint32)
    c_t, p_t = convert.ecp_to_torch(cums, probs, 128)
    assert c_t.shape == p_t.shape == (3, 128) and c_t.dtype == torch.int32
    # padded past n with (cum 0, prob 1), as encode_tables_pallas pads
    assert int(c_t.reshape(-1)[300:].abs().sum()) == 0
    assert bool((p_t.reshape(-1)[300:] == 1).all())
    for a, b in zip(convert.ecp_from_torch(c_t, p_t, 300), (cums, probs)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        convert.ecp_to_torch(cums, probs[:-1], 128)


def test_packed_tables_dedup_matches():
    """Repeated (mean, scale) pairs take the memoized path."""
    means = np.repeat(np.linspace(-60, 60, 24), 32)
    scales = np.tile(np.array([0.3, 1.0, 4.0, 9.0]), 192)
    for family in ("gaussian", "cauchy"):
        got = ef.packed_tables_device(means, scales, family, -100, 100, 24,
                                      255, 6, 1)
        ref = ref_ef.packed_tables_device(means, scales, family, -100, 100,
                                          24, 255, 6, 1)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0], ref[0])


def test_table_errors_match():
    means, scales = _edge_params(64, seed=2)
    for fn in (ef.exact_boundary_tables, ref_ef.exact_boundary_tables):
        with pytest.raises(ValueError, match="cmax"):
            fn(means, scales * 50, "gaussian", -100, 100, 24, cmax=8)
    for fn in (ef.exact_ecp, ref_ef.exact_ecp):
        with pytest.raises(ValueError, match="outside support"):
            fn(np.array([101]), means[:1], scales[:1], "gaussian", -100, 100,
               24)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy",
                                    "binomial"])
def test_group_plan_matches(family):
    n, L = 5000, 256
    if family == "binomial":
        means, scales = _binomial_params(n, seed=3)
        lo, hi = 0, 60
    else:
        means, scales = _edge_params(n, seed=3)
        means = means[:n] * 0.5
        lo, hi = -100, 100
    for max_segments in (3, 10):
        perm, segs = ef.group_plan(means, scales, family, lo, hi, 24, L, n,
                                   max_segments)
        r_perm, r_segs = ref_ef.group_plan(means, scales, family, lo, hi, 24,
                                           L, n, max_segments)
        np.testing.assert_array_equal(perm, r_perm)
        assert segs == r_segs


def test_segment_dp_matches():
    rng = np.random.RandomState(8)
    for _ in range(20):
        stepw = np.sort(rng.choice(np.arange(4, 260, 4), rng.randint(1, 60)))
        for k in (1, 3, 10):
            assert ef._segment_dp(stepw, k) == ref_ef._segment_dp(stepw, k)


# ---------------------------------------------------------------------------
# the on-card builder on the CPU (the twins of kernel 18 and derive_pack)
# ---------------------------------------------------------------------------


def _window_grid(family, n, seed):
    """Parameters whose windows cross each family's saturation band: the
    standardized argument reaches sat_threshold(family) inside the window
    for a share of the symbols."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-110, 110, n)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(12.0), n))
    if family != "cauchy":
        t_star = et.sat_threshold(family)
        k = n // 4
        # put s - 1/2 = mean + t* scale (*sqrt2 for the erf argument) at a
        # window position for a quarter of the symbols
        mul = t_star * (math.sqrt(2.0) if family == "gaussian" else 1.0)
        scales[:k] = rng.uniform(0.5, 3.0, k)
        means[:k] = rng.randint(-80, 60, k) + 0.5 - mul * scales[:k] \
            + rng.uniform(-1e-7, 1e-7, k)
        CL = ef._EST_C[family][0]
        ws = np.clip(np.ceil(means - CL * scales) - 3.0, -99, 100
                     ).astype(np.int64)
        W = 64
    else:
        ws = np.full(n, -99, np.int64)
        W = 201 + 16
    return means, scales, ws, W


@pytest.mark.parametrize("family", CONT)
def test_eval_window_unambiguous_entries_exact(family):
    n = 2048 if family != "cauchy" else 512
    means, scales, ws, W = _window_grid(family, n, seed=len(family))
    assert n * W >= 100_000
    m_t, s_t = convert.params64_to_torch(means, scales)
    ws_t = torch.from_numpy(ws.astype(np.int32))
    before = dict(ef.LAUNCHES)
    tv, amb = et.eval_window(m_t, s_t, ws_t, family, -100, 100, 24, W)
    assert ef.LAUNCHES == before  # the twin ran: no kernel launch counted
    tv, amb = tv.numpy().reshape(-1), amb.numpy().reshape(-1)
    svals = (ws[:, None] + np.arange(W)[None, :]).reshape(-1)
    sym_i = np.repeat(np.arange(n), W)
    live = svals <= 100
    exact = np.full(n * W, (1 << 24) - 1 - 200, np.int64)
    exact[live] = et.exact_tv_at(family, -100, 100, 24, means, scales,
                                 sym_i[live], svals[live])
    assert not np.any(~amb & (tv != exact))
    assert amb.mean() < 0.2
    if family != "cauchy":  # the band is reached and stays ambiguous
        t = ((svals - 0.5) - means[sym_i]) / (
            scales[sym_i] * (math.sqrt(2.0) if family == "gaussian" else 1))
        t_star, eps, _ = et._band(family)
        in_band = live & (np.abs(t - t_star) <= eps)
        assert in_band.sum() > 0 and amb[in_band].all()
        assert np.any(live & (t > t_star + eps))
    # the JAX package's f64 evaluator holds the same contract on the inputs
    r_tv, r_amb = etj.eval_window(means, scales, ws.astype(np.int32),
                                  family=family, min_sym=-100, max_sym=100,
                                  precision=24, W=W)
    r_tv = np.asarray(r_tv).reshape(-1)
    r_amb = np.asarray(r_amb).reshape(-1)
    assert not np.any(~r_amb & (r_tv != exact))
    # where both evaluators decide, they agree
    both = ~amb & ~r_amb
    np.testing.assert_array_equal(tv[both], r_tv[both])


def test_sat_threshold_and_tv_at_match():
    for family in CONT:
        assert et.sat_threshold(family) == etj.sat_threshold(family)
    rng = np.random.RandomState(4)
    means, scales = _edge_params(300, seed=4)
    sym_i = rng.randint(0, 300, 5000)
    svals = rng.randint(-99, 101, 5000)
    for family in CONT:
        free = float((1 << 24) - 1 - 200)
        want = ref_ef._trunc(free * ref_ef._cdf(
            family, svals - 0.5, means[sym_i], scales[sym_i]))
        np.testing.assert_array_equal(
            et.exact_tv_at(family, -100, 100, 24, means, scales, sym_i,
                           svals), want)


@pytest.mark.parametrize("family", CONT)
def test_derive_pack_matches(family):
    """The same window values and patches through both derive_packs."""
    L, nsteps = 128, 3
    n = nsteps * L
    means, scales = _edge_params(n, seed=11)
    nc = ef.exact_ncore(means, scales, family, -100, 100, 24)
    cmax = min(max(int(nc.max()), 1), 255)
    CL = ef._EST_C[family][0]
    ws = (np.full(n, -99, np.int64) if np.isinf(CL) else np.clip(
        np.ceil(means - CL * scales) - 3.0, -99, 100).astype(np.int64))
    W = min(cmax + 16, 201 + 16)
    m_t, s_t = convert.params64_to_torch(means, scales)
    ws_t = torch.from_numpy(ws.astype(np.int32))
    tv, amb = et.eval_window_plain(m_t, s_t, ws_t, family, -100, 100, 24, W)
    tv_np = tv.numpy().copy()  # derive_pack patches tv in place
    idx = et.ambig_indices(amb)
    assert int(et.ambig_count(amb)) == idx.numel()
    idx_h = idx.numpy()
    vals = et.exact_tv_at(family, -100, 100, 24, means, scales,
                          idx_h // W, ws[idx_h // W] + idx_h % W)
    # the JAX package pads its index list with the scratch slot n * W
    pad_idx = np.concatenate([idx_h, np.full(5, n * W)])
    pad_vals = np.concatenate([vals.astype(np.int32), np.zeros(5, np.int32)])
    got = et.derive_pack(tv, ws_t, torch.from_numpy(pad_idx),
                         torch.from_numpy(pad_vals), -100, 100, 24, cmax,
                         nsteps, L)
    import jax.numpy as jnp

    ref = etj.derive_pack(jnp.asarray(tv_np), jnp.asarray(ws, jnp.int32),
                          jnp.asarray(pad_idx, jnp.int32),
                          jnp.asarray(pad_vals), min_sym=-100, max_sym=100,
                          precision=24, cmax=cmax, nsteps=nsteps, R=1)
    np.testing.assert_array_equal(convert.exact_tables_from_torch(got[0]),
                                  np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[3] == int(ref[3])


def _builder_case(family, seed):
    L = 128
    means, scales = _edge_params(5 * L, seed=seed)
    segs, hosts = [], []
    for t0, ns in ((0, 2), (2, 3)):
        m = means[t0 * L:(t0 + ns) * L]
        s = scales[t0 * L:(t0 + ns) * L]
        nc = ef.exact_ncore(m, s, family, -100, 100, 24)
        cmax = min(max(int(nc.max()), 1), 255) + 4 * t0  # tight, then loose
        segs.append((m, s, cmax, ns))
        hosts.append(ef.packed_tables_device(m, s, family, -100, 100, 24,
                                             cmax, ns, 1))
    return segs, hosts


def _check_built(built, hosts):
    for (tabs, cm), host in zip(built, hosts):
        assert cm == host[1]
        np.testing.assert_array_equal(convert.exact_tables_from_torch(tabs),
                                      host[0])


@pytest.mark.parametrize("family", CONT)
def test_cpu_builder_pipeline_matches_host_builder(family):
    """packed_tables_on_device_batch on CPU tensors (the twins) equals the
    host builder bit for bit, segment by segment."""
    segs, hosts = _builder_case(family, seed=21)
    timings = {}
    built = et.packed_tables_on_device_batch(segs, family, -100, 100, 24,
                                             128, "cpu", timings=timings)
    _check_built(built, hosts)
    assert set(timings) == {"eval_s", "patch_s", "ambiguous",
                            "derive_pack_s"}


def test_cpu_builder_host_rows_and_segments(monkeypatch):
    """Windows that start inside the core (a core bound too small for the
    data) are inconclusive and get host rows; a segment with too many
    ambiguous entries goes to the host builder whole.  Either way the
    tables equal the host builder's."""
    segs, hosts = _builder_case("gaussian", seed=22)
    monkeypatch.setitem(ef._EST_C, "gaussian", (1.0, 8.6))
    rows, whole = et.HOST_ROWS["count"], et.HOST_SEGMENTS["count"]
    _check_built(et.packed_tables_on_device_batch(
        segs, "gaussian", -100, 100, 24, 128, "cpu"), hosts)
    assert et.HOST_ROWS["count"] > rows
    assert et.HOST_SEGMENTS["count"] == whole
    monkeypatch.setattr(et, "MARGIN", 0.49)
    _check_built(et.packed_tables_on_device_batch(
        segs, "gaussian", -100, 100, 24, 128, "cpu", canary=False), hosts)
    assert et.HOST_SEGMENTS["count"] == whole + 2


def test_canaries_pass_on_cpu():
    et.eval_window_canary("cpu")
    et.builder_canary("cpu")


# ---------------------------------------------------------------------------
# the kernel twins against the numpy oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,n,seeded", [(128, 1, False), (128, 1000, True),
                                        (384, 384 * 4, False)])
def test_encode_twin_matches_host_coder(L, n, seeded):
    means, scales, syms = _data(n, seed=L + n)
    cfg = _cfg(L)
    cums, probs = ef.exact_ecp(syms, means, scales, "laplace", -100, 100, 24)
    seeds = (np.random.RandomState(n).randint(
        1 << 32, (1 << 63) - 1, L, dtype=np.int64).astype(np.uint64)
        if seeded else None)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L)
    np.testing.assert_array_equal(
        np.concatenate(convert.ecp_from_torch(c_t, p_t, n)),
        np.concatenate([cums, probs]))
    st, w = ef.encode_tables(
        c_t, p_t, cfg, None if seeds is None else convert.u64_to_torch(seeds),
        n)
    st_h, w_h = ref_il2.encode_shared(cums, probs, _ref_cfg(L), seeds=seeds)
    np.testing.assert_array_equal(convert.u64_from_torch(st), st_h)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_h)
    np.testing.assert_array_equal(
        convert.u64_from_torch(st),
        il2.encode_shared(cums, probs, cfg, seeds=seeds)[0])


@pytest.mark.parametrize("family,lo,hi", [("gaussian", -100, 100),
                                          ("cauchy", -100, 100),
                                          ("binomial", 0, 60)])
def test_decode_twin_matches_host_oracle(family, lo, hi):
    L, n = 256, 5 * 256 - 77  # a partial last step
    cfg = _cfg(L)
    if family == "binomial":
        means, scales = _binomial_params(n, seed=6)
        syms = np.random.RandomState(6).binomial(60, scales)
    else:
        means, scales, syms = _data(n, seed=6)
    st, w = ef.encode_family_exact(syms, means, scales, family, lo, hi, cfg,
                                   "cpu")
    out = ef.decode_family_exact(st, w, means, scales, family, lo, hi, cfg, n)
    np.testing.assert_array_equal(out.numpy(), syms)
    # a truncated stream: the twin zero-fills as the oracle does
    cut = w[: w.numel() // 3]
    got = ef.decode_family_exact(st, cut, means, scales, family, lo, hi, cfg,
                                 n)
    host = ref_ef.decode_family_exact_host(
        convert.u64_from_torch(st), convert.u32_from_torch(cut), means,
        scales, family, lo, hi, _ref_cfg(L), n)
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(
        host, ef.decode_family_exact_host(
            convert.u64_from_torch(st), convert.u32_from_torch(cut), means,
            scales, family, lo, hi, cfg, n))


def _straddle_data():
    """Three steps of L = 128 whose cores sort into segments of 13, 31 and
    70 planes, either side of ``BISECT_FROM_PLANES`` (16): the kernel's
    scan and its binary search in one grouped stream."""
    L, n = 128, 3 * 128 - 5
    rng = np.random.RandomState(21)
    means = rng.randn(n) * 20
    scales = np.concatenate([np.full(L, 0.6), np.full(L, 2.0),
                             np.full(n - 2 * L, 5.0)]) * np.exp(
                                 rng.normal(0, 0.1, n))
    syms = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
                   ).astype(np.int64)
    return means, scales, syms


@pytest.mark.parametrize("case", ["laplace", "straddle"])
def test_segment_twin_chains_offsets(case):
    """Segments decoded one after another carry states and the word offset
    from launch to launch and end at the stream's last word.  The
    ``straddle`` case's segments lie on both sides of the search crossover,
    and its decode equals the JAX package's grouped decode (its segment
    decoder in interpret mode, once a segment)."""
    L = 128
    if case == "laplace":
        family, n, max_segments = "laplace", 11 * 128 - 5, 4
        means, scales, syms = _data(n, seed=9)
        scales[:200] *= 5.0
    else:
        family, max_segments = "gaussian", 3
        means, scales, syms = _straddle_data()
        n = len(syms)
    cfg = _cfg(L)
    perm, segs = ef.group_plan(means, scales, family, -100, 100, 24, L, n,
                               max_segments=max_segments)
    assert len(segs) >= 3
    st, w = ef.encode_family_exact_grouped(syms, means, scales, family,
                                           -100, 100, cfg, "cpu",
                                           max_segments=max_segments)
    T = -(-n // L)
    pm, ps = ef._pad_params(means[perm], scales[perm], T * L, family, 100)
    out, fin = ef.decode_segments(st, w, pm, ps, segs, family, -100, 100,
                                  cfg, n, device_tables=False)
    np.testing.assert_array_equal(out.numpy(), syms[perm])
    assert bool((fin == 1 << 32).all())
    whole = ef.decode_family_exact_grouped(st, w, means, scales, family,
                                           -100, 100, cfg, n,
                                           max_segments=max_segments)
    np.testing.assert_array_equal(whole.numpy(), syms)
    if case == "straddle":
        planes = [1 + 3 * (cm // 4) for _, _, cm in segs]
        assert min(planes) < ef.BISECT_FROM_PLANES <= max(planes)
        ref = ref_ef.decode_family_exact_grouped(
            convert.u64_from_torch(st), convert.u32_from_torch(w), means,
            scales, family, -100, 100, _ref_cfg(L), n, interpret=True,
            max_segments=max_segments, device_tables=False)
        np.testing.assert_array_equal(whole.numpy(), ref)


def test_interpret_mode_segment_decoder_and_encoder():
    """The JAX package's S=64 Pallas encoder and segment decoder, once each
    in interpret mode (L=128, T=2, cmax <= 32), against the twins."""
    import jax.numpy as jnp

    L, n = 128, 2 * 128 - 9
    means, scales, syms = _data(n, seed=13, spread=8.0, mu=-0.5, sd=0.3)
    cums, probs = ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, 24)
    r_st, r_w = ref_ef.encode_tables_pallas(cums, probs, _ref_cfg(L),
                                            interpret=True)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L)
    st, w = ef.encode_tables(c_t, p_t, _cfg(L), None, n)
    np.testing.assert_array_equal(convert.u64_from_torch(st),
                                  np.asarray(r_st))
    np.testing.assert_array_equal(convert.u32_from_torch(w), np.asarray(r_w))

    pm, ps = ef._pad_params(means, scales, 2 * L, "gaussian", 100)
    nc = ef.exact_ncore(pm, ps, "gaussian", -100, 100, 24)
    tabs4, cm = ef.packed_tables_device(pm, ps, "gaussian", -100, 100, 24,
                                        int(nc.max()), 2, 1)
    assert cm <= 32
    # decode from a nonzero word offset: prefix the stream with 3 junk words
    stream = np.concatenate([np.array([7, 8, 9], np.uint32),
                             convert.u32_from_torch(w)])
    fn = ref_ef._build_exact_decoder64_seg(-100, 100, _ref_cfg(L), 2,
                                           n - L, L, cm, True)
    st_np = convert.u64_from_torch(st)
    r_syms, r_hi, r_lo, r_base = fn(
        jnp.asarray([3], jnp.int32),
        jnp.asarray((st_np >> np.uint64(32)).astype(np.uint32)).reshape(1, 128),
        jnp.asarray((st_np & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                    ).reshape(1, 128),
        jnp.asarray(tabs4), ref_ef._pad_stream2d(stream, 1))
    out, fin, base = ef.decode_tables_plain(
        st, convert.u32_to_torch(stream), convert.exact_tables_to_torch(tabs4),
        _cfg(L), -100, 100, n, torch.tensor([3]))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(r_syms).reshape(-1)[:n])
    np.testing.assert_array_equal(out.numpy(), syms)
    fin_ref = (np.asarray(r_hi, np.uint64).reshape(-1) << np.uint64(32)) \
        | np.asarray(r_lo, np.uint64).reshape(-1)
    np.testing.assert_array_equal(convert.u64_from_torch(fin), fin_ref)
    assert int(base) == int(np.asarray(r_base)[0]) == len(stream)


# ---------------------------------------------------------------------------
# argument checks and the facade on the CPU
# ---------------------------------------------------------------------------


def test_argument_errors():
    means, scales, syms = _data(300, seed=1)
    cfg = _cfg(128)
    with pytest.raises(ValueError, match="family"):
        ef.encode_family_exact(syms, means, scales, "logistic", -100, 100,
                               cfg, "cpu")
    with pytest.raises(ValueError, match="family"):
        ef.encode_family_exact_grouped(syms, means, scales, "uniform", -100,
                                       100, cfg, "cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        ef.encode_family_exact(syms, means, scales, "gaussian", -100, 100,
                               _cfg(96), "cpu")
    with pytest.raises(ValueError, match="16 < P <= 24"):
        ef.encode_family_exact(syms, means, scales, "gaussian", -100, 100,
                               LaneConfig(128, 32, 64, 16), "cpu")
    st, w = ef.encode_family_exact(syms, means, scales, "gaussian", -100, 100,
                                   cfg, "cpu")
    with pytest.raises(ValueError, match="family"):  # binomial: host builder
        ef.decode_family_exact(st, w, means, scales, "binomial", 0, 60, cfg,
                               300, device_tables=True)
    with pytest.raises(ValueError, match="tabs"):
        ef.decode_tables(st, w, torch.zeros((3, 5, 128), dtype=torch.int32),
                         cfg, -100, 100, 300)
    m_t, s_t = convert.params64_to_torch(means, scales)
    with pytest.raises(ValueError, match="family"):
        et.eval_window(m_t, s_t, torch.zeros(300, dtype=torch.int32),
                       "binomial", -100, 100, 24, 8)
    with pytest.raises(TypeError):
        et.eval_window(m_t.float(), s_t, torch.zeros(300, dtype=torch.int32),
                       "gaussian", -100, 100, 24, 8)


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_facade_grouped_matches_jax_facade(family):
    n = 3000
    if family == "binomial":
        means, scales = _binomial_params(n, seed=2)
        syms = np.random.RandomState(2).binomial(60, scales)
        lo, hi = 0, 60
    else:
        means, scales, syms = _data(n, seed=2)
        lo, hi = -100, 100
    cfg = LaneConfig(num_lanes=128, word_bits=32, state_bits=64,
                     precision=24)
    st, w = ctt.encode_family_exact(syms, means, scales, family, lo, hi,
                                    cfg=cfg, grouped=True, device="cpu")
    # the JAX facade's grouped encode: host planes, then the host coder
    perm, _ = ref_ef.group_plan(means, scales, family, lo, hi, 24, 128, n)
    c, p = ref_ef.exact_ecp(syms[perm], means[perm], scales[perm], family,
                            lo, hi, 24)
    st_h, w_h = ref_il2.encode_shared(c, p, _ref_cfg(128))
    assert st.dtype == np.uint64 and w.dtype == np.uint32
    np.testing.assert_array_equal(st, st_h)
    np.testing.assert_array_equal(w, w_h)
    out = ctt.decode_family_exact(st, w, means, scales, family, lo, hi, n,
                                  cfg=cfg, grouped=True, device="cpu")
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, syms)
    # ungrouped, explicit S=64 config, cmax auto and explicit
    st, w = ctt.encode_family_exact(syms, means, scales, family, lo, hi,
                                    cfg=cfg, device="cpu")
    for cmax in (None, 255):
        out = ctt.decode_family_exact(st, w, means, scales, family, lo, hi,
                                      n, cfg=cfg, cmax=cmax, device="cpu")
        np.testing.assert_array_equal(out, syms)
