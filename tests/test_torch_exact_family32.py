"""The port's S=32 reference-exact family path against the JAX package's,
exactly.

Held here, on inputs made with numpy from a seed: the narrow-table
inversion (``invert_tables`` on u16 (b - 1) pairs) against the JAX
package's ``_invert_with_tables`` and, exhaustively over every quantile,
the P=16 flat-core case that once broke it; the narrow host tables; the
twins of kernels 14 (encode over planes) and 13 (narrow-table decode)
against the JAX package's numpy coder and decode oracle; one
interpret-mode run each of the JAX package's Pallas sites 13 and 14; the
facade's default call at ``device="cpu"``; and the repairs: i.i.d.
encoders reject P > W (C.1), the ungrouped exact encoder rejects models
whose core no decode table holds (C.2), and the ungrouped S=64 decode
picks its table builder as the grouped one does (C.3).  The JAX package's
host functions run their numpy branches (``native.LIB`` set to None).
Integer coding: tolerance is equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu import tpu as ctpu
from constriction_tpu.ops import exact_family as ref_ef
from constriction_tpu.ops import interleaved2 as ref_il2
from constriction_tpu.ops.interleaved import LaneConfig as RefCfg
from constriction_tpu_torch import convert
from constriction_tpu_torch import cuda as ctt
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import framing
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host functions take their numpy branches."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(L, P=12):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)


def _ref_cfg(L, P=12):
    return RefCfg(num_lanes=L, word_bits=16, state_bits=32, precision=P)


def _data(n, seed, spread=20.0, mu=0.4, sd=0.6):
    rng = np.random.RandomState(seed)
    means = rng.randn(n) * spread
    scales = np.exp(rng.normal(mu, sd, n))
    syms = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
                   ).astype(np.int64)
    return means, scales, syms


def _binomial(n, seed, NT=60):
    rng = np.random.RandomState(seed)
    ps = rng.uniform(0.02, 0.98, n)
    return np.full(n, float(NT)), ps, rng.binomial(NT, ps)


def _family_case(family, n, seed):
    """(means, scales, symbols, lo, hi); the continuous families get sharp,
    flat and support-edge models in their first slots."""
    if family == "binomial":
        return (*_binomial(n, seed), 0, 60)
    means, scales, syms = _data(n, seed)
    means[:8] = [-108.3, 108.3, -99.9999, 99.9999, 0.0, -50.0, 3e4, 100.0]
    scales[:8] = [0.02, 0.02, 1e-3, 5e-4, 1e-4, 60.0, 5.0, 0.3]
    syms[:8] = [-100, 100, -100, 100, 0, -50, 100, 100]
    return means, scales, syms, -100, 100


# ---------------------------------------------------------------------------
# narrow tables and their inversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy",
                                    "binomial"])
def test_narrow_invert_matches_jax(family):
    """``invert_tables`` on packed u16 pairs equals ``_invert_with_tables``
    on the JAX package's raw tables, for random and edge quantiles."""
    P, n = 12, 512
    means, scales, _, lo, hi = _family_case(family, n, seed=len(family))
    aux, core = ref_ef.exact_boundary_tables(means, scales, family, lo, hi, P)
    tabs, cmax = ef.pack_decode_tables(aux, core, P)
    assert cmax % 2 == 0 and tabs.shape[1] == cmax // 2 + 1
    tab = torch.from_numpy(tabs.T.astype(np.int64))
    rng = np.random.RandomState(7)
    for q in (rng.randint(0, 1 << P, n), np.zeros(n, np.int64),
              np.full(n, (1 << P) - 1), (aux & 0xFFFF).astype(np.int64)):
        got = ef.invert_tables(torch.from_numpy(q.astype(np.int64)), tab, lo,
                               hi, P)
        ref = ref_ef._invert_with_tables(q, aux, core, lo, hi, P)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b.astype(np.int64))


def test_p16_top_quantile_exhaustive():
    """The P=16 flat-core case (``test_p16_top_quantile_regression`` of
    the JAX package): every quantile in [0, 2^16) inverts to the symbol,
    cum and prob of the exact CDF, so the 0xFFFF pads are never counted and
    the top interval keeps its full width."""
    P, lo, hi = 16, -50, 50
    aux, core = ref_ef.exact_boundary_tables(
        np.array([0.0]), np.array([500.0]), "gaussian", lo, hi, P, 128)
    tabs, _ = ef.pack_decode_tables(aux, core, P)
    syms = np.arange(lo, hi + 1)
    cums, probs = ref_ef.exact_ecp(syms, np.zeros(len(syms)),
                                   np.full(len(syms), 500.0), "gaussian", lo,
                                   hi, P)
    q = np.arange(1 << P)
    tab = torch.from_numpy(np.repeat(tabs.T.astype(np.int64), len(q), 1))
    s, c, p = ef.invert_tables(torch.from_numpy(q), tab, lo, hi, P)
    idx = np.searchsorted(cums.astype(np.int64), q, side="right") - 1
    np.testing.assert_array_equal(s.numpy(), syms[idx])
    np.testing.assert_array_equal(c.numpy(), cums[idx].astype(np.int64))
    np.testing.assert_array_equal(p.numpy(), probs[idx].astype(np.int64))


@pytest.mark.parametrize("loose", [False, True])
def test_narrow_tables_match_jax(loose, monkeypatch):
    """``narrow_tables`` (built in row chunks) equals the JAX package's S=32
    table path: ``exact_boundary_tables``, ``pack_decode_tables``, the
    transpose to ``[T, CP1, R, 128]``; with ``cmax=None`` and with a cmax
    wider than the batch's largest core."""
    monkeypatch.setattr(ef, "_ROW_CHUNK", 200)  # several chunks
    T, R = 3, 2
    means, scales, _, lo, hi = _family_case("laplace", T * R * 128, seed=3)
    nc = int(ef.exact_ncore(means, scales, "laplace", lo, hi, 12).max())
    cmax = nc + (nc & 1) + 6 if loose else None
    got, cm = ef.narrow_tables(means, scales, "laplace", lo, hi, 12, cmax, T,
                               R)
    aux, core = ref_ef.exact_boundary_tables(means, scales, "laplace", lo, hi,
                                             12, cmax)
    tabs, r_cm = ref_ef.pack_decode_tables(aux, core, 12)
    assert cm == r_cm
    ref = tabs.reshape(T, R, 128, -1).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got, ref)
    t = convert.exact_tables_to_torch(got)
    assert t.shape == (T, cm // 2 + 1, R * 128)
    np.testing.assert_array_equal(convert.exact_tables_from_torch(t), ref)


# ---------------------------------------------------------------------------
# the twins of kernels 14 and 13 against the numpy oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,n,seeded", [(128, 5 * 128 - 3, False),
                                        (256, 4 * 256 - 77, True)])
def test_encode32_twin_matches_host_coder(L, n, seeded):
    means, scales, syms = _data(n, seed=L + n)
    cums, probs = ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, 12)
    seeds = (np.random.RandomState(n).randint(
        1 << 16, 1 << 32, L, dtype=np.int64).astype(np.uint32)
        if seeded else None)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L)
    st, w = ef.encode_tables(
        c_t, p_t, _cfg(L), None if seeds is None else convert.u32_to_torch(
            seeds), n)
    assert st.dtype == torch.int32
    st_h, w_h = ref_il2.encode_shared(cums, probs, _ref_cfg(L), seeds=seeds)
    np.testing.assert_array_equal(convert.u32_from_torch(st), st_h)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_h)


@pytest.mark.parametrize("family", ["gaussian", "cauchy", "binomial"])
def test_decode32_twin_matches_host_oracle(family):
    L, n = 256, 5 * 256 - 77  # a partial last step
    means, scales, syms, lo, hi = _family_case(family, n, seed=6)
    cfg = _cfg(L)
    st, w = ef.encode_family_exact(syms, means, scales, family, lo, hi, cfg,
                                   "cpu")
    out = ef.decode_family_exact(st, w, means, scales, family, lo, hi, cfg, n)
    np.testing.assert_array_equal(out.numpy(), syms)
    # a truncated stream: the twin zero-fills as the oracle does
    cut = w[: w.numel() // 3]
    got = ef.decode_family_exact(st, cut, means, scales, family, lo, hi, cfg,
                                 n)
    host = ref_ef.decode_family_exact_host(
        convert.u32_from_torch(st), convert.u32_from_torch(cut), means,
        scales, family, lo, hi, _ref_cfg(L), n)
    np.testing.assert_array_equal(got.numpy(), host)


def test_interpret_mode_exact_decoder_and_encoder():
    """The JAX package's Pallas sites 13 (``_build_exact_decoder``) and 14
    (``_build_exact_encoder``), once each in interpret mode (L=128, T=2,
    cmax <= 32), against the twins: words, final states and symbols."""
    import jax.numpy as jnp

    L, n = 128, 2 * 128 - 9
    means, scales, syms = _data(n, seed=13, spread=8.0, mu=-0.5, sd=0.3)
    cums, probs = ef.exact_ecp(syms, means, scales, "gaussian", -100, 100, 12)
    r_st, r_w = ref_ef.encode_tables_pallas(cums, probs, _ref_cfg(L),
                                            interpret=True)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L)
    st, w = ef.encode_tables(c_t, p_t, _cfg(L), None, n)
    np.testing.assert_array_equal(convert.u32_from_torch(st),
                                  np.asarray(r_st))
    np.testing.assert_array_equal(convert.u32_from_torch(w), np.asarray(r_w))

    pm, ps = ef._pad_params(means, scales, 2 * L, "gaussian", 100)
    tabs4, cm = ef.narrow_tables(pm, ps, "gaussian", -100, 100, 12, None, 2,
                                 1)
    assert cm <= 32
    fn = ref_ef._build_exact_decoder(-100, 100, _ref_cfg(L), 2, n - L, L, cm,
                                     True)
    r_syms, r_fin = fn(jnp.asarray(np.asarray(r_st)).reshape(1, 128),
                       jnp.asarray(tabs4), ref_ef._pad_stream2d(
                           np.asarray(r_w), 1))
    out, fin, base = ef.decode_tables_plain(
        st, w, convert.exact_tables_to_torch(tabs4), _cfg(L), -100, 100, n)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(r_syms).reshape(-1)[:n])
    np.testing.assert_array_equal(out.numpy(), syms)
    np.testing.assert_array_equal(convert.u32_from_torch(fin),
                                  np.asarray(r_fin).reshape(-1))
    assert bool((fin == 1 << 16).all()) and int(base) == w.numel()


# ---------------------------------------------------------------------------
# the facade's default call and the argument checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_facade_default_matches_jax_facade(family):
    """No cfg: the facade picks W=16, S=32, P=12, as ``tpu.py`` does; its
    states (u32) and stream equal what ``tpu.encode_family_exact`` writes
    (its host planes through the host coder), and the decode equals the
    JAX package's host decode and the symbols."""
    n = 3000
    means, scales, syms = _data(n, seed=len(family))
    st, w = ctt.encode_family_exact(syms, means, scales, family, -100, 100,
                                    device="cpu")
    rc = ctpu._pick_cfg_family(n, None, False)
    assert (rc.word_bits, rc.state_bits, rc.precision) == (16, 32, 12)
    c, p = ref_ef.exact_ecp(syms, means, scales, family, -100, 100, 12)
    st_h, w_h = ref_il2.encode_shared(c, p, rc)
    assert st.dtype == np.uint32 and w.dtype == np.uint32
    np.testing.assert_array_equal(st, st_h)
    np.testing.assert_array_equal(w, w_h)
    out = ctt.decode_family_exact(st, w, means, scales, family, -100, 100, n,
                                  device="cpu")
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, syms)
    np.testing.assert_array_equal(out, ref_ef.decode_family_exact_host(
        st_h, w_h, means, scales, family, -100, 100, rc, n))


def test_grouped_s32_raises():
    means, scales, syms = _data(300, seed=1)
    cfg = _cfg(128)
    with pytest.raises(ValueError, match="S=64"):
        ef.encode_family_exact_grouped(syms, means, scales, "gaussian", -100,
                                       100, cfg, "cpu")
    with pytest.raises(ValueError, match="S=64"):
        ctt.encode_family_exact(syms, means, scales, "gaussian", -100, 100,
                                cfg=cfg, grouped=True, device="cpu")
    st, w = ef.encode_family_exact(syms, means, scales, "gaussian", -100, 100,
                                   cfg, "cpu")
    with pytest.raises(ValueError, match="S=64"):
        ef.decode_family_exact_grouped(st, w, means, scales, "gaussian", -100,
                                       100, cfg, 300)
    with pytest.raises(ValueError, match="S=64"):
        ef.decode_tables_seg(st, w, torch.zeros((3, 5, 128),
                                                dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int64), cfg, -100,
                             100, 300)
    # narrow tables come from the host builder, as in the JAX package
    with pytest.raises(ValueError, match="host"):
        ef.decode_family_exact(st, w, means, scales, "gaussian", -100, 100,
                               cfg, 300, device_tables=True)


def test_s32_argument_errors():
    means, scales, syms = _data(300, seed=2)
    cfg = _cfg(128)
    with pytest.raises(ValueError, match="P <= 16"):
        ef.check_cfg(LaneConfig(128, 16, 48, 17))
    with pytest.raises(ValueError, match="does not fit"):
        ef.encode_family_exact(syms, means, scales, "gaussian", -2047, 2047,
                               cfg, "cpu")
    st, w = ef.encode_family_exact(syms, means, scales, "gaussian", -100, 100,
                                   cfg, "cpu")
    with pytest.raises(TypeError, match="int32"):
        ef.decode_tables(st.long(), w, torch.zeros((3, 5, 128),
                                                   dtype=torch.int32),
                         cfg, -100, 100, 300)
    with pytest.raises(ValueError, match="planes"):
        ef.decode_tables(st, w, torch.zeros((3, 1, 128), dtype=torch.int32),
                         cfg, -100, 100, 300)
    with pytest.raises(ValueError, match="seeds"):
        ef.encode_family_exact(syms, means, scales, "gaussian", -100, 100,
                               cfg, "cpu", seeds=np.ones(128, np.uint32))


# ---------------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------------


def test_c1_precision_above_word_size():
    """P=24 on W=8 lanes: the JAX package's pair writes a v1 container and
    decodes 56 of its 456 symbols wrong (the first at index 202); the
    port's i.i.d. encoders raise instead.  A P <= W config still writes the
    JAX package's bytes."""
    cdf = np.array([0, 1, 1 << 24], np.uint32)
    syms = np.array([0, 1] * 200 + [0] * 56)
    data = ctpu.encode_iid(syms, cdf, cfg=RefCfg(128, 8, 32, 24),
                           compact=False)
    wrong = np.nonzero(ctpu.decode_iid(data, cdf) != syms)[0]
    assert len(wrong) == 56 and wrong[0] == 202
    cfg = LaneConfig(128, 8, 32, 24)
    for compact in (False, True):
        with pytest.raises(ValueError, match="precision <= word_bits"):
            ctt.encode_iid(syms, cdf, cfg=cfg, compact=compact, device="cpu")
    with pytest.raises(ValueError, match="precision <= word_bits"):
        il2.encode_iid_categorical2(syms, cdf, cfg, device="cpu")
    with pytest.raises(ValueError, match="precision <= word_bits"):
        framing.encode_iid_v2(syms, cdf, cfg, device="cpu")
    cdf16 = np.array([0, 1, 1 << 16], np.uint32)
    for compact in (False, True):
        np.testing.assert_array_equal(
            ctt.encode_iid(syms, cdf16, cfg=LaneConfig(128, 16, 32, 16),
                           compact=compact, device="cpu"),
            ctpu.encode_iid(syms, cdf16, cfg=RefCfg(128, 16, 32, 16),
                            compact=compact))


def test_c2_ungrouped_encode_rejects_cores_past_the_cap(monkeypatch):
    """Cauchy on [-2000, 2000]: every core spans the support (4000
    boundaries), past the wide tables' cap of 255.  The JAX package writes
    the stream and no decoder reads it; the port's ungrouped encoder raises
    before it codes.  A model whose bound exceeds the cap but whose exact
    core fits still codes, with the JAX package's bytes."""
    rng = np.random.RandomState(0)
    n = 300
    means = rng.uniform(-100, 100, n)
    scales = np.exp(rng.uniform(2, 6, n))
    syms = np.clip(np.round(means + scales * rng.standard_cauchy(n)), -2000,
                   2000).astype(np.int64)
    wide, ref_wide = LaneConfig(128, 32, 64, 24), RefCfg(128, 32, 64, 24)
    c, p = ref_ef.exact_ecp(syms, means, scales, "cauchy", -2000, 2000, 24)
    st_h, w_h = ref_il2.encode_shared(c, p, ref_wide)
    assert len(w_h) > 0
    with pytest.raises(ValueError, match="core needs"):
        ref_ef.decode_family_exact_host(st_h, w_h, means, scales, "cauchy",
                                        -2000, 2000, ref_wide, n)
    with pytest.raises(ValueError, match="core needs 4000 boundaries"):
        ef.encode_family_exact(syms, means, scales, "cauchy", -2000, 2000,
                               wide, "cpu")
    with pytest.raises(ValueError, match="core needs 4000 boundaries"):
        ctt.encode_family_exact(syms, means, scales, "cauchy", -2000, 2000,
                                cfg=wide, device="cpu")
    # the bound says "too wide" for every gaussian here, the exact cores fit
    monkeypatch.setitem(ef._EST_C, "gaussian", (np.inf, np.inf))
    means, scales, syms = _data(n, seed=4)
    st, w = ef.encode_family_exact(syms, means, scales, "gaussian", -300, 300,
                                   wide, "cpu")
    c, p = ref_ef.exact_ecp(syms, means, scales, "gaussian", -300, 300, 24)
    st_h, w_h = ref_il2.encode_shared(c, p, ref_wide)
    np.testing.assert_array_equal(convert.u64_from_torch(st), st_h)
    np.testing.assert_array_equal(convert.u32_from_torch(w), w_h)


@pytest.mark.parametrize("S", [64, 32])
def test_c3_ungrouped_decode_picks_its_table_builder(S, monkeypatch):
    """With ``device_tables=None`` the S=64 ungrouped decode asks
    ``_device_tables_default`` (the on-card builder on a CUDA device), as
    the grouped decode does; the S=32 decode builds on the host.  On the
    CPU the host builder runs either way, and the symbols come back."""
    asked = []

    def default(*args):
        asked.append(args)
        return False

    monkeypatch.setattr(ef, "_device_tables_default", default)
    n = 700
    means, scales, syms = _data(n, seed=S)
    cfg = (LaneConfig(128, 32, 64, 24) if S == 64 else _cfg(128))
    st, w = ef.encode_family_exact(syms, means, scales, "laplace", -100, 100,
                                   cfg, "cpu")
    out = ef.decode_family_exact(st, w, means, scales, "laplace", -100, 100,
                                 cfg, n)
    np.testing.assert_array_equal(out.numpy(), syms)
    assert asked == ([("laplace", -100, 100, torch.device("cpu"))] if S == 64
                     else [])
