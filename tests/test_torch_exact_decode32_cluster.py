"""Kernel 13, the S=32 reference-exact decode (W=16, P <= 16, narrow
tables), as the card runs it: ``csrc/ilans2_wide.cuh``'s cluster step over
``csrc/exact_family.cu``'s ``NarrowTableModel``, whose binary search runs a
thread's lanes in lock step.  Held here on the CPU:

- that search's probe order in plain PyTorch
  (``exact_family.invert_tables_bisect`` on narrow tables: a branchless
  lower bound over the 2 (CP1 - 1) u16 fields, then the field at the bound
  and its successor) equal to the scan (``invert_tables``) on the host
  builder's ``narrow_tables``: gaussian, laplace and cauchy models at P=12
  over every quantile, tables padded with 0xFFFF planes to other widths,
  and the P=16 flat-core model whose top quantiles fall in the saturated
  right tail;
- the twin decoding by that search (``decode_tables_plain(...,
  bisect=True)``) equal to the scan twin, the port's numpy oracle
  (``decode_family_exact_host``) and the JAX package's Pallas site 13
  (``_build_exact_decoder``) in interpret mode on one few-step message;
- the wrappers: on a CUDA device (faked here) ``decode_tables`` and
  ``decode_tables32_cluster`` take at most ``coder.MAX_DECODE_LANES``
  lanes and raise ValueError past it before any launch; CPU tensors run
  the twin at any L; a forced cluster needs CUDA tensors.

The JAX package's host functions run their numpy branches (``native.LIB``
set to None).  Integer coding: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu import native
from constriction_tpu.ops import exact_family as ref_ef
from constriction_tpu.ops.interleaved import LaneConfig as RefCfg
from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops.interleaved import LaneConfig

LO, HI = -100, 100


@pytest.fixture(autouse=True)
def numpy_oracle(monkeypatch):
    """The JAX package's host functions take their numpy branches."""
    monkeypatch.setattr(native, "LIB", None)


def _cfg(L, P=12):
    return LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)


def _data(n, seed, family="gaussian", mu=-0.5, sd=0.6):
    """The suite's synthetic latents (means on [-100, 100], log-normal
    scales), sharp and flat models among them, and symbols near the
    means."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n) * 20.0
    scales = np.exp(rng.normal(mu, sd, n))
    noise = rng.standard_cauchy(n) if family == "cauchy" else rng.randn(n)
    syms = np.clip(np.round(means + scales * noise), LO, HI).astype(np.int64)
    return means, scales, syms


def _tables(means, scales, family, lo, hi, P, T, L):
    """The host builder's narrow tables for T steps of L lanes, as the
    decode reads them: int32 [T, CP1, L]."""
    pm, ps = ef._pad_params(means, scales, T * L, family, hi)
    tabs4, _ = ef.narrow_tables(pm, ps, family, lo, hi, P, None, T, L // 128)
    return convert.exact_tables_to_torch(tabs4)


def _every_quantile(tab, P):
    """One step's table [CP1, L] repeated for each quantile 0 .. 2^P - 1:
    (q, table) with a column per (quantile, lane)."""
    L = tab.shape[1]
    q = torch.arange(1 << P, dtype=torch.int64).repeat_interleave(L)
    return q, tab.repeat(1, 1 << P)


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# --- the lock-step search against the scan ----------------------------------


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_bisect_equals_scan_on_every_quantile(family):
    L = 128
    means, scales, _ = _data(L, seed=len(family), family=family)
    tabs = _tables(means, scales, family, LO, HI, 12, 1, L)
    tab = convert.u32_values(tabs[0])
    q, rep = _every_quantile(tab, 12)
    _same(ef.invert_tables_bisect(q, rep, LO, HI, 12),
          ef.invert_tables(q, rep, LO, HI, 12))


@pytest.mark.parametrize("planes", [2, 3, 7, 8, 20, 33])
def test_bisect_equals_scan_at_other_widths(planes):
    """Tables padded with 0xFFFF planes (as the search sweep pads them) to
    field counts that are and are not powers of two; sharp models whose
    tables need the fewest planes."""
    L = 128
    means, scales, _ = _data(L, seed=planes, mu=-2.5, sd=0.2)
    tabs = convert.u32_values(_tables(means, scales, "gaussian", LO, HI, 12,
                                      1, L)[0])
    CP1 = tabs.shape[0]
    assert CP1 <= planes
    tab = torch.cat([tabs, torch.full((planes - CP1, L), 0xFFFFFFFF,
                                      dtype=torch.int64)])
    q, rep = _every_quantile(tab, 12)
    _same(ef.invert_tables_bisect(q, rep, LO, HI, 12),
          ef.invert_tables(q, rep, LO, HI, 12))


def test_bisect_on_the_p16_top_quantile():
    """The P=16 flat-core model on [-50, 50] (the JAX package's
    ``test_p16_top_quantile_regression``): every quantile, the top ones in
    the saturated right tail, inverts by the search as by the scan and to
    the exact CDF's symbol, cum and prob."""
    P, lo, hi = 16, -50, 50
    aux, core = ref_ef.exact_boundary_tables(
        np.array([0.0]), np.array([500.0]), "gaussian", lo, hi, P, 128)
    tabs, _ = ef.pack_decode_tables(aux, core, P)
    q = torch.arange(1 << P, dtype=torch.int64)
    tab = torch.from_numpy(np.repeat(tabs.T.astype(np.int64), len(q), 1))
    got = ef.invert_tables_bisect(q, tab, lo, hi, P)
    _same(got, ef.invert_tables(q, tab, lo, hi, P))
    syms = np.arange(lo, hi + 1)
    cums, probs = ref_ef.exact_ecp(syms, np.zeros(len(syms)),
                                   np.full(len(syms), 500.0), "gaussian", lo,
                                   hi, P)
    idx = np.searchsorted(cums.astype(np.int64), q.numpy(), side="right") - 1
    np.testing.assert_array_equal(got[0].numpy(), syms[idx])
    np.testing.assert_array_equal(got[1].numpy(), cums[idx].astype(np.int64))
    np.testing.assert_array_equal(got[2].numpy(), probs[idx].astype(np.int64))


# --- the decode by that search ----------------------------------------------


@pytest.mark.parametrize("family", ["gaussian", "cauchy"])
def test_bisect_twin_decodes_like_scan_twin_and_host_oracle(family):
    L, n = 256, 4 * 256 - 37  # a partial last step
    means, scales, syms = _data(n, seed=21, family=family)
    cfg = _cfg(L)
    st, w = ef.encode_family_exact(syms, means, scales, family, LO, HI, cfg,
                                   "cpu")
    T = -(-n // L)
    tabs = _tables(means, scales, family, LO, HI, 12, T, L)
    got = ef.decode_tables_plain(st, w, tabs, cfg, LO, HI, n, bisect=True)
    _same(got, ef.decode_tables_plain(st, w, tabs, cfg, LO, HI, n))
    np.testing.assert_array_equal(got[0].numpy(), syms)
    assert bool((got[1] == 1 << 16).all()) and int(got[2]) == w.numel()
    np.testing.assert_array_equal(
        got[0].numpy(), ef.decode_family_exact_host(
            convert.u32_from_torch(st), convert.u32_from_torch(w), means,
            scales, family, LO, HI, cfg, n))


def test_bisect_twin_equals_pallas_interpret():
    """The JAX package's Pallas site 13 (``_build_exact_decoder``) once in
    interpret mode (L=128, T=3, a partial last step) against the twin
    decoding by the lock-step search: symbols and final states."""
    import jax.numpy as jnp

    L, n = 128, 3 * 128 - 11
    means, scales, syms = _data(n, seed=13, mu=-0.5, sd=0.3)
    cfg = _cfg(L)
    st, w = ef.encode_family_exact(syms, means, scales, "gaussian", LO, HI,
                                   cfg, "cpu")
    pm, ps = ef._pad_params(means, scales, 3 * L, "gaussian", HI)
    tabs4, cm = ef.narrow_tables(pm, ps, "gaussian", LO, HI, 12, None, 3, 1)
    fn = ref_ef._build_exact_decoder(LO, HI, RefCfg(L, 16, 32, 12), 3,
                                     n - 2 * L, L, cm, True)
    r_syms, r_fin = fn(
        jnp.asarray(convert.u32_from_torch(st)).reshape(1, 128),
        jnp.asarray(tabs4),
        ref_ef._pad_stream2d(convert.u32_from_torch(w), 1))
    out, fin, _ = ef.decode_tables_plain(
        st, w, convert.exact_tables_to_torch(tabs4), cfg, LO, HI, n,
        bisect=True)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(r_syms).reshape(-1)[:n])
    np.testing.assert_array_equal(out.numpy(), syms)
    np.testing.assert_array_equal(convert.u32_from_torch(fin),
                                  np.asarray(r_fin).reshape(-1))


# --- the wrappers -----------------------------------------------------------


def _message(L, T=1):
    states = torch.full((L,), 1 << 16, dtype=torch.int32)
    stream = torch.zeros(4, dtype=torch.int32)
    tabs = torch.zeros((T, 2, L), dtype=torch.int32)
    return states, stream, tabs


def test_lane_cap_on_a_cuda_device(monkeypatch):
    """Past the cluster's reach a CUDA device raises ValueError with the
    limit named, before any launch; a CPU tensor runs the twin at any L."""
    L = coder.MAX_DECODE_LANES + 128
    states, stream, tabs = _message(L)
    before = dict(ef.LAUNCHES)
    out = ef.decode_tables(states, stream, tabs, _cfg(L), LO, HI, 5)
    assert out.shape == (5,)
    monkeypatch.setattr(ef, "_on_cuda", lambda device: True)
    with pytest.raises(ValueError, match=f"at most {L - 128} lanes"):
        ef.decode_tables(states, stream, tabs, _cfg(L), LO, HI, 5)
    with pytest.raises(ValueError, match=f"at most {L - 128} lanes"):
        ef.decode_tables32_cluster(states, stream, tabs, _cfg(L), LO, HI, 5,
                                   16)
    with pytest.raises(ValueError, match="cluster must be in 0 .. 16"):
        ef.decode_tables32_cluster(*_message(128), _cfg(128), LO, HI, 5, 17)
    assert ef.LAUNCHES == before


def test_forced_decode_needs_cuda_tensors_and_the_s32_preset():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ef.decode_tables32_cluster(*_message(32), _cfg(32), LO, HI, 5, 1)
    with pytest.raises(ValueError, match="multiple of 32"):
        ef.decode_tables32_cluster(*_message(48), _cfg(48), LO, HI, 5, 1)
    with pytest.raises(ValueError, match="S=32 narrow tables"):
        ef.decode_tables32_cluster(
            *_message(128), LaneConfig(128, 32, 64, 24), LO, HI, 5, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        ef.decode_tables(*_message(32), _cfg(32), LO, HI, 5)
