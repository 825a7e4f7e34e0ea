"""The arithmetic of the two cluster decodes that replaced kernels 5 and 15,
on the CPU.

- The S=64 range decode (``csrc/ilans2_wide.cuh``,
  ``cluster_range_decode_kernel``) takes a lane's quantile (point - lower) /
  (range >> P) without the card's u64 division: an f64 estimate corrected by
  one product (``coder64.range_quotient``), after the invalid case q >= 2^P
  is told apart as num >= scale << P (``coder64.range_quantile``).  Both are
  held exact against Python integer division at edge states (range 2^32 and
  2^64 - 1, num at 0, at scale q and its neighbours, at scale << P and its
  neighbours, the smallest legal scale 2^8) and on seeded random grids, at
  P = 1 .. 24, and against the twin's own quotient (``coder64._div_scale``).
- The S=64 exact table decode (``csrc/exact_family.cu``,
  ``TableModel::invert_lanes``) binary-searches a thread's lanes in lock
  step, as a branchless lower bound; ``exact_family.invert_tables_bisect``
  is that probe order in plain PyTorch, held equal to
  ``exact_family.invert_tables`` (the scan with the Pallas body's select
  semantics) on wide tables from the host builder, at several widths.

No Pallas call and no kernel runs here.  Integer arithmetic: the tolerance
is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu_torch import convert
from constriction_tpu_torch.ops import coder64
from constriction_tpu_torch.ops import exact_family as ef

M64 = (1 << 64) - 1
PRECISIONS = (1, 8, 16, 24)


def _edge_cases(P):
    """(num, scale) pairs at the edges the kernel meets: range 2^32 (the
    smallest after a refill), 2^64 - 1 (a fresh lane) and the smallest
    legal scale 2^(64 - 32 - 24); num at 0, at scale q - 1, scale q and
    scale q + 1 for quotients near 0, 2^(P-1) and 2^P - 1, and at scale <<
    P and its neighbours (the first invalid quotient)."""
    scales = {(1 << 32) >> P, M64 >> P, 1 << 8, ((1 << 32) >> P) + 1,
              (M64 >> P) - 1, 3, 1}
    qs = {1, 2, 3, max(1, 1 << (P - 1)), (1 << P) - 1}
    out = []
    for scale in scales:
        out.append((0, scale))
        for q in qs:
            out += [(scale * q + d, scale) for d in (-1, 0, 1)]
        top = scale << P
        out += [(top + d, scale) for d in (-1, 0, 1) if top + d <= M64]
    return out


def _random_cases(P, seed, count=4000):
    """Seeded (num, scale) pairs: scales log-uniform over [1, 2^(64-P)),
    quotients uniform below 2^P plus a remainder below the scale, a tenth of
    them past 2^P (invalid data); and for each the exact multiple q scale
    and the value below it, where the f64 estimate of a large num rounds
    to either side of q."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        scale = int(2 ** rng.uniform(0, 64 - P)) or 1
        scale = min(scale | 1, (M64 >> P))
        q = int(rng.randint(0, 1 << P))
        if rng.random_sample() < 0.1:
            q = (1 << P) + int(rng.randint(0, 1 << 16))
        for num in (q * scale + int(rng.randint(0, 1 << 62)) % scale,
                    q * scale, q * scale - 1):
            if 0 <= num <= M64:
                out.append((num, scale))
    return out


def _check_quotients(cases, P):
    for num, scale in cases:
        exact = num // scale
        # the invalid test equals q >= 2^P, and needs no division
        assert (num >= scale << P) == (exact >= 1 << P), (num, scale)
        if exact < 1 << P:
            assert coder64.range_quotient(num, scale) == exact, (num, scale)


@pytest.mark.parametrize("P", PRECISIONS)
def test_range_quotient_exact_at_edge_states(P):
    cases = _edge_cases(P)
    assert any(num // scale == (1 << P) - 1 for num, scale in cases)
    _check_quotients(cases, P)


@pytest.mark.parametrize("P", PRECISIONS)
def test_range_quotient_exact_on_random_grid(P):
    _check_quotients(_random_cases(P, seed=P), P)


@pytest.mark.parametrize("P", PRECISIONS)
def test_range_quotient_exact_below_two_quotients(P):
    """Every num from scale (2^P - 2) to scale << P + 2 at small scales,
    where the f64 estimate sits closest to an integer."""
    for scale in (1, 2, 3, 255, 256, 257):
        lo = max(0, scale * ((1 << P) - 2) - 2)
        _check_quotients([(num, scale) for num in range(lo, (scale << P) + 3)
                          ][:5000], P)


@pytest.mark.parametrize("P", PRECISIONS)
def test_range_quantile_matches_integer_division(P):
    """The lane's quantile as the kernel takes it (``range_quantile``):
    (point - lower) mod 2^64 over range >> P, clamped to 2^P - 1, with the
    invalid flag; 0 where the scale is 0 (corrupt checkpoint planes)."""
    rng = np.random.RandomState(100 + P)
    states = [(0, 0, M64), (5, 7, M64), (M64, 0, 1 << 32), (3, 3, 0),
              (0, 0, (1 << P) - 1), (1 << 40, 1 << 41, 1 << 32)]
    for _ in range(3000):
        rg = int(rng.randint(1 << 31, 1 << 62)) << int(rng.randint(1, 3))
        rg = min(rg, M64)
        lower = int(rng.randint(0, 1 << 62)) * 4 % (1 << 64)
        point = (lower + int(rng.randint(0, 1 << 62)) % max(rg, 1)) & M64
        if rng.random_sample() < 0.05:
            point = int(rng.randint(0, 1 << 62)) << 2  # garbage
        states.append((point, lower, rg))
    for point, lower, rg in states:
        scale = rg >> P
        num = (point - lower) & M64
        exact = num // scale if scale else 0
        q, over = coder64.range_quantile(point, lower, rg, P)
        assert over == (exact >= 1 << P)
        assert q == min(exact, (1 << P) - 1)


@pytest.mark.parametrize("P", (8, 24))
def test_range_quotient_equals_twin_quotient(P):
    """The kernel's quotient and the twin's (a float64 estimate clamped to
    2^P, corrected both ways on (hi, lo) halves) on the same grid."""
    cases = [(num, scale) for num, scale in _random_cases(P, seed=7 + P,
                                                          count=3000)
             if num < scale << P]
    d = [num for num, _ in cases]
    s = [scale for _, scale in cases]
    d_hi = torch.tensor([x >> 32 for x in d], dtype=torch.int64)
    d_lo = torch.tensor([x & 0xFFFFFFFF for x in d], dtype=torch.int64)
    s_hi = torch.tensor([x >> 32 for x in s], dtype=torch.int64)
    s_lo = torch.tensor([x & 0xFFFFFFFF for x in s], dtype=torch.int64)
    twin = coder64._div_scale(d_hi, d_lo, s_hi, s_lo, P).tolist()
    assert twin == [coder64.range_quotient(num, scale)
                    for num, scale in cases]


# --- kernel 15's lock-step binary search -----------------------------------


def _wide_tables(family, L, T, extra, seed):
    """Host-built wide tables ``[T, CP1, L]`` (u32 values in int64) at the
    tight width plus ``extra`` boundaries (pads 2^24 - 1 after the core)."""
    rng = np.random.RandomState(seed)
    n = T * L
    means = rng.randn(n) * 30
    scales = np.exp(rng.normal(-1.5, 0.3, n))
    nc = int(ef.exact_ncore(means, scales, family, -100, 100, 24).max())
    cmax = min(255, max(4, nc) + extra)
    tabs4, _ = ef._packed_table_rows(means, scales, family, -100, 100, 24,
                                     cmax)
    CP1 = tabs4.shape[1]
    tabs = tabs4.reshape(T, L, CP1).transpose(0, 2, 1)
    return convert.u32_values(convert.u32_to_torch(
        np.ascontiguousarray(tabs)).reshape(T, CP1, L))


def _quantiles(tab, rng, L):
    """Per lane: random quantiles below 2^24, 0, 2^24 - 1, and the values
    of 24 fields spread over the column and the values one above them (the
    search's ties)."""
    fields = ef._table_fields(tab)
    qs = [torch.from_numpy(rng.randint(0, 1 << 24, L).astype(np.int64))
          for _ in range(4)]
    qs += [torch.zeros(L, dtype=torch.int64),
           torch.full((L,), (1 << 24) - 1, dtype=torch.int64)]
    N = fields.shape[0]
    for k in sorted({int(k) for k in np.linspace(0, N - 1, 24)}):
        qs += [fields[k].clamp(max=(1 << 24) - 1),
               (fields[k] + 1).clamp(max=(1 << 24) - 1)]
    return qs


@pytest.mark.parametrize("extra", [0, 5, 30, 120])
@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_lock_step_bisect_equals_select_scan(family, extra):
    L, T = 256, 2
    tabs = _wide_tables(family, L, T, extra, seed=len(family) + extra)
    assert (tabs[0, 0] >> 24).max() > 0  # a core in some lane
    rng = np.random.RandomState(extra)
    for t in range(T):
        tab = tabs[t]
        for q in _quantiles(tab, rng, L):
            got = ef.invert_tables_bisect(q, tab, -100, 100, 24)
            want = ef.invert_tables(q, tab, -100, 100, 24)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.parametrize("G", [1, 2, 3, 5, 12, 16, 33, 46, 64])
def test_lock_step_bisect_at_every_table_width(G):
    """Synthetic packed tables of 4G fields a lane (cores of 0 .. 4G
    ascending boundaries below 2^24, then pads, through the host packer
    ``pack_decode_tables``): the lock-step binary search equals the scan
    for N = 4G not a power of two as well, at random quantiles and at each
    boundary and its neighbour."""
    rng = np.random.RandomState(G)
    L, P = 64, 24
    ncore = rng.randint(0, 4 * G + 1, L)
    ncore[:2] = (0, 4 * G)
    # strictly ascending boundaries in [2, 2^24 - 1), then raw pads 2^P
    steps = rng.randint(1, ((1 << P) - 3) // (4 * G), (L, 4 * G))
    core = 1 + np.cumsum(steps, axis=1)
    core[np.arange(4 * G)[None, :] >= ncore[:, None]] = 1 << P
    aux = (rng.randint(1, 50, L) | (ncore << 24)).astype(np.uint32)
    rows, _ = ef.pack_decode_tables(aux, core.astype(np.uint32), P)
    tab = convert.u32_values(convert.u32_to_torch(
        np.ascontiguousarray(rows.T)).reshape(rows.shape[1], L))
    cols = [torch.from_numpy(rng.randint(0, 1 << P, L).astype(np.int64))
            for _ in range(6)]
    for k in sorted({int(k) for k in np.linspace(0, 4 * G - 1, 12)}):
        b = torch.from_numpy(np.minimum(core[:, k], (1 << P) - 1))
        cols += [b - 1, b, (b + 1).clamp(max=(1 << P) - 1)]
    for q in cols:
        got = ef.invert_tables_bisect(q, tab, -100, 100, P)
        want = ef.invert_tables(q, tab, -100, 100, P)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
