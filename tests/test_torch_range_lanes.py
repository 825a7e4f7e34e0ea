"""The arithmetic of the two cluster decodes that replaced kernels 5 and 15,
on the CPU.

- The S=64 range decode (``csrc/ilans2_wide.cuh``,
  ``cluster_range_decode_kernel``) takes a lane's quantile (point - lower) /
  (range >> P) without the card's u64 division: an f64 estimate corrected by
  one product (``coder64.range_quotient``), after the invalid case q >= 2^P
  is told apart as num >= scale << P (``coder64.range_quantile``); the
  kernel's estimate comes from an approximate reciprocal, so the
  correction (``coder.range_correct``) is held exact from every estimate
  within one of the quotient, at both presets.  Both are
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

- The S=32 range decode (kernel 6) runs the same kernel at W=16/S=32: its
  quotient (``coder.range_quotient`` at 32 bits, ``range_num_quantile``)
  is held exact against Python integer division at the S=32 edge states
  (range 2^16 after a refill, 2^32 - 1 for a fresh lane, scale 1 at P =
  16, num at scale q +- 1 and at scale << P +- 1) and on seeded grids at
  P = 1, 8, 12, 16.
- The lane form both range decodes share (a lane carries num = point -
  lower and range; the point changes only on a refill; lower is point -
  num at the end: ``coder.decode_range_lanes``) is held equal to both
  presets' range decode twins, from fresh lanes and from checkpoint
  planes, and at S=32 on stream words with bits above 16.

No Pallas call and no kernel runs here.  Integer arithmetic: the tolerance
is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu_torch import convert
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import coder, coder64
from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import interleaved2 as il2
from constriction_tpu_torch.ops.interleaved import LaneConfig

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


# --- kernel 6: the same quotient at S=32 ------------------------------------

M32 = (1 << 32) - 1
PRECISIONS32 = (1, 8, 12, 16)


def _edge_cases32(P):
    """(num, scale) pairs at S=32's edges: range 2^16 (the smallest after a
    refill; scale 1 at P = 16), 2^32 - 1 (a fresh lane) and their
    neighbours; num at 0, at scale q and its neighbours for quotients near
    0, 2^(P-1) and 2^P - 1, and at scale << P and its neighbours."""
    scales = {(1 << 16) >> P or 1, M32 >> P, ((1 << 16) >> P) + 1,
              (M32 >> P) - 1, 1, 2, 3}
    qs = {1, 2, 3, max(1, 1 << (P - 1)), (1 << P) - 1}
    out = []
    for scale in scales:
        out.append((0, scale))
        for q in qs:
            out += [(scale * q + d, scale) for d in (-1, 0, 1)
                    if 0 <= scale * q + d <= M32]
        top = scale << P
        out += [(top + d, scale) for d in (-1, 0, 1) if top + d <= M32]
    return out


def _random_cases32(P, seed, count=4000):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        scale = max(1, min(int(2 ** rng.uniform(0, 32 - P)), M32 >> P))
        q = int(rng.randint(0, 1 << P))
        if rng.random_sample() < 0.1:
            q = (1 << P) + int(rng.randint(0, 1 << 8))
        for num in (q * scale + int(rng.randint(0, 1 << 31)) % scale,
                    q * scale, q * scale - 1):
            if 0 <= num <= M32:
                out.append((num, scale))
    return out


@pytest.mark.parametrize("grid", ["edges", "random"])
@pytest.mark.parametrize("P", PRECISIONS32)
def test_range32_quotient_exact(P, grid):
    cases = (_edge_cases32(P) if grid == "edges"
             else _random_cases32(P, seed=200 + P))
    if grid == "edges":
        assert any(num // scale == (1 << P) - 1 for num, scale in cases)
    for num, scale in cases:
        exact = num // scale
        q, over = coder.range_num_quantile(num, scale, P, 32)
        assert over == (exact >= 1 << P), (num, scale)
        assert q == min(exact, (1 << P) - 1), (num, scale)
        if exact < 1 << P:
            assert coder.range_quotient(num, scale, 32) == exact


@pytest.mark.parametrize("P", PRECISIONS32)
def test_range32_quantile_matches_integer_division(P):
    """The lane's quantile from (point, lower, range) at S=32, as the
    kernel takes it: (point - lower) mod 2^32 over range >> P, clamped, with
    the invalid flag; 0 where the scale is 0."""
    rng = np.random.RandomState(300 + P)
    states = [(0, 0, M32), (5, 7, M32), (M32, 0, 1 << 16), (3, 3, 0),
              (0, 0, (1 << P) - 1), (1 << 20, 1 << 21, 1 << 16)]
    for _ in range(3000):
        rg = int(rng.randint(1 << 16, 1 << 32))
        lower = int(rng.randint(0, 1 << 32))
        point = (lower + int(rng.randint(0, 1 << 32)) % rg) & M32
        if rng.random_sample() < 0.05:
            point = int(rng.randint(0, 1 << 32))  # garbage
        states.append((point, lower, rg))
    for point, lower, rg in states:
        scale = rg >> P
        num = (point - lower) & M32
        exact = num // scale if scale else 0
        q, over = coder.range_quantile(point, lower, rg, P, 32)
        assert over == (exact >= 1 << P)
        assert q == min(exact, (1 << P) - 1)


@pytest.mark.parametrize("grid", ["edges", "random"])
@pytest.mark.parametrize("S,P", [(64, 1), (64, 12), (64, 24), (32, 1),
                                 (32, 12), (32, 16)])
def test_range_correction_from_any_estimate_within_one(S, P, grid):
    """The kernel's estimate comes from an approximate reciprocal and a
    Newton step (``f64_quotient``), within one of num / scale: from each
    of floor - 1, floor and floor + 1 the correcting product gives the
    floor, at both presets' edge states and seeded grids."""
    if S == 64:
        cases = (_edge_cases(P) if grid == "edges"
                 else _random_cases(P, seed=400 + P, count=1500))
    else:
        cases = (_edge_cases32(P) if grid == "edges"
                 else _random_cases32(P, seed=500 + P, count=1500))
    checked = 0
    for num, scale in cases:
        exact = num // scale
        if exact >= 1 << P:
            continue
        for q in (exact - 1, exact, exact + 1):
            if q >= 0:
                assert coder.range_correct(q, num, scale, S) == exact, (
                    q, num, scale)
                checked += 1
    assert checked > 100


# --- the range lane form of both presets (C.5) ------------------------------


def _range_message(S, P, L, n, seed):
    """A message, its CDF, and the port's host range encoding."""
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(40, 2.0))
    cdf = fast_quantized_cdf(probs, P)
    syms = rng.choice(40, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=S // 2, state_bits=S,
                     precision=P)
    c = cdf.astype(np.uint64)
    pts, words = il2.encode_shared_range(c[syms], c[syms + 1] - c[syms], cfg)
    return cfg, syms, cdf, pts, words


def _twin(S, cfg, pts, words, cdf, n, lows=None, rngs=None):
    """The preset's range decode twin on CPU tensors: (symbols, planes as
    numpy uint64)."""
    dec = (coder.decode_shared_range_plain if S == 32
           else coder64.decode_shared_range64_plain)
    planes = [None if v is None else convert.states_to_torch(v, cfg)
              for v in (pts, lows, rngs)]
    out, fin = dec(planes[0], convert.u32_to_torch(words),
                   convert.cdf_to_torch(cdf), cfg, n, planes[1], planes[2],
                   return_final_states=True)
    return out.numpy(), [convert.states_from_torch(v, cfg).astype(np.uint64)
                         for v in fin]


def _check_lane_form(S, cfg, pts, words, cdf, n, lows=None, rngs=None):
    got = coder.decode_range_lanes(pts, words, cdf, cfg, n, lows, rngs)
    want = _twin(S, cfg, pts, words, cdf, n, lows, rngs)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("S,P", [(32, 12), (32, 16), (64, 24), (64, 12)])
def test_range_lane_form_equals_twins(S, P):
    """From fresh lanes over a partial last step, then resumed from each
    of two checkpoints' (lows, rngs, pts) planes: the lane form's symbols
    and final planes equal the twin's."""
    L, n = 256, 256 * 9 + 77
    cfg, syms, cdf, pts, words = _range_message(S, P, L, n, seed=S + P)
    out, _ = _check_lane_form(S, cfg, pts, words, cdf, n)
    np.testing.assert_array_equal(out, syms)
    off, lows, rngs, pps = il2.build_checkpoints_range(pts, words, n, cdf,
                                                       cfg, 3)
    for c in (0, len(off) - 1):
        start = (c + 1) * 3 * L
        out, _ = _check_lane_form(S, cfg, pps[c], words[off[c]:], cdf,
                                  n - start, lows[c], rngs[c])
        np.testing.assert_array_equal(out, syms[start:])


@pytest.mark.parametrize("S", [32, 64])
def test_range_lane_form_on_corrupt_input(S):
    """Stream words with bits above W (S=32: ORed into the shifted point by
    the reference), garbage points, checkpoint planes of scale 0 and a
    truncated stream: the lane form gives the twin's symbols and planes,
    or its error."""
    P = 12
    L, n = 128, 128 * 6 + 5
    cfg, syms, cdf, pts, words = _range_message(S, P, L, n, seed=5 * S)
    rng = np.random.RandomState(S)
    wide, tail = words.copy(), words.copy()
    if S == 32:  # everywhere (an error), and in the last words (a decode)
        wide[::3] |= rng.randint(1, 1 << 16, size=len(wide[::3])).astype(
            np.uint32) << np.uint32(16)
        tail[-8:] |= np.uint32(0xABCD0000)
    garbage = pts.copy()
    garbage[::4] = rng.randint(0, 1 << 31, size=len(garbage[::4])).astype(
        pts.dtype) << pts.dtype.type(S - 31)
    rngs = np.full(L, (1 << S) - 1, dtype=pts.dtype)
    rngs[::5] = rng.randint(0, 1 << P, size=len(rngs[::5]))
    lows = np.zeros(L, dtype=pts.dtype)
    cases = [(pts, wide, None, None), (pts, tail, None, None),
             (garbage, words, None, None),
             (pts, words, lows, rngs), (pts, words[:len(words) // 2], None,
                                        None)]
    for p, w, lo, rg in cases:
        outcome = []
        for fn in (lambda: coder.decode_range_lanes(p, w, cdf, cfg, n, lo,
                                                     rg),
                   lambda: _twin(S, cfg, p, w, cdf, n, lo, rg)):
            try:
                outcome.append(fn())
            except ValueError as e:
                outcome.append(str(e))
        if isinstance(outcome[0], str) or isinstance(outcome[1], str):
            assert outcome[0] == outcome[1]
        else:
            np.testing.assert_array_equal(outcome[0][0], outcome[1][0])
            for a, b in zip(outcome[0][1], outcome[1][1]):
                np.testing.assert_array_equal(a, b)


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
