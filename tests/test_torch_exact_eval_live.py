"""Kernel 18's live ends: the first window position of a row whose entry is
out of the support or certainly saturated (t - t* > eps), from which on
every entry is ``(free, False)`` whatever its CDF, so the kernel runs no
CDF there.  The kernel finds it by a search with the entry's own
arithmetic (``csrc/exact_family.cu``, eight probes a round);
``exact_tables.live_ends_plain`` finds it by a binary search in float64
torch operations, which ends at the same first position.  It is held equal, row by row, to the first j at which
``eval_window_plain``'s own per-entry arithmetic (``exact_tables.
window_t``, then ``d = t - t*`` and ``d > eps``, and ``s > max_sym``)
says certain saturation or out of support, and every entry of
``eval_window_plain`` at and past it is ``(free, False)``.

Inputs are made by numpy from a seed, for the three device families:
random rows over the builder's windows; rows whose live end is 0 (the
window starts saturated, or past the support) and W (the window ends
before saturation); W in {1, 31, 32, 33, 271}; and means found by
bisection over float64 bit patterns so that one entry's d lands on each
side of eps, on the double just above and just below it and on their
neighbours, with the band entries (|d| <= eps) staying live.  Rows whose
den is not above 0 end at the support's end.  The JAX package's window
evaluator (``exact_tables_jax.eval_window``) gives the same accepted
values as ``eval_window_plain``; the port's CPU tests of the builder
(``tests/test_torch_exact_family.py``) hold that.  Tolerance: exact
equality.
"""

import math

import numpy as np
import pytest
import torch

from constriction_tpu_torch.ops import exact_family as ef
from constriction_tpu_torch.ops import exact_tables as et

LO, HI, P = -100, 100, 24
FREE = (1 << P) - 1 - (HI - LO)
FAMILIES = ("gaussian", "laplace", "cauchy")


def _first_dead(means, scales, ws, family, W):
    """The first j whose entry is out of the support or certainly saturated
    by eval_window_plain's per-entry arithmetic, else W; and whether the
    dead entries of each row are a suffix."""
    s, t = et.window_t(means, scales, ws, family, W)
    t_star, eps, has_star = et._band(family)
    dead = s > HI
    if has_star:
        dead = dead | ((t - t_star) > eps)
    first = torch.where(dead.any(1), dead.to(torch.int8).argmax(1), W)
    j = torch.arange(W)
    suffix = (dead == (j[None, :] >= first[:, None])).all(1)
    return first, suffix


def _check(means, scales, ws, family, W):
    m = torch.tensor(means, dtype=torch.float64)
    sc = torch.tensor(scales, dtype=torch.float64)
    w = torch.tensor(ws, dtype=torch.int32)
    ends = et.live_ends_plain(m, sc, w, family, HI, W)
    first, suffix = _first_dead(m, sc, w, family, W)
    assert bool(suffix.all())
    assert torch.equal(ends, first)
    tv, amb = et.eval_window_plain(m, sc, w, family, LO, HI, P, W)
    past = torch.arange(W)[None, :] >= ends[:, None]
    assert bool((tv[past] == FREE).all()) and not bool(amb[past].any())
    return ends, tv, amb


def _windows(family, means, scales):
    """The builder's window starts (``packed_tables_on_device_batch``)."""
    CL = ef._EST_C[family][0]
    if np.isinf(CL):
        return np.full(len(means), LO + 1, np.int64)
    return np.clip(np.ceil(means - CL * scales) - 3.0, LO + 1, HI).astype(
        np.int64)


@pytest.mark.parametrize("W", [1, 31, 32, 33, 271])
@pytest.mark.parametrize("family", FAMILIES)
def test_live_ends_equal_the_first_dead_entry(family, W):
    rng = np.random.RandomState(W + len(family))
    n = 600
    means = rng.uniform(-110, 110, n)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(12.0), n))
    ws = _windows(family, means, scales)
    ws[:50] = rng.randint(LO - 20, HI + 20, 50)  # anywhere, past HI too
    ends, _, _ = _check(means, scales, ws, family, W)
    assert int(ends.min()) >= 0 and int(ends.max()) <= W


@pytest.mark.parametrize("family", ["gaussian", "laplace"])
def test_rows_ending_at_zero_and_at_w(family):
    """A window starting past t* or past the support ends at 0; one that
    stops before t* inside the support ends at W."""
    W = 33
    t_star = et._band(family)[0]
    k = math.sqrt(2.0) if family == "gaussian" else 1.0
    means = np.array([0.0, 0.0, 0.0, 50.0])
    scales = np.array([1.0, 1.0, 1.0, 30.0])
    ws = np.array([int(t_star * k) + 3, HI + 1, HI + 7, -40])
    ends, _, _ = _check(means, scales, ws, family, W)
    assert ends.tolist() == [0, 0, 0, W]


def _ordered(x: float) -> int:
    b = int(np.float64(x).view(np.int64))
    return b if b >= 0 else -(b & ((1 << 63) - 1))


def _from_ordered(k: int) -> float:
    b = k if k >= 0 else (-k) | (1 << 63)
    return float(np.int64(np.uint64(b).astype(np.int64)).view(np.float64))


def _d(family, s, mean, scale):
    f64 = torch.float64
    t = et._std_arg(torch.tensor([s]), torch.tensor([mean], dtype=f64),
                    et._den(torch.tensor([scale], dtype=f64), family))
    return float(t[0]) - et._band(family)[0]


def _boundary_mean(family, s, scale):
    """The largest mean at which the entry s has d > eps (d falls as the
    mean rises): bisection over the ordered float64 bit patterns."""
    t_star, eps, _ = et._band(family)
    k = math.sqrt(2.0) if family == "gaussian" else 1.0
    guess = s - 0.5 - t_star * scale * k
    width = (2.0 * eps + 1.0) * scale * k
    lo, hi = _ordered(guess - width), _ordered(guess + width)
    assert _d(family, s, _from_ordered(lo), scale) > eps
    assert not _d(family, s, _from_ordered(hi), scale) > eps
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _d(family, s, _from_ordered(mid), scale) > eps:
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("family,scale", [("gaussian", 1.0),
                                          ("gaussian", 0.37),
                                          ("laplace", 1.0),
                                          ("laplace", 2.5),
                                          ("cauchy", 1e-13)])
def test_d_on_each_side_of_eps(family, scale):
    """Means two doubles below to three above the boundary: the entry at
    j = 5 (s = 10) is saturated for the first three and live (in the band,
    ambiguous) for the rest, so the live end is 5 and then 6."""
    t_star, eps, _ = et._band(family)
    s, j = 10, 5
    b = _boundary_mean(family, s, scale)
    means = [_from_ordered(b + k) for k in range(-2, 4)]
    ds = [_d(family, s, m, scale) for m in means]
    assert [d > eps for d in ds] == [True] * 3 + [False] * 3
    assert all(abs(d - eps) <= 1e-6 * max(eps, 1.0) for d in ds)
    n = len(means)
    ends, tv, amb = _check(np.array(means), np.full(n, scale),
                           np.full(n, s - j), family, 16)
    assert ends.tolist() == [j] * 3 + [j + 1] * 3
    # the band: |d| <= eps is ambiguous and live
    assert bool(amb[3:, j].all())


def test_rows_with_den_not_above_zero_end_at_the_support_end():
    """A zero or negative scale breaks the monotone order in j: the kernel
    evaluates every entry in the support of such a row."""
    W = 40
    means = np.array([0.0, 0.0, 3.0])
    scales = np.array([0.0, -1.0, -0.5])
    ws = np.array([-10, -10, HI - 30])
    for family in FAMILIES:
        ends = et.live_ends_plain(
            torch.tensor(means), torch.tensor(scales),
            torch.tensor(ws, dtype=torch.int32), family, HI, W)
        assert ends.tolist() == [W, W, 31]


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_evaluator_is_free_past_the_live_ends(family):
    """The JAX package's window evaluator (``exact_tables_jax.eval_window``,
    XLA float64) gives ``(free, False)`` at and past every row's live end
    too: what the kernel leaves out needs no CDF in either package."""
    from constriction_tpu.ops import exact_tables_jax as etj

    rng = np.random.RandomState(len(family) + 40)
    n = 300
    W = HI - LO + 17 if family == "cauchy" else 64  # the builder's widths
    means = rng.uniform(-110, 110, n)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(12.0), n))
    ws = _windows(family, means, scales)
    ends, _, _ = _check(means, scales, ws, family, W)
    r_tv, r_amb = etj.eval_window(means, scales, ws.astype(np.int32),
                                  family=family, min_sym=LO, max_sym=HI,
                                  precision=P, W=W)
    past = (np.arange(W)[None, :] >= ends.numpy()[:, None])
    assert past.any()
    assert (np.asarray(r_tv)[past] == FREE).all()
    assert not np.asarray(r_amb)[past].any()
