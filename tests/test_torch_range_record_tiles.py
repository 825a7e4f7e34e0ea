"""Kernels 7 and 9, the range encoder's phase A at S=32 and S=64, walked as
the card walks it (``csrc/ilans2_range.cu``, ``range_record_ring_kernel``:
each lane's next symbols loaded many steps ahead, the steps taken in tiles
of that depth), in plain PyTorch:

- ``range_enc.record_tiles_plain(symbols, cdf, cfg, depth)``: the steps in
  tiles of ``depth``, each tile's whole step rows read as one block, the
  partial last step (all of it when n < L) lane by lane, 0 past n;
- ``range_enc.record_plain``: the one-step-at-a-time twin that the
  wrapper runs on CPU tensors and ``chip_smoke.py`` holds the kernel
  against on the card.

The two are held equal, records and final (lower, range) alike, at depths
1, 3, 8 and 16, with T steps below, at and one past a multiple of the
depth, n whole, with a partial last step and shorter than L, L = 128 and
384, a Dirichlet model and a skewed one with carry runs.  The whole tuple
is held against one interpret-mode call per preset of the JAX package's
Pallas recorders (``pallas_range_enc._build_range_recorder`` and
``_build_range_recorder64``, sixteen steps with carries), the S=64
records split into the Pallas kernel's word and flag planes and the final
state into its u32 limb planes.  The wrappers on CPU tensors launch
nothing.  Integer coding: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from constriction_tpu.ops import pallas_range_enc as pre
from constriction_tpu.ops.interleaved import LaneConfig as RefLaneConfig
from constriction_tpu_torch import convert
from constriction_tpu_torch.models import fast_quantized_cdf
from constriction_tpu_torch.ops import range_enc
from constriction_tpu_torch.ops.interleaved import LaneConfig

PRESETS = {32: 12, 64: 24}  # state bits: the precision the facade takes


def _cfg(S, L):
    return LaneConfig(num_lanes=L, word_bits=S // 2, state_bits=S,
                      precision=PRESETS[S])


def _data(S, n, seed, skewed=False):
    """(symbols int32 tensor, cdf int64 tensor, cdf u32 array).  ``skewed``
    puts 99.9% of the mass on one symbol at cum 0 and the rest at the top
    of the range, so lower wraps: carry runs."""
    rng = np.random.RandomState(seed)
    P = PRESETS[S]
    if skewed:
        q = np.array([(1 << P) - 3, 1, 1, 1], dtype=np.int64)
        cdf = np.concatenate([[0], np.cumsum(q)]).astype(np.uint32)
        syms = np.where(rng.random_sample(n) < 0.999, 0,
                        rng.randint(1, 4, n))
    else:
        probs = rng.dirichlet(np.full(40, 2.0))
        cdf = np.asarray(fast_quantized_cdf(probs, P), dtype=np.uint32)
        syms = rng.choice(40, size=n, p=probs)
    return (torch.from_numpy(syms.astype(np.int32)),
            convert.cdf_to_torch(cdf), cdf)


def _assert_same(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _n(kind, T, L):
    """The message length of ``kind`` over T steps of L lanes."""
    return {"whole": T * L, "partial": (T - 1) * L + L // 3 + 1}[kind]


@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("depth", [1, 3, 8, 16])
@pytest.mark.parametrize("L", [128, 384])
@pytest.mark.parametrize("dT", [-1, 0, 1])
@pytest.mark.parametrize("kind", ["whole", "partial"])
def test_tiles_walk_equals_record_plain(S, depth, L, dT, kind):
    """T below, at and one past a multiple of the depth (the last tile
    short, whole, or one step long)."""
    T = max(1, 2 * depth + dT)
    syms, cdf, _ = _data(S, _n(kind, T, L), seed=depth * 97 + L + dT + S)
    cfg = _cfg(S, L)
    want = range_enc.record_plain(syms, cdf, cfg)
    assert want[0].numel() == T * L
    _assert_same(range_enc.record_tiles_plain(syms, cdf, cfg, depth), want)


@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("depth", [1, 3, 8, 16])
@pytest.mark.parametrize("n", [1, 77, 383])
def test_tiles_walk_shorter_than_one_step(S, depth, n):
    """n < L: one step, read lane by lane; the lanes past n keep their
    initial state and write record 0."""
    syms, cdf, _ = _data(S, n, seed=n + depth)
    cfg = _cfg(S, 384)
    got = range_enc.record_tiles_plain(syms, cdf, cfg, depth)
    _assert_same(got, range_enc.record_plain(syms, cdf, cfg))
    assert not bool(got[0][n:].any())
    assert not bool(got[1][n:].any())
    assert bool((got[2][n:] == -1).all())


@pytest.mark.parametrize("S", [32, 64])
@pytest.mark.parametrize("depth", [3, 16])
def test_tiles_walk_skewed_model_carry_runs(S, depth):
    """The JAX package's carry-run model: a lane renorms only every few
    hundred steps, so most records are 0 and the words between renorms
    defer their carries for long runs."""
    L = 128
    syms, cdf, _ = _data(S, 400 * L + 50, seed=S + depth, skewed=True)
    cfg = _cfg(S, L)
    got = range_enc.record_tiles_plain(syms, cdf, cfg, depth)
    _assert_same(got, range_enc.record_plain(syms, cdf, cfg))
    renorms = int(((got[0].to(torch.int64) >> cfg.word_bits) & 1).sum())
    assert 0 < renorms < L


def _pallas_records(S, syms_np, cdf_np, L):
    """One interpret-mode call of the JAX package's Pallas recorder, its
    planes joined into the port's layout: ``(records, low_f, rng_f)``."""
    P = PRESETS[S]
    n = len(syms_np)
    T = -(-n // L)
    tail = n - (T - 1) * L
    ref_cfg = RefLaneConfig(L, S // 2, S, P)
    syms3d = np.zeros(T * L, np.int32)
    syms3d[:n] = syms_np
    syms3d = syms3d.reshape(T, L // 128, 128)
    cdf_t = tuple(int(x) for x in cdf_np)
    if S == 32:
        fn = pre._build_range_recorder(cdf_t, ref_cfg, T, tail, L, True)
        recs, low_f, rng_f = (np.asarray(x).reshape(-1) for x in fn(syms3d))
        return (convert.u32_to_torch(recs), convert.u32_to_torch(low_f),
                convert.u32_to_torch(rng_f))
    fn = pre._build_range_recorder64(cdf_t, ref_cfg, T, tail, L, True)
    word, flags, lhi, llo, rhi, rlo = (np.asarray(x).reshape(-1).astype(
        np.uint64) for x in fn(syms3d))
    cfg = _cfg(S, L)
    join = (lambda hi, lo: convert.states_to_torch(
        (hi << np.uint64(32)) | lo, cfg))
    return join(flags, word), join(lhi, llo), join(rhi, rlo)


@pytest.mark.parametrize("S", [32, 64])
def test_tiles_walk_matches_pallas_interpret(S):
    """Sixteen steps at L=128, the last partial: the records (at S=64 the
    word plane and the flag plane, renorm bit and carry bit, as one u64)
    and the final (lower, range) equal the Pallas kernel's."""
    L = 128
    syms, cdf, cdf_np = _data(S, 15 * L + 40, seed=S)
    cfg = _cfg(S, L)
    want = _pallas_records(S, syms.numpy(), cdf_np, L)
    carries = (want[0].to(torch.int64) >> (S // 2 + 1)) & 1
    assert int(carries.sum()) > 0
    for depth in (1, 3, 8, 16):
        _assert_same(range_enc.record_tiles_plain(syms, cdf, cfg, depth),
                     want)
    _assert_same(range_enc.record_plain(syms, cdf, cfg), want)


def test_record_on_cpu_tensors_launches_nothing():
    before = dict(range_enc.LAUNCHES)
    for S in (32, 64):
        syms, cdf, _ = _data(S, 3 * 128 + 5, seed=S + 1)
        cfg = _cfg(S, 128)
        _assert_same(range_enc.record(syms, cdf, cfg),
                     range_enc.record_tiles_plain(syms, cdf, cfg, 8))
        # a view at an odd offset (not 16-byte aligned) codes alike
        view = torch.cat([torch.zeros(1, dtype=torch.int32), syms])[1:]
        _assert_same(range_enc.record(view, cdf, cfg),
                     range_enc.record_plain(syms, cdf, cfg))
    assert range_enc.LAUNCHES == before
