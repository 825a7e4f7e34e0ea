#!/usr/bin/env python3
"""All twenty-four coding kernels timed in several checkouts on one card,
one checkout after another in the order given.

    git archive <commit> | tar -x -C _scratch/parent
    python3 chip_ab.py _scratch/parent . . _scratch/parent
    python3 chip_ab.py --kernels 11,16 _scratch/parent . . _scratch/parent
    python3 chip_ab.py --kernels 7,9 _scratch/parent . . _scratch/parent

Each checkout runs in a process of its own (the packages share a name),
builds its kernels and times, on the same inputs:

- kernels 1 and 2, the DEFAULT-preset rANS decode and encode (W=32/S=64),
  and kernels 4 and 3, the small preset's (W=16/S=32), on bench.py's
  workload (2^25 symbols, K=100, Dirichlet(2), seed 1234) at L=32768:
  kernels 1 and 2 at P=24 and P=12, kernels 3 and 4 at P=12 (an encode
  timed as its whole call, as chip_smoke.py times it, and as its C entry
  alone: both passes on preallocated scratch, no read-back);
- kernel 5, the S=64 range decode, on the same symbols at L=32768 and
  L=65536 (2 and 4 lanes a thread), P=24;
- kernel 6, the S=32 range decode, on the same symbols at L=32768, P=12
  and P=16, and at L=65536, P=12;
- kernels 7 and 9, the range encode's phase A at S=32 (P=12) and S=64
  (P=24), on the same symbols at L=32768 and L=65536: the C entry on
  preallocated records and final (lower, range) planes, and, in a
  checkout that has ``ctt_ilans2_range_record_form_*``, each phase-A form
  of ``RECORD_FORMS`` (the register ring and the TMA ring at several
  depths, block widths and stage counts);
- kernel 8, the S=32 range encode's phase B (carry resolve), on the same
  symbols' records at L=32768, P=12: its C entry on preallocated scratch,
  and, in a checkout that has it (``ctt_ilans2_range_resolve_direct_
  w16s32``), its direct form: the flags counted from the records over the
  grid, one scan, and the lane pass writing the stream itself (this
  package keeps the scratch form, which was the faster);
- kernel 10, the S=64 range encode's phase B, on the same symbols'
  records at P=24, L=32768 and L=65536: its C entry on preallocated
  scratch (a checkout whose entry takes the lane state in place, one
  block, has it reset outside the CUDA events), and, where the checkout
  has them, its lane pass and pass B alone;
- kernel 24, the TChain-24 encode, on the JAX suite's TChain row (2^24
  uniform quantiles, K=100 Dirichlet(2), seed 1234) at L=32768: its C
  entry;
- kernel 20, the TChain-16 encode, on the TChain-16 row (2^24 uniform
  16-bit quantiles, the same model at P=16) at L=32768: its C entry (with
  a records scratch where it takes one);
- kernel 23, the TChain-24 decode, on the TChain-24 row: its C entry (on
  preallocated scratch where it takes some), and, where the checkout has
  them, its head pass and pass B alone;
- kernel 19, the TChain-16 decode, on the TChain-16 row: the same (a
  checkout whose entry takes no scratch, one block, gets none);
- kernel 15, the S=64 reference-exact table decode, on the JAX suite's
  exact row (2^22 synthetic symbols, gaussian, [-100, 100], P=24) at
  L=32768 and L=65536, over tables built on the card at the ungrouped
  core bound;
- kernel 21, the TChain-12 family decode, on inputs drawn as the JAX
  suite's family row draws them (uniform 12-bit quantiles, gaussian means
  and scales on [-100, 100], seed 1234), 2^23 and 2^24 quantiles at
  L=32768, checked against its plain twin on the card, as whole calls of
  ``tchain.tchain12_family_decode`` (their arguments are the same in
  every checkout), and at 2^23 its C entry on preallocated scratch and
  its head pass alone;
- kernel 22, the TChain-12 family encode, on the family row's 2^23
  quantiles decoded at L=32768 (gaussian): its C entry on preallocated
  scratch (8 bytes a symbol, and a u16 quantile a symbol where the entry
  takes it; a checkout whose entry keeps L words of pending tables, one
  block, uses the first of the 8-byte scratch), the heads reset and the
  quantile words zeroed outside the CUDA events; where the checkout has
  them, its tables pass alone and its cluster step with the packing pass;
- kernel 11, the family rANS decode, on the family row itself (2^23
  symbols and their means and scales, seed 1234, [-100, 100]) at
  L=32768, for each of the four families: its C entry on a stream the
  checkout's own encoder wrote;
- kernel 12, the family rANS encode, on the same row (gaussian): its C
  entry on preallocated scratch (a checkout whose entry keeps L words of
  pending tables, one block, gets those; one that runs the tables pass,
  pass A and pass B gets its records, dense words, ballots and block
  offsets), the states reset outside the CUDA events; where the checkout
  has them, its tables pass, pass A and pass B alone;
- kernel 13, the S=32 reference-exact decode, on the facade's default
  exact call (the exact row's synthetic latents cut to 2^20 symbols,
  gaussian, [-100, 100], W=16, S=32, P=12, L=32768) over the host
  builder's narrow tables (built once a run, in up to 8 worker processes,
  and shared by the checkouts through a temporary directory): its C entry
  with the search the checkout picks for the tables' width, and with the
  scan and the binary search forced, the states reset outside the CUDA
  events;
- kernel 17, the S=64 exact encode, on the exact row's planes (2^22
  symbols, gaussian, P=24) at L=32768: its C entry (on preallocated
  scratch where it takes some; the states reset outside the CUDA events),
  and, where the checkout has them, its pass A and pass B alone;
- kernel 14, the S=32 exact encode, on the default exact call's planes
  (2^20 symbols, P=12, L=32768): its C entry (on preallocated scratch
  where it takes some; the states reset outside the CUDA events), and,
  where the checkout has them, its pass A and pass B alone;
- kernel 18, the window evaluator, on the exact row's grouped plan (2^22
  symbols, gaussian, P=24, L=32768, the builder's windows): one launch a
  segment back to back, every entry and flag checked against its plain
  twin;
- kernel 16, the S=64 exact segment decode, on the exact row's grouped
  plan (2^22 symbols, gaussian, P=24, L=32768, its segments' tables built
  on the card): the whole chain of its launches (CUDA events around it,
  launched back to back), each launch alone (events around it after a
  synchronisation, summed over the chain) and the host time of issuing
  the chain (host clock, no synchronisation).

``--kernels`` picks some of them (1 to 4 go together).  Each decode is
checked against the symbols first, each encode entry against its call's
states and stream.  A checkout prints one
JSON line: its path and, per kernel, five timings of ten launches (ms per
launch; the encodes' C entries and kernels 5 and 15 reset their in-place
states or planes before each launch, outside the CUDA events around it).  Give the checkouts in turns
(parent, change, change, parent) to compare two versions within one call.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

N = 1 << 25
N_EXACT = 1 << 22
N_EXACT32 = 1 << 20  # the facade's default exact call, as chip_smoke.py cuts it
K = 100
LANES = 32768
REPS, LAUNCHES = 5, 10


def _events_ms(launch, reset=None) -> list:
    """REPS samples of the mean ms of LAUNCHES launches: CUDA events
    around the whole run, or around each launch when ``reset`` restores
    state first."""
    import torch

    launch()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        total = 0.0
        for _ in range(1 if reset is None else LAUNCHES):
            if reset is not None:
                reset()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(LAUNCHES if reset is None else 1):
                launch()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        out.append(total / LAUNCHES)
    return out


def _exact_workload(n: int):
    """chip_smoke.py's exact row: the JAX suite's synthetic latents."""
    import numpy as np

    rng = np.random.RandomState(1234)
    lat = rng.randn(512 * 512) * 0.15
    means = np.tile(lat * 50.0, -(-n // len(lat)))[:n]
    scales = np.exp(rng.normal(0.7, 0.4, size=n))
    symbols = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
                      ).astype(np.int64)
    return means, scales, symbols


def time_decodes(root: str, kernels: set) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build, coder, coder64
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    if not torch.cuda.is_available():
        sys.exit("chip_ab: needs a CUDA device")
    _build.library()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(1234)
    probs = rng.dirichlet(np.full(K, 2.0))
    syms = torch.from_numpy(
        rng.choice(K, size=N, p=probs).astype(np.int32)).to(dev)
    out = {"root": root}

    def check(got, want, what):
        if not torch.equal(got, want):
            sys.exit(f"chip_ab: {root} codes wrong output ({what})")

    # kernels 1 to 4
    rans = ((32, 64, 24, coder64.encode_iid64, coder64.decode_shared64),
            (32, 64, 12, coder64.encode_iid64, coder64.decode_shared64),
            (16, 32, 12, coder.encode_iid, coder.decode_shared))
    for W, S, P, enc, dec in rans if kernels & {1, 2, 3, 4} else ():
        cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, P), dev)
        cfg = LaneConfig(num_lanes=LANES, word_bits=W, state_bits=S,
                         precision=P)
        st, w = enc(syms, cdf, cfg)
        check(dec(st, w, cdf, cfg, N), syms, f"w{W}s{S} P={P}")
        suffix = "" if S == 64 else "_w16s32"
        out[f"decode{suffix}_P{P}_ms"] = _events_ms(
            lambda: dec(st, w, cdf, cfg, N))
        out[f"encode{suffix}_P{P}_ms"] = _events_ms(
            lambda: enc(syms, cdf, cfg))
        _time_encode_entry(out, f"encode_entry{suffix}_P{P}_ms", syms, cdf,
                           cfg, st, w, check)
    if 5 in kernels:
        _time_range(out, syms, probs, check)
    if 6 in kernels:
        _time_range32(out, syms, probs, check)
    if kernels & {7, 9}:
        _time_record(out, syms, probs, check, kernels)
    if 8 in kernels:
        _time_resolve32(out, syms, probs, check)
    if 10 in kernels:
        _time_resolve64(out, syms, probs, check)
    if 24 in kernels:
        _time_tchain24(out, check)
    if 20 in kernels:
        _time_tchain16(out, check)
    if 23 in kernels:
        _time_cat_decode(out, check, 24)
    if 19 in kernels:
        _time_cat_decode(out, check, 16)
    if 15 in kernels:
        _time_exact(out, check)
    if 17 in kernels:
        _time_exact_encode(out, check)
    if 21 in kernels:
        _time_tchain12(out, check)
    if 22 in kernels:
        _time_tchain12_encode(out, check)
    if 11 in kernels:
        _time_family(out, check)
    if 16 in kernels:
        _time_exact_seg(out, check)
    if 12 in kernels:
        _time_family_encode(out, check)
    if 13 in kernels:
        _time_exact32(out, check, root)
    if 14 in kernels:
        _time_exact_encode32(out, check)
    if 18 in kernels:
        _time_eval_window(out, check)
    return out


def _time_encode_entry(out, key, syms, cdf, cfg, st, w, check):
    """An encode's C entry alone (both passes, no read-back) into
    ``out[key]``, on preallocated scratch, the start states reset outside
    the CUDA events; its states and stream must equal the call's."""
    import torch

    from constriction_tpu_torch.ops import _build, coder

    dev = syms.device
    L, W, S = cfg.num_lanes, cfg.word_bits, cfg.state_bits
    T = -(-N // L)
    cdf32 = cdf.to(torch.int32)
    states = torch.empty_like(st)
    buf = torch.empty(N, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = (torch.empty(T * L, dtype=torch.int32, device=dev),
               torch.empty(T * L // 32, dtype=torch.int32, device=dev),
               torch.empty(coder.SCAN_BLOCKS, dtype=torch.int64, device=dev),
               coder._records(cdf32, cfg))

    def reset():
        states.fill_(1 << (S - W))

    def launch():
        _build.call(f"ctt_ilans2_encode_w{W}s{S}", dev, states, syms, N, cdf32,
                    K, buf, N, end, *scratch, L, cfg.precision)

    reset()
    launch()
    check(states, st, key)
    check(buf[int(end.item()):], w, key)
    out[key] = _events_ms(launch, reset)


def _time_range(out, syms, probs, check):
    """Kernel 5 into ``out``: the C entry on preallocated planes."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build, range_enc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = syms.device
    cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, 24), dev)
    cdf32 = cdf.to(torch.int32)
    for lanes in (LANES, 2 * LANES):
        cfg = LaneConfig(num_lanes=lanes, word_bits=32, state_bits=64,
                         precision=24)
        recs, low_f, rng_f = range_enc.record(syms, cdf, cfg)
        s0, carry = range_enc.seal(low_f, rng_f, cfg)
        pts, words = range_enc.resolve(recs, s0, carry, cfg, N)
        del recs
        planes = [torch.empty_like(pts) for _ in range(3)]
        o_buf = torch.empty(N, dtype=torch.int32, device=dev)
        bad = torch.empty(1, dtype=torch.int64, device=dev)

        def reset_range():
            planes[0].zero_()
            planes[1].fill_(-1)
            planes[2].copy_(pts)
            bad.fill_(N)

        key = "range_decode" + ("" if lanes == LANES else f"_L{lanes}")

        def launch():
            _build.call("ctt_ilans2_range_decode_w32s64", dev, *planes, words,
                        words.numel(), cdf32, K, o_buf, N, lanes, 24, bad)
        reset_range()
        launch()
        check(o_buf, syms, key)
        out[f"{key}_ms"] = _events_ms(launch, reset_range)


def _time_range32(out, syms, probs, check):
    """Kernel 6 into ``out``: the C entry on preallocated planes."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build, range_enc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = syms.device
    for lanes, P in ((LANES, 12), (LANES, 16), (2 * LANES, 12)):
        cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, P), dev)
        cdf32 = cdf.to(torch.int32)
        cfg = LaneConfig(num_lanes=lanes, word_bits=16, state_bits=32,
                         precision=P)
        recs, low_f, rng_f = range_enc.record(syms, cdf, cfg)
        s0, carry = range_enc.seal(low_f, rng_f, cfg)
        pts, words = range_enc.resolve(recs, s0, carry, cfg, N)
        del recs
        planes = [torch.empty_like(pts) for _ in range(3)]
        o_buf = torch.empty(N, dtype=torch.int32, device=dev)
        bad = torch.empty(1, dtype=torch.int64, device=dev)

        def reset_range():
            planes[0].zero_()
            planes[1].fill_(-1)
            planes[2].copy_(pts)
            bad.fill_(N)

        key = f"range_decode_w16s32_P{P}" + (
            "" if lanes == LANES else f"_L{lanes}")

        def launch():
            _build.call("ctt_ilans2_range_decode_w16s32", dev, *planes,
                        words, words.numel(), cdf32, K, o_buf, N, lanes, P,
                        bad)
        reset_range()
        launch()
        check(o_buf, syms, key)
        out[f"{key}_ms"] = _events_ms(launch, reset_range)


# phase A's forms timed where a checkout has ``ctt_ilans2_range_record_
# form_*``: (form, lanes a block, steps a tile, ring stages); form 0 the
# register ring, 1 the TMA ring
RECORD_FORMS = ((0, 128, 16, 0), (0, 128, 32, 0), (0, 64, 32, 0),
                (0, 128, 48, 0), (1, 128, 16, 4), (1, 128, 32, 3),
                (1, 128, 32, 4), (1, 64, 32, 4))


def _time_record(out, syms, probs, check, kernels):
    """Kernels 7 and 9 into ``out``: the range encode's phase A at P=12
    (W=16/S=32, kernel 7) and P=24 (W=32/S=64, kernel 9) on bench.py's
    symbols at L=32768 and 65536, its C entry on preallocated records and
    final (lower, range) planes, against the wrapper's outputs.  Neither
    entry takes a scratch (a checkout whose entry did would need one, by
    its signature's length).  Where the checkout has the form entry, each
    of RECORD_FORMS alike."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build, range_enc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = syms.device
    for kernel, tag, W, S, P in ((7, "w16s32", 16, 32, 12),
                                 (9, "w32s64", 32, 64, 24)):
        if kernel not in kernels:
            continue
        cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, P), dev)
        cdf32 = cdf.to(torch.int32)
        entry = f"ctt_ilans2_range_record_{tag}"
        if len(_build.SIGNATURES[entry]) != 11:
            sys.exit(f"chip_ab: {entry} takes arguments this script does "
                     "not know")
        forms = {"": (entry, ())}
        if f"ctt_ilans2_range_record_form_{tag}" in _build.SIGNATURES:
            for f in RECORD_FORMS:
                name = ("ring", "tma")[f[0]] + "_" + "x".join(
                    str(v) for v in f[1:3 if f[0] == 0 else 4])
                forms["_" + name] = (
                    f"ctt_ilans2_range_record_form_{tag}", f)
        for lanes in (LANES, 2 * LANES):
            cfg = LaneConfig(num_lanes=lanes, word_bits=W, state_bits=S,
                             precision=P)
            want = range_enc.record(syms, cdf, cfg)
            bufs = [torch.empty_like(x) for x in want]
            key = f"record_{tag}" + ("" if lanes == LANES else f"_L{lanes}")
            for suffix, (name, form) in forms.items():
                def launch():
                    _build.call(name, dev, syms, N, cdf32, K, *bufs, lanes,
                                P, *form)
                for b in bufs:
                    b.zero_()
                launch()
                for got, ref in zip(bufs, want):
                    check(got, ref, key + suffix)
                out[f"{key}{suffix}_ms"] = _events_ms(launch)
            # the same bytes as one PyTorch copy: the symbols read once,
            # a record's width written per symbol
            rec = bufs[0][:N]
            out[f"{key}_copy_ms"] = _events_ms(lambda: rec.copy_(syms))
            del want, bufs, rec


def _time_resolve32(out, syms, probs, check):
    """Kernel 8 into ``out``: the S=32 range resolve's C entry on bench.py's
    symbols at L=32768, P=12, on preallocated scratch, against the
    wrapper's points and stream.  A checkout whose entry takes the lane
    state (pend, d1, d2: one block) has it reset outside the CUDA events;
    one with the lane pass and the compaction also times the direct form
    where it has one (a grid pass of flags from the records, one scan, the
    lane pass writing the stream itself)."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build, range_enc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = syms.device
    cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, 12), dev)
    cfg = LaneConfig(num_lanes=LANES, word_bits=16, state_bits=32,
                     precision=12)
    T = -(-N // LANES)
    recs, low_f, rng_f = range_enc.record(syms, cdf, cfg)
    s0, carry = range_enc.seal(low_f, rng_f, cfg)
    pts, words = range_enc.resolve(recs, s0, carry, cfg, N)
    buf = torch.empty(N, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    p_buf = torch.empty_like(pts)
    entry = "ctt_ilans2_range_resolve_w16s32"
    if len(_build.SIGNATURES[entry]) == 12:  # one block, state in place
        lane_state = [torch.empty_like(s0) for _ in range(3)]

        def reset():
            lane_state[0].copy_(carry)
            lane_state[1].copy_(s0)
            lane_state[2].zero_()
        forms = {"": (entry, (recs, *lane_state, buf, N, end, p_buf, LANES,
                              T), reset)}
    else:
        scratch = (torch.empty(T * LANES, dtype=torch.int32, device=dev),
                   torch.empty(T * LANES // 32, dtype=torch.int32,
                               device=dev),
                   torch.empty(1024, dtype=torch.int64, device=dev))
        args = (recs, s0, carry, buf, N, end, p_buf, *scratch, LANES, T)
        forms = {"": (entry, args, None)}
        direct = "ctt_ilans2_range_resolve_direct_w16s32"
        if direct in _build.SIGNATURES:
            forms["_direct"] = (direct, args, None)
    for suffix, (name, args, reset) in forms.items():
        def launch():
            _build.call(name, dev, *args)
        if reset is not None:
            reset()
        launch()
        check(p_buf, pts, f"resolve32{suffix} points")
        check(buf[int(end.item()):], words, f"resolve32{suffix} stream")
        out[f"resolve32{suffix}_ms"] = _events_ms(launch, reset)


def _time_resolve64(out, syms, probs, check):
    """Kernel 10 into ``out``: the S=64 range resolve's C entry on bench.py's
    symbols at P=24, L=32768 and 65536, on preallocated scratch, against
    the wrapper's points and stream.  A checkout whose entry takes the lane
    state (pend, d1, d2: one block) has it reset outside the CUDA events;
    one with the lane pass also times it and pass B alone."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build, range_enc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = syms.device
    cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, 24), dev)
    entry = "ctt_ilans2_range_resolve_w32s64"
    lanes_entry = "ctt_ilans2_range_resolve_lanes_w32s64"
    for lanes in (LANES, 2 * LANES):
        cfg = LaneConfig(num_lanes=lanes, word_bits=32, state_bits=64,
                         precision=24)
        T = -(-N // lanes)
        recs, low_f, rng_f = range_enc.record(syms, cdf, cfg)
        s0, carry = range_enc.seal(low_f, rng_f, cfg)
        pts, words = range_enc.resolve(recs, s0, carry, cfg, N)
        buf = torch.empty(N, dtype=torch.int32, device=dev)
        end = torch.empty(1, dtype=torch.int64, device=dev)
        p_buf = torch.empty_like(pts)
        key = "resolve64" + ("" if lanes == LANES else f"_L{lanes}")
        scratch = ()
        if len(_build.SIGNATURES[entry]) == 12:  # one block, state in place
            lane_state = [torch.empty_like(s0) for _ in range(3)]

            def reset():
                lane_state[0].copy_(carry)
                lane_state[1].copy_(s0)
                lane_state[2].zero_()
            args = (recs, *lane_state, buf, N, end, p_buf, lanes, T)
        else:
            scratch = (torch.empty(T * lanes, dtype=torch.int32, device=dev),
                       torch.empty(T * lanes // 32, dtype=torch.int32,
                                   device=dev),
                       torch.empty(1024, dtype=torch.int64, device=dev))
            reset = None
            args = (recs, s0, carry, buf, N, end, p_buf, *scratch, lanes, T)

        def launch():
            _build.call(entry, dev, *args)
        if reset is not None:
            reset()
        launch()
        check(p_buf, pts, f"{key} points")
        check(buf[int(end.item()):], words, f"{key} stream")
        out[f"{key}_ms"] = _events_ms(launch, reset)
        if scratch and lanes_entry in _build.SIGNATURES:
            out[f"{key}_lanes_ms"] = _events_ms(lambda: _build.call(
                lanes_entry, dev, recs, s0, carry, scratch[0], scratch[1],
                p_buf, lanes, T))
            out[f"{key}_pass_b_ms"] = _events_ms(lambda: _build.call(
                "ctt_ilans2_compact", dev, scratch[1], scratch[0],
                scratch[1].numel(), buf, N, end, scratch[2]))
            check(buf[int(end.item()):], words, f"{key} passes apart")
        del recs


def _time_tchain24(out, check):
    """Kernel 24 into ``out``: the TChain-24 encode's C entry on the JAX
    suite's TChain row (2^24 uniform 24-bit quantiles, K=100 Dirichlet(2),
    seed 1234, L=32768), the heads reset outside the CUDA events; the
    quantiles must come back.  A checkout whose entry takes a records
    scratch gets one."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import tchain as tc

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(1234)
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, 24), dev)
    cdf32 = cdf.to(torch.int32)
    n = 1 << 24
    qt = convert.u32_to_torch(
        rng.randint(0, 1 << 24, size=n).astype(np.uint32), dev)
    syms, rem, heads = tc.tchain24_decode(qt, cdf, tc.TCHAIN24_CFG)
    h_buf = torch.empty_like(heads)
    q_buf = torch.empty_like(qt)
    entry = "ctt_tchain24_encode"
    records = (() if len(_build.SIGNATURES[entry]) == 11 else
               (torch.empty(4 * K, dtype=torch.int32, device=dev),))

    def reset():
        h_buf.copy_(heads)

    def launch():
        _build.call(entry, dev, h_buf, syms, cdf32, K, rem, rem.numel(),
                    q_buf, *records, LANES, n // LANES)
    reset()
    launch()
    check(q_buf, qt, "tchain24 encode")
    out["tchain24_encode_ms"] = _events_ms(launch, reset)


def _time_tchain16(out, check):
    """Kernel 20 into ``out``: the TChain-16 encode's C entry on the JAX
    suite's TChain-16 row (2^24 uniform 16-bit quantiles, K=100
    Dirichlet(2), seed 1234, L=32768), the heads reset outside the CUDA
    events; the quantile words must come back.  A checkout whose entry
    takes a records scratch gets one."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import tchain as tc

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(1234)
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, 16), dev)
    cdf32 = cdf.to(torch.int32)
    n = 1 << 24
    qw = convert.quantiles16_to_torch(
        rng.randint(0, 1 << 16, size=n).astype(np.uint16), LANES, dev)
    syms, rem, heads = tc.tchain16_decode(qw, cdf, tc.TCHAIN_CFG)
    h_buf = torch.empty_like(heads)
    q_buf = torch.empty_like(qw)
    entry = "ctt_tchain16_encode"
    records = (() if len(_build.SIGNATURES[entry]) == 11 else
               (torch.empty(2 * K, dtype=torch.int32, device=dev),))

    def reset():
        h_buf.copy_(heads)

    def launch():
        _build.call(entry, dev, h_buf, syms, cdf32, K, rem, rem.numel(),
                    q_buf, *records, LANES, n // LANES)
    reset()
    launch()
    check(q_buf, qw, "tchain16 encode")
    out["tchain16_encode_ms"] = _events_ms(launch, reset)


def _time_cat_decode(out, check, P: int):
    """Kernel 23 (P=24) or kernel 19 (P=16) into ``out``: the decode's C
    entry on the JAX suite's TChain row at that precision (2^24 uniform
    quantiles, K=100 Dirichlet(2), seed 1234, L=32768), on preallocated
    scratch where it takes some, the heads reset outside the CUDA events;
    symbols, stream and heads must equal the wrapper's.  Where the checkout
    has them, its head pass and pass B alone."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build, coder
    from constriction_tpu_torch.ops import tchain as tc

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(1234)
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, P), dev)
    cdf32 = cdf.to(torch.int32)
    n = 1 << 24
    T = n // LANES
    q = rng.randint(0, 1 << P, size=n)
    if P == 24:
        cfg, decode, seed, head_dtype = (tc.TCHAIN24_CFG, tc.tchain24_decode,
                                         256, torch.int64)
        qt = convert.u32_to_torch(q.astype(np.uint32), dev)
    else:
        cfg, decode, seed, head_dtype = (tc.TCHAIN_CFG, tc.tchain16_decode, 1,
                                         torch.int32)
        qt = convert.quantiles16_to_torch(q.astype(np.uint16), LANES, dev)
    want = decode(qt, cdf, cfg)
    i32 = {"dtype": torch.int32, "device": dev}
    h_buf = torch.empty(LANES, dtype=head_dtype, device=dev)
    s_buf, w_buf = torch.empty(n, **i32), torch.empty(n, **i32)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    words, flags, offsets = coder.compaction_scratch(T, LANES, dev)
    entry, key = f"ctt_tchain{P}_decode", f"tchain{P}_decode"
    scratch = (() if len(_build.SIGNATURES[entry]) == 12 else
               (words, flags, offsets))

    def reset():
        h_buf.fill_(seed)

    def same(what):
        check(s_buf, want[0], f"{what} symbols")
        check(w_buf[int(end.item()):], want[1], f"{what} stream")
        check(h_buf, want[2], f"{what} heads")

    def launch():
        _build.call(entry, dev, h_buf, qt, cdf32, K, s_buf, w_buf, n, end,
                    *scratch, LANES, T)
    reset()
    launch()
    same(key)
    out[f"{key}_ms"] = _events_ms(launch, reset)
    if f"ctt_tchain{P}_head_pass" in _build.SIGNATURES:
        out[f"{key}_heads_ms"] = _events_ms(
            lambda: _build.call(f"ctt_tchain{P}_head_pass", dev, h_buf, qt,
                                cdf32, K, s_buf, words, flags, LANES, T),
            reset)
        out[f"{key}_pass_b_ms"] = _events_ms(
            lambda: _build.call("ctt_ilans2_compact", dev, flags, words,
                                flags.numel(), w_buf, n, end, offsets))
        same(f"{key} passes apart")


def _time_tchain12(out, check):
    """Kernel 21 into ``out``: whole calls of the wrapper (launches, the
    scratch from PyTorch's caching allocator, the read-back of the
    stream's start) on the family row's inputs, at 2^23 and 2^24
    quantiles; at 2^23 also its C entry on preallocated scratch and its
    head pass alone on the inversion pass's records (the heads reset
    outside the CUDA events), each checked against the call."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import tchain as tc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    cfg = LaneConfig(num_lanes=LANES, word_bits=16, state_bits=32,
                     precision=12)
    rng = np.random.RandomState(1234)
    n_max = 1 << 24
    means = (rng.randn(n_max) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n_max)) * 5).astype(np.float32)
    quantiles = rng.randint(0, 1 << 12, size=n_max).astype(np.uint16)
    for n in (1 << 23, n_max):
        mu, sg = convert.params_to_torch(means[:n], scales[:n], n, LANES,
                                         dev)
        qw = convert.quantiles_to_torch(quantiles[:n], LANES, dev)
        got = tc.tchain12_family_decode(qw, mu, sg, "gaussian", -100, 100,
                                        cfg)
        if n == 1 << 23:
            want = tc.tchain12_family_decode_plain(qw, mu, sg, "gaussian",
                                                   -100, 100, cfg)
            for a, b, what in zip(got, want, ("symbols", "stream", "heads")):
                check(a, b, f"tchain12 {what}")
            _time_tchain12_entry(out, check, qw, mu, sg, got, n)
        out[f"tchain12_decode_n{n.bit_length() - 1}_ms"] = _events_ms(
            lambda: tc.tchain12_family_decode(qw, mu, sg, "gaussian", -100,
                                              100, cfg))


def _time_tchain12_entry(out, check, qw, mu, sg, want, n):
    """Kernel 21's C entry (gaussian) and its head pass alone into
    ``out``."""
    import torch

    from constriction_tpu_torch.ops import _build, coder

    dev = qw.device
    T = n // LANES
    i32 = {"dtype": torch.int32, "device": dev}
    h_buf, s_buf = torch.empty(LANES, **i32), torch.empty(n, **i32)
    w_buf, recs = torch.empty(n, **i32), torch.empty(n, **i32)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    words, flags, offsets = coder.compaction_scratch(T, LANES, dev)

    def reset():
        h_buf.fill_(16)

    def launch():
        _build.call("ctt_tchain12_family_decode", dev, h_buf, qw, mu, sg,
                    s_buf, w_buf, n, end, recs, words, flags, offsets,
                    LANES, T, 0, -100, 100)

    reset()
    launch()
    check(s_buf, want[0], "tchain12 entry symbols")
    check(w_buf[int(end.item()):], want[1], "tchain12 entry stream")
    check(h_buf, want[2], "tchain12 entry heads")
    out["tchain12_decode_entry_ms"] = _events_ms(launch, reset)
    out["tchain12_decode_heads_ms"] = _events_ms(
        lambda: _build.call("ctt_tchain12_head_pass", dev, h_buf, recs,
                            words, flags, LANES, T), reset)
    check(h_buf, want[2], "tchain12 head pass heads")


def _time_tchain12_encode(out, check):
    """Kernel 22 into ``out``: the TChain-12 family encode's C entry
    (gaussian) on the family row's 2^23 quantiles decoded at L=32768, on
    preallocated scratch (8 bytes a symbol; a checkout whose entry takes a
    u16 quantile scratch too gets one), the heads reset and the quantile
    words zeroed outside the CUDA events; the quantiles must come back and
    every head must be 16.  Where the checkout has them, its tables pass
    and, on those records, its cluster step with the packing pass."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import tchain as tc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    cfg = LaneConfig(num_lanes=LANES, word_bits=16, state_bits=32,
                     precision=12)
    rng = np.random.RandomState(1234)
    n = 1 << 23
    T = n // LANES
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    quantiles = rng.randint(0, 1 << 12, size=n).astype(np.uint16)
    mu, sg = convert.params_to_torch(means, scales, n, LANES, dev)
    qw = convert.quantiles_to_torch(quantiles, LANES, dev)
    syms, rem, heads = tc.tchain12_family_decode(qw, mu, sg, "gaussian",
                                                 -100, 100, cfg)
    h_buf, q_buf = torch.empty_like(heads), torch.empty_like(qw)
    recs = torch.empty(n, dtype=torch.int64, device=dev)
    q16 = torch.empty(n // 2, dtype=torch.int32, device=dev)
    entry = "ctt_tchain12_family_encode"
    scratch = (recs,) if len(_build.SIGNATURES[entry]) == 15 else (recs, q16)

    def reset():
        h_buf.copy_(heads)
        q_buf.zero_()

    def launch():
        _build.call(entry, dev, h_buf, syms, mu, sg, rem, rem.numel(),
                    *scratch, q_buf, LANES, T, 0, -100, 100)

    def same(what):
        check(q_buf, qw, f"{what} quantiles")
        check(h_buf, torch.full_like(h_buf, 16), f"{what} heads")

    reset()
    launch()
    same("tchain12 encode")
    out["tchain12_encode_ms"] = _events_ms(launch, reset)
    if "ctt_tchain12_tables_pass" in _build.SIGNATURES:
        out["tchain12_encode_tables_ms"] = _events_ms(
            lambda: _build.call("ctt_tchain12_tables_pass", dev, syms, mu, sg,
                                recs, LANES, T, 0, -100, 100))
        out["tchain12_encode_step_ms"] = _events_ms(
            lambda: _build.call("ctt_tchain12_encode_step", dev, h_buf, recs,
                                rem, rem.numel(), q16, q_buf, LANES, T),
            reset)
        same("tchain12 encode passes apart")


def _time_family_encode(out, check):
    """Kernel 12 into ``out`` (see the module docstring)."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build, coder
    from constriction_tpu_torch.ops import family as fam
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    n = 1 << 23
    T = n // LANES
    cfg = LaneConfig(num_lanes=LANES, word_bits=16, state_bits=32,
                     precision=12)
    rng = np.random.RandomState(1234)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    symbols = np.clip(np.round(means + rng.randn(n) * scales), -100, 100
                      ).astype(np.int32)
    mu, sg = convert.params_to_torch(means, scales, n, LANES, dev)
    syms = torch.from_numpy(symbols).to(dev)
    st, w = fam.encode_family(syms, mu, sg, "gaussian", -100, 100, cfg)
    states = torch.empty_like(st)
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    recs = torch.empty(n, dtype=torch.int64, device=dev)
    entry = "ctt_family_encode"
    passes = len(_build.SIGNATURES[entry]) > 15
    if passes:
        words, flags, offsets = coder.compaction_scratch(T, LANES, dev)
        scratch = (recs, buf, n, end, words, flags, offsets)
    else:  # one block: L words of pending tables
        scratch = (recs, buf, n, end)

    def reset():
        states.fill_(1 << 16)

    def launch():
        _build.call(entry, dev, states, syms, n, mu, sg, *scratch, LANES, 0,
                    -100, 100)

    def same(what):
        check(states, st, f"{what} states")
        check(buf[int(end.item()):], w, f"{what} stream")

    reset()
    launch()
    same("family encode")
    out["family_encode_ms"] = _events_ms(launch, reset)
    if not passes:
        return
    out["family_encode_tables_ms"] = _events_ms(
        lambda: _build.call("ctt_family_tables_pass", dev, syms, mu, sg, recs,
                            n, 0, -100, 100))
    out["family_encode_pass_a_ms"] = _events_ms(
        lambda: _build.call("ctt_family_encode_lanes", dev, states, recs, n,
                            words, flags, LANES), reset)
    out["family_encode_pass_b_ms"] = _events_ms(
        lambda: _build.call("ctt_ilans2_compact", dev, flags, words,
                            flags.numel(), buf, n, end, offsets))
    same("family encode passes apart")


def _narrow_chunk(args):
    """The host builder's narrow tables of a run of steps (a worker
    process): ``exact_family.narrow_tables`` at the chunk's own cmax."""
    root, means, scales, nsteps, R = args
    sys.path.insert(0, os.path.abspath(root))
    from constriction_tpu_torch.ops import exact_family as ef

    return ef.narrow_tables(means, scales, "gaussian", -100, 100, 12, None,
                            nsteps, R)[0]


def _exact32_tables(root: str, means, scales):
    """Kernel 13's narrow tables u32[T, CP1, R, 128] for the default call:
    from the run's cache directory ($CHIP_AB_CACHE) when an earlier
    checkout built them, else built in step chunks by up to 8 worker
    processes, each chunk padded to the widest chunk's planes with 0xFFFF
    pairs (fields no quantile selects), and cached."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    cache = os.environ.get("CHIP_AB_CACHE")
    path = os.path.join(cache, "exact32_tables.npy") if cache else None
    if path and os.path.exists(path):
        return np.load(path)
    T = N_EXACT32 // LANES
    per = -(-T // min(8, os.cpu_count() or 1))
    chunks = [(root, means[t * LANES:(t + per) * LANES],
               scales[t * LANES:(t + per) * LANES], min(per, T - t),
               LANES // 128)
              for t in range(0, T, per)]
    with ProcessPoolExecutor(
            max_workers=len(chunks),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(_narrow_chunk, chunks))
    cp1 = max(p.shape[1] for p in parts)
    tabs = np.concatenate([np.concatenate([p, np.full(
        (p.shape[0], cp1 - p.shape[1], *p.shape[2:]), 0xFFFFFFFF, np.uint32)],
        1) for p in parts])
    if path:
        np.save(path, tabs)
    return tabs


def _time_exact32(out, check, root: str):
    """Kernel 13 into ``out`` (see the module docstring)."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    n = N_EXACT32
    cfg = LaneConfig(num_lanes=LANES, word_bits=16, state_bits=32,
                     precision=12)
    means, scales, symbols = _exact_workload(n)
    cums, probs = ef.exact_ecp(symbols, means, scales, "gaussian", -100, 100,
                               12)
    c_t, p_t = convert.ecp_to_torch(cums, probs, LANES, dev)
    st, w = ef.encode_tables(c_t, p_t, cfg, None, n)
    tabs = convert.exact_tables_to_torch(_exact32_tables(root, means, scales),
                                         dev)
    syms = torch.from_numpy(symbols.astype(np.int32)).to(dev)
    states = torch.empty_like(st)
    o_buf = torch.empty(n, dtype=torch.int32, device=dev)
    out["decode32_planes"] = int(tabs.shape[1])
    modes = {"": int(ef.bisect_tables(tabs.shape[1], True)), "_scan": 0,
             "_bisect": 1}
    for suffix, bisect in modes.items():
        def launch():
            _build.call("ctt_exact_decode32", dev, states, w, w.numel(), tabs,
                        tabs.shape[1], o_buf, n, LANES, 12, -100, 100,
                        bisect, None)

        states.copy_(st)
        launch()
        check(o_buf, syms, f"decode32{suffix}")
        out[f"decode32{suffix}_ms"] = _events_ms(
            launch, lambda: states.copy_(st))


def _time_exact(out, check):
    """Kernel 15 into ``out``: the ungrouped exact row over tables built on
    the card, at L=32768 and L=65536 (2 and 4 lanes a thread)."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import exact_tables as et
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    means, scales, esyms = _exact_workload(N_EXACT)
    want = torch.from_numpy(esyms.astype(np.int32))
    cu, pr = ef.exact_ecp(esyms, means, scales, "gaussian", -100, 100, 24)
    cmax = min(255, -(-int(ef._ncore_estimate(
        means, scales, "gaussian", -100, 100).max()) // 4) * 4)
    for lanes in (LANES, 2 * LANES):
        cfg = LaneConfig(num_lanes=lanes, word_bits=32, state_bits=64,
                         precision=24)
        c_t, p_t = convert.ecp_to_torch(cu, pr, lanes, dev)
        st, w = ef.encode_tables(c_t, p_t, cfg, None, N_EXACT)
        del c_t, p_t
        T = -(-N_EXACT // lanes)
        pm, ps = ef._pad_params(means, scales, T * lanes, "gaussian", 100)
        (tabs, _), = et.packed_tables_on_device_batch(
            [(pm, ps, cmax, T)], "gaussian", -100, 100, 24, lanes, dev)
        s_buf = torch.empty_like(st)
        e_buf = torch.empty(N_EXACT, dtype=torch.int32, device=dev)
        bisect = int(ef.bisect_tables(tabs.shape[1]))

        def launch_exact():
            _build.call("ctt_exact_decode64", dev, s_buf, w, w.numel(), tabs,
                        tabs.shape[1], e_buf, N_EXACT, lanes, 24, -100, 100,
                        bisect, None)

        key = "exact_decode" + ("" if lanes == LANES else f"_L{lanes}")
        s_buf.copy_(st)
        launch_exact()
        check(e_buf.cpu(), want, key)
        out["exact_planes"] = int(tabs.shape[1])
        out[f"{key}_ms"] = _events_ms(launch_exact, lambda: s_buf.copy_(st))


def _time_exact_encode(out, check):
    """Kernel 17 into ``out``: the C entry on the exact row's planes at
    L=32768, the states reset outside the CUDA events, against the
    wrapper's states and stream; on preallocated scratch where the entry
    takes some, and then its pass A and pass B alone too."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    means, scales, esyms = _exact_workload(N_EXACT)
    cu, pr = ef.exact_ecp(esyms, means, scales, "gaussian", -100, 100, 24)
    cfg = LaneConfig(num_lanes=LANES, word_bits=32, state_bits=64,
                     precision=24)
    c_t, p_t = convert.ecp_to_torch(cu, pr, LANES, dev)
    st, w = ef.encode_tables(c_t, p_t, cfg, None, N_EXACT)
    T = -(-N_EXACT // LANES)
    s_buf = torch.empty_like(st)
    buf = torch.empty(N_EXACT, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    entry = "ctt_exact_encode64"
    scratch = ()
    if len(_build.SIGNATURES[entry]) > 11:
        scratch = (torch.empty(T * LANES, dtype=torch.int32, device=dev),
                   torch.empty(T * LANES // 32, dtype=torch.int32,
                               device=dev),
                   torch.empty(1024, dtype=torch.int64, device=dev))

    def reset():
        s_buf.fill_(1 << 32)

    def launch():
        _build.call(entry, dev, s_buf, c_t, p_t, N_EXACT, buf, N_EXACT, end,
                    *scratch, LANES, 24)

    reset()
    launch()
    check(s_buf, st, "exact encode states")
    check(buf[int(end.item()):], w, "exact encode stream")
    out["exact_encode_ms"] = _events_ms(launch, reset)
    if scratch and "ctt_exact_encode_lanes64" in _build.SIGNATURES:
        out["exact_encode_pass_a_ms"] = _events_ms(lambda: _build.call(
            "ctt_exact_encode_lanes64", dev, s_buf, c_t, p_t, N_EXACT,
            scratch[0], scratch[1], LANES, 24), reset)
        check(s_buf, st, "exact encode pass A states")
        out["exact_encode_pass_b_ms"] = _events_ms(lambda: _build.call(
            "ctt_ilans2_compact", dev, scratch[1], scratch[0],
            scratch[1].numel(), buf, N_EXACT, end, scratch[2]))
        check(buf[int(end.item()):], w, "exact encode passes apart")


def _time_family(out, check):
    """Kernel 11 into ``out``: the C entry on the family row, each family,
    the states reset outside the CUDA events."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import family as fam
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    n = 1 << 23
    cfg = LaneConfig(num_lanes=LANES, word_bits=16, state_bits=32,
                     precision=12)
    rng = np.random.RandomState(1234)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    symbols = np.clip(np.round(means + rng.randn(n) * scales), -100, 100
                      ).astype(np.int32)
    mu, sg = convert.params_to_torch(means, scales, n, LANES, dev)
    syms = torch.from_numpy(symbols).to(dev)
    o_buf = torch.empty(n, dtype=torch.int32, device=dev)
    for fi, family in enumerate(fam.FAMILIES):
        st, w = fam.encode_family(syms, mu, sg, family, -100, 100, cfg)
        s_buf = torch.empty_like(st)

        def launch():
            _build.call("ctt_family_decode", dev, s_buf, w, w.numel(), mu, sg,
                        o_buf, n, LANES, fi, -100, 100)

        s_buf.copy_(st)
        launch()
        check(o_buf, syms, f"family {family}")
        out[f"family_decode_{family}_ms"] = _events_ms(
            launch, lambda: s_buf.copy_(st))


def _time_exact_seg(out, check):
    """Kernel 16 into ``out``: the exact row's grouped decode, its launches
    as one chain on preallocated buffers (the states and the base reset
    outside the events), each launch alone, and the host time of issuing
    the chain."""
    import time

    import numpy as np
    import torch

    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    lo, hi = -100, 100
    means, scales, esyms = _exact_workload(N_EXACT)
    cfg = LaneConfig(num_lanes=LANES, word_bits=32, state_bits=64,
                     precision=24)
    perm, segs = ef.group_plan(means, scales, "gaussian", lo, hi, 24, LANES,
                               N_EXACT)
    st, w = ef.encode_family_exact_grouped(esyms, means, scales, "gaussian",
                                           lo, hi, cfg, dev)
    T = -(-N_EXACT // LANES)
    pm, ps = ef._pad_params(means[perm], scales[perm], T * LANES, "gaussian",
                            hi)
    built = ef._segment_tables(pm, ps, segs, "gaussian", lo, hi, cfg, dev,
                               device_tables=True)
    # the crossover of this checkout's kernel 16 (its own constant before
    # the two were merged)
    seg_from = getattr(ef, "BISECT_FROM_PLANES_SEG", ef.BISECT_FROM_PLANES)
    s_buf = torch.empty_like(st)
    b_buf = torch.empty(1, dtype=torch.int64, device=dev)
    o_buf = torch.empty(N_EXACT, dtype=torch.int32, device=dev)
    launches = []
    for t0, ns, _ in segs:
        r0, k = t0 * LANES, min(ns * LANES, N_EXACT - t0 * LANES)
        tb = built[len(launches)][0]
        launches.append(lambda r0=r0, k=k, tb=tb: _build.call(
            "ctt_exact_decode64_seg", dev, s_buf, w, w.numel(), tb,
            tb.shape[1], o_buf[r0:], k, LANES, 24, lo, hi,
            int(tb.shape[1] >= seg_from), b_buf))

    def reset():
        s_buf.copy_(st)
        b_buf.zero_()

    def chain():
        for launch in launches:
            launch()

    reset()
    chain()
    check(o_buf.cpu(), torch.from_numpy(esyms[perm].astype(np.int32)),
          "exact segments")
    out["exact_seg_planes"] = [int(tb.shape[1]) for tb, _ in built]
    out["exact_seg_chain_ms"] = _events_ms(chain, reset)
    alone, enqueue = [], []
    for _ in range(REPS):
        total = 0.0
        reset()
        for launch in launches:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        alone.append(total)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain()
        enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    out["exact_seg_launches_alone_ms"] = alone
    out["exact_seg_enqueue_ms"] = enqueue


def _time_exact_encode32(out, check):
    """Kernel 14 into ``out``: the C entry on the default exact call's
    planes (2^20 symbols, P=12, L=32768), the states reset outside the CUDA
    events, against the wrapper's states and stream; on preallocated
    scratch where the entry takes some (a checkout whose entry takes none
    runs one block), and then its pass A and pass B alone too."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    dev = torch.device("cuda", 0)
    n = N_EXACT32
    means, scales, esyms = _exact_workload(n)
    cu, pr = ef.exact_ecp(esyms, means, scales, "gaussian", -100, 100, 12)
    cfg = LaneConfig(num_lanes=LANES, word_bits=16, state_bits=32,
                     precision=12)
    c_t, p_t = convert.ecp_to_torch(cu, pr, LANES, dev)
    st, w = ef.encode_tables(c_t, p_t, cfg, None, n)
    T = -(-n // LANES)
    s_buf = torch.empty_like(st)
    buf = torch.empty(n, dtype=torch.int32, device=dev)
    end = torch.empty(1, dtype=torch.int64, device=dev)
    entry = "ctt_exact_encode32"
    scratch = ()
    if len(_build.SIGNATURES[entry]) > 11:
        scratch = (torch.empty(T * LANES, dtype=torch.int32, device=dev),
                   torch.empty(T * LANES // 32, dtype=torch.int32,
                               device=dev),
                   torch.empty(1024, dtype=torch.int64, device=dev))

    def reset():
        s_buf.fill_(1 << 16)

    def launch():
        _build.call(entry, dev, s_buf, c_t, p_t, n, buf, n, end, *scratch,
                    LANES, 12)

    reset()
    launch()
    check(s_buf, st, "exact32 encode states")
    check(buf[int(end.item()):], w, "exact32 encode stream")
    out["exact32_encode_ms"] = _events_ms(launch, reset)
    if not scratch:
        return
    out["exact32_encode_pass_a_ms"] = _events_ms(lambda: _build.call(
        "ctt_exact_encode_lanes32", dev, s_buf, c_t, p_t, n, scratch[0],
        scratch[1], LANES, 12), reset)
    check(s_buf, st, "exact32 encode pass A states")
    out["exact32_encode_pass_b_ms"] = _events_ms(lambda: _build.call(
        "ctt_ilans2_compact", dev, scratch[1], scratch[0],
        scratch[1].numel(), buf, n, end, scratch[2]))
    check(buf[int(end.item()):], w, "exact32 encode passes apart")


def _time_eval_window(out, check):
    """Kernel 18 into ``out``: one launch a segment of the exact row's
    grouped plan (2^22 symbols, gaussian, P=24, L=32768) over the
    builder's windows, launched back to back (CUDA events around the
    chain), every entry and flag checked against ``eval_window_plain``,
    and the live share where the checkout has ``live_ends_plain``."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import exact_tables as et

    dev = torch.device("cuda", 0)
    lo, hi, P = -100, 100, 24
    means, scales, _ = _exact_workload(N_EXACT)
    perm, segs = ef.group_plan(means, scales, "gaussian", lo, hi, P, LANES,
                               N_EXACT)
    T = -(-N_EXACT // LANES)
    pm, ps = ef._pad_params(means[perm], scales[perm], T * LANES, "gaussian",
                            hi)
    CL = ef._EST_C["gaussian"][0]
    t_star, eps, has_star = et._band("gaussian")
    wins = []
    for t0, ns, cm in segs:
        m = pm[t0 * LANES:(t0 + ns) * LANES]
        sc = ps[t0 * LANES:(t0 + ns) * LANES]
        ws = np.clip(np.ceil(m - CL * sc) - 3.0, lo + 1, hi).astype(np.int32)
        W = min(cm + 16, hi - lo + 17)
        m_t, s_t = convert.params64_to_torch(m, sc, dev)
        wins.append((m_t, s_t, torch.from_numpy(ws).to(dev), W,
                     torch.empty((len(m), W), dtype=torch.int32, device=dev),
                     torch.empty((len(m), W), dtype=torch.bool, device=dev)))
    out["eval_launches"] = len(wins)
    out["eval_entries"] = sum(m_t.numel() * W for m_t, _, _, W, _, _ in wins)
    if hasattr(et, "live_ends_plain"):
        live = sum(int(et.live_ends_plain(m_t, s_t, ws_t, "gaussian", hi,
                                          W).sum())
                   for m_t, s_t, ws_t, W, _, _ in wins)
        out["eval_live_share"] = live / out["eval_entries"]
    def launch():
        for m_t, s_t, ws_t, W, tv, amb in wins:
            _build.call("ctt_exact_eval_window", dev, m_t, s_t, ws_t,
                        m_t.numel(), W, 0, lo, hi, P, t_star, eps,
                        int(has_star), tv, amb)

    launch()
    for m_t, s_t, ws_t, W, tv, amb in wins:
        tv_p, amb_p = et.eval_window_plain(m_t, s_t, ws_t, "gaussian", lo, hi,
                                           P, W)
        check(tv, tv_p, "eval_window tv")
        check(amb, amb_p, "eval_window ambig")
        del tv_p, amb_p
    out["eval_window_ms"] = _events_ms(launch)


def main(argv: list[str]) -> int:
    kernels = ("1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,22,"
               "23,24")
    if len(argv) > 1 and argv[0] == "--kernels":
        kernels, argv = argv[1], argv[2:]
    if len(argv) == 2 and argv[0] == "--one":
        picked = {int(k) for k in kernels.split(",")}
        print(json.dumps(time_decodes(argv[1], picked)), flush=True)
        return 0
    if not argv:
        sys.exit(f"usage: chip_ab.py [--kernels {kernels}] CHECKOUT ...")
    with tempfile.TemporaryDirectory() as cache:
        env = {**os.environ, "CHIP_AB_CACHE": cache}
        for root in argv:
            done = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--kernels", kernels, "--one", root],
                                  env=env)
            if done.returncode != 0:
                return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
