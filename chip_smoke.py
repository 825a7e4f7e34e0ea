#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (constriction_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA device (it exits non-zero without one), nvcc and g++; it
builds the kernels from constriction_tpu_torch/ops/csrc and the host codec
(constriction_tpu_torch/native) into build/ first.  It
prints one JSON object per phase, then the kernels line, the card's
``nvidia-smi`` name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.

1. build         -- nvcc build time (one nvcc per source, in parallel),
                    ptxas register/shared-memory report.
   native        -- the host codec (``constriction_tpu_torch/native``, C++
                    built with g++ at first use): its build time, the
                    host's CPU model and OpenMP team size, and each entry
                    point the port binds against its plain numpy version,
                    byte for byte, with both times: erf / erfc on 2^20
                    values, the exact-family tables (``exact_ecp``,
                    ``exact_ncore``, ``exact_boundary_tables``,
                    ``_packed_table_rows``, ``packed_tables_device`` with
                    unique and with repeated (mean, scale) pairs,
                    ``exact_tv_at``) on 2^16 models (binomial's tables on
                    2^12), and the shared-stream coders (``encode_shared``
                    seeded and not, ``decode_shared_cdf``,
                    ``build_checkpoints``, ``encode_shared_range``,
                    ``decode_shared_range_cdf``) on 2^20 symbols at both
                    presets (L=32768); a range encode at (W, S, P) = (8,
                    32, 8), which the plain encoder does not take,
                    round-tripped through the plain decoder.
   geometry      -- the launch geometry of the cluster decodes and
                    two-pass encodes at L=32768 and 65536: the rANS pairs
                    at both presets (kernels 1 and 2 at P=24; kernels 3 and
                    4 at P=12 and P=16), the range decodes (kernel 5 at
                    P=24, kernel 6 at P=12 and P=16), the S=64 exact
                    table decodes (kernels 15 and 16), the S=32 one
                    (kernel 13), the family decode (kernel 11, each
                    family) and the TChain cluster encodes (kernels 20,
                    24 and 22's step):
                    the decode's cluster size,
                    CTAs, threads, lanes per thread, the card's maximum of
                    such active clusters (more than one CTA, or the run
                    fails), its bucket table's lut_bits and whether the CDF
                    is in shared memory, the encode's pass-A grid, and
                    ptxas' registers and spills for their kernels at each
                    preset and lanes a thread and for the lane passes of
                    kernels 21, 23, 19, 8, 10, 17, 14 and 12, the range
                    encode's phase A (kernels 7 and 9), the family
                    tables pass (kernels 22 and 12) and the window
                    evaluator (kernel 18, each family).  A spill in the
                    range decodes or kernels 11, 13, 15, 16, 20, 24 and 22
                    at 2 or 4 lanes a thread, or in those lane passes or
                    kernel 18, fails the run, as does kernel 11, 13, 16,
                    20, 24 or 22 on fewer than 16 CTAs at L=32768.
2. kernels       -- each rANS kernel against its plain PyTorch twin on the
                    same CUDA tensors and against the host oracle (the
                    host codec's ILANS2 coder; L=32768, about 2^20
                    symbols, with and without seeds):
                    streams, initial and final lane states and symbols must
                    be identical (integer coding: tolerance 0).
3. main path     -- bench.py's workload (2^25 symbols, K=100, Dirichlet(2),
                    seed 1234) through ``constriction_tpu_torch.cuda.
                    encode_iid`` -> ``decode_iid`` at P=24 and P=12, v2 and
                    v1 containers.  Each container must equal the host
                    oracle's byte for byte and decode to the symbols; every
                    rANS kernel must have launched.
4. times         -- kernel-only rANS encode/decode at that size (CUDA
                    events), and the twins on the card at the same size,
                    whose streams, states and symbols must equal the
                    kernels'; kernel times at bench.py's explicit configs
                    (L=65536, P=24 and P=12); the DEFAULT preset's pair
                    also at P=12 (L=32768 and 65536), the small preset's
                    also at P=16 (L=32768 and 65536), and each encode's
                    pass A and pass B timed apart.
5. sweep         -- kernel time per coding step at T=256 steps over
                    L=128 .. 65536, both presets and kernel 11 (gaussian,
                    its C entry): the per-step floor (at L=128) and the
                    added microseconds per 1024 lanes (the slope from
                    L=4096 to 65536).
6. range_kernels -- each of the six range kernels (phase A, phase B,
                    decode; both presets) against its twin on the same CUDA
                    tensors and against the port's host range coder
                    (L=32768, about 2^20 symbols, P=24 and P=12, and a
                    skewed carry-run model; the S=32 preset also at
                    L=65536 and at P=16), plus a seeded decode from a
                    checkpoint of ``build_checkpoints_range``: records,
                    final planes, points, streams and symbols identical.
7. range_main_path -- the same 2^25-symbol workload through
                    ``cuda.encode_iid_range`` -> ``decode_iid_range`` at
                    P=24 and P=12 (the facade's L, 32768): points and stream
                    byte for byte the host oracle's, the decode equal to the
                    symbols; every range kernel must have launched.
8. range_times   -- kernel-only time of each range kernel at that size
                    (CUDA events around each launch, after a warm-up; the
                    C entries on preallocated scratch), phase B's lane
                    pass and pass B timed apart at both presets (kernels 8
                    and 10), phase A's launch shape (depth, ring stages,
                    shared-memory bytes) and achieved TB/s (kernels 7 and
                    9), its twin's time on the card (outputs equal
                    to the kernel's), and the facade's encode and decode
                    call times and host shares.
   range_sweep   -- the range decodes' time per coding step (kernel 5 at
                    P=24, kernel 6 at P=12) at T=256 steps over L=128 ..
                    65536, as phase 5 fits it.

9. family_math   -- the kernels' integer CDF (``left(x, mean, scale)``,
                    through the test entry point ``ctt_family_left``)
                    against the plain arithmetic in torch on the card and
                    in numpy, for all four families: every ``t_fix`` in
                    [-32768, 32767], 2^22 random (x, mean, scale) triples at
                    support [-100, 100], and an extreme grid (scale 1e-6 ..
                    1e6, mean -500 .. 500).  Tolerance 0.
10. family_kernels -- the rANS family pair and the TChain-12 bits-back pair
                    against their twins and the port's numpy host oracles,
                    all four families, L=32768 (about 2^20 symbols with a
                    partial last step; 32 full steps for TChain): states,
                    heads, words, quantiles and symbols identical; the
                    rANS encode's three steps (tables pass, pass A, pass
                    B), the TChain-12 decode's three steps (inversion,
                    heads, pass B) and its encode's tables pass also
                    launched alone, each against its plain version.
11. family_main_path -- the JAX package's family benchmark workload (2^23
                    symbols, gaussian, support [-100, 100], seed 1234)
                    through ``cuda.encode_family`` -> ``decode_family`` and
                    2^23 uniform 12-bit quantiles through
                    ``cuda.bits_back_decode_family`` ->
                    ``bits_back_encode_family``: byte for byte the host
                    oracles', exact round trips, heads back at 16; each of
                    the four kernels must have launched.
12. family_times -- kernel-only time of each of the four at that size, its
                    twin's time on the card (outputs equal), the facade's
                    call times, and each kernel's bound; kernel 11's C
                    entry for each of the four families (each on its own
                    encode's stream); the TChain-12 decode's three steps
                    timed apart, and the whole decode at 2^24 quantiles
                    too; the rANS encode's three steps timed apart; the
                    TChain-12 encode's tables pass apart from its
                    cluster step and packing pass.
13. checkpoints  -- random access: on the v2 and v1 containers of the rANS
                    main path at both presets, ``cuda.build_checkpoints``
                    then ``cuda.decode_from_checkpoint`` from the middle
                    checkpoint must give the message's suffix, through the
                    decode kernels; ``build_checkpoints`` timed as it runs
                    (the host codec at S=32) and with its plain version in
                    place, whose snapshots must be the same.
    sharded      -- the block-sharded containers (``constriction_tpu_torch.
                    parallel``, B=8, the config ``parallel.encode`` picks),
                    each call one block program (upload, launch, gather);
                    in ``sharded_bytes``, ``sharded_main_path`` and
                    ``sharded_dryrun`` every launch half runs under
                    ``torch.cuda.set_sync_debug_mode("error")`` (any
                    read-back in it fails the run) and each call's uploads
                    and read-backs are counted: ``sharded_bytes``: v1 rANS,
                    compact v2 rANS and v1 range containers of the first
                    N_KERNEL_CHECK symbols at P=24 and P=12 written on the
                    card, and on device lists that repeat it 2 and 8
                    times, byte for byte the port's host coders'
                    (``parallel.encode_host``), decoded exactly, and one
                    within-block checkpoint seek per preset;
                    ``sharded_main_path``: the main workload (2^25 symbols)
                    through ``parallel.encode`` -> ``decode`` for the six
                    containers, exact, with the call times, each call's
                    launches (one a block) and transfers, L and T per
                    block and the size against the single v2 container;
                    every rANS and range kernel must have launched;
                    ``sharded_times``: each container's B block calls back
                    to back between CUDA events beside one call of the
                    same wrapper on the same symbols, and the block
                    program's encode and decode on the host clock
                    (``program_*_ms``: launch and gather;
                    ``program_launch_*_ms``: the launch half and a
                    synchronize), on every card where torch sees more than
                    one; ``sharded_dryrun``: ``parallel.dryrun([card])``
                    (three containers and the eight block legs), whose
                    kernels must all have launched.
14. tchain_kernels -- the TChain-16 and TChain-24 pairs against their twins
                    and the port's numpy host oracles (L=32768, 2^20
                    quantiles, a K=100 Dirichlet(2) model at P=16 and P=24):
                    symbols, remainders, heads and re-encoded quantiles
                    identical, every head back at its seed; each decode's
                    two steps (the head pass, pass B) also launched alone,
                    each against its plain version.
15. tchain_main_path -- the JAX package's TChain benchmark rows (2^24
                    uniform quantiles, that model, L=32768, T=512) through
                    ``cuda.bits_back_decode`` -> ``bits_back_encode`` and
                    ``bits_back_decode24`` -> ``bits_back_encode24``: the
                    decode byte for byte the host oracle's, the quantiles
                    back with every head at 1 (P=16) and 256 (P=24); each of
                    the four kernels must have launched.
16. tchain_times -- kernel-only time of each of the four at that size (C
                    entries on preallocated buffers; kernels 20 and 24 with
                    their records' scratch, kernels 19 and 23 with the
                    compaction's), each decode's two steps timed apart,
                    its twin's time on the card (outputs equal), the
                    facade's call times and host shares, and each
                    kernel's bound.
    tchain_sweep -- the cluster encodes' time per coding step at T=256
                    steps, kernel 24 over L=128 .. 65536, kernel 20 over
                    L=256 .. 65536 and kernel 22's cluster step and
                    packing pass (on its tables pass's records) over
                    L=1024 .. 65536, as phase 5 fits it.
17. chain_decode -- ``cuda.decode_chain_iid`` on 2^24 symbols of random
                    chain data (K=100, P=24) and ``cuda.decode_chain_rows``
                    on 2^20 symbols with a K=16 model each, against the
                    port's numpy path (torch operations, no kernel of this
                    repository).
18. exact_builder -- the reference-exact families' on-card table builder:
                    both canaries (window evaluator, whole builder) pass
                    on the card; kernel 18 (window evaluation) against its
                    twin on the card, every entry and every flag, and every
                    entry it calls unambiguous against the host oracle
                    ``exact_tv_at`` (2^20 symbols of the suite's
                    distribution, gaussian, laplace, cauchy), with the
                    shares of live, saturated and out-of-support entries;
                    tables built on the card equal to the host builder's
                    bit for bit (2^18 symbols each).
19. exact_kernels -- kernels 15, 16 and 17 against their twins on the same
                    CUDA tensors and the port's host oracles
                    (``encode_shared_plain``, ``decode_family_exact_host``) at
                    L=32768, about 2^20 symbols: kernel 17 with and without
                    seeds, kernel 15 over the host builder's tables at the
                    batch's largest core, kernel 16 over three or more
                    segments with tables built on the card.
20. exact_main_path -- the JAX suite's exact-family row (2^22 symbols,
                    synthetic latents, gaussian, support [-100, 100], P=24,
                    L=32768, seed 1234) through ``cuda.encode_family_exact``
                    -> ``decode_family_exact`` (grouped), ``cuda.
                    encode_family_exact_container`` -> ``decode_family_
                    exact_container``, the facade's ungrouped pair at the
                    same config (its decode builds the tables on the card
                    by default), and on the first 2^18 symbols the
                    ungrouped decode with ``device_tables=False`` (tables
                    from the host builder, cmax=None): states, streams and
                    container byte for byte the host oracles', every
                    decode equal to the symbols, each of the four kernels
                    launched; the
                    container's overhead against the information content
                    (as the suite computes it), the host rows and segments
                    of the builder and which libm functions
                    ``utils/special.py`` picked.
21. exact_times  -- kernel-only time of each of the four at that size
                    (kernel 17's pass A and pass B also apart), its
                    twin's time on the card (kernel 18: equal on every
                    entry and flag; its entries and their live,
                    saturated and out-of-support shares), the device
                    table build split
                    into evaluation, host patch and derive + pack (Msym/s),
                    the facade's call times, and each kernel's bound
                    (kernels 15 and 16: the table words on the binary
                    search's path, counted from this run's tables and
                    symbols); kernel 16's chain of launches (one a
                    segment) against its launches alone, summed, and the
                    host time of issuing it (the gap between them); the
                    search sweep (scan and binary search of kernels 16 and
                    15 at each segment's table width and at the ungrouped
                    table's) and the fewest planes from which the binary
                    search won at every width, which fixes
                    ``exact_family.BISECT_FROM_PLANES`` (kernels 15 and
                    16).
22. exact32_kernels -- kernels 14 and 13 (the S=32 reference-exact pair)
                    against their twins on the same CUDA tensors and the
                    port's host oracles (``encode_shared_plain``,
                    ``decode_family_exact_host``) at L=32768: gaussian,
                    laplace and cauchy on [-100, 100] (about 2^20 symbols,
                    partial last step), gaussian with sharp cores (2^20)
                    and binomial (2 steps) at P=12, a
                    flat P=16 gaussian on [-50, 50] with a run of top
                    symbols (4 steps); kernel 14 with and without seeds,
                    kernel 13 through its wrapper and with the scan and
                    the binary search forced, over the host builder's
                    narrow tables; kernel 14's pass A also launched alone
                    against its plain version.  Tolerance 0.
23. exact32_main_path -- the facade's DEFAULT exact call, no cfg
                    (W=16, S=32, P=12, L=32768): ``cuda.encode_family_
                    exact(sym, mu, sigma, "gaussian", -100, 100)`` ->
                    ``decode_family_exact(..., num_symbols=n)`` on 2^20
                    symbols of the suite's synthetic latents (the host
                    table build cuts the suite's 2^22): states and
                    stream byte for byte the plain host coder's on
                    ``exact_ecp_plain``'s planes, the decode equal to the
                    symbols, the narrow tables' build time; both kernels
                    launched.
24. exact32_times -- kernel-only time of kernels 14 and 13 at that size
                    over the main path's planes and tables (kernel 14's
                    pass A and pass B also apart), the twins' time on the
                    card (outputs equal), the facade's call
                    times and host share, each kernel's bound (kernel 13:
                    the table words on the binary search's path), the
                    narrow search sweep (scan and binary search at table
                    widths from the tight one to 128 planes) that fixes
                    ``exact_family.BISECT_FROM_PLANES_NARROW``, and
                    kernel 13's time per step at T=256 steps over L=128
                    .. 65536 on the main path's tables, tiled (the floor
                    and slope as phase 5 fits them).
25. host_api     -- the constriction-compatible host API
                    (``constriction_tpu_torch.stream``, ``.symbol``,
                    ``.models``; host code, numpy in and out) on this
                    machine: the README's quick start and the golden
                    vectors of the QuantizedGaussian family (ANS and
                    range words), the chain coder's bits-back round trip
                    and Huffman on both bit coders, word for word; bench.py's
                    model (K=100, Dirichlet(2), seed 1234, P=24) at 2^20
                    symbols through ``AnsCoder``, ``RangeEncoder`` /
                    ``RangeDecoder`` and ``ChainCoder`` (and the cores'
                    lookup decodes at P=12 and 16), the QuantizedGaussian
                    family at 2^20 through the ANS and range coders (the
                    chain coder's family decode is a Python loop: 2^11),
                    each round trip exact and each host-codec entry equal
                    to its ``*_plain`` loop on a 2^14-symbol prefix (2^11
                    for the family decodes, whose loops evaluate one
                    scalar erf at a time), both times printed; 2^16
                    (mean, scale, symbol) rows at P=24 whose host
                    ``(cum, prob)`` (``QuantizedFamily.ecp_all``) the card
                    codes (``cuda.encode_family_exact`` at W=32, S=64,
                    kernel 17: the host coder's stream on those planes),
                    decodes (kernels 18 and 15) and, inverted in the
                    card-built tables at q = cum, gives back as (symbol,
                    cum, prob); Huffman and Exp-Golomb round trips over
                    2^16 symbols.  No launch of this phase counts in the
                    kernels line.
26. examples     -- the six scripts of ``examples_torch/`` (the JAX
                    package's examples, ported), each ``run("cuda")`` in
                    this process at its card size, with every launch
                    counter set to 0 just before it: its printed lines,
                    wall time and the kernels it launched (each kernel the
                    script's docstring names must have launched).  Every
                    container, stream, state and checkpoint the scripts
                    write equals the port's host oracle on the same input
                    (``interleaved2.encode_shared`` and its v1 and v2
                    framing, ``encode_shared_range``, the exact families'
                    planes through ``encode_shared``, ``ops/family.py``'s
                    ``family_tables_host`` / ``decode_family_host``, the
                    sharded streams block by block, the plain
                    ``AnsCoderCore`` loop, ``build_checkpoints_plain``,
                    ``exact_family.decode_family_exact_host``), and
                    every decode
                    its input.  No launch of this phase counts in the
                    kernels line.

Each main path runs with every launch counter set to 0 just before it, and
the counts read just after it are the ``launches`` of its kernels.
``bound_ms`` is the larger of the bytes the function must move (each input
read once, each output written once) over the card's 3.35 TB/s and its
integer operations over 33.5 T per second (NVIDIA's 67 TFLOP/s float32
rate counts a fused multiply-add as two); for the family kernels the
operations are ``left()`` evaluations (LEFT_OPS each, counted from
family.cuh) times what this run's inputs need; for the window evaluator
the float64 flops read from its SASS (EVAL_T_FLOPS for every entry in
the support, EVAL_CDF_FLOPS more for each live one, a DFMA as two) over
the card's 34 TFLOP/s float64 rate outside the tensor cores (NVIDIA's
data sheet).
No single PyTorch call computes these functions, so ``library_ms`` is
null.  The host oracles of phases 18 and 19 and of phase 22 run in
worker processes (at most 8), which the script stops before phase 20 and
before phase 23.

Everything comes from the port: the model's CDF
(``constriction_tpu_torch.models``), the host API and the host oracles, which are the
port's ILANS2 and ILANS2-R host coders (the host codec, C++) under the
port's container framing, its numpy family and TChain oracles, its numpy
chain decode, its exact-family host builder (the host codec) and decode
oracle, and for the exact-family encoders the plain numpy versions of
``exact_ecp`` and ``encode_shared`` (the native phase and the CPU tests
hold the host codec byte for byte against the plain versions, and the CPU
tests both against the JAX package).  The script imports
nothing of JAX or of the JAX package, and checks that at the end.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

N_KERNEL_CHECK = (1 << 20) - 12345  # partial last step
N_MAIN = 1 << 25
K_MAIN = 100
BENCH_LANES = 1 << 16
N_SKEWED = 1 << 19  # the carry-run model: 4096 steps on 128 lanes
SKEWED_LANES = 128

# the rANS pairs at both presets: the cluster decode and the two-pass
# encode, instantiated in csrc/ilans2.cu; the range decodes at both presets
# (cluster_range_decode_kernel, instantiated in csrc/ilans2_range.cu), the
# S=64 exact table decodes (the cluster decode over csrc/exact_family.cu's
# TableModel, whole message and segment) and the family decode (over
# csrc/ilans2_family.cu's FamilyModel)
WIDE_SOURCE = "constriction_tpu_torch/ops/csrc/ilans2_wide.cuh"
RANGE_SOURCE = "constriction_tpu_torch/ops/csrc/ilans2_range.cu"
# kernel -> (module whose LAUNCHES counts it, counter key, Pallas site,
# source)
KERNELS = {
    "ilans2_decode_w32s64": ("coder64", "decode",
                             "constriction_tpu/ops/pallas_coder64.py:187",
                             WIDE_SOURCE),
    "ilans2_encode_w32s64": ("coder64", "encode",
                             "constriction_tpu/ops/pallas_coder64.py:373",
                             WIDE_SOURCE),
    "ilans2_decode_w16s32": ("coder", "decode",
                             "constriction_tpu/ops/pallas_coder.py:1638",
                             WIDE_SOURCE),
    "ilans2_encode_w16s32": ("coder", "encode",
                             "constriction_tpu/ops/pallas_coder.py:1352",
                             WIDE_SOURCE),
}
RANGE_KERNELS = {
    "ilans2_range_decode_w32s64": (
        "coder64", "range_decode",
        "constriction_tpu/ops/pallas_coder64.py:677", WIDE_SOURCE),
    "ilans2_range_decode_w16s32": (
        "coder", "range_decode",
        "constriction_tpu/ops/pallas_coder.py:1550", WIDE_SOURCE),
    "ilans2_range_record_w16s32": (
        "range_enc", "record",
        "constriction_tpu/ops/pallas_range_enc.py:151", RANGE_SOURCE),
    # kernels 8 and 10: the lane pass and the compaction (ilans2_wide.cuh)
    "range_resolve_lanes_w16s32": (
        "range_enc", "resolve",
        "constriction_tpu/ops/pallas_range_enc.py:185", RANGE_SOURCE),
    "ilans2_range_record_w32s64": (
        "range_enc", "record64",
        "constriction_tpu/ops/pallas_range_enc.py:441", RANGE_SOURCE),
    "range_resolve_lanes_w32s64": (
        "range_enc", "resolve64",
        "constriction_tpu/ops/pallas_range_enc.py:484", RANGE_SOURCE),
}
FAMILY_SOURCE = "constriction_tpu_torch/ops/csrc/ilans2_family.cu"
TCHAIN_SOURCE = "constriction_tpu_torch/ops/csrc/tchain.cu"
FAMILY_KERNELS = {
    "family_decode": ("family", "decode",
                      "constriction_tpu/ops/pallas_family.py:629",
                      WIDE_SOURCE),
    "family_encode": ("family", "encode",
                      "constriction_tpu/ops/pallas_family.py:670",
                      FAMILY_SOURCE),
    "tchain12_family_decode": ("tchain", "decode12_family",
                               "constriction_tpu/ops/tchain.py:691",
                               TCHAIN_SOURCE),
    "tchain12_family_encode": ("tchain", "encode12_family",
                               "constriction_tpu/ops/tchain.py:733",
                               TCHAIN_SOURCE),
}
TCHAIN_KERNELS = {
    "tchain16_decode": ("tchain", "decode16",
                        "constriction_tpu/ops/tchain.py:264", TCHAIN_SOURCE),
    # kernels 20 and 24 on the cluster step; kernel 23 as three grid steps
    "cluster_tchain16_encode": ("tchain", "encode16",
                                "constriction_tpu/ops/tchain.py:302",
                                TCHAIN_SOURCE),
    "tchain24_decode": ("tchain", "decode24",
                        "constriction_tpu/ops/tchain.py:1106", TCHAIN_SOURCE),
    "cluster_tchain24_encode": ("tchain", "encode24",
                                "constriction_tpu/ops/tchain.py:1147",
                                TCHAIN_SOURCE),
}
EXACT_SOURCE = "constriction_tpu_torch/ops/csrc/exact_family.cu"
EXACT_KERNELS = {
    "exact_decode64": ("exact", "decode64",
                       "constriction_tpu/ops/exact_family.py:1835",
                       WIDE_SOURCE),
    "exact_decode64_seg": ("exact", "decode64_seg",
                           "constriction_tpu/ops/exact_family.py:1919",
                           WIDE_SOURCE),
    "exact_encode64": ("exact", "encode64",
                       "constriction_tpu/ops/exact_family.py:1953",
                       EXACT_SOURCE),
    "exact_eval_window": ("exact", "eval_window",
                          "constriction_tpu/ops/df32_pallas.py:135",
                          EXACT_SOURCE),
}
EXACT32_KERNELS = {
    "exact_decode32": ("exact", "decode32",
                       "constriction_tpu/ops/exact_family.py:1106",
                       WIDE_SOURCE),
    "exact_encode32": ("exact", "encode32",
                       "constriction_tpu/ops/exact_family.py:1148",
                       EXACT_SOURCE),
}
# the native phase: models of the exact-table checks, symbols of the
# shared-stream coders'
N_NATIVE_TABLES = 1 << 16
N_NATIVE_STREAM = 1 << 20
N_EXACT = 1 << 22  # the JAX suite's exact-family row at its TPU size
N_EXACT_CHECK = (1 << 20) - 12345  # partial last step
N_EXACT_EVAL = 1 << 20
N_EXACT_TABLES = 1 << 18
N_EXACT_HOST_TABLES = 1 << 18  # the ungrouped decode with host-built
# tables (cmax=None)
# the facade's default S=32 pair (W=16, P=12): its narrow tables come from
# the host builder (the host codec's fill, then a numpy pack of the [n,
# cmax] boundaries), 2.1 s at 2^20 symbols and 13.4 s at the suite's 2^22
# on the card's host, which keeps the cut at 2^20
N_EXACT32 = 1 << 20
N_EXACT32_CHECK = (1 << 20) - 12345  # partial last step
EXACT32_CHECK_LANES = 32768
# binomial's f64 CDF costs about 4 us on the host: 2 steps of 32768 lanes
N_EXACT32_BINOMIAL = 2 * 32768 - 99
N_EXACT32_FLAT = 4 * 32768 - 99
EXACT32_P = 12
# narrow table widths (planes) of the search sweep
SWEEP32_PLANES = (4, 6, 7, 8, 10, 12, 14, 16, 20, 24, 32, 48, 64, 96, 128)
EXACT_SUPPORT = (-100, 100)
EXACT_FAMILY = "gaussian"
EXACT_P = 24
N_TCHAIN = 1 << 24  # the JAX suite's TChain rows: 2^24 quantiles, T = 512
N_KERNEL_CHECK_TCHAIN = 1 << 20  # 32 steps of 32768 lanes
N_CHAIN_ROWS = 1 << 20
N_FAMILY = 1 << 23  # the family benchmark row of the JAX package's suite
FAMILY_SUPPORT = (-100, 100)
MAIN_FAMILY = "gaussian"
N_MATH = 1 << 22
N_HOST_API = 1 << 20  # the host API's bulk round trips
N_HOST_API_PLAIN = 1 << 14  # the prefix its Python loops run on
# the family decodes' loops evaluate the quantizer's CDF one scalar at a
# time (about a millisecond a symbol where erf runs through the host codec)
N_HOST_API_FAMILY_PLAIN = 1 << 11
N_HOST_API_CROSS = 1 << 16  # rows of the host-model / card cross-check
HOST_API_CROSS_LANES = 4096
N_HOST_API_SYMBOL = 1 << 16
CKPT_INTERVAL = 256
# arithmetic operations of one left() in family.cuh (standardized argument
# 8, sign 2, the family's sigmoid or arctangent, one or two small floor
# divisions of 10, the offset 2)
LEFT_OPS = {"gaussian": 50, "laplace": 36, "logistic": 40, "cauchy": 56}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 33.5e12  # 32-bit scalar operations, 132 SMs
SWEEP_LANES = (128, 1024, 4096, 16384, 32768, 65536)
SWEEP_STEPS = 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def model_cdf(probs, precision):
    from constriction_tpu_torch.models import fast_quantized_cdf

    return fast_quantized_cdf(probs, precision)


def host_container(symbols, cdf, cfg, compact: bool):
    """The host oracle's container: the host coder for every lane,
    under the v2 framing or in a v1 container (the JAX package's
    ``framing.encode_iid_v2`` / ``interleaved2.encode_iid_categorical2``
    with ``device=False``)."""
    import numpy as np

    from constriction_tpu_torch.ops import framing
    from constriction_tpu_torch.ops import interleaved2 as il2

    cdf64 = np.asarray(cdf, dtype=np.uint64)
    cums = cdf64[symbols]
    probs = cdf64[symbols + 1] - cums
    if not compact:
        states, stream = il2.encode_shared(cums, probs, cfg)
        return il2.pack_container2(states, stream, len(symbols), cfg)

    def encode_a(n_A, seeds):
        return il2.encode_shared(cums[:n_A], probs[:n_A], cfg, seeds=seeds)

    return framing.frame_planes_v2(cums, probs, cfg, None, encode_a)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    between CUDA events (device time, including any sync a call makes)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def presets():
    """(label, W, S, P, encode, decode, encode_plain, decode_plain)."""
    from constriction_tpu_torch.ops import coder, coder64

    return [
        ("w32s64", 32, 64, 24, coder64.encode_iid64, coder64.decode_shared64,
         coder64.encode_iid64_plain, coder64.decode_shared64_plain),
        ("w16s32", 16, 32, 12, coder.encode_iid, coder.decode_shared,
         coder.encode_iid_plain, coder.decode_shared_plain),
    ]


def mismatch(a, b) -> int:
    """Largest |a - b| over two integer tensors; fails the run if their
    shapes differ."""
    import torch

    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0
    return max(1, int((a.long() - b.long()).abs().max()))


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take to move
    ``bytes_moved`` bytes and do ``ops`` integer operations."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_ops(K: int) -> int:
    """Integer operations of the quantile -> symbol binary search."""
    return 3 * max(1, (K - 1).bit_length())


def phase_build() -> dict:
    from constriction_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info or {}
    return {
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "nvcc_seconds": info.get("seconds"),
        "command": info.get("command"),
        "ptxas": [ln.strip() for ln in info.get("log", "").splitlines()
                  if "registers" in ln or "spill" in ln],
        "gpu": gpu_line(),
    }


def cpu_model() -> str:
    """The host CPU from /proc/cpuinfo: its model name, else (where that
    is missing or "unknown", as on the card's host) its vendor, family and
    model numbers (the first value of each field)."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, sep, value = ln.partition(":")
                if sep:
                    fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        return "unknown"
    if fields.get("model name", "unknown") != "unknown":
        return fields["model name"]
    return " ".join(f"{k} {fields[k]}" for k in (
        "vendor_id", "cpu family", "model", "stepping")
        if fields.get(k, "unknown") != "unknown") or "unknown"


def omp_threads() -> int:
    """The OpenMP team size the host codec's loops run with (libgomp,
    which the codec links, is in the process once the codec is loaded)."""
    import ctypes

    return int(ctypes.CDLL("libgomp.so.1").omp_get_max_threads())


def same_arrays(a, b) -> bool:
    """Equal results: arrays (dtype, shape and bytes), scalars, or tuples
    of them."""
    import numpy as np

    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(same_arrays(x, y) for x, y in zip(a, b)))
    if np.isscalar(a) or np.isscalar(b):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def native_cases():
    """(entry, label, routed function, plain version, arguments) of the
    native phase: exact tables at N_NATIVE_TABLES models, the shared-stream
    coders at N_NATIVE_STREAM symbols (L=32768)."""
    import numpy as np

    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import exact_tables as et
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops.interleaved import LaneConfig
    from constriction_tpu_torch.utils import special

    lo, hi = EXACT_SUPPORT
    nt = N_NATIVE_TABLES
    means, scales, syms = exact_workload(nt)
    rng = np.random.RandomState(20)
    x = rng.uniform(-7.0, 7.0, N_NATIVE_STREAM)
    cases = [("erf", "f64", special.erf_native, special.erf_plain, (x,)),
             ("erfc", "f64", special.erfc_native, special.erfc_plain, (x,))]
    for fam in ("gaussian", "laplace", "cauchy"):
        cases.append(("exact_ecp", f"{fam}_p24", ef.exact_ecp,
                      ef.exact_ecp_plain,
                      (syms, means, scales, fam, lo, hi, 24)))
        cases.append(("exact_ncore", f"{fam}_p24", ef.exact_ncore,
                      ef.exact_ncore_plain, (means, scales, fam, lo, hi, 24)))
        cases.append(("exact_boundary_tables", f"{fam}_p24",
                      ef.exact_boundary_tables, ef.exact_boundary_tables_plain,
                      (means, scales, fam, lo, hi, 24)))
    cases.append(("exact_ecp", "gaussian_p12", ef.exact_ecp,
                  ef.exact_ecp_plain,
                  (syms, means, scales, "gaussian", lo, hi, 12)))
    cases.append(("exact_boundary_tables", "gaussian_p12",
                  ef.exact_boundary_tables, ef.exact_boundary_tables_plain,
                  (means, scales, "gaussian", lo, hi, 12)))
    # binomial's f64 CDF costs microseconds in the plain version: 2^12
    # models for its tables
    nb = 1 << 12
    ps = rng.uniform(0.02, 0.98, nt)
    bsyms = rng.binomial(60, ps)
    cases.append(("exact_ecp", "binomial_p12", ef.exact_ecp,
                  ef.exact_ecp_plain,
                  (bsyms, np.full(nt, 60.0), ps, "binomial", 0, 60, 12)))
    cases.append(("exact_boundary_tables", "binomial_p12",
                  ef.exact_boundary_tables, ef.exact_boundary_tables_plain,
                  (np.full(nb, 60.0), ps[:nb], "binomial", 0, 60, 12)))
    cmax = int(ef.exact_ncore(means, scales, "gaussian", lo, hi, 24).max())
    cases.append(("_packed_table_rows", "gaussian_p24",
                  ef._packed_table_rows, ef._packed_table_rows_plain,
                  (means, scales, "gaussian", lo, hi, 24, cmax)))
    R = 256
    nsteps = nt // (R * 128)
    cases.append(("packed_tables_device", "gaussian_unique",
                  ef.packed_tables_device, ef.packed_tables_device_plain,
                  (means, scales, "gaussian", lo, hi, 24, min(255, cmax + 8),
                   nsteps, R)))
    # a hyperprior-like batch: scales from a table of 64, means on a grid
    qm = np.round(means * 2.0) / 2.0
    qs = np.exp(np.round(np.log(scales) * 8.0) / 8.0)
    cases.append(("packed_tables_device", "gaussian_repeated",
                  ef.packed_tables_device, ef.packed_tables_device_plain,
                  (qm, qs, "gaussian", lo, hi, 24, min(255, cmax + 8),
                   nsteps, R)))
    W = 48
    ws = np.clip(np.ceil(means - 5.5 * scales) - 3, lo + 1, hi).astype(
        np.int64)
    sym_i = np.repeat(np.arange(nt), W)
    svals = np.minimum((ws[:, None] + np.arange(W)[None, :]).reshape(-1), hi)
    cases.append(("exact_tv_at", "gaussian_p24", et.exact_tv_at,
                  et.exact_tv_at_plain,
                  ("gaussian", lo, hi, 24, means, scales, sym_i, svals)))
    ns = N_NATIVE_STREAM
    rng = np.random.RandomState(1234)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    ssyms = rng.choice(K_MAIN, size=ns, p=probs).astype(np.int64)
    for W_, S_, P_ in ((16, 32, 12), (32, 64, 24)):
        cfg = LaneConfig(32768, W_, S_, P_)
        cdf = np.asarray(model_cdf(probs, P_), dtype=np.uint64)
        cums, pr = cdf[ssyms], cdf[ssyms + 1] - cdf[ssyms]
        label = f"w{W_}s{S_}p{P_}"
        states, stream = il2.encode_shared(cums, pr, cfg)
        points, rstream = il2.encode_shared_range(cums, pr, cfg)
        cases += [
            ("encode_shared", label, il2.encode_shared,
             il2.encode_shared_plain, (cums, pr, cfg)),
            ("decode_shared_cdf", label, il2.decode_shared_cdf,
             il2.decode_shared_cdf_plain,
             (states, stream, ns, cdf, cfg, True)),
            ("encode_shared_range", label, il2.encode_shared_range,
             il2.encode_shared_range_plain, (cums, pr, cfg)),
            ("decode_shared_range_cdf", label, il2.decode_shared_range_cdf,
             il2.decode_shared_range_cdf_plain,
             (points, rstream, ns, cdf, cfg)),
        ]
        if S_ == 32:
            seeds = (np.uint32(1 << 16) + rng.randint(
                0, 1 << 16, 32768).astype(np.uint32))
            cases += [
                ("encode_shared", label + "_seeded", il2.encode_shared,
                 il2.encode_shared_plain, (cums, pr, cfg, seeds)),
                ("build_checkpoints", label, il2.build_checkpoints,
                 il2.build_checkpoints_plain,
                 (states, stream, ns, cdf, cfg, 4)),
            ]
    return cases


def phase_native() -> dict:
    """The host codec: its build time, the host's CPU model and OpenMP
    team size, each bound entry point against its plain version byte for
    byte with both times, and a range encode at (W, S, P) = (8, 32, 8),
    which the plain encoder does not take, round-tripped through the plain
    decoder."""
    import numpy as np

    from constriction_tpu_torch import native
    from constriction_tpu_torch.native import build
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops.interleaved import LaneConfig
    from constriction_tpu_torch.utils import special

    clock = time.perf_counter
    t0 = clock()
    native.library()
    load_s = clock() - t0
    info = build.build_info or {}
    rows = []
    for entry, label, fn, plain, args in native_cases():
        t0 = clock()
        got = fn(*args)
        t1 = clock()
        want = plain(*args)
        t2 = clock()
        rows.append({"entry": entry, "case": label, "native_s": t1 - t0,
                     "plain_s": t2 - t1,
                     "identical": same_arrays(got, want)})
    ns = N_NATIVE_STREAM
    rng = np.random.RandomState(8)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    syms = rng.choice(K_MAIN, size=ns, p=probs).astype(np.int64)
    cfg = LaneConfig(32768, 8, 32, 8)
    cdf = np.asarray(model_cdf(probs, 8), dtype=np.uint64)
    t0 = clock()
    points, stream = il2.encode_shared_range(
        cdf[syms], cdf[syms + 1] - cdf[syms], cfg)
    t1 = clock()
    back = il2.decode_shared_range_cdf_plain(points, stream, ns, cdf, cfg)
    t2 = clock()
    rows.append({"entry": "encode_shared_range", "case": "w8s32p8",
                 "native_s": t1 - t0, "plain_decode_s": t2 - t1,
                 "identical": bool(np.array_equal(back, syms))})
    rec = {"phase": "native", "load_s": load_s,
           "build_s": info.get("seconds"), "command": info.get("command"),
           "cpu": cpu_model(), "cpus": os.cpu_count(),
           "omp_threads": omp_threads(), "erf": special.ERF,
           "special_picked": special.PICKED, "cases": rows}
    bad = [r for r in rows if not r["identical"]]
    if bad:
        emit(rec)
        fail(f"native: entry points differ from their plain versions: {bad}")
    return rec


def ptxas_usage(log: str, marks: tuple) -> dict:
    """Registers and spill bytes from nvcc's ``-Xptxas -v`` output for each
    kernel whose mangled name holds one of ``marks``."""
    out = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else None
            if name is not None and not any(m in name for m in marks):
                name = None
        elif name is not None and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return out


# the kernels ptxas must compile without spilling: the range decodes at
# both presets, the exact table decodes (kernels 15 and 16 at S=64, 13 at
# S=32), the family decode (kernel 11, each family) and the TChain encodes
# (kernels 20, 24 and 22's cluster step) at 2 and 4 lanes a thread (L =
# 32768 and 65536), the TChain-12 decode's first two passes (kernel 21),
# the TChain-24 and TChain-16 decodes' head passes (kernels 23 and 19), the
# family tables pass (kernels 22 and 12), the range resolves' lane passes
# (kernels 8 and 10), the range encode's phase A (kernels 7 and 9), the
# pass A of kernels 17, 14 and 12 and the window evaluator (kernel 18, each
# family)
NO_SPILL = (r"cluster_range_decode_kernelILi32ELi64ELi[24]E",
            r"cluster_range_decode_kernelILi16ELi32ELi[24]E",
            r"cluster_decode_kernelILi32ELi64ELi[24]E.*TableModelELb0E",
            r"cluster_decode_kernelILi32ELi64ELi[24]E.*TableModelELb1E",
            r"cluster_decode_kernelILi16ELi32ELi[24]E.*NarrowTableModel",
            *(rf"cluster_decode_kernelILi16ELi32ELi[24]E.*FamilyModelILi{k}EE"
              for k in range(4)),
            r"cluster_tchain_encode_kernelILi32ELi64ELi24ELi[24]E",
            r"cluster_tchain_encode_kernelILi16ELi32ELi16ELi[24]E",
            r"cluster_tchain_encode_kernelILi16ELi32ELi12ELi[24]E",
            r"tchain12_invert_kernel", r"tchain_heads_kernelILi16ELi32ELi12E",
            r"tchain_heads_kernelILi32ELi64ELi24E",
            r"tchain_heads_kernelILi16ELi32ELi16E", r"family_tables_kernel",
            r"range_resolve_lanes_kernelILi16ELi32E",
            r"range_resolve_lanes_kernelILi32ELi64E",
            r"range_record_ring_kernelILi16ELi32E",
            r"range_record_ring_kernelILi32ELi64E",
            r"encode_lanes_kernelILi32ELi64E.*PlaneLanesModel",
            r"encode_lanes_kernelILi16ELi32E.*PlaneLanesModel",
            r"encode_lanes_kernelILi16ELi32E.*RecordLanesModel",
            *(rf"exact_eval_window_kernelILi{k}E" for k in range(3)))


def phase_geometry(device) -> dict:
    """Launch geometry of the cluster decodes and the two-pass encodes: the
    rANS pairs (kernels 1 and 2 at P=24, kernels 3 and 4 at P=12 and P=16),
    the range decodes (kernel 5 at P=24, kernel 6 at P=12 and P=16), the
    exact table decodes (kernels 15 and 16 at S=64, kernel 13 at S=32),
    the family decode (kernel 11, each family) and the TChain cluster
    encodes (kernels 20, 24 and 22's step) at bench.py's lane counts for
    its K, and what ptxas reported for their kernels at each preset and
    lanes a thread, for the lane passes of kernels 21, 23, 19, 8, 10, 17,
    14 and 12, range phase A (kernels 7 and 9), the family tables pass and
    kernel 18.  Fails on a spill in a kernel of
    NO_SPILL, and unless kernels 11, 13, 16, 20, 24 and 22 run on 16 CTAs
    at L=32768."""
    import re

    from constriction_tpu_torch.ops import _build, coder, coder64
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import family as fam
    from constriction_tpu_torch.ops import tchain as tc

    rows = [{"kernel": 1, "preset": "w32s64", "num_lanes": L, "K": K_MAIN,
             "P": 24, **coder64.geometry(L, K_MAIN, device)}
            for L in (32768, BENCH_LANES)]
    rows += [{"kernel": 4, "preset": "w16s32", "num_lanes": L, "K": K_MAIN,
              "P": P, **coder.geometry(L, K_MAIN, P, device)}
             for L in (32768, BENCH_LANES) for P in (12, 16)]
    rows += [{"kernel": 5, "preset": "w32s64", "num_lanes": L, "K": K_MAIN,
              "P": 24, **coder64.range_geometry(L, K_MAIN, 24, device)}
             for L in (32768, BENCH_LANES)]
    rows += [{"kernel": 6, "preset": "w16s32", "num_lanes": L, "K": K_MAIN,
              "P": P, **coder.range_geometry(L, K_MAIN, P, device)}
             for L in (32768, BENCH_LANES) for P in (12, 16)]
    rows += [{"kernel": 16 if seg else 15, "preset": "w32s64",
              "num_lanes": L, "P": EXACT_P, **ef.geometry(L, device, seg)}
             for L in (32768, BENCH_LANES) for seg in (False, True)]
    rows += [{"kernel": 13, "preset": "w16s32", "num_lanes": L,
              "P": EXACT32_P, **ef.geometry(L, device, narrow=True)}
             for L in (32768, BENCH_LANES)]
    rows += [{"kernel": 11, "preset": "w16s32", "num_lanes": L, "P": 12,
              "family": family, **fam.geometry(L, family, device)}
             for L in (32768, BENCH_LANES) for family in fam.FAMILIES]
    rows += [{"kernel": 24, "preset": "w32s64", "num_lanes": L, "K": K_MAIN,
              "P": 24, **tc.geometry24(L, K_MAIN, device)}
             for L in (32768, BENCH_LANES)]
    rows += [{"kernel": 20, "preset": "w16s32", "num_lanes": L, "K": K_MAIN,
              "P": 16, **tc.geometry16(L, K_MAIN, device)}
             for L in (32768, BENCH_LANES)]
    rows += [{"kernel": 22, "preset": "w16s32", "num_lanes": L, "P": 12,
              **tc.geometry12(L, device)} for L in (32768, BENCH_LANES)]
    for row in rows:
        if "encode_blocks" in row:
            row["encode_grid"] = (f"{row['encode_blocks']} x "
                                  f"{row['encode_threads']}")
        if row["cluster"] < 2:
            fail(f"geometry: kernel {row['kernel']} runs on one CTA at "
                 f"L={row['num_lanes']}")
        if (row["kernel"] in (11, 13, 16, 20, 22, 24)
                and row["num_lanes"] == 32768 and row["ctas"] != 16):
            fail(f"geometry: kernel {row['kernel']} runs on {row['ctas']} "
                 f"CTAs at L=32768")
    log = _build.ptxas_log()
    spills = _build.ptxas_spills(log)
    checked = {name: v for name, v in spills.items()
               if any(re.search(pat, name) for pat in NO_SPILL)}
    for pat in NO_SPILL:
        if not any(re.search(pat, name) for name in checked):
            fail(f"geometry: ptxas reported no kernel matching {pat}")
    spilled = {name: v for name, v in checked.items() if v != (0, 0)}
    if spilled:
        fail(f"geometry: spills (store, load bytes) in {spilled}")
    return {"phase": "geometry", "cases": rows,
            "no_spill_kernels": len(checked),
            "ptxas": ptxas_usage(log, ("cluster_decode_kernelILi32ELi64E",
                                       "encode_lanes_kernelILi32ELi64E",
                                       "cluster_decode_kernelILi16ELi32E",
                                       "encode_lanes_kernelILi16ELi32E",
                                       "cluster_range_decode_kernel",
                                       "tchain12_invert_kernel",
                                       "family_tables_kernel",
                                       "tchain_heads_kernel",
                                       "cluster_tchain_encode_kernel",
                                       "range_resolve_lanes_kernel",
                                       "range_record_",
                                       "exact_eval_window_kernel",
                                       "division_records", "compact_"))}


def phase_kernels(device, n: int, L: int) -> tuple[dict, dict]:
    """Each kernel against its twin on the same tensors, and both times on
    the unseeded case.  Returns the phase record and {kernel name:
    max_abs_err}."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    rng = np.random.RandomState(7)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    syms_np = rng.choice(K_MAIN, size=n, p=probs).astype(np.int32)
    syms = torch.from_numpy(syms_np).to(device)
    errs: dict[str, int] = {}
    rows = []
    for label, W, S, P, enc, dec, enc_p, dec_p in presets():
        cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)
        cdf_np = model_cdf(probs, P)
        cdf = convert.cdf_to_torch(cdf_np, device)
        cums = cdf_np[syms_np]
        probs_np = cdf_np[syms_np + 1] - cums
        floor = 1 << (S - W)
        # start states over all of [2^(S-W), 2^S), u64 ones >= 2^63 included
        seeds_np = rng.randint(0, 1 << 32, size=L).astype(np.uint64)
        if S == 64:
            seeds_np = (seeds_np << np.uint64(32)) | rng.randint(
                0, 1 << 32, size=L).astype(np.uint64)
        seeds_np = np.maximum(seeds_np, np.uint64(floor))
        for seeded in (False, True):
            seeds = (convert.states_to_torch(seeds_np, cfg, device)
                     if seeded else None)
            st_k, w_k = enc(syms, cdf, cfg, seeds=seeds)
            st_p, w_p = enc_p(syms, cdf, cfg, seeds=seeds)
            e_enc = max(mismatch(st_k, st_p), mismatch(w_k, w_p))
            out_k, fin_k = dec(st_k, w_k, cdf, cfg, n,
                               return_final_states=True)
            out_p, fin_p = dec_p(st_k, w_k, cdf, cfg, n,
                                 return_final_states=True)
            e_dec = max(mismatch(out_k, out_p), mismatch(fin_k, fin_p))
            start = (seeds if seeded else torch.full_like(st_k, floor))
            round_trip = (mismatch(out_k, syms) == 0
                          and mismatch(fin_k, start) == 0)
            # the numpy host oracle on the same inputs
            st_h, w_h = il2.encode_shared(cums, probs_np, cfg,
                                          seeds=seeds_np if seeded else None)
            out_h, fin_h = il2.decode_shared_cdf(st_h, w_h, n, cdf_np, cfg,
                                                 return_final_states=True)
            e_enc = max(e_enc, mismatch(st_k, convert.states_to_torch(
                st_h, cfg, device)), mismatch(w_k, convert.u32_to_torch(
                    w_h, device)))
            e_dec = max(e_dec, mismatch(out_k.cpu(), torch.from_numpy(out_h)),
                        mismatch(fin_k, convert.states_to_torch(
                            fin_h, cfg, device)))
            errs[f"ilans2_encode_{label}"] = max(
                errs.get(f"ilans2_encode_{label}", 0), e_enc)
            errs[f"ilans2_decode_{label}"] = max(
                errs.get(f"ilans2_decode_{label}", 0), e_dec)
            row = {"preset": label, "seeded": seeded,
                   "words": int(w_k.numel()), "encode_max_abs_err": e_enc,
                   "decode_max_abs_err": e_dec, "round_trip": round_trip}
            rows.append(row)
            if e_enc != 0 or e_dec != 0 or not round_trip:
                fail(f"kernel != twin or host oracle, or no round trip: "
                     f"{row}")
            if not seeded:
                row["encode_ms"] = time_ms(lambda: enc(syms, cdf, cfg), 3)
                row["encode_plain_ms"] = time_ms(
                    lambda: enc_p(syms, cdf, cfg), 1)
                row["decode_ms"] = time_ms(
                    lambda: dec(st_k, w_k, cdf, cfg, n), 3)
                row["decode_plain_ms"] = time_ms(
                    lambda: dec_p(st_k, w_k, cdf, cfg, n), 1)
    return {"phase": "kernels", "num_lanes": L, "n": n, "cases": rows}, errs


def main_workload():
    import numpy as np

    rng = np.random.RandomState(1234)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    symbols = rng.choice(K_MAIN, size=N_MAIN, p=probs).astype(np.int64)
    return probs, symbols


def phase_main(device, probs, symbols, keep: dict) -> dict:
    """The facade on the card at full size, against the host oracle.
    ``keep[(P, compact)]`` gets each (cdf, container) for the checkpoints
    phase."""
    import numpy as np

    from constriction_tpu_torch import cuda as ctt

    rows = []
    for P in (24, 12):
        cdf = model_cdf(probs, P)
        p = (cdf[symbols + 1].astype(np.float64) - cdf[symbols]) / cdf[-1]
        cfg = ctt._pick_cfg(len(symbols), None, cdf,
                            est_bits=float((-np.log2(p)).sum()))
        for compact in (True, False):
            t0 = time.perf_counter()
            data = ctt.encode_iid(symbols, cdf, compact=compact,
                                  device=device)
            t1 = time.perf_counter()
            out = ctt.decode_iid(data, cdf, device=device)
            t2 = time.perf_counter()
            ref = host_container(symbols, cdf, cfg, compact)
            t3 = time.perf_counter()
            row = {
                "P": P, "container": "v2" if compact else "v1",
                "num_lanes": cfg.num_lanes, "words": int(len(data)),
                "identical_to_host_oracle": bool(np.array_equal(data, ref)),
                "decodes_exactly": bool(np.array_equal(out, symbols)),
                "encode_call_s": t1 - t0, "decode_call_s": t2 - t1,
                "host_oracle_encode_s": t3 - t2,
            }
            rows.append(row)
            keep[(P, compact)] = (cdf, data)
            if not (row["identical_to_host_oracle"]
                    and row["decodes_exactly"]):
                fail(f"main path: {row}")
    return {"phase": "main_path", "n": len(symbols), "cases": rows}


def time_passes(row: dict, syms, cdf, cfg, stream) -> None:
    """An encode's two passes timed apart (CUDA events): pass A (the
    lane-parallel coding) and pass B (the row-major compaction of its
    words, whose stream must equal the two-pass call's), and pass A's
    scratch (the dense words and the ballots) in bytes."""
    from constriction_tpu_torch.ops import coder, coder64

    lanes = (coder64.lanes_pass64 if cfg.state_bits == 64
             else coder.lanes_pass32)
    words, ballots, _ = lanes(syms, cdf, cfg)
    if mismatch(coder.compact_pass(words, ballots), stream) != 0:
        fail(f"times: pass B's stream != the encode's at {cfg}")
    row["encode_pass_a_ms"] = time_ms(lambda: lanes(syms, cdf, cfg), 3)
    row["encode_pass_b_ms"] = time_ms(
        lambda: coder.compact_pass(words, ballots), 3)
    row["encode_scratch_bytes"] = 4 * (words.numel() + ballots.numel())


def phase_times(device, probs, symbols, gpu: str,
                errs: dict) -> tuple[dict, dict]:
    """Kernel-only times at the main path's size, and the twins on the card
    at the facade's config and the same size: the twins' streams, states
    and symbols must equal the kernels' (their largest difference goes into
    ``errs``); the DEFAULT preset's pair also at P=12 and the small
    preset's at P=16 (L=32768 against their twins, and L=65536), and each
    encode's two passes apart.  Returns the phase record and {kernel: (ms,
    plain_ms, bound_ms, bound_by)}."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    n = len(symbols)
    syms = torch.from_numpy(symbols.astype(np.int32)).to(device)
    rows = []
    times = {}
    for label, W, S, P_main, enc, dec, enc_p, dec_p in presets():
        cases = []
        for P in (P_main, 12 if S == 64 else 16):
            cdf_np = model_cdf(probs, P)
            p = (cdf_np[symbols + 1].astype(np.float64) - cdf_np[symbols]) \
                / cdf_np[-1]
            facade = ctt._pick_cfg(n, None, cdf_np,
                                   est_bits=float((-np.log2(p)).sum()))
            # the facade's lanes at this preset (P=12 takes the small one)
            facade = LaneConfig(num_lanes=facade.num_lanes, word_bits=W,
                                state_bits=S, precision=P)
            bench = LaneConfig(num_lanes=BENCH_LANES, word_bits=W,
                               state_bits=S, precision=P)
            cases += [(cdf_np, facade, True, P == P_main),
                      (cdf_np, bench, False, False)]
        for cdf_np, cfg, plain, main in cases:
            cdf = convert.cdf_to_torch(cdf_np, device)
            st, w = enc(syms, cdf, cfg)
            out, fin = dec(st, w, cdf, cfg, n, return_final_states=True)
            if (mismatch(out, syms) != 0
                    or mismatch(fin, torch.full_like(st, 1 << (S - W))) != 0):
                fail(f"times: {label} L={cfg.num_lanes} round trip")
            row = {
                "preset": label, "P": cfg.precision,
                "num_lanes": cfg.num_lanes, "n": n,
                "encode_ms": time_ms(lambda: enc(syms, cdf, cfg), 3),
                "decode_ms": time_ms(lambda: dec(st, w, cdf, cfg, n), 3),
            }
            time_passes(row, syms, cdf, cfg, w)
            if plain:
                st_p, w_p = enc_p(syms, cdf, cfg)
                out_p, fin_p = dec_p(st, w, cdf, cfg, n,
                                     return_final_states=True)
                e_enc = max(mismatch(st, st_p), mismatch(w, w_p))
                e_dec = max(mismatch(out, out_p), mismatch(fin, fin_p))
                row["encode_max_abs_err"] = e_enc
                row["decode_max_abs_err"] = e_dec
                if e_enc != 0 or e_dec != 0:
                    fail(f"times: kernel != twin at full size: {row}")
                for key, e in ((f"ilans2_encode_{label}", e_enc),
                               (f"ilans2_decode_{label}", e_dec)):
                    errs[key] = max(errs[key], e)
                row["encode_plain_ms"] = time_ms(
                    lambda: enc_p(syms, cdf, cfg), 1)
                row["decode_plain_ms"] = time_ms(
                    lambda: dec_p(st, w, cdf, cfg, n), 1)
            if main:
                K, B = len(cdf_np) - 1, S // 8
                L, words = cfg.num_lanes, int(w.numel())
                # encode: symbols and CDF in; states and stream out
                times[f"ilans2_encode_{label}"] = (
                    row["encode_ms"], row["encode_plain_ms"],
                    *bound(4 * n + 4 * (K + 1) + B * L + 4 * words, 10 * n))
                # decode: states, stream and CDF in; symbols, states out
                times[f"ilans2_decode_{label}"] = (
                    row["decode_ms"], row["decode_plain_ms"],
                    *bound(2 * B * L + 4 * words + 4 * (K + 1) + 4 * n,
                           (search_ops(K) + 8) * n))
            for k in ("encode", "decode"):
                row[f"{k}_gsym_per_s"] = n / (row[f"{k}_ms"] * 1e-3) / 1e9
            row["gpu"] = gpu
            rows.append(row)
    return {"phase": "times", "cases": rows}, times


def phase_sweep(device, gpu: str) -> dict:
    """Kernel time per coding step at SWEEP_STEPS steps over SWEEP_LANES
    lanes, both presets and kernel 11 (the family decode, gaussian on
    FAMILY_SUPPORT, its C entry alone); per kernel, the floor (microseconds
    per step at the fewest lanes) and the slope from 4096 lanes up
    (microseconds per step per 1024 lanes).  Small L sits above that line,
    so the two are read separately rather than fitted as one."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build
    from constriction_tpu_torch.ops import family as fam
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    rng = np.random.RandomState(11)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    n_max = max(SWEEP_LANES) * SWEEP_STEPS
    all_syms = torch.from_numpy(
        rng.choice(K_MAIN, size=n_max, p=probs).astype(np.int32)).to(device)
    rows = []
    fits = {}
    for label, W, S, P, enc, dec, _, _ in presets():
        cdf = convert.cdf_to_torch(model_cdf(probs, P), device)
        us = {"encode": [], "decode": []}
        for L in SWEEP_LANES:
            cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S,
                             precision=P)
            n = L * SWEEP_STEPS
            syms = all_syms[:n]
            st, w = enc(syms, cdf, cfg)
            if mismatch(dec(st, w, cdf, cfg, n), syms) != 0:
                fail(f"sweep: {label} L={L} round trip")
            row = {"preset": label, "P": P, "num_lanes": L,
                   "steps": SWEEP_STEPS}
            for k, fn in (("encode", lambda: enc(syms, cdf, cfg)),
                          ("decode", lambda: dec(st, w, cdf, cfg, n))):
                ms = time_ms(fn, 3)
                row[f"{k}_ms"] = ms
                row[f"{k}_us_per_step"] = ms * 1e3 / SWEEP_STEPS
                us[k].append(row[f"{k}_us_per_step"])
            rows.append(row)
        i = SWEEP_LANES.index(4096)
        for k, ys in us.items():
            fits[f"ilans2_{k}_{label}"] = {
                "us_per_step_floor": ys[0],
                "us_per_1024_lanes_per_step": (ys[-1] - ys[i]) * 1024 / (
                    SWEEP_LANES[-1] - SWEEP_LANES[i]),
            }
    means, scales, symbols, _ = family_workload(n_max)
    lo, hi = FAMILY_SUPPORT
    fi = fam.FAMILIES.index(MAIN_FAMILY)
    ys = []
    for L in SWEEP_LANES:
        cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                         precision=12)
        n = L * SWEEP_STEPS
        mu, sg = convert.params_to_torch(means[:n], scales[:n], n, L, device)
        syms = torch.from_numpy(symbols[:n]).to(device)
        st, w = fam.encode_family(syms, mu, sg, MAIN_FAMILY, lo, hi, cfg)
        s_buf = torch.empty_like(st)
        o_buf = torch.empty(n, dtype=torch.int32, device=device)
        ms = kernel_ms(lambda: s_buf.copy_(st), lambda: _build.call(
            "ctt_family_decode", device, s_buf, w, w.numel(), mu, sg, o_buf,
            n, L, fi, lo, hi), 3)
        if mismatch(o_buf, syms) != 0:
            fail(f"sweep: family decode L={L} round trip")
        ys.append(ms * 1e3 / SWEEP_STEPS)
        rows.append({"kernel": 11, "family": MAIN_FAMILY, "num_lanes": L,
                     "steps": SWEEP_STEPS, "decode_ms": ms,
                     "decode_us_per_step": ys[-1]})
    fits["family_decode"] = {
        "us_per_step_floor": ys[0],
        "us_per_1024_lanes_per_step": (ys[-1] - ys[i]) * 1024 / (
            SWEEP_LANES[-1] - SWEEP_LANES[i])}
    return {"phase": "sweep", "cases": rows, "fits": fits, "gpu": gpu}


def range_presets():
    """(label, W, S, P, decode, decode_plain)."""
    from constriction_tpu_torch.ops import coder, coder64

    return [
        ("w32s64", 32, 64, 24, coder64.decode_shared_range64,
         coder64.decode_shared_range64_plain),
        ("w16s32", 16, 32, 12, coder.decode_shared_range,
         coder.decode_shared_range_plain),
    ]


def host_range(symbols, cdf, cfg):
    """The port's host range encoder: ``(points, stream)``."""
    import numpy as np

    from constriction_tpu_torch.ops import interleaved2 as il2

    c = np.asarray(cdf, dtype=np.uint64)
    cums = c[symbols]
    return il2.encode_shared_range(cums, c[symbols + 1] - cums, cfg)


def range_name(kind: str, label: str) -> str:
    """The name of a range kernel in RANGE_KERNELS: phase B (kernels 8 and
    10) is the lane pass (and the compaction)."""
    if kind == "resolve":
        return f"range_resolve_lanes_{label}"
    return f"ilans2_range_{kind}_{label}"


def planes_err(a, b) -> int:
    return max(mismatch(x, y) for x, y in zip(a, b))


def range_case(device, cfg, syms_np, cdf_np, dec, dec_p, label,
               errs, interval: int = 8) -> dict:
    """The three range kernels of one preset against their twins on the
    same CUDA tensors and against the host oracle, and a seeded decode
    from the middle checkpoint (one every ``interval`` steps).  Adds each
    kernel's largest difference to ``errs``."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops import range_enc

    n, L = len(syms_np), cfg.num_lanes
    syms = torch.from_numpy(syms_np.astype(np.int32)).to(device)
    cdf = convert.cdf_to_torch(cdf_np, device)
    rec = range_enc.record(syms, cdf, cfg)
    e_rec = planes_err(rec, range_enc.record_plain(syms, cdf, cfg))
    s0, carry = range_enc.seal(rec[1], rec[2], cfg)
    pts, words = range_enc.resolve(rec[0], s0, carry, cfg, n)
    e_res = planes_err((pts, words),
                       range_enc.resolve_plain(rec[0], s0, carry, cfg, n))
    pts_h, words_h = host_range(syms_np, cdf_np, cfg)
    e_res = max(e_res, mismatch(pts, convert.states_to_torch(
        pts_h, cfg, device)), mismatch(words, convert.u32_to_torch(
            words_h, device)))
    out, fin = dec(pts, words, cdf, cfg, n, return_final_states=True)
    out_p, fin_p = dec_p(pts, words, cdf, cfg, n, return_final_states=True)
    e_dec = max(mismatch(out, out_p), planes_err(fin, fin_p),
                mismatch(out.cpu(), torch.from_numpy(
                    il2.decode_shared_range_cdf(pts_h, words_h, n, cdf_np,
                                                cfg))))
    round_trip = mismatch(out, syms) == 0
    # seeded: resume from the middle checkpoint
    off, lows, rngs, pps = il2.build_checkpoints_range(
        pts_h, words_h, n, cdf_np, cfg, interval)
    c = len(off) // 2
    start = (c + 1) * interval * L
    lo, rn, pt = convert.planes_to_torch((lows[c], rngs[c], pps[c]), cfg,
                                         device)
    sub = convert.u32_to_torch(words_h[off[c]:], device)
    k = dec(pt, sub, cdf, cfg, n - start, lows=lo, rngs=rn,
            return_final_states=True)
    p = dec_p(pt, sub, cdf, cfg, n - start, lows=lo, rngs=rn,
              return_final_states=True)
    e_dec = max(e_dec, mismatch(k[0], p[0]), planes_err(k[1], p[1]),
                planes_err(k[1], fin))
    seeded_ok = mismatch(k[0], syms[start:]) == 0
    for kind, e in (("record", e_rec), ("resolve", e_res), ("decode", e_dec)):
        name = range_name(kind, label)
        errs[name] = max(errs.get(name, 0), e)
    row = {"preset": label, "P": cfg.precision, "words": int(words.numel()),
           "carries": int(((rec[0].long() >> (cfg.word_bits + 1)) & 1).sum()),
           "record_max_abs_err": e_rec, "resolve_max_abs_err": e_res,
           "decode_max_abs_err": e_dec, "round_trip": round_trip,
           "seeded_from_step": (c + 1) * interval,
           "seeded_decode_exact": seeded_ok}
    if e_rec or e_res or e_dec or not round_trip or not seeded_ok:
        fail(f"range kernel != twin or host oracle, or no round trip: {row}")
    return row


def phase_range_kernels(device, n: int, L: int) -> tuple[dict, dict]:
    import numpy as np

    from constriction_tpu_torch.ops.interleaved import LaneConfig

    rng = np.random.RandomState(17)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    syms = rng.choice(K_MAIN, size=n, p=probs).astype(np.int64)
    # 99.9% of the mass on one symbol: a lane renorms only every thousand
    # steps or so, after long runs of deferred words, so this model runs
    # on few lanes and many steps
    skewed = np.where(rng.random_sample(N_SKEWED) < 0.999, 0,
                      rng.randint(1, 4, N_SKEWED)).astype(np.int64)
    errs: dict[str, int] = {}
    rows = []
    for label, W, S, P, dec, dec_p in range_presets():
        cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)
        row = range_case(device, cfg, syms, model_cdf(probs, P), dec, dec_p,
                         label, errs)
        rows.append({"model": "dirichlet", "num_lanes": L, "n": n, **row})
        q = np.array([(1 << P) - 3, 1, 1, 1], dtype=np.int64)
        cdf = np.concatenate([[0], np.cumsum(q)]).astype(np.uint32)
        cfg = LaneConfig(num_lanes=SKEWED_LANES, word_bits=W, state_bits=S,
                         precision=P)
        row = range_case(device, cfg, skewed, cdf, dec, dec_p, label, errs)
        rows.append({"model": "skewed 99.9%", "num_lanes": SKEWED_LANES,
                     "n": N_SKEWED, **row})
    # kernel 6 on the cluster step at the facade's lane counts and both
    # ends of its precisions (P=12: the bucket table holds every quantile;
    # P=16: a search behind it), each resumed from a checkpoint's planes
    for L, P in ((65536, 12), (32768, 16), (65536, 16)):
        cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                         precision=P)
        row = range_case(device, cfg, syms, model_cdf(probs, P),
                         *range_presets()[1][4:], "w16s32", errs,
                         interval=max(1, -(-n // L) // 4))
        rows.append({"model": "dirichlet", "num_lanes": L, "n": n, **row})
    return {"phase": "range_kernels", "cases": rows}, errs


def phase_range_main(device, probs, symbols) -> dict:
    """The range facade on the card at full size, against the host
    oracle."""
    import numpy as np

    from constriction_tpu_torch import cuda as ctt

    rows = []
    for P in (24, 12):
        cdf = model_cdf(probs, P)
        cfg = ctt._pick_cfg(len(symbols), None, cdf)
        t0 = time.perf_counter()
        pts, words = ctt.encode_iid_range(symbols, cdf, device=device)
        t1 = time.perf_counter()
        out = ctt.decode_iid_range(pts, words, cdf, len(symbols),
                                   device=device)
        t2 = time.perf_counter()
        pts_h, words_h = host_range(symbols, cdf, cfg)
        t3 = time.perf_counter()
        row = {
            "P": P, "num_lanes": cfg.num_lanes, "words": int(len(words)),
            "identical_to_host_oracle": bool(
                pts.dtype == pts_h.dtype and np.array_equal(pts, pts_h)
                and np.array_equal(words, words_h)),
            "decodes_exactly": bool(np.array_equal(out, symbols)),
            "encode_call_s": t1 - t0, "decode_call_s": t2 - t1,
            "host_oracle_encode_s": t3 - t2,
        }
        rows.append(row)
        if not (row["identical_to_host_oracle"] and row["decodes_exactly"]):
            fail(f"range main path: {row}")
    return {"phase": "range_main_path", "n": len(symbols), "cases": rows}


def kernel_ms(setup, launch, reps: int) -> float:
    """Mean milliseconds of ``launch()`` alone over ``reps`` runs after one
    warm-up: CUDA events around each launch, ``setup()`` (restoring state
    the kernel updates in place) outside them."""
    import torch

    setup()
    launch()
    total = 0.0
    for _ in range(reps):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def timed(fn):
    """(milliseconds, result) of one call, between CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def phase_range_times(device, probs, symbols, gpu: str,
                      errs: dict) -> tuple[dict, dict]:
    """Kernel-only time of each range kernel at the main path's size and
    config, its twin's time and outputs (which must equal the kernel's)
    on the same tensors, and the facade's call times.  Returns the phase
    record and {kernel: (ms, plain_ms, bound_ms, bound_by)}."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import _build, coder, range_enc

    n = len(symbols)
    syms = torch.from_numpy(symbols.astype(np.int32)).to(device)
    rows, times = [], {}
    for label, W, S, P, dec, dec_p in range_presets():
        cdf_np = model_cdf(probs, P)
        cfg = ctt._pick_cfg(n, None, cdf_np)
        L, K, B = cfg.num_lanes, len(cdf_np) - 1, S // 8
        T = -(-n // L)
        cdf = convert.cdf_to_torch(cdf_np, device)
        cdf32 = cdf.to(torch.int32)
        recs, low_f, rng_f = range_enc.record(syms, cdf, cfg)
        s0, carry = range_enc.seal(low_f, rng_f, cfg)
        pts, words = range_enc.resolve(recs, s0, carry, cfg, n)
        out, fin = dec(pts, words, cdf, cfg, n, return_final_states=True)
        if mismatch(out, syms):
            fail(f"range_times: {label} round trip")
        nw = int(words.numel())
        # kernel-only: the C entry points on preallocated buffers
        r_buf = torch.empty_like(recs)
        lo_buf, rg_buf = torch.empty_like(low_f), torch.empty_like(rng_f)
        buf = torch.empty(n, dtype=torch.int32, device=device)
        end = torch.empty(1, dtype=torch.int64, device=device)
        p_buf = torch.empty_like(pts)
        planes = [torch.empty_like(pts) for _ in range(3)]
        o_buf = torch.empty(n, dtype=torch.int32, device=device)
        bad = torch.empty(1, dtype=torch.int64, device=device)
        # phase B (kernel 8 or 10): the lane pass and pass B, their scratch
        scratch = coder.compaction_scratch(T, L, device)

        def reset_decode():
            planes[0].zero_()
            planes[1].fill_(-1)
            planes[2].copy_(pts)
            bad.fill_(n)

        ms = {
            "record": kernel_ms(lambda: None, lambda: _build.call(
                f"ctt_ilans2_range_record_{label}", device, syms, n, cdf32,
                K, r_buf, lo_buf, rg_buf, L, P), 3),
            "resolve": kernel_ms(lambda: None, lambda: _build.call(
                f"ctt_ilans2_range_resolve_{label}", device, recs, s0, carry,
                buf, n, end, p_buf, *scratch, L, T), 3),
            "decode": kernel_ms(reset_decode, lambda: _build.call(
                f"ctt_ilans2_range_decode_{label}", device, *planes, words,
                nw, cdf32, K, o_buf, n, L, P, bad), 3),
        }
        if not (torch.equal(r_buf, recs) and torch.equal(p_buf, pts)
                and torch.equal(buf[int(end.item()):], words)
                and torch.equal(o_buf, syms) and int(bad.item()) == n):
            fail(f"range_times: {label} timed launches differ")
        # phase B's two passes apart
        passes = {"resolve_lanes_ms": kernel_ms(lambda: None, lambda: (
            _build.call(f"ctt_ilans2_range_resolve_lanes_{label}", device,
                        recs, s0, carry, scratch[0], scratch[1], p_buf, L,
                        T)), 3)}
        passes["resolve_pass_b_ms"] = kernel_ms(lambda: None, lambda: (
            _build.call("ctt_ilans2_compact", device, scratch[1], scratch[0],
                        scratch[1].numel(), buf, n, end, scratch[2])), 3)
        if not (torch.equal(p_buf, pts)
                and torch.equal(buf[int(end.item()):], words)):
            fail(f"range_times: {label} phase B's passes timed apart differ")
        passes["resolve_scratch_bytes"] = 4 * (scratch[0].numel()
                                               + scratch[1].numel())
        # phase A (kernels 7 and 9): its launch shape and achieved rate
        record_bytes = 4 * n + 4 * (K + 1) + B * T * L + 2 * B * L
        passes.update({f"record_{k}": v for k, v in
                       range_enc.record_geometry(cfg, K, device).items()})
        passes["record_tb_per_s"] = record_bytes / ms["record"] / 1e9
        # the twins on the same tensors (after the smaller warm-up above)
        plain_ms, rec_p = timed(lambda: range_enc.record_plain(syms, cdf,
                                                               cfg))
        plain = {"record": plain_ms}
        plain["resolve"], res_p = timed(lambda: range_enc.resolve_plain(
            recs, s0, carry, cfg, n))
        plain["decode"], dec_out = timed(lambda: dec_p(
            pts, words, cdf, cfg, n, return_final_states=True))
        e = {"record": planes_err((recs, low_f, rng_f), rec_p),
             "resolve": planes_err((pts, words), res_p),
             "decode": max(mismatch(out, dec_out[0]),
                           planes_err(fin, dec_out[1]))}
        bounds = {
            # symbols and CDF in; records and final (lower, range) out
            "record": bound(record_bytes, 12 * n),
            # records, seal words and carries in; stream and points out
            "resolve": bound(B * T * L + 8 * L + 4 * nw + B * L, 8 * T * L),
            # points, stream and CDF in; symbols and final planes out
            "decode": bound(B * L + 4 * nw + 4 * (K + 1) + 4 * n + 3 * B * L,
                            (search_ops(K) + 14) * n),
        }
        for kind in ms:
            name = range_name(kind, label)
            errs[name] = max(errs[name], e[kind])
            times[name] = (ms[kind], plain[kind], *bounds[kind])
        if any(e.values()):
            fail(f"range_times: kernel != twin at full size: {label} {e}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_np, w_np = ctt.encode_iid_range(symbols, cdf_np, device=device)
        t1 = time.perf_counter()
        ctt.decode_iid_range(p_np, w_np, cdf_np, n, device=device)
        t2 = time.perf_counter()
        rows.append({
            "preset": label, "P": P, "num_lanes": L, "n": n, "words": nw,
            **{f"{k}_ms": v for k, v in ms.items()},
            **{f"{k}_plain_ms": v for k, v in plain.items()},
            **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
            **{f"{k}_max_abs_err": v for k, v in e.items()},
            **passes,
            "encode_kernels_gsym_per_s": n / ((ms["record"] + ms["resolve"])
                                              * 1e-3) / 1e9,
            "decode_kernel_gsym_per_s": n / (ms["decode"] * 1e-3) / 1e9,
            "facade_encode_call_s": t1 - t0, "facade_decode_call_s": t2 - t1,
            "facade_encode_ns_per_symbol": (t1 - t0) / n * 1e9,
            "facade_decode_ns_per_symbol": (t2 - t1) / n * 1e9,
            "facade_encode_host_share": 1 - (ms["record"] + ms["resolve"])
            * 1e-3 / (t1 - t0),
            "facade_decode_host_share": 1 - ms["decode"] * 1e-3 / (t2 - t1),
            "gpu": gpu,
        })
    return {"phase": "range_times", "cases": rows}, times


def phase_range_sweep(device, gpu: str) -> dict:
    """The range decodes (kernel 5 at P=24, kernel 6 at P=12) per coding
    step at SWEEP_STEPS steps over SWEEP_LANES lanes, as phase_sweep times
    the rANS pairs: kernel-only (CUDA events around the C entry, the planes
    reset outside them), the floor at the fewest lanes and the slope from
    4096 lanes up (microseconds per step per 1024 lanes)."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build, range_enc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    rng = np.random.RandomState(11)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    n_max = max(SWEEP_LANES) * SWEEP_STEPS
    all_syms = torch.from_numpy(
        rng.choice(K_MAIN, size=n_max, p=probs).astype(np.int32)).to(device)
    rows, fits = [], {}
    for kernel, label, W, S, P in ((5, "w32s64", 32, 64, 24),
                                   (6, "w16s32", 16, 32, 12)):
        cdf = convert.cdf_to_torch(model_cdf(probs, P), device)
        cdf32 = cdf.to(torch.int32)
        us = []
        for L in SWEEP_LANES:
            cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S,
                             precision=P)
            n = L * SWEEP_STEPS
            syms = all_syms[:n]
            recs, low_f, rng_f = range_enc.record(syms, cdf, cfg)
            s0, carry = range_enc.seal(low_f, rng_f, cfg)
            pts, words = range_enc.resolve(recs, s0, carry, cfg, n)
            planes = [torch.empty_like(pts) for _ in range(3)]
            out = torch.empty(n, dtype=torch.int32, device=device)
            bad = torch.empty(1, dtype=torch.int64, device=device)

            def reset():
                planes[0].zero_()
                planes[1].fill_(-1)
                planes[2].copy_(pts)
                bad.fill_(n)

            ms = kernel_ms(reset, lambda: _build.call(
                f"ctt_ilans2_range_decode_{label}", device, *planes, words,
                words.numel(), cdf32, K_MAIN, out, n, L, P, bad), 3)
            if mismatch(out, syms) != 0 or int(bad.item()) != n:
                fail(f"range_sweep: kernel {kernel} L={L} round trip")
            us.append(ms * 1e3 / SWEEP_STEPS)
            rows.append({"kernel": kernel, "preset": label, "P": P,
                         "num_lanes": L, "steps": SWEEP_STEPS,
                         "decode_ms": ms, "decode_us_per_step": us[-1]})
        i = SWEEP_LANES.index(4096)
        fits[f"ilans2_range_decode_{label}"] = {
            "us_per_step_floor": us[0],
            "us_per_1024_lanes_per_step": (us[-1] - us[i]) * 1024 / (
                SWEEP_LANES[-1] - SWEEP_LANES[i])}
    return {"phase": "range_sweep", "cases": rows, "fits": fits, "gpu": gpu}


def family_workload(n: int):
    """The family benchmark row of the JAX package's suite: per-symbol
    gaussian parameters and symbols at support [-100, 100]."""
    import numpy as np

    rng = np.random.RandomState(1234)
    means = (rng.randn(n) * 10).astype(np.float32)
    scales = (0.3 + np.abs(rng.randn(n)) * 5).astype(np.float32)
    symbols = np.clip(np.round(means + rng.randn(n) * scales),
                      *FAMILY_SUPPORT).astype(np.int32)
    quantiles = rng.randint(0, 1 << 12, size=n).astype(np.uint16)
    return means, scales, symbols, quantiles


def phase_family_math(device) -> dict:
    """``ctt_family_left`` against the plain arithmetic, value by value."""
    import numpy as np
    import torch

    from constriction_tpu_torch.ops import family as fam

    lo, hi = FAMILY_SUPPORT
    rng = np.random.RandomState(23)
    # x = 0, scale = 1, mean = -(0.5 + t / 4096): t_fix is exactly t
    t = np.arange(-fam.T_CLAMP, fam.T_CLAMP, dtype=np.int64)
    grid = np.array([(x, m, s) for m in (-500.0, -100.0, 0.0, 99.7, 500.0)
                     for s in (1e-6, 0.01, 1.0, 1e4, 1e6)
                     for x in range(lo + 1, hi + 2)], dtype=np.float64)
    cases = {
        "every_t_fix": (np.zeros(len(t)), -(0.5 + t / 4096.0),
                        np.ones(len(t))),
        "random": (rng.randint(lo + 1, hi + 2, size=N_MATH),
                   rng.randn(N_MATH) * 30, np.exp(rng.randn(N_MATH) * 3)),
        "extreme_grid": (grid[:, 0], grid[:, 1], grid[:, 2]),
    }
    rows = []
    for name, (x, mean, scale) in cases.items():
        x_np = x.astype(np.int32)
        mean_np, scale_np = mean.astype(np.float32), scale.astype(np.float32)
        xs, mu, sg = (torch.from_numpy(a).to(device)
                      for a in (x_np, mean_np, scale_np))
        for family in fam.FAMILIES:
            got = fam.family_left(xs, mu, sg, family, lo, hi)
            plain = fam.left(torch, family, lo, hi, xs, mu, 1.0 / sg)
            host = fam.left(np, family, lo, hi, x_np, mean_np,
                            np.float32(1.0) / scale_np)
            row = {"case": name, "family": family, "values": len(x_np),
                   "max_abs_err": max(mismatch(got, plain), mismatch(
                       got.cpu(), torch.from_numpy(host)))}
            if name == "every_t_fix":
                t_fix = fam.t_fixed(torch, xs, mu, 1.0 / sg).cpu().numpy()
                row["t_fix_covered"] = bool(np.array_equal(t_fix, t))
                if not row["t_fix_covered"]:
                    fail(f"family_math: t_fix domain not covered: {row}")
            rows.append(row)
            if row["max_abs_err"]:
                fail(f"family_math: kernel CDF != plain CDF: {row}")
    return {"phase": "family_math", "cases": rows, "max_abs_err": 0}


def family_case(device, cfg, family, means, scales, symbols, errs) -> dict:
    """The rANS family pair against its twins and the numpy host oracles;
    the encode's three steps also launched alone, each against its plain
    version on the same tensors."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import coder
    from constriction_tpu_torch.ops import family as fam
    from constriction_tpu_torch.ops import interleaved2 as il2

    lo, hi = FAMILY_SUPPORT
    n, L = len(symbols), cfg.num_lanes
    mu, sg = convert.params_to_torch(means, scales, n, L, device)
    syms = torch.from_numpy(symbols).to(device)
    st, w = fam.encode_family(syms, mu, sg, family, lo, hi, cfg)
    st_p, w_p = fam.encode_family_plain(syms, mu, sg, family, lo, hi, cfg)
    cums, probs = fam.family_tables_host(symbols, means, scales, family, lo,
                                         hi)
    st_h, w_h = il2.encode_shared(cums, probs, cfg)
    # (a) the tables pass, (b) pass A, (c) pass B, each alone
    recs = fam.family_tables_pass(syms, mu, sg, family, lo, hi, cfg)
    e_a = mismatch(recs, fam.family_tables_pass_plain(syms, mu, sg, family,
                                                      lo, hi))
    words, ballots, states = fam.family_lanes_pass(recs, cfg)
    words_p, flags_p, states_p = fam.family_lanes_pass_plain(recs, n, cfg)
    e_b = max(mismatch(ballots, coder.flag_ballots(flags_p)),
              mismatch(words[flags_p], words_p[flags_p]),
              mismatch(states, states_p))
    stream = coder.compact_pass(words, ballots)
    e_c = max(mismatch(stream, coder.compact_pass_plain(words_p, flags_p)),
              planes_err((states, stream), (st_p, w_p)))
    e_enc = max(mismatch(st, st_p), mismatch(w, w_p),
                mismatch(st, convert.u32_to_torch(st_h, device)),
                mismatch(w, convert.u32_to_torch(w_h, device)), e_a, e_b,
                e_c)
    out, fin = fam.decode_family(st, w, mu, sg, family, lo, hi, cfg, n,
                                 return_final_states=True)
    out_p, fin_p = fam.decode_family_plain(st, w, mu, sg, family, lo, hi, cfg,
                                           n, return_final_states=True)
    out_h = fam.decode_family_host(st_h, w_h, means, scales, family, lo, hi,
                                   cfg, n)
    e_dec = max(mismatch(out, out_p), mismatch(fin, fin_p),
                mismatch(out.cpu(), torch.from_numpy(out_h)))
    round_trip = (mismatch(out, syms) == 0
                  and mismatch(fin, torch.full_like(fin, 1 << 16)) == 0)
    errs["family_encode"] = max(errs.get("family_encode", 0), e_enc)
    errs["family_decode"] = max(errs.get("family_decode", 0), e_dec)
    row = {"coder": "rans", "family": family, "n": n, "num_lanes": L,
           "words": int(w.numel()), "encode_max_abs_err": e_enc,
           "tables_pass_max_abs_err": e_a, "pass_a_max_abs_err": e_b,
           "pass_b_max_abs_err": e_c,
           "decode_max_abs_err": e_dec, "round_trip": round_trip}
    if e_enc or e_dec or not round_trip:
        fail(f"family kernel != twin or host oracle, or no round trip: {row}")
    return row


def tchain_case(device, cfg, family, means, scales, quantiles, errs) -> dict:
    """The TChain-12 bits-back pair against its twins and host oracles."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import coder
    from constriction_tpu_torch.ops import tchain as tc

    lo, hi = FAMILY_SUPPORT
    n, L = len(quantiles), cfg.num_lanes
    mu, sg = convert.params_to_torch(means, scales, n, L, device)
    qw = convert.quantiles_to_torch(quantiles, L, device)
    dec = tc.tchain12_family_decode(qw, mu, sg, family, lo, hi, cfg)
    dec_p = tc.tchain12_family_decode_plain(qw, mu, sg, family, lo, hi, cfg)
    syms_h, rem_h, heads_h = tc.tchain12_family_decode_host(
        quantiles, means, scales, family, lo, hi, cfg)
    e_dec = max(planes_err(dec, dec_p),
                mismatch(dec[0].cpu(), torch.from_numpy(syms_h)),
                mismatch(dec[1], convert.u32_to_torch(rem_h, device)),
                mismatch(dec[2], convert.u32_to_torch(heads_h, device)))
    # the decode's three steps launched alone, each against its plain
    # version on the same tensors, and composed against the twin
    syms, recs = tc.tchain12_invert_pass(qw, mu, sg, family, lo, hi, cfg)
    plain = tc.tchain12_invert_pass_plain(qw, mu, sg, family, lo, hi, cfg)
    e_a = planes_err((syms, recs), plain)
    words, ballots, heads = tc.tchain12_head_pass(recs, cfg)
    words_p, flags_p, heads_p = tc.tchain12_head_pass_plain(recs, cfg)
    e_b = max(mismatch(ballots, coder.flag_ballots(flags_p)),
              mismatch(words[flags_p], words_p[flags_p]),
              mismatch(heads, heads_p))
    stream = coder.compact_pass(words, ballots)
    e_c = max(mismatch(stream, coder.compact_pass_plain(words_p, flags_p)),
              planes_err((syms, stream, heads), dec_p))
    e_dec = max(e_dec, e_a, e_b, e_c)
    enc = tc.tchain12_family_encode(*dec, mu, sg, family, lo, hi, cfg)
    enc_p = tc.tchain12_family_encode_plain(*dec, mu, sg, family, lo, hi, cfg)
    q_h, h_h = tc.tchain12_family_encode_host(syms_h, rem_h, heads_h, means,
                                              scales, family, lo, hi, cfg)
    # the encode's tables pass launched alone against its plain version
    e_t = mismatch(
        tc.tchain12_tables_pass(dec[0], mu, sg, family, lo, hi, cfg),
        tc.tchain12_tables_pass_plain(dec[0], mu, sg, family, lo, hi, cfg))
    e_enc = max(planes_err(enc, enc_p), mismatch(
        torch.from_numpy(convert.quantiles_from_torch(enc[0], L).astype(
            np.int32)), torch.from_numpy(q_h.astype(np.int32))),
        mismatch(enc[1], convert.u32_to_torch(h_h, device)), e_t)
    round_trip = (mismatch(enc[0], qw) == 0
                  and mismatch(enc[1], torch.full_like(enc[1], 16)) == 0)
    errs["tchain12_family_decode"] = max(
        errs.get("tchain12_family_decode", 0), e_dec)
    errs["tchain12_family_encode"] = max(
        errs.get("tchain12_family_encode", 0), e_enc)
    row = {"coder": "tchain12", "family": family, "n": n, "num_lanes": L,
           "words": int(dec[1].numel()), "decode_max_abs_err": e_dec,
           "invert_pass_max_abs_err": e_a, "head_pass_max_abs_err": e_b,
           "pass_b_max_abs_err": e_c, "tables_pass_max_abs_err": e_t,
           "encode_max_abs_err": e_enc, "round_trip": round_trip}
    if e_enc or e_dec or not round_trip:
        fail(f"tchain kernel != twin or host oracle, or no round trip: {row}")
    return row


def phase_family_kernels(device, n: int, L: int) -> tuple[dict, dict]:
    from constriction_tpu_torch.ops import family as fam
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    n_chain = 32 * L
    means, scales, symbols, quantiles = family_workload(max(n, n_chain))
    errs: dict[str, int] = {}
    rows = []
    for family in fam.FAMILIES:
        rows.append(family_case(device, cfg, family, means[:n], scales[:n],
                                symbols[:n], errs))
        rows.append(tchain_case(device, cfg, family, means[:n_chain],
                                scales[:n_chain], quantiles[:n_chain], errs))
    return {"phase": "family_kernels", "cases": rows}, errs


def phase_family_main(device, work) -> dict:
    """The family facade on the card at full size, against the host
    oracles."""
    import numpy as np

    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import family as fam
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops import tchain as tc

    means, scales, symbols, quantiles = work
    lo, hi = FAMILY_SUPPORT
    n = len(symbols)
    cfg = ctt._pick_cfg(n, None)
    t0 = time.perf_counter()
    states, stream = ctt.encode_family(symbols, means, scales, MAIN_FAMILY,
                                       lo, hi, device=device)
    t1 = time.perf_counter()
    out = ctt.decode_family(states, stream, means, scales, MAIN_FAMILY, lo,
                            hi, n, device=device)
    t2 = time.perf_counter()
    cums, probs = fam.family_tables_host(symbols, means, scales, MAIN_FAMILY,
                                         lo, hi)
    st_h, w_h = il2.encode_shared(cums, probs, cfg)
    t3 = time.perf_counter()
    syms, rem, heads = ctt.bits_back_decode_family(
        quantiles, means, scales, MAIN_FAMILY, lo, hi, device=device)
    t4 = time.perf_counter()
    q_back, h_back = ctt.bits_back_encode_family(
        syms, rem, heads, means, scales, MAIN_FAMILY, lo, hi, device=device)
    t5 = time.perf_counter()
    syms_h, rem_h, heads_h = tc.tchain12_family_decode_host(
        quantiles, means, scales, MAIN_FAMILY, lo, hi)
    t6 = time.perf_counter()
    row = {
        "family": MAIN_FAMILY, "support": [lo, hi], "n": n,
        "num_lanes": cfg.num_lanes, "stream_words": int(len(stream)),
        "remainder_words": int(len(rem)),
        "encode_identical_to_host_oracle": bool(
            states.dtype == st_h.dtype and np.array_equal(states, st_h)
            and np.array_equal(stream, w_h)),
        "decodes_exactly": bool(np.array_equal(out, symbols)),
        "bits_back_decode_identical_to_host_oracle": bool(
            np.array_equal(syms, syms_h) and np.array_equal(rem, rem_h)
            and np.array_equal(heads, heads_h)),
        "bits_back_round_trip": bool(np.array_equal(q_back, quantiles)
                                     and (h_back == 16).all()),
        "max_abs_err": 0,
        "encode_call_s": t1 - t0, "decode_call_s": t2 - t1,
        "host_oracle_encode_s": t3 - t2,
        "bits_back_decode_call_s": t4 - t3,
        "bits_back_encode_call_s": t5 - t4,
        "host_oracle_bits_back_decode_s": t6 - t5,
    }
    if not (row["encode_identical_to_host_oracle"] and row["decodes_exactly"]
            and row["bits_back_decode_identical_to_host_oracle"]
            and row["bits_back_round_trip"]):
        fail(f"family main path: {row}")
    return {"phase": "family_main_path", "cases": [row]}


def phase_family_times(device, work, gpu: str,
                       errs: dict) -> tuple[dict, dict]:
    """Kernel-only time of each family kernel at the main path's size and
    config (the C entry points on preallocated buffers), its twin's time
    and outputs on the same tensors, the facade's call times, and each
    kernel's bound.  Returns the phase record and {kernel: (ms, plain_ms,
    bound_ms, bound_by)}."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import _build, coder
    from constriction_tpu_torch.ops import family as fam
    from constriction_tpu_torch.ops import tchain as tc

    means, scales, symbols, quantiles = work
    lo, hi = FAMILY_SUPPORT
    family, n = MAIN_FAMILY, len(symbols)
    cfg = ctt._pick_cfg(n, None)
    L = cfg.num_lanes
    T = n // L
    fi = fam.FAMILIES.index(family)
    mu, sg = convert.params_to_torch(means, scales, n, L, device)
    syms = torch.from_numpy(symbols).to(device)
    qw = convert.quantiles_to_torch(quantiles, L, device)
    st, w = fam.encode_family(syms, mu, sg, family, lo, hi, cfg)
    out, fin = fam.decode_family(st, w, mu, sg, family, lo, hi, cfg, n,
                                 return_final_states=True)
    bb = tc.tchain12_family_decode(qw, mu, sg, family, lo, hi, cfg)
    back = tc.tchain12_family_encode(*bb, mu, sg, family, lo, hi, cfg)
    if mismatch(out, syms) or mismatch(back[0], qw):
        fail("family_times: round trip")
    nw, nr = int(w.numel()), int(bb[1].numel())

    i32 = {"dtype": torch.int32, "device": device}
    s_buf, h_buf = torch.empty(L, **i32), torch.empty(L, **i32)
    o_buf = torch.empty(n, **i32)
    w_buf, q_buf = torch.empty(n, **i32), torch.empty_like(qw)
    end = torch.empty(1, dtype=torch.int64, device=device)
    # kernel 12's scratch: a division record (8 bytes) a symbol, the dense
    # words, the ballots and the compaction's block offsets
    recs12 = torch.empty(n, dtype=torch.int64, device=device)
    words12, flags12, offsets12 = coder.compaction_scratch(T, L, device)
    ms = {}
    ms["family_encode"] = kernel_ms(
        lambda: s_buf.fill_(1 << 16), lambda: _build.call(
            "ctt_family_encode", device, s_buf, syms, n, mu, sg, recs12,
            w_buf, n, end, words12, flags12, offsets12, L, fi, lo, hi), 3)
    same = (torch.equal(s_buf, st)
            and torch.equal(w_buf[int(end.item()):], w))
    # its three steps apart: (a) tables, (b) pass A, (c) pass B
    enc12_passes = {
        "tables": kernel_ms(lambda: None, lambda: _build.call(
            "ctt_family_tables_pass", device, syms, mu, sg, recs12, n, fi,
            lo, hi), 3),
        "pass_a": kernel_ms(lambda: s_buf.fill_(1 << 16), lambda: _build.call(
            "ctt_family_encode_lanes", device, s_buf, recs12, n, words12,
            flags12, L), 3),
        "pass_b": kernel_ms(lambda: None, lambda: _build.call(
            "ctt_ilans2_compact", device, flags12, words12, flags12.numel(),
            w_buf, n, end, offsets12), 3),
    }
    same = (same and torch.equal(s_buf, st)
            and torch.equal(w_buf[int(end.item()):], w))
    del recs12, words12, flags12
    ms["family_decode"] = kernel_ms(
        lambda: s_buf.copy_(st), lambda: _build.call(
            "ctt_family_decode", device, s_buf, w, nw, mu, sg, o_buf, n, L,
            fi, lo, hi), 3)
    same = same and torch.equal(o_buf, syms) and torch.equal(s_buf, fin)
    # kernel 11's C entry for each family on the same symbols and
    # parameters, each on a stream of its own encode
    per_family, family_words = {}, {}
    for k, name in enumerate(fam.FAMILIES):
        st_k, w_k = ((st, w) if name == family else fam.encode_family(
            syms, mu, sg, name, lo, hi, cfg))
        family_words[name] = int(w_k.numel())
        per_family[name] = kernel_ms(
            lambda: s_buf.copy_(st_k), lambda: _build.call(
                "ctt_family_decode", device, s_buf, w_k, w_k.numel(), mu, sg,
                o_buf, n, L, k, lo, hi), 3)
        same = (same and torch.equal(o_buf, syms)
                and bool((s_buf == 1 << 16).all()))
    # kernel 21's scratch: records, dense words, ballots, block offsets
    recs, words = torch.empty(n, **i32), torch.empty(n, **i32)
    flags = torch.empty(n // 32, **i32)
    offsets = torch.empty(coder.SCAN_BLOCKS, dtype=torch.int64,
                          device=device)
    ms["tchain12_family_decode"] = kernel_ms(
        lambda: h_buf.fill_(16), lambda: _build.call(
            "ctt_tchain12_family_decode", device, h_buf, qw, mu, sg, o_buf,
            w_buf, n, end, recs, words, flags, offsets, L, T, fi, lo, hi), 3)
    same = (same and torch.equal(o_buf, bb[0]) and torch.equal(h_buf, bb[2])
            and torch.equal(w_buf[int(end.item()):], bb[1]))
    # its three steps apart: (a) inversion, (b) heads, pass B
    passes = {
        "invert": kernel_ms(lambda: None, lambda: _build.call(
            "ctt_tchain12_invert_pass", device, qw, mu, sg, o_buf, recs, L,
            T, fi, lo, hi), 3),
        "heads": kernel_ms(lambda: h_buf.fill_(16), lambda: _build.call(
            "ctt_tchain12_head_pass", device, h_buf, recs, words, flags, L,
            T), 3),
        "pass_b": kernel_ms(lambda: None, lambda: _build.call(
            "ctt_ilans2_compact", device, flags, words, flags.numel(), w_buf,
            n, end, offsets), 3),
    }
    same = (same and torch.equal(o_buf, bb[0]) and torch.equal(h_buf, bb[2])
            and torch.equal(w_buf[int(end.item()):], bb[1]))
    # and the whole decode at the TChain rows' 2^24 quantiles
    m24, s24, _, q24 = family_workload(N_TCHAIN)
    mu24, sg24 = convert.params_to_torch(m24, s24, N_TCHAIN, L, device)
    qw24 = convert.quantiles_to_torch(q24, L, device)
    del m24, s24, q24
    big = {k: torch.empty(N_TCHAIN, **i32) for k in ("o", "w", "r", "d")}
    flags24 = torch.empty(N_TCHAIN // 32, **i32)
    n24_ms = kernel_ms(lambda: h_buf.fill_(16), lambda: _build.call(
        "ctt_tchain12_family_decode", device, h_buf, qw24, mu24, sg24,
        big["o"], big["w"], N_TCHAIN, end, big["r"], big["d"], flags24,
        offsets, L, N_TCHAIN // L, fi, lo, hi), 3)
    ref24 = tc.tchain12_family_decode(qw24, mu24, sg24, family, lo, hi, cfg)
    same = (same and torch.equal(big["o"], ref24[0])
            and torch.equal(big["w"][int(end.item()):], ref24[1]))
    del big, flags24, mu24, sg24, qw24, ref24

    def reset_chain_encode():
        h_buf.copy_(bb[2])
        q_buf.fill_(-1)  # every word is written

    # kernel 22's scratch: a division record (8 bytes) and a u16 quantile
    # a symbol
    recs12 = torch.empty(n, dtype=torch.int64, device=device)
    q16 = torch.empty(n // 2, **i32)
    ms["tchain12_family_encode"] = kernel_ms(
        reset_chain_encode, lambda: _build.call(
            "ctt_tchain12_family_encode", device, h_buf, bb[0], mu, sg, bb[1],
            nr, recs12, q16, q_buf, L, T, fi, lo, hi), 3)
    same = same and torch.equal(q_buf, qw) and bool((h_buf == 16).all())
    # its steps apart: the tables pass; the cluster step and the packing
    enc_passes = {
        "tables": kernel_ms(lambda: None, lambda: _build.call(
            "ctt_tchain12_tables_pass", device, bb[0], mu, sg, recs12, L, T,
            fi, lo, hi), 3),
        "step": kernel_ms(reset_chain_encode, lambda: _build.call(
            "ctt_tchain12_encode_step", device, h_buf, recs12, bb[1], nr,
            q16, q_buf, L, T), 3),
    }
    same = same and torch.equal(q_buf, qw) and bool((h_buf == 16).all())
    if not same:
        fail("family_times: timed launches differ from the wrappers' output")

    plain, e = {}, {}
    plain["family_encode"], p = timed(lambda: fam.encode_family_plain(
        syms, mu, sg, family, lo, hi, cfg))
    e["family_encode"] = planes_err((st, w), p)
    plain["family_decode"], p = timed(lambda: fam.decode_family_plain(
        st, w, mu, sg, family, lo, hi, cfg, n, return_final_states=True))
    e["family_decode"] = planes_err((out, fin), p)
    plain["tchain12_family_decode"], p = timed(
        lambda: tc.tchain12_family_decode_plain(qw, mu, sg, family, lo, hi,
                                                cfg))
    e["tchain12_family_decode"] = planes_err(bb, p)
    plain["tchain12_family_encode"], p = timed(
        lambda: tc.tchain12_family_encode_plain(*bb, mu, sg, family, lo, hi,
                                                cfg))
    e["tchain12_family_encode"] = planes_err(back, p)

    # operations: left() evaluations these inputs need.  A decoded symbol
    # bisects in bit_length(max - min) steps; an encoded symbol evaluates
    # both ends of its interval unless one is pinned (min_sym, max_sym).
    per_left = LEFT_OPS[family]
    steps = fam.bisection_steps(lo, hi)
    decode_ops = n * (steps * (per_left + 6) + 8)
    ends = int(np.count_nonzero(symbols == lo)
               + np.count_nonzero(symbols == hi))
    bb_syms = bb[0].cpu().numpy()
    bb_ends = int(np.count_nonzero(bb_syms == lo)
                  + np.count_nonzero(bb_syms == hi))
    q_bytes = 3 * n // 2
    bounds = {
        # symbols and parameters in; states and stream out
        "family_encode": bound(4 * n + 8 * n + 4 * L + 4 * nw,
                               (2 * n - ends) * per_left + 12 * n),
        # states, stream and parameters in; symbols and states out
        "family_decode": bound(8 * L + 4 * nw + 8 * n + 4 * n, decode_ops),
        # quantiles and parameters in; symbols, remainders and heads out
        "tchain12_family_decode": bound(
            q_bytes + 8 * n + 4 * n + 4 * nr + 4 * L, decode_ops),
        # symbols, parameters, remainders, heads in; quantiles, heads out
        "tchain12_family_encode": bound(
            4 * n + 8 * n + 4 * nr + 8 * L + q_bytes,
            (2 * n - bb_ends) * per_left + 12 * n),
    }
    times = {}
    for name in ms:
        errs[name] = max(errs[name], e[name])
        times[name] = (ms[name], plain[name], *bounds[name])
    if any(e.values()):
        fail(f"family_times: kernel != twin at full size: {e}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_np, w_np = ctt.encode_family(symbols, means, scales, family, lo, hi,
                                   device=device)
    t1 = time.perf_counter()
    ctt.decode_family(s_np, w_np, means, scales, family, lo, hi, n,
                      device=device)
    t2 = time.perf_counter()
    got = ctt.bits_back_decode_family(quantiles, means, scales, family, lo,
                                      hi, device=device)
    t3 = time.perf_counter()
    ctt.bits_back_encode_family(*got, means, scales, family, lo, hi,
                                device=device)
    t4 = time.perf_counter()
    calls = {"encode_family": t1 - t0, "decode_family": t2 - t1,
             "bits_back_decode_family": t3 - t2,
             "bits_back_encode_family": t4 - t3}
    kernel_of = {"encode_family": "family_encode",
                 "decode_family": "family_decode",
                 "bits_back_decode_family": "tchain12_family_decode",
                 "bits_back_encode_family": "tchain12_family_encode"}
    row = {
        "family": family, "support": [lo, hi], "n": n, "num_lanes": L,
        "stream_words": nw, "remainder_words": nr,
        "left_evaluations_per_decoded_symbol": steps,
        "left_evaluations_encode": 2 * n - ends,
        **{f"{k}_ms": v for k, v in ms.items()},
        **{f"family_decode_{k}_ms": v for k, v in per_family.items()},
        **{f"family_decode_{k}_bound_ms": bound(
            8 * L + 4 * family_words[k] + 8 * n + 4 * n,
            n * (steps * (LEFT_OPS[k] + 6) + 8))[0] for k in per_family},
        **{f"family_encode_{k}_ms": v for k, v in enc12_passes.items()},
        # symbols and parameters in, records out
        "family_encode_tables_bound_ms": bound(
            4 * n + 8 * n + 8 * n, (2 * n - ends) * per_left)[0],
        **{f"tchain12_family_decode_{k}_ms": v for k, v in passes.items()},
        "tchain12_family_decode_invert_bound_ms": bound(
            q_bytes + 8 * n + 8 * n, decode_ops)[0],
        "tchain12_family_decode_n24_ms": n24_ms,
        **{f"tchain12_family_encode_{k}_ms": v
           for k, v in enc_passes.items()},
        # symbols and parameters in, records out
        "tchain12_family_encode_tables_bound_ms": bound(
            4 * n + 8 * n + 8 * n, (2 * n - bb_ends) * per_left)[0],
        **{f"{k}_ns_per_symbol": v * 1e6 / n for k, v in ms.items()},
        **{f"{k}_plain_ms": v for k, v in plain.items()},
        **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
        **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
        **{f"{k}_max_abs_err": v for k, v in e.items()},
        **{f"facade_{k}_call_s": v for k, v in calls.items()},
        **{f"facade_{k}_ns_per_symbol": v / n * 1e9
           for k, v in calls.items()},
        **{f"facade_{k}_host_share": 1 - ms[kernel_of[k]] * 1e-3 / v
           for k, v in calls.items()},
        "gpu": gpu,
    }
    return {"phase": "family_times", "cases": [row]}, times


def phase_checkpoints(device, symbols, containers: dict,
                      counters: dict) -> dict:
    """Random access on the rANS main path's containers: a decode from the
    middle checkpoint must equal the message's suffix and must have run
    the decode kernel.  ``build_checkpoints`` is timed as it runs (the
    host codec where it takes the config) and with the plain version in
    its place, whose snapshots must be the same."""
    import numpy as np

    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import interleaved2 as il2

    rows = []
    routed = il2.build_checkpoints
    for (P, compact), (cdf, data) in containers.items():
        for counts in counters.values():
            counts["decode"] = 0
        t0 = time.perf_counter()
        offsets, states = ctt.build_checkpoints(data, cdf, CKPT_INTERVAL)
        build_s = time.perf_counter() - t0
        il2.build_checkpoints = il2.build_checkpoints_plain
        try:
            t0 = time.perf_counter()
            plain = ctt.build_checkpoints(data, cdf, CKPT_INTERVAL)
            plain_s = time.perf_counter() - t0
        finally:
            il2.build_checkpoints = routed
        t1 = time.perf_counter()
        c = len(offsets) // 2
        start, suffix = ctt.decode_from_checkpoint(
            data, cdf, CKPT_INTERVAL, c, offsets, states, device=device)
        t2 = time.perf_counter()
        launches = sum(counts["decode"] for counts in counters.values())
        row = {"P": P, "container": "v2" if compact else "v1",
               "interval_steps": CKPT_INTERVAL, "checkpoints": len(offsets),
               "from_checkpoint": c, "start_symbol": int(start),
               "suffix_exact": bool(np.array_equal(suffix, symbols[start:])),
               "decode_launches": launches,
               "build_checkpoints_s": build_s,
               "build_checkpoints_plain_s": plain_s,
               "plain_identical": same_arrays((offsets, states), plain),
               "decode_from_checkpoint_s": t2 - t1}
        rows.append(row)
        if not (len(offsets) and row["suffix_exact"] and launches == 1
                and row["plain_identical"]):
            fail(f"checkpoints: {row}")
    return {"phase": "checkpoints", "n": len(symbols), "cases": rows}


# the block-sharded containers (parallel/): ILANS2 units of one message in
# equal blocks, each coded by the rANS or range kernels above
SHARDED_BLOCKS = 8
SHARDED_CONTAINERS = (("rans", False), ("rans", True), ("range", False))
SHARDED_KERNELS = {**KERNELS, **RANGE_KERNELS}
SHARDED_CKPT_INTERVAL = 2
# the dry run's legs on one card: the containers and block legs at their
# tiny shapes (kernels 2, 9 and 10 are not among them)
DRYRUN_KERNELS = {
    name: table[name]
    for table in (KERNELS, RANGE_KERNELS, FAMILY_KERNELS, TCHAIN_KERNELS,
                  EXACT32_KERNELS)
    for name in table
    if name in ("ilans2_decode_w32s64", "ilans2_encode_w16s32",
                "ilans2_decode_w16s32", "ilans2_range_decode_w32s64",
                "ilans2_range_decode_w16s32", "ilans2_range_record_w16s32",
                "range_resolve_lanes_w16s32", "family_decode",
                "exact_decode32", "tchain16_decode")
}


def sharded_name(P: int, coder: str, compact: bool) -> str:
    return f"P{P}_{coder}_{'v2' if compact else 'v1'}"


@contextlib.contextmanager
def program_watch():
    """Runs every launch half of the block program
    (``parallel.container.launch``) under
    ``torch.cuda.set_sync_debug_mode("error")``, where any host
    synchronisation raises and ends the run, and counts the program's transfers
    (``convert.upload`` and the gathers' ``convert.to_host``).  Yields
    ``{"windows": [blocks of each launch half], "uploads": n,
    "read_backs": n}``."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.parallel import container

    seen = {"windows": [], "uploads": 0, "read_backs": 0}
    launch, up, back = container.launch, convert.upload, convert.to_host

    def strict(step, programs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = launch(step, programs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seen["windows"].append(sum(len(blocks) for blocks in programs))
        return out

    def counted_upload(tensors, device):
        seen["uploads"] += 1
        return up(tensors, device)

    def counted_back(t):
        seen["read_backs"] += 1
        return back(t)

    container.launch = strict
    convert.upload, convert.to_host = counted_upload, counted_back
    try:
        yield seen
    finally:
        container.launch = launch
        convert.upload, convert.to_host = up, back


def transfers(seen: dict, fn):
    """``fn()`` and the uploads and read-backs it made under
    :func:`program_watch`."""
    seen.update(uploads=0, read_backs=0)
    out = fn()
    return out, {"uploads": seen["uploads"],
                 "read_backs": seen["read_backs"]}


def phase_sharded_bytes(device, probs, symbols) -> dict:
    """The sharded containers of the first N_KERNEL_CHECK symbols of the
    main workload, written on the card (B=8, the lane config
    ``parallel.encode`` picks), and on device lists that repeat the card 2
    and 8 times, against the port's numpy host coders run block by block
    and packed by the same framing (``parallel.encode_host``), byte for
    byte; they must decode to the symbols, and one within-block checkpoint
    seek per preset (v1 rANS containers) must give its slice of the
    message.  Every launch half under :func:`program_watch`."""
    import numpy as np

    from constriction_tpu_torch import parallel

    syms = symbols[:N_KERNEL_CHECK]
    rows = []
    with program_watch() as seen:
        for P in (24, 12):
            cdf = model_cdf(probs, P)
            for coder_name, compact in SHARDED_CONTAINERS:
                def encode(devices):
                    return parallel.encode(
                        syms, cdf, num_blocks=SHARDED_BLOCKS, device=devices,
                        coder=coder_name, compact=compact)

                windows = len(seen["windows"])
                cont, enc = transfers(seen, lambda: encode(device))
                out, dec = transfers(
                    seen, lambda: parallel.decode(cont, cdf, device=device))
                ref = parallel.encode_host(syms, cdf, None, SHARDED_BLOCKS,
                                           coder_name, compact)
                row = {"container": sharded_name(P, coder_name, compact),
                       "words": int(len(cont)),
                       "identical_to_host_oracle": bool(
                           np.array_equal(cont, ref)),
                       "decodes_exactly": bool(np.array_equal(out, syms)),
                       "transfers": {"encode": enc, "decode": dec}}
                for k in (2, 8):
                    row[f"card_x{k}_identical"] = bool(
                        np.array_equal(encode([device] * k), ref)
                        and np.array_equal(parallel.decode(
                            ref, cdf, device=[device] * k), syms))
                row["launch_windows"] = len(seen["windows"]) - windows
                rows.append(row)
                if not (row["identical_to_host_oracle"]
                        and row["decodes_exactly"]
                        and row["card_x2_identical"]
                        and row["card_x8_identical"]):
                    fail(f"sharded bytes: {row}")
                if coder_name == "rans" and not compact:
                    offsets, states = parallel.build_block_checkpoints(
                        cont, cdf, SHARDED_CKPT_INTERVAL)
                    block_len = parallel.unpack_sharded(cont)[3]
                    block, c = SHARDED_BLOCKS - 1, offsets.shape[1] // 2
                    start, suffix = parallel.decode_block_from_checkpoint(
                        cont, cdf, SHARDED_CKPT_INTERVAL, block, c, offsets,
                        states, device=device)
                    row["seek"] = {"block": block, "checkpoint": c,
                                   "start_symbol": int(start),
                                   "suffix_exact": bool(np.array_equal(
                                       suffix, syms[start:(block + 1)
                                                    * block_len]))}
                    if not row["seek"]["suffix_exact"]:
                        fail(f"sharded seek: {row}")
    return {"phase": "sharded_bytes", "n": len(syms),
            "blocks": SHARDED_BLOCKS, "cases": rows}


def phase_sharded_main(device, probs, symbols, singles: dict,
                       keep: dict) -> dict:
    """``parallel.encode`` -> ``decode`` of the whole main workload (B=8)
    at both presets for the three containers: exact round trips, the
    facade's call times (host clock), each call's launches, each block's L
    and T, and the size against the single v2 container of the same
    message (``singles[(P, True)]``, from the main path).  ``keep[name]``
    gets (coder, compact, cdf, container) for the kernel times."""
    import numpy as np

    from constriction_tpu_torch import parallel
    from constriction_tpu_torch.ops import coder, coder64, range_enc

    counters = {"coder": coder.LAUNCHES, "coder64": coder64.LAUNCHES,
                "range_enc": range_enc.LAUNCHES}
    rows = []
    for P in (24, 12):
        cdf = model_cdf(probs, P)
        for coder_name, compact in SHARDED_CONTAINERS:
            name = sharded_name(P, coder_name, compact)
            before = {m: dict(c) for m, c in counters.items()}
            with program_watch() as seen:
                t0 = time.perf_counter()
                cont, enc = transfers(seen, lambda: parallel.encode(
                    symbols, cdf, num_blocks=SHARDED_BLOCKS, device=device,
                    coder=coder_name, compact=compact))
                t1 = time.perf_counter()
                mid = {m: dict(c) for m, c in counters.items()}
                out, dec = transfers(
                    seen, lambda: parallel.decode(cont, cdf, device=device))
                t2 = time.perf_counter()
            fields = (parallel.unpack_sharded_v2(cont) if compact
                      else parallel.unpack_sharded(cont))
            block_len, cfg = fields[3], fields[4]
            row = {
                "container": name, "words": int(len(cont)),
                "single_v2_words": int(len(singles[(P, True)][1])),
                "num_lanes": cfg.num_lanes,
                "steps_per_block": -(-block_len // cfg.num_lanes),
                "block_len": int(block_len),
                "k_tail": int(fields[5]) if compact else 0,
                "decodes_exactly": bool(np.array_equal(out, symbols)),
                "encode_call_s": t1 - t0, "decode_call_s": t2 - t1,
                "transfers": {"encode": enc, "decode": dec},
                "launch_windows": seen["windows"],
                "encode_launches": {
                    f"{m}.{k}": c[k] - before[m][k]
                    for m, c in mid.items() for k in c
                    if c[k] != before[m][k]},
                "decode_launches": {
                    f"{m}.{k}": c[k] - mid[m][k]
                    for m, c in counters.items() for k in c
                    if c[k] != mid[m][k]},
            }
            rows.append(row)
            keep[name] = (coder_name, compact, cdf, cont)
            if not row["decodes_exactly"]:
                fail(f"sharded main path: {row}")
    return {"phase": "sharded_main_path", "n": len(symbols),
            "blocks": SHARDED_BLOCKS, "cases": rows}


def program_ms(devices, program, reps: int = 3) -> tuple[float, float]:
    """Milliseconds per call of a block program ``(programs, step,
    finish)`` on the host clock after a warm-up, each run started after
    every card's ``synchronize()``: (launch and gather, the launch half and
    a ``synchronize()``)."""
    import torch

    from constriction_tpu_torch.parallel import container

    programs, step, finish = program
    cards = sorted({torch.device(d) for d in devices}, key=str)

    def sync():
        for card in cards:
            torch.cuda.synchronize(card)

    container.gather(finish, container.launch(step, programs))
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        container.gather(finish, container.launch(step, programs))
    t1 = time.perf_counter()
    sync()
    t2 = time.perf_counter()
    for _ in range(reps):
        container.launch(step, programs)
        sync()
    t3 = time.perf_counter()
    return (t1 - t0) * 1e3 / reps, (t3 - t2) * 1e3 / reps


def program_times(devices, padded, seeds, states, streams, cdf_np, cfg,
                  block_len: int, coder_id: int) -> dict:
    """:func:`program_ms` of a container's encode and decode programs on
    ``devices``."""
    from constriction_tpu_torch.parallel import container

    B = len(streams)
    enc = program_ms(devices, container.encode_program(
        padded, cdf_np, cfg, B, block_len, coder_id, seeds, devices))
    dec = program_ms(devices, container.decode_program(
        states, streams, cdf_np, cfg, block_len, coder_id, devices))
    return {"program_encode_ms": enc[0], "program_launch_encode_ms": enc[1],
            "program_decode_ms": dec[0], "program_launch_decode_ms": dec[1]}


def phase_sharded_times(device, keep: dict, gpu: str) -> dict:
    """The B blocks' wrapper calls of each container back to back between
    CUDA events, beside one call of the same wrapper on the same symbols
    as one container at the same L (T = B times the block's steps).  The
    rANS decode reads nothing back; the encodes (their end pointer, and a
    seeded one its seeds' check) and the range decode (its invalid-data
    flag) read back once a call, so the blocks' time holds B such waits
    and the host work each exposes.  Beside them the block program of the
    same blocks (:func:`program_times`), which waits for nothing between
    launches; with more than one card, also over every card."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert, parallel
    from constriction_tpu_torch.ops import coder, coder64, range_enc

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    rows = []
    for name, (coder_name, compact, cdf_np, cont) in keep.items():
        fields = (parallel.unpack_sharded_v2(cont) if compact
                  else parallel.unpack_sharded(cont))
        states, streams, _, block_len, cfg = fields[:5]
        wide = cfg.state_bits == 64
        cdf = convert.cdf_to_torch(cdf_np, device)
        st = [convert.states_to_torch(s, cfg, device) for s in states]
        sw = [convert.u32_to_torch(w, device) for w in streams]
        ranged = coder_name == "range"
        if ranged:
            dec = coder64.decode_shared_range64 if wide else \
                coder.decode_shared_range
            enc = range_enc.encode_iid_range64 if wide else \
                range_enc.encode_iid_range
            syms = [dec(p, w, cdf, cfg, block_len) for p, w in zip(st, sw)]
            seeds = [None] * len(st)
        else:
            dec = coder64.decode_shared64 if wide else coder.decode_shared
            enc = coder64.encode_iid64 if wide else coder.encode_iid
            decoded = [dec(s, w, cdf, cfg, block_len,
                           return_final_states=True)
                       for s, w in zip(st, sw)]
            syms = [d[0] for d in decoded]
            # a v2 block's final states are its encoder's seeds
            seeds = [d[1] if compact else None for d in decoded]

        def encode(s, sd):
            return enc(s, cdf, cfg) if ranged else enc(s, cdf, cfg, seeds=sd)

        again = [encode(s, sd) for s, sd in zip(syms, seeds)]
        if any(not torch.equal(a[0], s) or not torch.equal(a[1], w)
               for a, s, w in zip(again, st, sw)):
            fail(f"sharded times: {name}: the blocks' encode != container")
        whole = torch.cat(syms)
        one_st, one_sw = encode(whole, seeds[0])
        if mismatch(dec(one_st, one_sw, cdf, cfg, whole.numel()), whole):
            fail(f"sharded times: {name}: one call's round trip")
        row = {
            "container": name, "blocks": len(streams),
            "num_lanes": cfg.num_lanes,
            "steps_per_block": -(-block_len // cfg.num_lanes),
            "blocks_encode_ms": time_ms(
                lambda: [encode(s, sd) for s, sd in zip(syms, seeds)], 3),
            "blocks_decode_ms": time_ms(
                lambda: [dec(s, w, cdf, cfg, block_len)
                         for s, w in zip(st, sw)], 3),
            "one_call_encode_ms": time_ms(lambda: encode(whole, seeds[0]),
                                          3),
            "one_call_decode_ms": time_ms(
                lambda: dec(one_st, one_sw, cdf, cfg, whole.numel()), 3),
        }
        program = (
            whole.cpu().numpy(),
            np.stack([convert.states_from_torch(sd, cfg) for sd in seeds])
            if compact else None,
            states, streams, cdf_np, cfg, block_len,
            parallel.CODER_RANGE if ranged else parallel.CODER_RANS)
        row.update(program_times([device], *program))
        if len(cards) > 1:
            row["all_cards"] = {"cards": len(cards),
                                **program_times(cards, *program)}
        row["gpu"] = gpu
        rows.append(row)
    return {"phase": "sharded_times", "cases": rows,
            "multi_card": (f"{len(cards)} cards: all_cards" if len(cards) > 1
                           else "not measured: torch sees one card")}


def phase_sharded_dryrun(device) -> dict:
    """``parallel.dryrun([card])`` under :func:`program_watch`: its three
    containers (an encode and a decode each) and eight block legs, one
    launch window each, none with a host synchronisation."""
    from constriction_tpu_torch.parallel import dryrun

    with program_watch() as seen:
        legs = dryrun([device])
    if len(seen["windows"]) != 3 * 2 + 8:
        fail(f"sharded dryrun: {len(seen['windows'])} launch windows")
    return {"phase": "sharded_dryrun", "legs": legs,
            "launch_windows": len(seen["windows"]),
            "uploads": seen["uploads"], "read_backs": seen["read_backs"]}


def cat_presets() -> dict:
    """P -> (label, cfg, decode, encode, decode_plain, encode_plain,
    host decode, host encode, seed head) of the categorical TChain pair."""
    from constriction_tpu_torch.ops import tchain as tc

    return {
        16: ("tchain16", tc.TCHAIN_CFG, tc.tchain16_decode,
             tc.tchain16_encode, tc.tchain16_decode_plain,
             tc.tchain16_encode_plain, tc.tchain_decode_host,
             tc.tchain_encode_host, 1),
        24: ("tchain24", tc.TCHAIN24_CFG, tc.tchain24_decode,
             tc.tchain24_encode, tc.tchain24_decode_plain,
             tc.tchain24_encode_plain, tc.tchain24_decode_host,
             tc.tchain24_encode_host, 256),
    }


def tchain_name(label: str, kind: str) -> str:
    """The name of a categorical TChain kernel in TCHAIN_KERNELS: the
    encodes (kernels 20 and 24) run on the cluster step."""
    return f"cluster_{label}_{kind}" if kind == "encode" else f"{label}_{kind}"


def cat_workload(n: int) -> dict:
    """The JAX suite's TChain rows at n quantiles: a K=100 Dirichlet(2)
    model at P=16 and P=24 and uniform quantiles, from RandomState(1234).
    Returns {P: (cdf, quantiles)}."""
    import numpy as np

    rng = np.random.RandomState(1234)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    work = {}
    for P, dtype in ((16, np.uint16), (24, np.uint32)):
        work[P] = (model_cdf(probs, P),
                   rng.randint(0, 1 << P, size=n).astype(dtype))
    return work


def cat_to_torch(P: int, values, L: int, device):
    """TChain quantiles or heads (numpy) -> the port's tensors."""
    import numpy as np

    from constriction_tpu_torch import convert

    if values.dtype == np.uint64:
        return convert.u64_to_torch(values, device)
    if P == 16 and values.dtype == np.uint16:
        return convert.quantiles16_to_torch(values, L, device)
    return convert.u32_to_torch(values, device)


def tchain_passes_err(P: int, qt, cdf, cfg, dec) -> int:
    """A categorical decode's two steps (kernel 19 at P=16, kernel 23 at
    P=24) launched alone, each against its plain version on the same
    tensors, and composed against the decode ``dec``: the largest
    mismatch."""
    from constriction_tpu_torch.ops import coder
    from constriction_tpu_torch.ops import tchain as tc

    head_pass, plain = {
        16: (tc.tchain16_head_pass, tc.tchain16_head_pass_plain),
        24: (tc.tchain24_head_pass, tc.tchain24_head_pass_plain)}[P]
    syms, words, ballots, heads = head_pass(qt, cdf, cfg)
    syms_p, words_p, flags_p, heads_p = plain(qt, cdf, cfg)
    stream = coder.compact_pass(words, ballots)
    return max(mismatch(syms, syms_p),
               mismatch(ballots, coder.flag_ballots(flags_p)),
               mismatch(words[flags_p], words_p[flags_p]),
               mismatch(heads, heads_p),
               mismatch(stream, coder.compact_pass_plain(words_p, flags_p)),
               planes_err((syms, stream, heads), dec))


def phase_tchain_kernels(device, n: int) -> tuple[dict, dict]:
    """Each categorical TChain kernel against its twin and the numpy host
    oracle (L=32768, n quantiles): symbols, remainders, heads and the
    re-encoded quantiles identical, every head back at its seed; kernel
    19's and kernel 23's two steps each against its plain version."""
    import torch

    from constriction_tpu_torch import convert

    work = cat_workload(n)
    errs: dict[str, int] = {}
    rows = []
    for P, (label, cfg, dec, enc, dec_p, enc_p, dec_h, enc_h,
            seed) in cat_presets().items():
        L = cfg.num_lanes
        cdf_np, q = work[P]
        cdf = convert.cdf_to_torch(cdf_np, device)
        qt = cat_to_torch(P, q, L, device)
        got = dec(qt, cdf, cfg)
        host = dec_h(q, cdf_np, cfg)
        e_dec = max(planes_err(got, dec_p(qt, cdf, cfg)),
                    mismatch(got[0].cpu(), torch.from_numpy(host[0])),
                    mismatch(got[1], convert.u32_to_torch(host[1], device)),
                    mismatch(got[2], cat_to_torch(P, host[2], L, device)))
        e_dec = max(e_dec, tchain_passes_err(P, qt, cdf, cfg, got))
        back = enc(*got, cdf, cfg)
        q_h, h_h = enc_h(*host, cdf_np, cfg)
        e_enc = max(planes_err(back, enc_p(*got, cdf, cfg)),
                    mismatch(back[0], cat_to_torch(P, q_h, L, device)),
                    mismatch(back[1], cat_to_torch(P, h_h, L, device)))
        round_trip = (mismatch(back[0], qt) == 0
                      and bool((back[1] == seed).all()))
        errs[tchain_name(label, "decode")] = e_dec
        errs[tchain_name(label, "encode")] = e_enc
        row = {"coder": label, "K": len(cdf_np) - 1, "n": n, "num_lanes": L,
               "remainder_words": int(got[1].numel()),
               "decode_max_abs_err": e_dec, "encode_max_abs_err": e_enc,
               "round_trip": round_trip}
        rows.append(row)
        if e_dec or e_enc or not round_trip:
            fail(f"tchain kernel != twin or host oracle, or no round trip: "
                 f"{row}")
    return {"phase": "tchain_kernels", "cases": rows}, errs


def phase_tchain_main(device, work) -> dict:
    """The bits-back facade at the JAX suite's TChain shape: decode then
    encode at P=16 and P=24, byte for byte the host oracle's decode, and
    the quantiles back with every head at its seed."""
    import numpy as np

    from constriction_tpu_torch import cuda as ctt

    facade = {16: (ctt.bits_back_decode, ctt.bits_back_encode),
              24: (ctt.bits_back_decode24, ctt.bits_back_encode24)}
    rows = []
    for P, (label, cfg, *_, dec_h, _enc_h, seed) in cat_presets().items():
        cdf, q = work[P]
        decode, encode = facade[P]
        t0 = time.perf_counter()
        syms, rem, heads = decode(q, cdf, device=device)
        t1 = time.perf_counter()
        q_back, h_back = encode(syms, rem, heads, cdf, device=device)
        t2 = time.perf_counter()
        ref = dec_h(q, cdf, cfg)
        t3 = time.perf_counter()
        row = {
            "coder": label, "K": len(cdf) - 1, "n": len(q),
            "num_lanes": cfg.num_lanes, "remainder_words": int(len(rem)),
            "decode_identical_to_host_oracle": all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip((syms, rem, heads), ref)),
            "round_trip": bool(q_back.dtype == q.dtype
                               and np.array_equal(q_back, q)
                               and (h_back == seed).all()),
            "max_abs_err": 0,
            "decode_call_s": t1 - t0, "encode_call_s": t2 - t1,
            "host_oracle_decode_s": t3 - t2,
        }
        rows.append(row)
        if not (row["decode_identical_to_host_oracle"] and row["round_trip"]):
            fail(f"tchain main path: {row}")
    return {"phase": "tchain_main_path", "cases": rows}


def phase_tchain_times(device, work, gpu: str,
                       errs: dict) -> tuple[dict, dict]:
    """Kernel-only time of each categorical TChain kernel at the main
    path's shape (the C entry points on preallocated buffers), its twin's
    time and outputs on the same tensors, the facade's call times, and each
    kernel's bound.  Returns the phase record and {kernel: (ms, plain_ms,
    bound_ms, bound_by)}."""
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import _build, coder

    facade = {16: (ctt.bits_back_decode, ctt.bits_back_encode),
              24: (ctt.bits_back_decode24, ctt.bits_back_encode24)}
    rows, times = [], {}
    for P, (label, cfg, dec, enc, dec_p, enc_p, _dh, _eh,
            seed) in cat_presets().items():
        cdf_np, q = work[P]
        L, n = cfg.num_lanes, len(q)
        T, K = n // L, len(cdf_np) - 1
        cdf = convert.cdf_to_torch(cdf_np, device)
        cdf32 = cdf.to(torch.int32)
        qt = cat_to_torch(P, q, L, device)
        got = dec(qt, cdf, cfg)
        back = enc(*got, cdf, cfg)
        if mismatch(back[0], qt):
            fail(f"tchain_times: {label} round trip")
        nr = int(got[1].numel())
        h_buf = torch.empty_like(got[2])
        s_buf = torch.empty(n, dtype=torch.int32, device=device)
        w_buf = torch.empty(n, dtype=torch.int32, device=device)
        q_buf = torch.empty_like(qt)
        end = torch.empty(1, dtype=torch.int64, device=device)
        # the decode's scratch (kernels 19 and 23): dense words, ballots,
        # offsets
        words, flags, offsets = coder.compaction_scratch(T, L, device)
        ms = {}
        ms["decode"] = kernel_ms(
            lambda: h_buf.fill_(seed), lambda: _build.call(
                f"ctt_{label}_decode", device, h_buf, qt, cdf32, K, s_buf,
                w_buf, n, end, words, flags, offsets, L, T), 5)
        same = (torch.equal(s_buf, got[0]) and torch.equal(h_buf, got[2])
                and torch.equal(w_buf[int(end.item()):], got[1]))
        # its two steps apart: the head pass, pass B
        passes = {
            "heads": kernel_ms(lambda: h_buf.fill_(seed), lambda: _build.call(
                f"ctt_{label}_head_pass", device, h_buf, qt, cdf32, K, s_buf,
                words, flags, L, T), 5),
            "pass_b": kernel_ms(lambda: None, lambda: _build.call(
                "ctt_ilans2_compact", device, flags, words, flags.numel(),
                w_buf, n, end, offsets), 5),
        }
        same = (same and torch.equal(s_buf, got[0])
                and torch.equal(h_buf, got[2])
                and torch.equal(w_buf[int(end.item()):], got[1]))
        # kernels 20 and 24 take a scratch for their K division records
        records = coder._records(cdf32, cfg)
        ms["encode"] = kernel_ms(
            lambda: h_buf.copy_(got[2]), lambda: _build.call(
                f"ctt_{label}_encode", device, h_buf, got[0], cdf32, K,
                got[1], nr, q_buf, records, L, T), 5)
        same = same and torch.equal(q_buf, qt) and bool((h_buf == seed).all())
        if not same:
            fail(f"tchain_times: {label} timed launches differ from the "
                 f"wrappers' output")
        plain, e = {}, {}
        plain["decode"], p = timed(lambda: dec_p(qt, cdf, cfg))
        e["decode"] = planes_err(got, p)
        plain["encode"], p = timed(lambda: enc_p(*got, cdf, cfg))
        e["encode"] = planes_err(back, p)
        # bytes: each input read once, each output written once (quantiles
        # 2 bytes at P=16, 4 at P=24; heads 4 or 8 bytes a lane)
        qb, hb = (2, 4) if P == 16 else (4, 8)
        cdf_b = 4 * (K + 1)
        bounds = {
            # quantiles and CDF in; symbols, remainders and heads out
            "decode": bound(qb * n + cdf_b + 4 * n + 4 * nr + hb * L,
                            (search_ops(K) + 8) * n),
            # symbols, CDF, remainders and heads in; quantiles, heads out
            "encode": bound(4 * n + cdf_b + 4 * nr + hb * L + qb * n + hb * L,
                            10 * n),
        }
        for kind in ms:
            name = tchain_name(label, kind)
            errs[name] = max(errs[name], e[kind])
            times[name] = (ms[kind], plain[kind], *bounds[kind])
        if any(e.values()):
            fail(f"tchain_times: {label} kernel != twin at full size: {e}")
        decode, encode = facade[P]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(q, cdf_np, device=device)
        t1 = time.perf_counter()
        encode(*out, cdf_np, device=device)
        t2 = time.perf_counter()
        calls = {"decode": t1 - t0, "encode": t2 - t1}
        rows.append({
            "coder": label, "K": K, "n": n, "num_lanes": L,
            "remainder_words": nr,
            **{f"{k}_ms": v for k, v in ms.items()},
            **{f"decode_{k}_ms": v for k, v in passes.items()},
            **{f"{k}_ns_per_symbol": v * 1e6 / n for k, v in ms.items()},
            **{f"{k}_plain_ms": v for k, v in plain.items()},
            **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
            **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
            **{f"{k}_max_abs_err": v for k, v in e.items()},
            **{f"facade_{k}_call_s": v for k, v in calls.items()},
            **{f"facade_{k}_ns_per_symbol": v / n * 1e9
               for k, v in calls.items()},
            **{f"facade_{k}_host_share": 1 - ms[k] * 1e-3 / v
               for k, v in calls.items()},
            "gpu": gpu,
        })
    return {"phase": "tchain_times", "cases": rows}, times


def phase_tchain_sweep(device, gpu: str) -> dict:
    """The cluster encodes (kernel 24, TChain-24; kernel 20, TChain-16;
    kernel 22's cluster step, TChain-12) per coding step at SWEEP_STEPS
    steps over SWEEP_LANES lanes (kernel 20 from 256, kernel 22 from 1024,
    their lane multiples), as phase_sweep times the rANS pairs:
    kernel-only (CUDA events around the C entry, the heads reset outside
    them), its quantiles equal to the decoded ones, the floor at the fewest
    lanes and the slope from 4096 lanes up (microseconds per step per 1024
    lanes)."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build, coder
    from constriction_tpu_torch.ops import tchain as tc
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    rng = np.random.RandomState(24)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    top = max(SWEEP_LANES) * SWEEP_STEPS
    q24 = rng.randint(0, 1 << 24, size=top).astype(np.uint32)
    q16 = rng.randint(0, 1 << 16, size=top).astype(np.uint16)
    # kernel, name, W, S, P, quantiles, decode, geometry, seed head, lanes
    presets = (
        (24, "cluster_tchain24_encode", 32, 64, 24, q24, tc.tchain24_decode,
         tc.geometry24, 256, SWEEP_LANES),
        (20, "cluster_tchain16_encode", 16, 32, 16, q16, tc.tchain16_decode,
         tc.geometry16, 1, (256,) + SWEEP_LANES[1:]),
    )
    rows, fits = [], {}
    for kernel, name, W, S, P, q_np, decode, geometry, seed, lanes in presets:
        cdf = convert.cdf_to_torch(model_cdf(probs, P), device)
        cdf32 = cdf.to(torch.int32)
        us = []
        for L in lanes:
            cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S,
                             precision=P)
            q = cat_to_torch(P, q_np[:L * SWEEP_STEPS], L, device)
            syms, rem, heads = decode(q, cdf, cfg)
            records = coder._records(cdf32, cfg)
            h_buf = torch.empty_like(heads)
            q_buf = torch.empty_like(q)
            ms = kernel_ms(lambda: h_buf.copy_(heads), lambda: _build.call(
                f"ctt_tchain{P}_encode", device, h_buf, syms, cdf32, K_MAIN,
                rem, rem.numel(), q_buf, records, L, SWEEP_STEPS), 3)
            if mismatch(q_buf, q) != 0 or not bool((h_buf == seed).all()):
                fail(f"tchain_sweep: kernel {kernel} L={L} round trip")
            us.append(ms * 1e3 / SWEEP_STEPS)
            rows.append({"kernel": kernel, "num_lanes": L,
                         "steps": SWEEP_STEPS, "encode_ms": ms,
                         "encode_us_per_step": us[-1],
                         **geometry(L, K_MAIN, device)})
        fits[name] = sweep_fit(lanes, us)
    # kernel 22's cluster step and packing pass on its tables pass's
    # records (the family row's gaussian models; L a multiple of 1024)
    lanes = SWEEP_LANES[1:]
    means, scales, _, quantiles = family_workload(max(lanes) * SWEEP_STEPS)
    lo, hi = FAMILY_SUPPORT
    us = []
    for L in lanes:
        cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                         precision=12)
        n = L * SWEEP_STEPS
        mu, sg = convert.params_to_torch(means[:n], scales[:n], n, L, device)
        qw = convert.quantiles_to_torch(quantiles[:n], L, device)
        syms, rem, heads = tc.tchain12_family_decode(qw, mu, sg, MAIN_FAMILY,
                                                     lo, hi, cfg)
        recs = tc.tchain12_tables_pass(syms, mu, sg, MAIN_FAMILY, lo, hi,
                                       cfg)
        h_buf = torch.empty_like(heads)
        q_buf = torch.empty_like(qw)
        q16 = torch.empty(n // 2, dtype=torch.int32, device=device)

        def reset():
            h_buf.copy_(heads)
            q_buf.fill_(-1)

        ms = kernel_ms(reset, lambda: _build.call(
            "ctt_tchain12_encode_step", device, h_buf, recs, rem,
            rem.numel(), q16, q_buf, L, SWEEP_STEPS), 3)
        if mismatch(q_buf, qw) != 0 or not bool((h_buf == 16).all()):
            fail(f"tchain_sweep: kernel 22 L={L} round trip")
        us.append(ms * 1e3 / SWEEP_STEPS)
        rows.append({"kernel": 22, "num_lanes": L, "steps": SWEEP_STEPS,
                     "encode_step_ms": ms, "encode_us_per_step": us[-1],
                     **tc.geometry12(L, device)})
    fits["tchain12_family_encode_step"] = sweep_fit(lanes, us)
    return {"phase": "tchain_sweep", "cases": rows, "fits": fits, "gpu": gpu}


def sweep_fit(lanes, us) -> dict:
    """The per-step floor at the fewest lanes and the slope from 4096 lanes
    up (microseconds per step per 1024 lanes)."""
    i = lanes.index(4096)
    return {"us_per_step_floor": us[0], "floor_lanes": lanes[0],
            "us_per_1024_lanes_per_step": (us[-1] - us[i]) * 1024
            / (lanes[-1] - lanes[i])}


def phase_chain_decode(device, gpu: str) -> dict:
    """The chain coder's parallel decode on the card against the port's
    numpy path: 2^24 i.i.d. symbols (K=100, P=24) and 2^20 symbols with a
    K=16 model each, from random chain data."""
    import numpy as np

    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import chain as ch

    rng = np.random.RandomState(1234)
    cdf = model_cdf(rng.dirichlet(np.full(K_MAIN, 2.0)), 24)
    # the per-row form of fast_quantized_cdf: every symbol weight >= 1
    p = rng.dirichlet(np.ones(16), size=N_CHAIN_ROWS)
    cum = np.concatenate([np.zeros((N_CHAIN_ROWS, 1)),
                          np.cumsum(p, 1)[:, :-1]], 1)
    rows = np.empty((N_CHAIN_ROWS, 17), np.uint32)
    rows[:, :16] = np.floor(cum * ((1 << 24) - 16)) + np.arange(16)
    rows[:, 16] = 1 << 24
    def data(n):
        words = rng.randint(0, 1 << 32, size=n - n // 4 + 8,
                            dtype=np.uint64).astype(np.uint32)
        words[-1] |= 0x8000_0000  # a head the from_compressed framing takes
        return words

    iid, per_row = data(N_TCHAIN), data(N_CHAIN_ROWS)
    ctt.decode_chain_iid(iid[:64], 16, cdf, device=device)  # warm-up
    ctt.decode_chain_rows(per_row[:64], rows[:16], device=device)
    t0 = time.perf_counter()
    got_iid = ctt.decode_chain_iid(iid, N_TCHAIN, cdf, device=device)
    t1 = time.perf_counter()
    ref_iid = ch.chain_decode_iid(iid, N_TCHAIN, cdf, np)
    t2 = time.perf_counter()
    got_rows = ctt.decode_chain_rows(per_row, rows, device=device)
    t3 = time.perf_counter()
    ref_rows = ch.chain_decode_rows(per_row, rows, np)
    t4 = time.perf_counter()
    out = []
    for name, n, K, got, ref, call_s, numpy_s in (
            ("iid", N_TCHAIN, K_MAIN, got_iid, ref_iid, t1 - t0, t2 - t1),
            ("rows", N_CHAIN_ROWS, 16, got_rows, ref_rows, t3 - t2,
             t4 - t3)):
        row = {"model": name, "n": n, "K": K,
               "identical_to_numpy_path": bool(
                   got.dtype == ref.dtype and np.array_equal(got, ref)),
               "call_s": call_s, "numpy_s": numpy_s,
               "call_ns_per_symbol": call_s / n * 1e9, "gpu": gpu}
        out.append(row)
        if not row["identical_to_numpy_path"]:
            fail(f"chain_decode: {row}")
    return {"phase": "chain_decode", "cases": out, "max_abs_err": 0}


# ---------------------------------------------------------------------------
# reference-exact families (W=32, S=64, P=24)
# ---------------------------------------------------------------------------


def exact_workload(n: int, scale_sd: float = 0.4, scale_mu: float = 0.7):
    """The JAX suite's exact-family row with its synthetic latents
    (benchmarks/suite.py:894-907): means tile 512 * 512 latents randn *
    0.15 * 50, scales exp(N(0.7, 0.4)), symbols clip(round(mean + scale *
    randn), -100, 100), from RandomState(1234)."""
    import numpy as np

    rng = np.random.RandomState(1234)
    lat = rng.randn(512 * 512) * 0.15
    means = np.tile(lat * 50.0, -(-n // len(lat)))[:n]
    scales = np.exp(rng.normal(scale_mu, scale_sd, size=n))
    lo, hi = EXACT_SUPPORT
    symbols = np.clip(np.round(means + scales * rng.randn(n)), lo, hi
                      ).astype(np.int64)
    return means, scales, symbols


def _exact_oracle_tv(args):
    """Host oracle (a worker process): exact trunc values of one chunk of
    windows, int32 [n * W]; the out-of-support sentinel past max_sym."""
    import numpy as np

    from constriction_tpu_torch.ops.exact_tables import exact_tv_at

    family, means, scales, ws, W = args
    lo, hi = EXACT_SUPPORT
    svals = (ws[:, None] + np.arange(W)[None, :]).reshape(-1)
    sym_i = np.repeat(np.arange(len(means)), W)
    live = svals <= hi
    out = np.full(len(svals), (1 << EXACT_P) - 1 - (hi - lo), np.int32)
    out[live] = exact_tv_at(family, lo, hi, EXACT_P, means, scales,
                            sym_i[live], svals[live])
    return out


def _exact_oracle_tables(args):
    """Host builder (a worker process): ``exact_family.
    packed_tables_device`` at cmax = the batch's largest core when ``cmax``
    is None."""
    from constriction_tpu_torch.ops import exact_family as ef

    family, means, scales, cmax, nsteps, R = args
    lo, hi = EXACT_SUPPORT
    if cmax is None:
        cmax = max(int(ef.exact_ncore(means, scales, family, lo, hi,
                                      EXACT_P).max()), 1)
    return ef.packed_tables_device(means, scales, family, lo, hi, EXACT_P,
                                   cmax, nsteps, R)


def _exact_oracle_decode(args):
    """Host decode oracle (a worker process):
    ``exact_family.decode_family_exact_host``."""
    from constriction_tpu_torch.ops import exact_family as ef

    states, stream, means, scales, family, cfg, n = args
    lo, hi = EXACT_SUPPORT
    return ef.decode_family_exact_host(states, stream, means, scales, family,
                                       lo, hi, cfg, n)


def host_pool():
    """Worker processes for the numpy host oracles (spawned: they never
    touch the card); the caller's ``with`` block stops them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                               mp_context=multiprocessing.get_context("spawn"))


def builder_windows(family, means, scales, W_core: int):
    """The builder's window starts (``packed_tables_on_device_batch``) and
    a window width: W_core for gaussian and laplace, the whole support
    plus 16 for cauchy."""
    import numpy as np

    from constriction_tpu_torch.ops import exact_family as ef

    lo, hi = EXACT_SUPPORT
    CL = ef._EST_C[family][0]
    if np.isinf(CL):
        return np.full(len(means), lo + 1, np.int64), hi - lo + 1 + 16
    ws = np.clip(np.ceil(means - CL * scales) - 3.0, lo + 1, hi)
    return ws.astype(np.int64), W_core


def window_shares(means, scales, ws, family, W: int) -> dict:
    """Kernel 18's entries by kind on these windows: the live ones (before
    each row's live end, ``exact_tables.live_ends_plain``: a CDF each),
    the certainly saturated ones (in the support, past the live end) and
    the ones out of the support (both (free, 0) with no CDF)."""
    from constriction_tpu_torch.ops import exact_tables as et

    lo, hi = EXACT_SUPPORT
    entries = means.numel() * W
    live = int(et.live_ends_plain(means, scales, ws, family, hi, W).sum())
    support = int((hi - ws.long() + 1).clamp(0, W).sum())
    return {"live_share": live / entries,
            "saturated_share": (support - live) / entries,
            "out_of_support_share": 1 - support / entries}


def phase_exact_builder(device, pool, errs: dict) -> dict:
    """Both canaries on the card; kernel 18 against its twin on the card,
    every entry and every flag, and every entry it calls unambiguous
    against the host oracle (2^20 symbols of each continuous family), with
    the shares of live, saturated and out-of-support entries; device-built
    tables against the host builder, bit for bit (2^18 symbols each)."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import exact_tables as et
    from constriction_tpu_torch.utils import special

    lo, hi = EXACT_SUPPORT
    t0 = time.perf_counter()
    et.eval_window_canary(device)
    et.builder_canary(device)
    canary_s = time.perf_counter() - t0
    means, scales, _ = exact_workload(N_EXACT_EVAL)
    L = 32768
    nt = N_EXACT_TABLES
    tables = {fam: pool.submit(_exact_oracle_tables, (
        fam, means[:nt], scales[:nt], None, nt // L, L // 128))
        for fam in ef.DEVICE_FAMILIES}
    rows = []
    err = 0
    for family in ef.DEVICE_FAMILIES:
        ws, W = builder_windows(family, means, scales, 64)
        m_t, s_t = convert.params64_to_torch(means, scales, device)
        ws_t = torch.from_numpy(ws.astype(np.int32)).to(device)
        tv, amb = et.eval_window(m_t, s_t, ws_t, family, lo, hi, EXACT_P, W)
        tv_p, amb_p = et.eval_window_plain(m_t, s_t, ws_t, family, lo, hi,
                                           EXACT_P, W)
        twin_err = mismatch(tv, tv_p)
        flags_differ = int((amb != amb_p).sum())
        del tv_p, amb_p
        shares = window_shares(m_t, s_t, ws_t, family, W)
        tv_h = tv.cpu().numpy().reshape(-1)
        amb_h = amb.cpu().numpy().reshape(-1)
        del tv, amb
        chunk = 1 << 16
        exact = np.concatenate(list(pool.map(_exact_oracle_tv, [
            (family, means[i:i + chunk], scales[i:i + chunk],
             ws[i:i + chunk], W) for i in range(0, len(means), chunk)])))
        wrong = int(np.count_nonzero(~amb_h & (tv_h != exact)))
        share = float(amb_h.mean())
        err = max(err, twin_err, wrong)
        rows.append({
            "family": family, "symbols": len(means), "W": W,
            "entries": int(tv_h.size), **shares, "ambiguous_share": share,
            "accepted_entries_wrong": wrong, "twin_max_abs_err": twin_err,
            "flags_differ_from_twin": flags_differ,
            "identical_to_twin": twin_err == 0 and flags_differ == 0,
        })
        if wrong or twin_err or flags_differ or share >= 0.2:
            fail(f"exact_builder: window evaluator: {rows[-1]}")
    for family in ef.DEVICE_FAMILIES:
        host4, ch = tables[family].result()
        nc = int(host4[:, 0].max() >> 24)
        (dev_t, cd), = et.packed_tables_on_device_batch(
            [(means[:nt], scales[:nt], max(nc, 1), nt // L)], family, lo, hi,
            EXACT_P, L, device)
        same = cd == ch and np.array_equal(
            convert.exact_tables_from_torch(dev_t), host4)
        rows.append({"family": family, "symbols": nt, "cmax": ch,
                     "device_tables_identical_to_host_builder": same})
        if not same:
            fail(f"exact_builder: device tables differ from the host "
                 f"builder's ({family})")
    errs["exact_eval_window"] = err
    return {"phase": "exact_builder", "canaries_passed": True,
            "canary_s": canary_s, "cases": rows,
            "special_picked": special.PICKED}


def phase_exact_kernels(device, pool, errs: dict) -> dict:
    """Kernels 15, 16 and 17 against their twins on the same CUDA tensors
    and against the numpy oracles at L=32768 and about 2^20 symbols:
    ungrouped (kernel 15, host-built tables, cmax from the batch's largest
    core) and grouped (kernel 16, three or more segments, tables built on
    the card), kernel 17 with and without seeds.  Scales exp(N(0, 0.3))
    keep the host builder's windows near 60 wide (it evaluates n * (cmax +
    8) CDFs in numpy)."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    lo, hi = EXACT_SUPPORT
    family, n, L = EXACT_FAMILY, N_EXACT_CHECK, 32768
    means, scales, syms = exact_workload(n, scale_sd=0.3, scale_mu=0.0)
    cfg = LaneConfig(num_lanes=L, word_bits=32, state_bits=64,
                     precision=EXACT_P)
    T = -(-n // L)
    pm, ps = ef._pad_params(means, scales, T * L, family, hi)
    host_tabs = pool.submit(_exact_oracle_tables,
                            (family, pm, ps, None, T, L // 128))
    cums, probs = ef.exact_ecp(syms, means, scales, family, lo, hi, EXACT_P)
    c_t, p_t = convert.ecp_to_torch(cums, probs, L, device)
    rng = np.random.RandomState(5)
    e_enc = 0
    rows = []
    for seeded in (False, True):
        seeds = (rng.randint(1 << 32, (1 << 63) - 1, L, dtype=np.int64)
                 .astype(np.uint64) if seeded else None)
        s_t = None if seeds is None else convert.u64_to_torch(seeds, device)
        st, w = ef.encode_tables(c_t, p_t, cfg, s_t, n)
        st_p, w_p = ef.encode_tables_plain(c_t, p_t, cfg, s_t, n)
        st_h, w_h = il2.encode_shared_plain(cums, probs, cfg, seeds=seeds)
        e = max(mismatch(st, st_p), mismatch(w, w_p))
        same_h = (np.array_equal(convert.u64_from_torch(st), st_h)
                  and np.array_equal(convert.u32_from_torch(w), w_h))
        e_enc = max(e_enc, e, 0 if same_h else 1)
        rows.append({"kernel": "exact_encode64", "seeded": seeded, "n": n,
                     "max_abs_err_vs_twin": e,
                     "identical_to_host_oracle": same_h})
        if not seeded:
            states, stream = st, w
    host_dec = pool.submit(_exact_oracle_decode, (
        convert.u64_from_torch(states), convert.u32_from_torch(stream), means,
        scales, family, cfg, n))
    # ungrouped: kernel 15 over the host builder's tables
    tabs4, cmax_u = host_tabs.result()
    tabs = convert.exact_tables_to_torch(tabs4, device)
    out, fin = ef.decode_tables(states, stream, tabs, cfg, lo, hi, n,
                                return_final_states=True)
    out_p, fin_p, _ = ef.decode_tables_plain(states, stream, tabs, cfg, lo,
                                             hi, n)
    e15 = max(mismatch(out, out_p), mismatch(fin, fin_p))
    ok15 = (np.array_equal(out.cpu().numpy(), syms)
            and bool((fin == 1 << 32).all()))
    # grouped: kernel 17 in core-size order, kernel 16 per segment
    perm, segs = ef.group_plan(means, scales, family, lo, hi, EXACT_P, L, n)
    if len(segs) < 3:
        fail(f"exact_kernels: the grouped plan has {len(segs)} segments")
    gst, gw = ef.encode_family_exact_grouped(syms, means, scales, family, lo,
                                             hi, cfg, device)
    host_gdec = pool.submit(_exact_oracle_decode, (
        convert.u64_from_torch(gst), convert.u32_from_torch(gw), means[perm],
        scales[perm], family, cfg, n))
    gpm, gps = ef._pad_params(means[perm], scales[perm], T * L, family, hi)
    built = ef._segment_tables(gpm, gps, segs, family, lo, hi, cfg, device,
                               device_tables=True)
    base = torch.zeros(1, dtype=torch.int64, device=device)
    st_k = st_q = gst
    base_q = base
    outs = []
    e16 = 0
    for (t0, ns, _), (tb, _) in zip(segs, built):
        k = min(ns * L, n - t0 * L)
        o, st_k, base = ef.decode_tables_seg(st_k, gw, tb, base, cfg, lo, hi,
                                             k)
        o_q, st_q, base_q = ef.decode_tables_plain(st_q, gw, tb, cfg, lo, hi,
                                                   k, base_q)
        e16 = max(e16, mismatch(o, o_q), mismatch(st_k, st_q),
                  mismatch(base, base_q))
        outs.append(o.cpu().numpy())
    ok16 = (np.array_equal(np.concatenate(outs), syms[perm])
            and int(base) == gw.numel() and bool((st_k == 1 << 32).all()))
    ok15 = ok15 and np.array_equal(host_dec.result(), syms)
    ok16 = ok16 and np.array_equal(host_gdec.result(), syms[perm])
    rows.append({"kernel": "exact_decode64", "n": n, "cmax": cmax_u,
                 "max_abs_err_vs_twin": e15,
                 "decodes_like_host_oracle": ok15})
    rows.append({"kernel": "exact_decode64_seg", "n": n,
                 "segments": [list(s) for s in segs],
                 "max_abs_err_vs_twin": e16,
                 "decodes_like_host_oracle": ok16})
    errs["exact_encode64"] = e_enc
    errs["exact_decode64"] = e15
    errs["exact_decode64_seg"] = e16
    if e_enc or e15 or e16 or not (ok15 and ok16):
        fail(f"exact_kernels: {rows}")
    return {"phase": "exact_kernels", "num_lanes": L, "cases": rows}


def info_bits(symbols, means, scales) -> float:
    """Information content of the message under the true sampling
    probabilities of clip(round(N(mean, scale^2))), as the JAX suite
    computes it (benchmarks/suite.py:78-89, :910-911)."""
    import numpy as np
    from scipy.special import ndtr

    lo, hi = EXACT_SUPPORT
    x = np.asarray(symbols, np.float64)
    upper = np.where(x >= hi, 1.0, ndtr((x + 0.5 - means) / scales))
    lower = np.where(x <= lo, 0.0, ndtr((x - 0.5 - means) / scales))
    return float(-np.sum(np.log2(np.maximum(upper - lower, 1e-300))))


def phase_exact_main(device, work, keep: dict) -> dict:
    """The JAX suite's exact-family row (2^22 symbols, gaussian, support
    [-100, 100], P=24, L=32768) through the four facade entry points
    (grouped pair and v2 container), the facade's ungrouped pair with the
    same DEFAULT-preset config (its decode builds the tables on the card by
    default), and on the first N_EXACT_HOST_TABLES symbols the ungrouped
    pair with ``exact_family.decode_family_exact(..., device_tables=False)``
    (tables from the host builder): states, streams and container byte for
    byte the port's numpy host oracles', every decode equal to the
    symbols."""
    import numpy as np

    from constriction_tpu_torch import convert
    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import exact_tables as et
    from constriction_tpu_torch.ops import framing
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.utils import special

    means, scales, syms = work
    lo, hi = EXACT_SUPPORT
    family, n = EXACT_FAMILY, len(syms)
    cfg = ctt._pick_cfg_family(n, None, True)
    et.HOST_ROWS["count"] = et.HOST_SEGMENTS["count"] = 0
    clock = time.perf_counter
    t = [clock()]
    st, w = ctt.encode_family_exact(syms, means, scales, family, lo, hi,
                                    grouped=True, device=device)
    t.append(clock())
    out = ctt.decode_family_exact(st, w, means, scales, family, lo, hi, n,
                                  grouped=True, device=device)
    t.append(clock())
    data = ctt.encode_family_exact_container(syms, means, scales, family, lo,
                                             hi, device=device)
    t.append(clock())
    out_c = ctt.decode_family_exact_container(data, means, scales, family,
                                              lo, hi, device=device)
    t.append(clock())
    st_u, w_u = ctt.encode_family_exact(syms, means, scales, family, lo, hi,
                                        cfg=cfg, device=device)
    t.append(clock())
    # the bound the ungrouped decode's on-card builder starts from
    cmax_u = min(255, -(-int(ef._ncore_estimate(
        means, scales, family, lo, hi).max()) // 4) * 4)
    out_u = ctt.decode_family_exact(st_u, w_u, means, scales, family, lo, hi,
                                    n, cfg=cfg, device=device)
    t.append(clock())
    # the host builder's route (cmax=None) on the message's first
    # N_EXACT_HOST_TABLES symbols
    nf = N_EXACT_HOST_TABLES
    st_f, w_f = ctt.encode_family_exact(syms[:nf], means[:nf], scales[:nf],
                                        family, lo, hi, cfg=cfg,
                                        device=device)
    t_f = clock()
    out_f = ef.decode_family_exact(
        convert.u64_to_torch(st_f, device), convert.u32_to_torch(w_f, device),
        means[:nf], scales[:nf], family, lo, hi, cfg, nf,
        device_tables=False).cpu().numpy()
    t_f = clock() - t_f
    t.append(clock())
    # host oracles: the plain (numpy) versions of the host codec's paths
    perm, segs = ef.group_plan(means, scales, family, lo, hi, EXACT_P,
                               cfg.num_lanes, n)
    cums, probs = ef.exact_ecp_plain(syms[perm], means[perm], scales[perm],
                                     family, lo, hi, EXACT_P)
    st_h, w_h = il2.encode_shared_plain(cums, probs, cfg)

    def encode_a(n_A, seeds):
        return il2.encode_shared_plain(cums[:n_A], probs[:n_A], cfg,
                                       seeds=seeds)

    data_h = framing.frame_planes_v2(cums, probs, cfg, None, encode_a)
    cu, pu = ef.exact_ecp_plain(syms, means, scales, family, lo, hi, EXACT_P)
    st_uh, w_uh = il2.encode_shared_plain(cu, pu, cfg)
    st_fh, w_fh = il2.encode_shared_plain(cu[:nf], pu[:nf], cfg)
    t.append(clock())
    info = info_bits(syms, means, scales)
    p = framing.parse_v2(data)
    calls = dict(zip(("encode_grouped", "decode_grouped",
                      "encode_container", "decode_container",
                      "encode_ungrouped", "decode_ungrouped",
                      "ungrouped_host_tables_pair", "host_oracles"),
                     np.diff(t)))
    row = {
        "family": family, "support": [lo, hi], "n": n,
        "num_lanes": cfg.num_lanes, "precision": cfg.precision,
        "segments": [list(s) for s in segs],
        "weighted_cmax": sum(ns * cm for _, ns, cm in segs) / (-(-n // cfg.num_lanes)),
        "ungrouped_cmax_bound": cmax_u,
        "stream_words": int(len(w)), "container_words": int(len(data)),
        "region_B_symbols": p.k_B,
        "grouped_identical_to_host_oracle": bool(
            np.array_equal(st, st_h) and np.array_equal(w, w_h)),
        "container_identical_to_host_oracle": bool(
            np.array_equal(data, data_h)),
        "ungrouped_identical_to_host_oracle": bool(
            np.array_equal(st_u, st_uh) and np.array_equal(w_u, w_uh)
            and np.array_equal(st_f, st_fh) and np.array_equal(w_f, w_fh)),
        "decodes_exactly": bool(np.array_equal(out, syms)
                                and np.array_equal(out_c, syms)
                                and np.array_equal(out_u, syms)
                                and np.array_equal(out_f, syms[:nf])),
        "host_tables_n": nf,
        "decode_ungrouped_host_tables_call_s": t_f,
        "max_abs_err": 0,
        "entropy_bits_per_symbol": info / n,
        "container_overhead_pct": (len(data) * 32 / info - 1) * 100,
        "raw_grouped_overhead_pct": (
            (cfg.num_lanes * 64 + len(w) * 32) / info - 1) * 100,
        "host_rows": et.HOST_ROWS["count"],
        "host_segments": et.HOST_SEGMENTS["count"],
        "special_picked": special.PICKED, "erf": special.ERF,
        **{f"{k}_call_s": v for k, v in calls.items()},
    }
    keep.update(calls=calls, segs=segs, perm=perm, cums=cums, probs=probs,
                cmax_u=cmax_u)
    if not (row["grouped_identical_to_host_oracle"]
            and row["container_identical_to_host_oracle"]
            and row["ungrouped_identical_to_host_oracle"]
            and row["decodes_exactly"]):
        fail(f"exact main path: {row}")
    return {"phase": "exact_main_path", "cases": [row]}


def search_sweep(device, states, stream, spans, built, cfg) -> list:
    """Kernels 16 and 15 per table width: each segment ``(first symbol,
    count)`` alone from the states and stream offset it starts from, its
    fields found by the linear scan and by binary search, timed in turns
    (scan, bisect, bisect, scan), kernel 16 (the cluster decode's Seg
    instance, from the segment's base) and kernel 15 (the cluster decode,
    on the stream from the segment's first word); all four must decode
    alike.  Both sets of columns set ``exact_family.BISECT_FROM_PLANES``."""
    import torch

    from constriction_tpu_torch.ops import _build

    lo, hi = EXACT_SUPPORT
    L = cfg.num_lanes
    x = states
    b = torch.zeros(1, dtype=torch.int64, device=device)
    rows = []
    for (r0, k), (tb, _) in zip(spans, built):
        x0, b0 = x.clone(), b.clone()
        s_buf, b_buf = x0.clone(), b0.clone()
        sub = stream[int(b0):]
        outs = {}
        res = {}
        for kernel in ("seg", "cluster"):
            for mode in (0, 1, 1, 0):
                o_buf = torch.empty(k, dtype=torch.int32, device=device)

                def reset():
                    s_buf.copy_(x0)
                    b_buf.copy_(b0)

                if kernel == "seg":
                    def launch():
                        _build.call(
                            "ctt_exact_decode64_seg", device, s_buf, stream,
                            stream.numel(), tb, tb.shape[1], o_buf, k, L,
                            cfg.precision, lo, hi, mode, b_buf)
                else:
                    def launch():
                        _build.call(
                            "ctt_exact_decode64", device, s_buf, sub,
                            sub.numel(), tb, tb.shape[1], o_buf, k, L,
                            cfg.precision, lo, hi, mode, None)
                res.setdefault((kernel, mode), []).append(
                    kernel_ms(reset, launch, 3))
                outs[kernel, mode] = (o_buf, s_buf.clone())
            if kernel == "seg":
                nxt = b_buf.clone()
        first = outs["seg", 0]
        if not all(torch.equal(a, c) for out in outs.values()
                   for a, c in zip(out, first)):
            fail(f"search_sweep: the searches or kernels differ at "
                 f"{tb.shape[1]} planes")
        x, b = first[1], nxt
        rows.append({"planes": int(tb.shape[1]), "symbols": k,
                     **{f"{'' if kern == 'seg' else 'cluster_'}"
                        f"{'bisect' if mode else 'scan'}_ms": sum(v) / 2
                        for (kern, mode), v in res.items()}})
    return rows


def chain_gap(launches, reset, reps: int) -> dict:
    """A chain of launches (one call's, issued back to back on one stream)
    against its launches one at a time: each alone between CUDA events
    after a synchronisation, summed over the chain (``launches_alone_ms``),
    and the host time of issuing the whole chain without synchronising
    (``enqueue_ms``); means over ``reps`` runs, ``reset()`` first."""
    import torch

    alone = enqueue = 0.0
    for _ in range(reps):
        reset()
        for launch in launches:
            torch.cuda.synchronize()
            ms, _ = timed(launch)
            alone += ms
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for launch in launches:
            launch()
        enqueue += (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    return {"launches_alone_ms": alone / reps, "enqueue_ms": enqueue / reps}


def crossover(rows: list, scan: str, bisect: str):
    """The fewest planes from which the binary search was faster than the
    scan at every width of ``rows`` (the search sweep's), or None."""
    widths = sorted({r["planes"] for r in rows})
    faster = {p: all(r[bisect] < r[scan] for r in rows if r["planes"] == p)
              for p in widths}
    best = None
    for p in reversed(widths):
        if not faster[p]:
            break
        best = p
    return best


def search_path_words(tabs, cums, k: int,
                      narrow: bool = False) -> tuple[int, int]:
    """What kernels 15 and 16 (or with ``narrow``, kernel 13) need to read
    of the tables ``tabs`` int32 [T, CP1, L] to decode the first ``k``
    symbols (symbol i in column i % L of step i // L) whose ``cums``
    (numpy, decode order) are known: per symbol the aux word and the
    distinct words of the packed fields that the binary search over the
    ascending fields probes (``field(mid)``, then ``field(cnt - 1)`` and
    ``field(cnt)``, as exact_family.cu's ``TableModel`` and
    ``NarrowTableModel`` do; in wide tables fields 1 and 2 of a group
    straddle two words, in narrow tables a word holds two fields).
    ``cnt``, the number of fields below the quantile, is the same for
    every quantile of a symbol's interval, so the symbol's cum stands for
    it.  Counted for every width, also where the wrapper scans: the least
    the decode needs.  Returns ``(words, probes)`` summed over symbols."""
    import numpy as np
    import torch

    T, CP1, L = tabs.shape
    N = 2 * (CP1 - 1) if narrow else 4 * ((CP1 - 1) // 3)
    q_all = torch.from_numpy(np.asarray(cums[:k], np.int64)).to(tabs.device)
    words = probes = 0
    per = max(1, (1 << 18) // L)  # steps a chunk
    for t0 in range(0, -(-k // L), per):
        t1 = min(t0 + per, -(-k // L))
        col = tabs[t0:t1].permute(0, 2, 1).reshape(-1, CP1)[:k - t0 * L]
        col = col.to(torch.int64) & 0xFFFFFFFF
        m = col.shape[0]
        if narrow:
            w = col[:, 1:]
            fields = torch.stack([w & 0xFFFF, w >> 16], -1).reshape(m, N)
        else:
            w = col[:, 1:].reshape(m, -1, 3)
            w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
            fields = torch.stack([
                w0 & 0xFFFFFF, (w0 >> 24) | ((w1 & 0xFFFF) << 8),
                (w1 >> 16) | ((w2 & 0xFF) << 16), w2 >> 8], -1).reshape(m, N)
        cnt = (fields < q_all[t0 * L:t0 * L + m, None]).sum(1)
        del fields, w, col
        touched = torch.zeros((m, CP1), dtype=torch.bool, device=tabs.device)
        touched[:, 0] = True  # the aux word

        def mark(kf, live):
            if narrow:
                first = second = 1 + (kf >> 1)
            else:
                base = 1 + 3 * (kf >> 2)
                r = kf & 3
                first = base + (r - 1).clamp(min=0)
                second = torch.where((r == 1) | (r == 2), base + r, first)
            for idx in (first, second):
                touched.scatter_(1, torch.where(live, idx, 0)[:, None], True)
            return int(live.sum())

        lo = torch.zeros(m, dtype=torch.int64, device=tabs.device)
        hi = torch.full_like(lo, N)
        while True:
            live = lo < hi
            if not bool(live.any()):
                break
            mid = (lo + hi) >> 1
            probes += mark(mid, live)
            below = mid < cnt
            lo = torch.where(live & below, mid + 1, lo)
            hi = torch.where(live & ~below, mid, hi)
        probes += mark((cnt - 1).clamp(min=0), cnt > 0)
        probes += mark(cnt.clamp(max=N - 1), cnt < N)
        words += int(touched.sum())
    return words, probes


# integer operations per symbol of the S=64 encoder (u64 division and
# remainder, renorm test, emission) and of the table decoder outside its
# search (regions, u64 update, refill), and per packed field it probes
ENCODE64_OPS = 30
DECODE64_OPS = 40
PROBE_OPS = 6
# float64 flops of kernel 18's gaussian entries (exact_family.cu,
# exact_eval_window_kernel<0>), read from cuobjdump -sass of its build on
# an H100 (sm_90a): a DFMA counts 2, a DADD, DMUL or DSETP 1, MUFU and the
# division's rare slow path nothing.  Every entry in the support needs its
# argument t (two DADD, the division's seven DFMA and one DMUL) and the
# saturation compare (a DADD and two DSETP): EVAL_T_FLOPS.  A live entry
# also runs the CDF and the rounding rules, the rest of the live loop's
# straight-line body (44 DFMA, 10 DADD, 4 DMUL, 7 DSETP in all; CUDA's erf
# takes no branch there): EVAL_CDF_FLOPS.  exact_times reports the static
# counts of the whole kernel beside them (sass_f64).
EVAL_T_FLOPS = 20
EVAL_CDF_FLOPS = 89
F64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores


def sass_f64(pattern: str) -> dict | None:
    """Static counts of the float64 instructions (DFMA, DADD, DMUL, DSETP,
    MUFU) in the SASS of the built kernels whose mangled name matches
    ``pattern`` (cuobjdump -sass of the library), or None without
    cuobjdump."""
    import re
    import shutil

    from constriction_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", _build._library_path()],
                          capture_output=True, text=True).stdout
    out = {}
    for block in re.split(r"\n\s+Function : ", sass)[1:]:
        name = block.split(None, 1)[0]
        if not re.search(pattern, name):
            continue
        counts = {}
        for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                             r"(DFMA|DADD|DMUL|DSETP|MUFU)", block):
            counts[op] = counts.get(op, 0) + 1
        out[name] = counts
    return out


def phase_exact_times(device, work, keep: dict, gpu: str,
                      errs: dict) -> tuple[dict, dict]:
    """Kernel-only time of each of the four at the main path's shapes
    (CUDA events around the C entry points on preallocated buffers, after
    a warm-up), its twin's time on the card (outputs equal), the device
    table build broken into evaluation, host patch and derive + pack, and
    each kernel's bound.  Returns the phase record and {kernel: (ms,
    plain_ms, bound_ms, bound_by)}."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build, coder
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import exact_tables as et
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    means, scales, syms = work
    lo, hi = EXACT_SUPPORT
    family, n = EXACT_FAMILY, len(syms)
    segs, perm = keep["segs"], keep["perm"]
    L = 32768
    T = -(-n // L)
    cfg = LaneConfig(num_lanes=L, word_bits=32, state_bits=64,
                     precision=EXACT_P)
    c_t, p_t = convert.ecp_to_torch(keep["cums"], keep["probs"], L, device)
    st, w = ef.encode_tables(c_t, p_t, cfg, None, n)
    nw = int(w.numel())
    # the device table build of the grouped decode, by phase
    pm, ps = ef._pad_params(means[perm], scales[perm], T * L, family, hi)
    seg_args = [(pm[t0 * L:(t0 + ns) * L], ps[t0 * L:(t0 + ns) * L], cm, ns)
                for t0, ns, cm in segs]
    build = {}
    t0 = time.perf_counter()
    built = et.packed_tables_on_device_batch(seg_args, family, lo, hi,
                                             EXACT_P, L, device,
                                             timings=build)
    build_s = time.perf_counter() - t0
    # kernel 18 alone over the segments' windows
    wins = []
    for m, s, cm, ns in seg_args:
        ws, _ = builder_windows(family, m, s, 0)
        W = min(cm + 16, hi - lo + 1 + 16)
        m_t, s_t = convert.params64_to_torch(m, s, device)
        wins.append((m_t, s_t, torch.from_numpy(ws.astype(np.int32)).to(
            device), W, torch.empty((len(m), W), dtype=torch.int32,
                                    device=device),
            torch.empty((len(m), W), dtype=torch.bool, device=device)))
    t_star, eps, has_star = et._band(family)
    fi = ef.DEVICE_FAMILIES.index(family)

    def eval_all():
        for m_t, s_t, ws_t, W, tv, amb in wins:
            _build.call("ctt_exact_eval_window", device, m_t, s_t, ws_t,
                        m_t.numel(), W, fi, lo, hi, EXACT_P, t_star, eps,
                        int(has_star), tv, amb)

    ms, plain, e = {}, {}, {}
    ms["exact_eval_window"] = kernel_ms(lambda: None, eval_all, 3)
    plain["exact_eval_window"], twins = timed(lambda: [
        et.eval_window_plain(m_t, s_t, ws_t, family, lo, hi, EXACT_P, W)
        for m_t, s_t, ws_t, W, _, _ in wins])
    # every entry and every flag
    e["exact_eval_window"] = max(
        max(mismatch(tv, tv_p), int((amb != amb_p).sum()))
        for (_, _, _, _, tv, amb), (tv_p, amb_p) in zip(wins, twins))
    del twins
    entries = sum(m_t.numel() * W for m_t, _, _, W, _, _ in wins)
    eval_shares: dict = {}
    for m_t, s_t, ws_t, W, _, _ in wins:
        for k, v in window_shares(m_t, s_t, ws_t, family, W).items():
            eval_shares[k] = eval_shares.get(k, 0.0) + v * m_t.numel() * W
    eval_shares = {k: v / entries for k, v in eval_shares.items()}
    # kernel 17 alone: both passes on preallocated scratch, then each
    s_buf = torch.empty(L, dtype=torch.int64, device=device)
    w_buf = torch.empty(n, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int64, device=device)
    scratch = coder.compaction_scratch(T, L, device)
    ms["exact_encode64"] = kernel_ms(
        lambda: s_buf.fill_(1 << 32), lambda: _build.call(
            "ctt_exact_encode64", device, s_buf, c_t, p_t, n, w_buf, n, end,
            *scratch, L, EXACT_P), 3)
    same = torch.equal(s_buf, st) and torch.equal(w_buf[int(end):], w)
    enc_passes = {"exact_encode64_pass_a_ms": kernel_ms(
        lambda: s_buf.fill_(1 << 32), lambda: _build.call(
            "ctt_exact_encode_lanes64", device, s_buf, c_t, p_t, n,
            scratch[0], scratch[1], L, EXACT_P), 3)}
    enc_passes["exact_encode64_pass_b_ms"] = kernel_ms(
        lambda: None, lambda: _build.call(
            "ctt_ilans2_compact", device, scratch[1], scratch[0],
            scratch[1].numel(), w_buf, n, end, scratch[2]), 3)
    same = (same and torch.equal(s_buf, st)
            and torch.equal(w_buf[int(end):], w))
    enc_passes["exact_encode64_scratch_bytes"] = 4 * (scratch[0].numel()
                                                      + scratch[1].numel())
    plain["exact_encode64"], pe = timed(
        lambda: ef.encode_tables_plain(c_t, p_t, cfg, None, n))
    e["exact_encode64"] = planes_err((st, w), pe)
    # kernel 16 alone: the segment chain
    o_buf = torch.empty(n, dtype=torch.int32, device=device)
    b_buf = torch.empty(1, dtype=torch.int64, device=device)
    spans = [(t0 * L, min(ns * L, n - t0 * L)) for t0, ns, _ in segs]

    seg_launches = [
        lambda r0=r0, k=k, tb=tb: _build.call(
            "ctt_exact_decode64_seg", device, s_buf, w, nw, tb, tb.shape[1],
            o_buf[r0:], k, L, EXACT_P, lo, hi,
            int(ef.bisect_tables(tb.shape[1])), b_buf)
        for (r0, k), (tb, _) in zip(spans, built)]

    def seg_chain():
        for launch in seg_launches:
            launch()

    def reset():
        s_buf.copy_(st)
        b_buf.zero_()

    ms["exact_decode64_seg"] = kernel_ms(reset, seg_chain, 3)
    same = (same and torch.equal(o_buf.cpu(), torch.from_numpy(
        syms[perm].astype(np.int32))) and int(b_buf) == nw)
    seg_gap = chain_gap(seg_launches, reset, 3)

    def seg_twin():
        x, b = st, torch.zeros(1, dtype=torch.int64, device=device)
        outs = []
        for (r0, k), (tb, _) in zip(spans, built):
            o, x, b = ef.decode_tables_plain(x, w, tb, cfg, lo, hi, k, b)
            outs.append(o)
        return torch.cat(outs), x

    plain["exact_decode64_seg"], pd = timed(seg_twin)
    e["exact_decode64_seg"] = planes_err((o_buf, s_buf), pd)
    search = search_sweep(device, st, w, spans, built, cfg)
    # kernel 15 alone: the ungrouped message, tables built on the card
    cu, pr = ef.exact_ecp(syms, means, scales, family, lo, hi, EXACT_P)
    cu_t, pu_t = convert.ecp_to_torch(cu, pr, L, device)
    su, wu = ef.encode_tables(cu_t, pu_t, cfg, None, n)
    del cu_t, pu_t
    pmu, psu = ef._pad_params(means, scales, T * L, family, hi)
    (tab_u, cmax_u), = et.packed_tables_on_device_batch(
        [(pmu, psu, keep["cmax_u"], T)], family, lo, hi, EXACT_P, L, device)
    nwu = int(wu.numel())
    ms["exact_decode64"] = kernel_ms(
        lambda: s_buf.copy_(su), lambda: _build.call(
            "ctt_exact_decode64", device, s_buf, wu, nwu, tab_u,
            tab_u.shape[1], o_buf, n, L, EXACT_P, lo, hi,
            int(ef.bisect_tables(tab_u.shape[1])), None), 3)
    same = (same and torch.equal(o_buf.cpu(), torch.from_numpy(
        syms.astype(np.int32))) and bool((s_buf == 1 << 32).all()))
    plain["exact_decode64"], pu = timed(lambda: ef.decode_tables_plain(
        su, wu, tab_u, cfg, lo, hi, n)[:2])
    e["exact_decode64"] = planes_err((o_buf, s_buf), pu)
    search += search_sweep(device, su, wu, [(0, n)], [(tab_u, cmax_u)], cfg)
    if not same:
        fail("exact_times: timed launches differ from the wrappers' output")
    if any(e.values()):
        fail(f"exact_times: kernel != twin at full size: {e}")

    # bounds: the table words on the binary search's path (aux word plus
    # the probed fields), stream, symbol and state bytes (decoders), planes,
    # stream and states (encoder), tv + flags against f64 operations
    # (evaluator)
    cums = keep["cums"]
    seg_path = [search_path_words(tb, cums[r0:r0 + k], k)
                for (r0, k), (tb, _) in zip(spans, built)]
    seg_words = sum(wd for wd, _ in seg_path)
    seg_probes = sum(pr for _, pr in seg_path)
    u_words, u_probes = search_path_words(tab_u, cu, n)
    bounds = {
        "exact_encode64": bound(8 * n + 16 * L + 4 * nw, ENCODE64_OPS * n),
        "exact_decode64_seg": bound(
            4 * seg_words + 4 * nw + 4 * n + 16 * L,
            PROBE_OPS * seg_probes + DECODE64_OPS * n),
        "exact_decode64": bound(
            4 * u_words + 4 * nwu + 4 * n + 16 * L,
            PROBE_OPS * u_probes + DECODE64_OPS * n),
    }
    # kernel 18: 5 bytes written an entry, 20 read a symbol; the argument
    # and compare of every entry in the support, the CDF of the live ones
    t_bytes = (entries * 5 + 20 * sum(m_t.numel() for m_t, *_ in wins)) \
        / HBM_BYTES_PER_S * 1e3
    support = 1 - eval_shares["out_of_support_share"]
    eval_flops = entries * (EVAL_T_FLOPS * support
                            + EVAL_CDF_FLOPS * eval_shares["live_share"])
    t_ops = eval_flops / F64_OPS_PER_S * 1e3
    bounds["exact_eval_window"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                   else (t_ops, "operations"))
    times = {}
    for name in ms:
        errs[name] = max(errs[name], e[name])
        times[name] = (ms[name], plain[name], *bounds[name])
    calls = keep["calls"]
    row = {
        "family": family, "n": n, "num_lanes": L,
        "segments": len(segs), "window_entries": entries,
        **{f"window_{k}": v for k, v in eval_shares.items()},
        "window_flops": eval_flops,
        "sass_f64": sass_f64(r"exact_eval_window_kernelILi0E"),
        "seg_table_bytes": sum(k * 4 * tb.shape[1] for (_, k), (tb, _)
                               in zip(spans, built)),
        "seg_search_path_bytes_per_symbol": 4 * seg_words / n,
        "ungrouped_search_path_bytes_per_symbol": 4 * u_words / n,
        "ungrouped_table_width": cmax_u,
        **{f"{k}_ms": v for k, v in ms.items()},
        **{f"{k}_ns_per_symbol": v * 1e6 / n for k, v in ms.items()},
        **{f"{k}_plain_ms": v for k, v in plain.items()},
        **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
        **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
        **{f"{k}_max_abs_err": v for k, v in e.items()},
        **enc_passes,
        "seg_chain": {"launches": len(seg_launches),
                      "chain_ms": ms["exact_decode64_seg"], **seg_gap,
                      "gap_ms": ms["exact_decode64_seg"]
                      - seg_gap["launches_alone_ms"]},
        "search_by_width": search,
        "crossover_planes": {
            kern: crossover(search, f"{col}scan_ms", f"{col}bisect_ms")
            for kern, col in (("seg", ""), ("cluster", "cluster_"))},
        "BISECT_FROM_PLANES": ef.BISECT_FROM_PLANES,
        "device_build_s": build_s,
        **{f"device_build_{k}": v for k, v in build.items()},
        "device_prep_Msyms": n / build_s / 1e6,
        "e2e_fresh_Msyms": n / (build_s + ms["exact_decode64_seg"] * 1e-3)
        / 1e6,
        **{f"facade_{k}_call_s": v for k, v in calls.items()},
        **{f"facade_{k}_Msyms": n / v / 1e6 for k, v in calls.items()
           if k not in ("host_oracles", "ungrouped_host_tables_pair")},
        "gpu": gpu,
    }
    return {"phase": "exact_times", "cases": [row]}, times


# ---------------------------------------------------------------------------
# reference-exact families at the small preset (W=16, S=32, P <= 16)
# ---------------------------------------------------------------------------

# operations per symbol of the S=32 encoder's pass A (the quotient's f64
# estimate, four DFMA and a DMUL, its correcting product, the remainder,
# renorm test and emission), counted at the integer rate, and of the
# narrow table decoder outside its search (regions, state update, refill);
# the encoder's bytes bound it either way (exact32_times)
ENCODE32_OPS = 20
DECODE32_OPS = 30


def _exact32_oracle_tables(args):
    """Host builder (a worker process): ``exact_family.narrow_tables`` at
    cmax = the batch's largest core, rounded up to even."""
    from constriction_tpu_torch.ops import exact_family as ef

    family, means, scales, lo, hi, P, nsteps, R = args
    return ef.narrow_tables(means, scales, family, lo, hi, P, None, nsteps,
                            R)


def _exact32_oracle_decode(args):
    """Host decode oracle (a worker process):
    ``exact_family.decode_family_exact_host``."""
    from constriction_tpu_torch.ops import exact_family as ef

    states, stream, means, scales, family, lo, hi, cfg, n = args
    return ef.decode_family_exact_host(states, stream, means, scales, family,
                                       lo, hi, cfg, n)


def exact32_cases():
    """The kernel checks' messages: (label, family, lo, hi, P, means,
    scales, symbols).  Gaussian, laplace and cauchy models of the suite's
    latents with scales exp(N(-0.5, 0.3)) on [-100, 100], gaussian models
    with sharp cores (scales exp(N(-2.5, 0.2)), whole steps, so that no
    padded lane's unit model widens the tables: the narrowest tables of
    the search sweep) and binomial (60 trials) at P=12; a flat P=16 gaussian
    on [-50, 50] whose run of top symbols steers quantiles into the top
    interval."""
    import numpy as np

    n = N_EXACT32_CHECK
    means, scales, syms = exact_workload(n, scale_sd=0.3, scale_mu=-0.5)
    cases = [(fam, fam, -100, 100, EXACT32_P, means, scales, syms)
             for fam in ("gaussian", "laplace", "cauchy")]
    cases.append(("gaussian_sharp", "gaussian", -100, 100, EXACT32_P,
                  *exact_workload(1 << 20, scale_sd=0.2, scale_mu=-2.5)))
    rng = np.random.RandomState(7)
    nb = N_EXACT32_BINOMIAL
    ps = rng.uniform(0.02, 0.98, nb)
    cases.append(("binomial", "binomial", 0, 60, EXACT32_P,
                  np.full(nb, 60.0), ps, rng.binomial(60, ps)))
    nf = N_EXACT32_FLAT
    flat = rng.randint(-50, 51, nf)
    flat[nf // 5:2 * nf // 5] = 50
    cases.append(("flat16", "gaussian", -50, 50, 16, np.zeros(nf),
                  np.full(nf, 500.0), flat))
    return cases


def decode32_launch(device, states, stream, tabs, syms, n, cfg, lo, hi,
                    bisect: int):
    """One kernel-13 launch through its C entry point, the search forced:
    ``bisect`` 0 scans, 1 binary-searches."""
    from constriction_tpu_torch.ops import _build

    _build.call("ctt_exact_decode32", device, states, stream, stream.numel(),
                tabs, tabs.shape[1], syms, n, cfg.num_lanes, cfg.precision,
                lo, hi, bisect, None)


def encode32_pass_a_err(device, c_t, p_t, cfg, seeds, n: int) -> int:
    """Kernel 14's pass A launched alone (``ctt_exact_encode_lanes32``)
    against its plain version ``exact_family.encode_lanes_plain``: final
    states, ballots and the words it flags; 0 when equal."""
    import torch

    from constriction_tpu_torch.ops import _build, coder
    from constriction_tpu_torch.ops import exact_family as ef

    L = cfg.num_lanes
    T = -(-n // L)
    words, flags, _ = coder.compaction_scratch(T, L, device)
    states = (seeds.clone() if seeds is not None else torch.full(
        (L,), cfg.lower_bound, dtype=torch.int32, device=device))
    _build.call("ctt_exact_encode_lanes32", device, states, c_t, p_t, n,
                words, flags, L, cfg.precision)
    w_p, f_p, st_p = ef.encode_lanes_plain(c_t, p_t, cfg, seeds, n)
    f = f_p.reshape(-1)
    return max(mismatch(states, st_p),
               mismatch(flags.view(T, L // 32), coder.flag_ballots(f_p)),
               mismatch(words[f], w_p.reshape(-1)[f]))


def phase_exact32_kernels(device, pool, errs: dict, keep: dict) -> dict:
    """Kernels 14 and 13 against their twins on the same CUDA tensors and
    against the numpy oracles (``encode_shared``,
    ``decode_family_exact_host``), L=32768: kernel 14 with and without
    seeds, its pass A also alone against its plain version, kernel 13
    through its wrapper and with the scan and the binary search forced,
    over the host builder's narrow tables."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    L = EXACT32_CHECK_LANES
    cases = exact32_cases()
    tables = []
    for label, family, lo, hi, P, means, scales, syms in cases:
        T = -(-len(syms) // L)
        pm, ps = ef._pad_params(means, scales, T * L, family, hi)
        tables.append(pool.submit(_exact32_oracle_tables, (
            family, pm, ps, lo, hi, P, T, L // 128)))
    rng = np.random.RandomState(6)
    rows, decodes, e14, e13 = [], [], 0, 0
    for label, family, lo, hi, P, means, scales, syms in cases:
        n = len(syms)
        cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                         precision=P)
        cums, probs = ef.exact_ecp(syms, means, scales, family, lo, hi, P)
        c_t, p_t = convert.ecp_to_torch(cums, probs, L, device)
        for seeded in (False, True):
            seeds = (rng.randint(1 << 16, 1 << 32, L, dtype=np.int64)
                     .astype(np.uint32) if seeded else None)
            s_t = None if seeds is None else convert.u32_to_torch(seeds,
                                                                  device)
            st, w = ef.encode_tables(c_t, p_t, cfg, s_t, n)
            st_p, w_p = ef.encode_tables_plain(c_t, p_t, cfg, s_t, n)
            st_h, w_h = il2.encode_shared_plain(cums, probs, cfg,
                                                seeds=seeds)
            e = max(mismatch(st, st_p), mismatch(w, w_p),
                    encode32_pass_a_err(device, c_t, p_t, cfg, s_t, n))
            same_h = (np.array_equal(convert.u32_from_torch(st), st_h)
                      and np.array_equal(convert.u32_from_torch(w), w_h))
            e14 = max(e14, e, 0 if same_h else 1)
            rows.append({"kernel": "exact_encode32", "case": label,
                         "seeded": seeded, "n": n,
                         "max_abs_err_vs_twin_and_pass_a": e,
                         "identical_to_host_oracle": same_h})
            if not seeded:
                states, stream = st, w
        decodes.append((states, stream, cfg, pool.submit(
            _exact32_oracle_decode, (
                convert.u32_from_torch(states),
                convert.u32_from_torch(stream), means, scales, family, lo,
                hi, cfg, n))))
    for case, table, (states, stream, cfg, host) in zip(cases, tables,
                                                         decodes):
        label, family, lo, hi, P, means, scales, syms = case
        n = len(syms)
        tabs4, cmax = table.result()
        tabs = convert.exact_tables_to_torch(tabs4, device)
        out, fin = ef.decode_tables(states, stream, tabs, cfg, lo, hi, n,
                                    return_final_states=True)
        out_p, fin_p, _ = ef.decode_tables_plain(states, stream, tabs, cfg,
                                                 lo, hi, n)
        e = max(mismatch(out, out_p), mismatch(fin, fin_p))
        for mode in (0, 1):  # the scan and the binary search, forced
            o_m, f_m = torch.empty_like(out), states.clone()
            decode32_launch(device, f_m, stream, tabs, o_m, n, cfg, lo, hi,
                            mode)
            e = max(e, mismatch(o_m, out), mismatch(f_m, fin))
        ok = (np.array_equal(out.cpu().numpy(), syms)
              and bool((fin == 1 << 16).all())
              and np.array_equal(host.result(), syms))
        e13 = max(e13, e)
        rows.append({"kernel": "exact_decode32", "case": label, "n": n,
                     "cmax": cmax, "planes": int(tabs.shape[1]),
                     "bisect_by_default": ef.bisect_tables(tabs.shape[1],
                                                           True),
                     "max_abs_err_vs_twin_and_forced_modes": e,
                     "decodes_like_host_oracle": ok})
        if label in ("gaussian", "gaussian_sharp"):
            keep.setdefault("sweep_cases", []).append(
                (states, stream, tabs, n, cfg, lo, hi))
        if not ok:
            e13 = max(e13, 1)
    errs["exact_encode32"] = e14
    errs["exact_decode32"] = e13
    if e14 or e13:
        fail(f"exact32_kernels: {rows}")
    return {"phase": "exact32_kernels", "num_lanes": L, "cases": rows}


def phase_exact32_main(device, work, keep: dict) -> dict:
    """The facade's default exact pair: ``cuda.encode_family_exact(sym, mu,
    sigma, "gaussian", -100, 100)`` -> ``cuda.decode_family_exact(...,
    num_symbols=n)`` with no cfg (W=16, S=32, P=12 at L=32768) on the
    suite's synthetic latents: states and stream byte for byte the numpy
    host coder's on ``exact_ecp``'s planes, the decode equal to the
    symbols.  The narrow tables the decode builds are kept for the times
    phase."""
    import numpy as np

    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import interleaved2 as il2

    means, scales, syms = work
    lo, hi = EXACT_SUPPORT
    family, n = EXACT_FAMILY, len(syms)
    build = ef.narrow_tables

    def kept_tables(*args):
        t0 = time.perf_counter()
        keep["tables"] = build(*args)
        keep["table_build_s"] = time.perf_counter() - t0
        return keep["tables"]

    clock = time.perf_counter
    t = [clock()]
    st, w = ctt.encode_family_exact(syms, means, scales, family, lo, hi,
                                    device=device)
    t.append(clock())
    ef.narrow_tables = kept_tables
    try:
        out = ctt.decode_family_exact(st, w, means, scales, family, lo, hi, n,
                                      device=device)
    finally:
        ef.narrow_tables = build
    t.append(clock())
    cfg = ctt._pick_cfg_family(n, None, False)
    cums, probs = ef.exact_ecp_plain(syms, means, scales, family, lo, hi,
                                     cfg.precision)
    st_h, w_h = il2.encode_shared_plain(cums, probs, cfg)
    t.append(clock())
    tabs4, cmax = keep["tables"]
    ncore = tabs4[:, 0] >> 16
    calls = dict(zip(("encode", "decode", "host_oracle"), np.diff(t)))
    row = {
        "family": family, "support": [lo, hi], "n": n,
        "num_lanes": cfg.num_lanes, "word_bits": cfg.word_bits,
        "state_bits": cfg.state_bits, "precision": cfg.precision,
        "states_dtype": str(st.dtype), "symbols_dtype": str(out.dtype),
        "ncore_max": int(ncore.max()), "ncore_mean": float(ncore.mean()),
        "cmax": cmax, "planes": int(tabs4.shape[1]),
        "table_build_s": keep["table_build_s"],
        "stream_words": int(len(w)),
        "identical_to_host_oracle": bool(
            st.dtype == np.uint32 and np.array_equal(st, st_h)
            and np.array_equal(w, w_h)),
        "decodes_exactly": bool(np.array_equal(out, syms)),
        "max_abs_err": 0,
        **{f"{k}_call_s": v for k, v in calls.items()},
    }
    keep.update(calls=calls, cums=cums, probs=probs, cfg=cfg, st=st, w=w)
    if not (row["identical_to_host_oracle"] and row["decodes_exactly"]):
        fail(f"exact32 main path: {row}")
    return {"phase": "exact32_main_path", "cases": [row]}


def search_sweep32(device, cases) -> tuple[list, int | None]:
    """Kernel 13 per table width: each message's narrow tables padded with
    pad planes (0xFFFF pairs, which no quantile selects) to every width of
    SWEEP32_PLANES above its own, decoded by the scan and by the binary
    search, timed in turns (scan, bisect, bisect, scan); the two must
    decode alike.  Returns the rows and the narrowest width from which the
    binary search was the faster at every width measured (None if
    never)."""
    import torch

    rows = []
    for states, stream, tabs, n, cfg, lo, hi in cases:
        T, CP1, L = tabs.shape
        for planes in [CP1] + [p for p in SWEEP32_PLANES if p > CP1]:
            tb = tabs if planes == CP1 else torch.cat([tabs, torch.full(
                (T, planes - CP1, L), -1, dtype=torch.int32,
                device=device)], 1)
            s_buf = states.clone()
            o_buf = torch.empty(n, dtype=torch.int32, device=device)
            res, outs = {0: [], 1: []}, {}
            for mode in (0, 1, 1, 0):
                res[mode].append(kernel_ms(
                    lambda: s_buf.copy_(states), lambda: decode32_launch(
                        device, s_buf, stream, tb, o_buf, n, cfg, lo, hi,
                        mode), 3))
                outs[mode] = (o_buf.clone(), s_buf.clone())
            if not all(torch.equal(a, b) for a, b in zip(outs[0], outs[1])):
                fail(f"search_sweep32: scan and bisect differ at {planes} "
                     "planes")
            rows.append({"planes": planes, "symbols": n,
                         "scan_ms": sum(res[0]) / 2,
                         "bisect_ms": sum(res[1]) / 2})
            del tb
    rows.sort(key=lambda r: r["planes"])
    from_planes = None
    for r in reversed(rows):
        if r["bisect_ms"] >= r["scan_ms"]:
            break
        from_planes = r["planes"]
    return rows, from_planes


def sweep32_lanes(device, tabs, cums, probs, syms, lo, hi) -> tuple:
    """Kernel 13 per coding step at SWEEP_STEPS steps over SWEEP_LANES lanes
    (the default search for the tables' width), as phase_sweep times the
    rANS pairs: the main path's n symbols repeated (symbol i of a sweep
    message is symbol i mod n, with its table column and planes), encoded
    by kernel 14, decoded through the C entry alone (CUDA events around it,
    the states reset outside them) and checked against the symbols.
    Returns the rows and sweep_fit's floor and slope."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    T, CP1, L0 = tabs.shape
    n = T * L0
    cols = tabs.permute(1, 0, 2).reshape(CP1, n)
    bisect = int(ef.bisect_tables(CP1, True))
    rows, us = [], []
    for L in SWEEP_LANES:
        cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                         precision=EXACT32_P)
        m = L * SWEEP_STEPS
        idx = np.arange(m) % n
        tb = cols[:, torch.from_numpy(idx).to(device)].reshape(
            CP1, SWEEP_STEPS, L).permute(1, 0, 2).contiguous()
        c_t, p_t = convert.ecp_to_torch(cums[idx], probs[idx], L, device)
        st, w = ef.encode_tables(c_t, p_t, cfg, None, m)
        s_buf = torch.empty_like(st)
        o_buf = torch.empty(m, dtype=torch.int32, device=device)
        ms = kernel_ms(lambda: s_buf.copy_(st), lambda: decode32_launch(
            device, s_buf, w, tb, o_buf, m, cfg, lo, hi, bisect), 3)
        if not np.array_equal(o_buf.cpu().numpy(), syms[idx]):
            fail(f"sweep32_lanes: kernel 13 L={L} round trip")
        us.append(ms * 1e3 / SWEEP_STEPS)
        rows.append({"kernel": 13, "num_lanes": L, "steps": SWEEP_STEPS,
                     "planes": CP1, "bisect": bool(bisect),
                     "decode_ms": ms, "decode_us_per_step": us[-1],
                     **ef.geometry(L, device, narrow=True)})
        del tb, c_t, p_t, st, w
    return rows, sweep_fit(list(SWEEP_LANES), us)


def phase_exact32_times(device, work, keep: dict, gpu: str,
                        errs: dict) -> tuple[dict, dict]:
    """Kernel-only time of kernels 14 and 13 at the main path's shapes (CUDA
    events around the C entry points, after a warm-up), over the main
    path's own planes and tables, kernel 14's pass A and pass B also
    apart; each twin's time on the card (outputs equal); the facade's call times and their host share; each kernel's
    bound (kernel 13: the table words on the binary search's path, counted
    from this run's tables and symbols); and the narrow search sweep."""
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.ops import _build, coder
    from constriction_tpu_torch.ops import exact_family as ef

    means, scales, syms = work
    lo, hi = EXACT_SUPPORT
    n, cfg = len(syms), keep["cfg"]
    L, P = cfg.num_lanes, cfg.precision
    c_t, p_t = convert.ecp_to_torch(keep["cums"], keep["probs"], L, device)
    st = convert.u32_to_torch(keep["st"], device)
    w = convert.u32_to_torch(keep["w"], device)
    nw = int(w.numel())
    tabs = convert.exact_tables_to_torch(keep["tables"][0], device)
    ms, plain, e = {}, {}, {}
    s_buf = torch.empty(L, dtype=torch.int32, device=device)
    w_buf = torch.empty(n, dtype=torch.int32, device=device)
    end = torch.empty(1, dtype=torch.int64, device=device)
    scratch = coder.compaction_scratch(-(-n // L), L, device)
    ms["exact_encode32"] = kernel_ms(
        lambda: s_buf.fill_(1 << 16), lambda: _build.call(
            "ctt_exact_encode32", device, s_buf, c_t, p_t, n, w_buf, n, end,
            *scratch, L, P), 3)
    same = torch.equal(s_buf, st) and torch.equal(w_buf[int(end):], w)
    enc_passes = {"exact_encode32_pass_a_ms": kernel_ms(
        lambda: s_buf.fill_(1 << 16), lambda: _build.call(
            "ctt_exact_encode_lanes32", device, s_buf, c_t, p_t, n,
            scratch[0], scratch[1], L, P), 3)}
    enc_passes["exact_encode32_pass_b_ms"] = kernel_ms(
        lambda: None, lambda: _build.call(
            "ctt_ilans2_compact", device, scratch[1], scratch[0],
            scratch[1].numel(), w_buf, n, end, scratch[2]), 3)
    same = (same and torch.equal(s_buf, st)
            and torch.equal(w_buf[int(end):], w))
    plain["exact_encode32"], pe = timed(
        lambda: ef.encode_tables_plain(c_t, p_t, cfg, None, n))
    e["exact_encode32"] = planes_err((st, w), pe)
    o_buf = torch.empty(n, dtype=torch.int32, device=device)
    bisect = int(ef.bisect_tables(tabs.shape[1], True))
    ms["exact_decode32"] = kernel_ms(
        lambda: s_buf.copy_(st), lambda: decode32_launch(
            device, s_buf, w, tabs, o_buf, n, cfg, lo, hi, bisect), 3)
    same = (same and torch.equal(o_buf.cpu(), torch.from_numpy(
        syms.astype(np.int32))) and bool((s_buf == 1 << 16).all()))
    plain["exact_decode32"], pd = timed(lambda: ef.decode_tables_plain(
        st, w, tabs, cfg, lo, hi, n)[:2])
    e["exact_decode32"] = planes_err((o_buf, s_buf), pd)
    if not same:
        fail("exact32_times: timed launches differ from the wrappers' output")
    if any(e.values()):
        fail(f"exact32_times: kernel != twin at full size: {e}")
    sweep, from_planes = search_sweep32(device, [
        *keep["sweep_cases"], (st, w, tabs, n, cfg, lo, hi)])
    lanes_rows, lanes_fit = sweep32_lanes(device, tabs, keep["cums"],
                                          keep["probs"], syms, lo, hi)

    words, probes = search_path_words(tabs, keep["cums"], n, narrow=True)
    bounds = {
        "exact_encode32": bound(8 * n + 8 * L + 4 * nw, ENCODE32_OPS * n),
        "exact_decode32": bound(4 * words + 4 * nw + 4 * n + 8 * L,
                                PROBE_OPS * probes + DECODE32_OPS * n),
    }
    times = {}
    for name in ms:
        errs[name] = max(errs[name], e[name])
        times[name] = (ms[name], plain[name], *bounds[name])
    calls = keep["calls"]
    kernel_of = {"encode": "exact_encode32", "decode": "exact_decode32"}
    row = {
        "family": EXACT_FAMILY, "n": n, "num_lanes": L, "precision": P,
        "planes": int(tabs.shape[1]),
        "search_path_bytes_per_symbol": 4 * words / n,
        "bisect_by_default": bool(bisect),
        **{f"{k}_ms": v for k, v in ms.items()},
        **{f"{k}_ns_per_symbol": v * 1e6 / n for k, v in ms.items()},
        **{f"{k}_plain_ms": v for k, v in plain.items()},
        **{f"{k}_bound_ms": v[0] for k, v in bounds.items()},
        **{f"{k}_bound_by": v[1] for k, v in bounds.items()},
        **{f"{k}_max_abs_err": v for k, v in e.items()},
        **enc_passes,
        **{f"facade_{k}_call_s": calls[k] for k in kernel_of},
        **{f"facade_{k}_host_share": 1 - ms[v] * 1e-3 / calls[k]
           for k, v in kernel_of.items()},
        "search_by_width": sweep,
        "decode32_by_lanes": lanes_rows,
        "decode32_sweep_fit": lanes_fit,
        "bisect_from_planes_measured": from_planes,
        "BISECT_FROM_PLANES_NARROW": ef.BISECT_FROM_PLANES_NARROW,
        "gpu": gpu,
    }
    return {"phase": "exact32_times", "cases": [row]}, times


def host_api_golden() -> list:
    """The quick start and the golden flows of the host API, each with its
    exact words: [(flow, ok)]."""
    import numpy as np

    import constriction_tpu_torch as constriction

    sm = constriction.stream.model
    out = []
    message = np.array([6, 10, -4, 2, 5, 2, 1, 0, 2], dtype=np.int32)
    model = sm.QuantizedGaussian(-50, 50, 3.2, 9.6)
    enc = constriction.stream.stack.AnsCoder()
    enc.encode_reverse(message, model)
    words = enc.get_compressed()
    back = constriction.stream.stack.AnsCoder(words).decode(model, 9)
    out.append(("quick_start", words.tolist() == [3114258274, 357938615]
                and np.array_equal(back, message)))
    family = sm.QuantizedGaussian(-100, 100)
    sym = np.array([23, -15, 78, 43, -69], dtype=np.int32)
    means = np.array([35.2, -1.7, 30.1, 71.2, -75.1])
    stds = np.array([10.1, 25.3, 23.8, 35.4, 3.9])
    ans = constriction.stream.stack.AnsCoder()
    ans.encode_reverse(sym, family, means, stds)
    words = ans.get_compressed()
    back = constriction.stream.stack.AnsCoder(words).decode(family, means,
                                                            stds)
    out.append(("ans_gaussian_family", words.tolist() == [1109163715, 757457]
                and np.array_equal(back, sym)))
    rng_enc = constriction.stream.queue.RangeEncoder()
    rng_enc.encode(sym, family, means, stds)
    words = rng_enc.get_compressed()
    dec = constriction.stream.queue.RangeDecoder(words)
    back = dec.decode(family, means, stds)
    out.append(("range_gaussian_family",
                words.tolist() == [473034731, 2276733146]
                and np.array_equal(back, sym) and dec.maybe_exhausted()))
    data = np.random.RandomState(123).randint(2**32, size=100,
                                              dtype=np.uint32)
    chain = constriction.stream.chain.ChainCoder(data, seal=True)
    cmeans, cstds = np.arange(50, dtype=np.float64), np.full(50, 10.0)
    csym = chain.decode(family, cmeans, cstds)
    prefix, suffix = chain.get_remainders()
    again = constriction.stream.chain.ChainCoder(suffix, is_remainders=True)
    again.encode_reverse(csym, family, cmeans, cstds)
    head, tail = again.get_data(unseal=True)
    out.append(("chain_bits_back", len(head) == 0 and np.array_equal(
        np.concatenate([prefix, tail]), data)))
    probs = np.array([0.3, 0.2, 0.4, 0.1], dtype=np.float32)
    msg = [1, 3, 2, 3, 0, 1, 3, 0, 2, 1, 1, 3, 3, 1, 2, 0, 1, 3, 1]
    huff = constriction.symbol.huffman
    book = huff.EncoderHuffmanTree(probs)
    dbook = huff.DecoderHuffmanTree(probs)
    queue = constriction.symbol.QueueEncoder()
    for s in msg:
        queue.encode_symbol(s, book)
    qwords, qbits = queue.get_compressed_and_bitrate()
    qdec = constriction.symbol.QueueDecoder(qwords)
    stack = constriction.symbol.StackCoder()
    for s in reversed(msg):
        stack.encode_symbol(s, book)
    swords, sbits = stack.get_compressed_and_bitrate()
    out.append(("huffman_queue_stack",
                qwords.tolist() == [3756389791, 61358] and qbits == 48
                and [qdec.decode_symbol(dbook) for _ in msg] == msg
                and swords.tolist() == [2818274807, 129455] and sbits == 48
                and [stack.decode_symbol(dbook) for _ in msg] == msg))
    return out


def _ans_state(core):
    return core.get_compressed().tobytes(), core.state, len(core.bulk)


def _range_state(core):
    return core.lower, core.range, core.point, core.cursor, core.pos()


def _chain_state(core):
    return (core.compressed.view().tobytes(), core.remainders.view().tobytes(),
            core.head_compressed, core.head_remainders)


def host_api_rows(clock) -> list:
    """Each host-codec entry of the host API at N_HOST_API symbols, round
    tripped, and on a prefix against its ``*_plain`` loop (words, symbols
    and the coder's state after the call): one row each, with the times."""
    import numpy as np

    import constriction_tpu_torch as constriction
    from constriction_tpu_torch.models import (ContiguousLookupDecoderModel,
                                               QuantizedFamily,
                                               fast_quantized_cdf)
    from constriction_tpu_torch.ops.ans import AnsCoderCore
    from constriction_tpu_torch.ops.chain import ChainCoderCore
    from constriction_tpu_torch.ops.range import (RangeDecoderCore,
                                                  RangeEncoderCore)

    sm = constriction.stream.model
    n, p, pf = N_HOST_API, N_HOST_API_PLAIN, N_HOST_API_FAMILY_PLAIN
    rng = np.random.RandomState(1234)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    syms = rng.choice(K_MAIN, size=n, p=probs).astype(np.int32)
    data = rng.randint(0, 1 << 32, size=n, dtype=np.uint32)
    rows = []

    def row(entry, case, route_s, plain_s, identical, round_trip=None,
            **more):
        rows.append({"entry": entry, "case": case, "route_s": route_s,
                     "plain_s": plain_s, "identical": bool(identical),
                     "round_trip": (None if round_trip is None
                                    else bool(round_trip)), **more})

    def timed(fn, *args):
        t0 = clock()
        out = fn(*args)
        return out, clock() - t0

    # bench.py's model through the stream API (P=24)
    model = sm.Categorical(probs, perfect=False)
    inner = model._as_parameterized()
    cums, prs = inner.ecp_array(syms)
    enc = constriction.stream.stack.AnsCoder()
    _, t_enc = timed(enc.encode_reverse, syms, model)
    words = enc.get_compressed()
    back, t_dec = timed(constriction.stream.stack.AnsCoder(words).decode,
                        model, n)
    a, b = AnsCoderCore(), AnsCoderCore()
    _, t_r = timed(a.encode_reverse_tables, cums[:p], prs[:p], 24)
    _, t_p = timed(b.encode_reverse_tables_plain, cums[:p], prs[:p], 24)
    row("ctpu_ans_encode_reverse", "stack_iid_p24", t_r, t_p,
        _ans_state(a) == _ans_state(b), np.array_equal(back, syms),
        n=n, n_plain=p, call_s=t_enc, decode_call_s=t_dec)
    a, b = AnsCoderCore.from_compressed(words), AnsCoderCore.from_compressed(
        words)
    got, t_r = timed(a.decode_iid_symbols, p, inner)
    want, t_p = timed(b.decode_iid_symbols_plain, p, inner)
    row("ctpu_ans_decode_cdf", "stack_iid_p24", t_r, t_p,
        np.array_equal(got, want) and _ans_state(a) == _ans_state(b),
        np.array_equal(back, syms), n=n, n_plain=p, call_s=t_dec)

    renc = constriction.stream.queue.RangeEncoder()
    _, t_enc = timed(renc.encode, syms, model)
    rwords = renc.get_compressed()
    # P=24 has no table route in the range decode (gate P <= 16): the loop
    rback, t_dec = timed(constriction.stream.queue.RangeDecoder(rwords).decode,
                         model, n)
    a, b = RangeEncoderCore(), RangeEncoderCore()
    _, t_r = timed(a.encode_tables, cums[:p], prs[:p], 24)
    _, t_p = timed(b.encode_tables_plain, cums[:p], prs[:p], 24)
    row("ctpu_range_encode", "queue_iid_p24", t_r, t_p,
        a.get_compressed().tobytes() == b.get_compressed().tobytes()
        and (a.lower, a.range, a.inverted) == (b.lower, b.range, b.inverted),
        np.array_equal(rback, syms), n=n, n_plain=p, call_s=t_enc,
        decode_loop_call_s=t_dec)

    chain = constriction.stream.chain.ChainCoder(data, seal=True)
    # P=24 has no table route in the chain decode (gate P <= 16): the loop
    csym, t_dec = timed(chain.decode, model, n)
    prefix, suffix = chain.get_remainders()
    cenc = constriction.stream.chain.ChainCoder(suffix, is_remainders=True)
    _, t_enc = timed(cenc.encode_reverse, csym, model)
    head, tail = cenc.get_data(unseal=True)
    ccum, cprob = inner.ecp_array(csym[:p])
    a = ChainCoderCore.from_remainders(suffix)
    b = ChainCoderCore.from_remainders(suffix)
    _, t_r = timed(a.encode_reverse_tables, ccum, cprob)
    _, t_p = timed(b.encode_reverse_tables_plain, ccum, cprob)
    row("ctpu_chain_encode_reverse", "chain_iid_p24", t_r, t_p,
        _chain_state(a) == _chain_state(b),
        len(head) == 0 and np.array_equal(np.concatenate([prefix, tail]),
                                          data),
        n=n, n_plain=p, call_s=t_enc, decode_loop_call_s=t_dec)

    # the cores' lookup decodes: the host API's lookup model at P=12
    # (ANS, range) and P=16 (chain)
    for entry, P in (("ctpu_ans_decode_lookup", 12),
                     ("ctpu_range_decode_lookup", 12),
                     ("ctpu_chain_decode_lookup", 16)):
        cdf = fast_quantized_cdf(probs, P)
        lut = ContiguousLookupDecoderModel(cdf, P)
        if entry == "ctpu_ans_decode_lookup":
            core = AnsCoderCore()
            core.encode_reverse_tables(cdf[syms], cdf[syms + 1] - cdf[syms], P)
            w = core.get_compressed()
            back, t_call = timed(AnsCoderCore.from_compressed(w)
                                 .decode_iid_symbols, n, lut)
            trip = np.array_equal(back, syms)
            a, b = AnsCoderCore.from_compressed(w), AnsCoderCore.from_compressed(w)
            got, t_r = timed(a.decode_iid_symbols, p, lut)
            want, t_p = timed(b.decode_iid_symbols_plain, p, lut)
            same = np.array_equal(got, want) and _ans_state(a) == _ans_state(b)
        elif entry == "ctpu_range_decode_lookup":
            core = RangeEncoderCore()
            core.encode_tables(cdf[syms], cdf[syms + 1] - cdf[syms], P)
            w = core.get_compressed()
            back, t_call = timed(RangeDecoderCore.from_compressed(w)
                                 .decode_iid_symbols, n, lut)
            trip = np.array_equal(back, syms)
            a = RangeDecoderCore.from_compressed(w)
            b = RangeDecoderCore.from_compressed(w)
            got, t_r = timed(a.decode_iid_symbols, p, lut)
            want, t_p = timed(b.decode_iid_symbols_plain, p, lut)
            same = (np.array_equal(got, want)
                    and _range_state(a) == _range_state(b))
        else:
            core = ChainCoderCore.from_binary(data, 32, 64, P)
            back, t_call = timed(core.decode_iid_symbols, n, lut)
            core.encode_reverse_tables(cdf[back], cdf[back + 1] - cdf[back])
            trip = np.array_equal(core.into_binary()[1], data)
            a = ChainCoderCore.from_binary(data, 32, 64, P)
            b = ChainCoderCore.from_binary(data, 32, 64, P)
            got, t_r = timed(a.decode_iid_symbols, p, lut)
            want, t_p = timed(b.decode_iid_symbols_plain, p, lut)
            same = (np.array_equal(got, want)
                    and _chain_state(a) == _chain_state(b))
        row(entry, f"lookup_p{P}", t_r, t_p, same, trip, n=n, n_plain=p,
            call_s=t_call)

    # the QuantizedGaussian family (-100, 100) with per-symbol means and
    # scales (the JAX suite's exact-family latents)
    lo, hi = EXACT_SUPPORT
    means, scales, fsyms = exact_workload(n)
    fsyms = fsyms.astype(np.int32)
    fam_model = sm.QuantizedGaussian(lo, hi)
    fam = QuantizedFamily("gaussian", lo, hi, means[:p], scales[:p], 24)
    got, t_r = timed(fam.ecp_all, fsyms[:p])
    want, t_p = timed(fam.ecp_all_plain, fsyms[:p])
    row("ctpu_quantized_ecp", "gaussian_p24", t_r, t_p,
        all(np.array_equal(x, y) for x, y in zip(got, want)), n_plain=p)
    small = QuantizedFamily("gaussian", lo, hi, means[:pf], scales[:pf], 24)
    enc = constriction.stream.stack.AnsCoder()
    _, t_enc = timed(enc.encode_reverse, fsyms, fam_model, means, scales)
    words = enc.get_compressed()
    back, t_dec = timed(constriction.stream.stack.AnsCoder(words).decode,
                        fam_model, means, scales)
    a, b = AnsCoderCore.from_compressed(words), AnsCoderCore.from_compressed(
        words)
    got, t_r = timed(a.decode_symbols, small)
    want, t_p = timed(b.decode_symbols_plain, small)
    row("ctpu_ans_decode_quantized", "stack_gaussian_family", t_r, t_p,
        np.array_equal(got, want) and _ans_state(a) == _ans_state(b),
        np.array_equal(back, fsyms), n=n, n_plain=pf, call_s=t_dec,
        encode_call_s=t_enc)
    renc = constriction.stream.queue.RangeEncoder()
    _, t_enc = timed(renc.encode, fsyms, fam_model, means, scales)
    rwords = renc.get_compressed()
    dec = constriction.stream.queue.RangeDecoder(rwords)
    back, t_dec = timed(dec.decode, fam_model, means, scales)
    a = RangeDecoderCore.from_compressed(rwords)
    b = RangeDecoderCore.from_compressed(rwords)
    got, t_r = timed(a.decode_symbols, small)
    want, t_p = timed(b.decode_symbols_plain, small)
    row("ctpu_range_decode_quantized", "queue_gaussian_family", t_r, t_p,
        np.array_equal(got, want) and _range_state(a) == _range_state(b),
        np.array_equal(back, fsyms) and dec.maybe_exhausted(), n=n,
        n_plain=pf, call_s=t_dec, encode_call_s=t_enc)
    # the chain coder has no family decode route: bits-back on 2^11
    chain = constriction.stream.chain.ChainCoder(data[:pf], seal=True)
    csym, t_dec = timed(chain.decode, fam_model, means[:pf], scales[:pf])
    prefix, suffix = chain.get_remainders()
    a = ChainCoderCore.from_remainders(suffix)
    b = ChainCoderCore.from_remainders(suffix)
    _, t_r = timed(a.encode_symbols_reverse, csym, small)
    _, t_p = timed(b.encode_reverse_tables_plain, *small.ecp_all_plain(csym))
    row("ctpu_chain_encode_reverse", "chain_gaussian_family", t_r, t_p,
        _chain_state(a) == _chain_state(b),
        np.array_equal(np.concatenate([prefix, a.into_binary()[1]]),
                       data[:pf]),
        n=pf, n_plain=pf, decode_loop_call_s=t_dec)
    return rows


def host_api_cross_check(device) -> dict:
    """N_HOST_API_CROSS (mean, scale, symbol) rows at P=24 on [-100, 100]:
    the host API's ``(cum, prob)`` (``QuantizedFamily.ecp_all``, the host
    codec's ``ctpu_quantized_ecp``) against what the card codes and
    decodes (``cuda.encode_family_exact`` / ``decode_family_exact`` at
    W=32, S=64: kernels 17, 18 and 15) and against the card-built tables
    inverted at q = cum (kernel 18's tables, ``exact_family.
    invert_tables``)."""
    import numpy as np
    import torch

    import constriction_tpu_torch as constriction
    from constriction_tpu_torch import convert
    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import exact_tables as et
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops.interleaved import LaneConfig

    n, L = N_HOST_API_CROSS, HOST_API_CROSS_LANES
    T = n // L
    lo, hi = EXACT_SUPPORT
    means, scales, syms = exact_workload(n)
    clock = time.perf_counter
    t0 = clock()
    fam = constriction.stream.model.QuantizedGaussian(lo, hi)._parameterize(
        (means, scales))
    cum, prob = fam.ecp_all(syms)
    t_host = clock() - t0
    cfg = LaneConfig(L, 32, 64, 24)
    for key in ef.LAUNCHES:
        ef.LAUNCHES[key] = 0
    t0 = clock()
    st, w = ctt.encode_family_exact(syms, means, scales, "gaussian", lo, hi,
                                    cfg=cfg, device=device)
    t_enc = clock() - t0
    st_h, w_h = il2.encode_shared_plain(cum, prob, cfg)
    t0 = clock()
    out = ctt.decode_family_exact(st, w, means, scales, "gaussian", lo, hi,
                                  n, cfg=cfg, device=device)
    t_dec = clock() - t0
    est = int(ef._ncore_estimate(means, scales, "gaussian", lo, hi).max())
    (tabs, cmax), = et.packed_tables_on_device_batch(
        [(means, scales, min(255, -(-est // 4) * 4), T)], "gaussian", lo,
        hi, 24, L, device)
    q = torch.from_numpy(cum.astype(np.int64)).to(device).reshape(T, L)
    inv = [ef.invert_tables(q[t], convert.u32_values(tabs[t]), lo, hi, 24)
           for t in range(T)]
    got = [torch.cat([x[i] for x in inv]).cpu().numpy() for i in range(3)]
    return {
        "rows": n, "lanes": L, "precision": 24, "family": "gaussian",
        "support": [lo, hi], "table_cmax": int(cmax),
        "card_codes_host_model": bool(np.array_equal(st, st_h)
                                      and np.array_equal(w, w_h)),
        "card_decodes_symbols": bool(np.array_equal(out, syms)),
        "tables_invert_to_host_model": bool(
            np.array_equal(got[0], syms)
            and np.array_equal(got[1], cum.astype(np.int64))
            and np.array_equal(got[2], prob.astype(np.int64))),
        "launches": {k: ef.LAUNCHES[k]
                     for k in ("eval_window", "encode64", "decode64")},
        "host_ecp_s": t_host, "card_encode_call_s": t_enc,
        "card_decode_call_s": t_dec,
    }


def host_api_symbol_codes(clock) -> list:
    """Huffman and Exp-Golomb round trips over N_HOST_API_SYMBOL symbols
    on the queue and the stack bit coder: [(case, seconds, ok)]."""
    import numpy as np

    import constriction_tpu_torch as constriction

    rng = np.random.RandomState(17)
    probs = rng.dirichlet(np.full(K_MAIN, 2.0))
    out = []
    for name in ("huffman", "exp_golomb"):
        if name == "huffman":
            syms = rng.choice(K_MAIN, size=N_HOST_API_SYMBOL, p=probs)
            book = constriction.symbol.huffman.EncoderHuffmanTree(probs)
            dbook = constriction.symbol.huffman.DecoderHuffmanTree(probs)
        else:
            syms = rng.geometric(0.02, size=N_HOST_API_SYMBOL) - 1
            book = dbook = constriction.symbol.exp_golomb.ExpGolomb()
        syms = syms.tolist()
        t0 = clock()
        queue = constriction.symbol.QueueEncoder()
        for s in syms:
            queue.encode_symbol(s, book)
        qdec = constriction.symbol.QueueDecoder(queue.get_compressed()[0])
        ok = [qdec.decode_symbol(dbook) for _ in syms] == syms
        stack = constriction.symbol.StackCoder()
        for s in reversed(syms):
            stack.encode_symbol(s, book)
        sdec = constriction.symbol.StackCoder(stack.get_compressed()[0])
        ok = ok and [sdec.decode_symbol(dbook) for _ in syms] == syms
        out.append({"case": name, "n": len(syms), "seconds": clock() - t0,
                    "bits": int(queue.get_compressed()[1]), "ok": bool(ok)})
    return out


def phase_host_api(device, gpu: str) -> dict:
    """The constriction-compatible host API on this machine: golden
    vectors, the host-codec routes at N_HOST_API symbols against their
    plain loops, the host models against the card's exact-family kernels,
    and the symbol codes."""
    from constriction_tpu_torch.utils import special

    clock = time.perf_counter
    t0 = clock()
    golden = host_api_golden()
    rows = host_api_rows(clock)
    cross = host_api_cross_check(device)
    codes = host_api_symbol_codes(clock)
    rec = {"phase": "host_api", "gpu": gpu, "cpu": cpu_model(),
           "cpus": os.cpu_count(), "omp_threads": omp_threads(),
           "erf": special.ERF, "golden": dict(golden), "cases": rows,
           "cross_check": cross, "symbol_codes": codes,
           "seconds": clock() - t0}
    bad = ([g for g, ok in golden if not ok]
           + [r for r in rows if not r["identical"]
              or r["round_trip"] is False]
           + [k for k in ("card_codes_host_model", "card_decodes_symbols",
                          "tables_invert_to_host_model") if not cross[k]]
           + [k for k, v in cross["launches"].items() if not v]
           + [c for c in codes if not c["ok"]])
    if bad:
        emit(rec)
        fail(f"host_api: {bad}")
    return rec


# the kernels each example launches on the card: (counter module, key)
EXAMPLE_KERNELS = {
    "default_preset": [("coder64", "encode"), ("coder64", "decode"),
                       ("range_enc", "record64"), ("range_enc", "resolve64"),
                       ("coder64", "range_decode"), ("exact", "encode64"),
                       ("exact", "eval_window"), ("exact", "decode64")],
    "compact_framing": [("coder64", "encode"), ("coder64", "decode")],
    "bits_back": [("coder", "encode"), ("coder", "decode")],
    "multichip_sharded": [("coder", "encode"), ("coder", "decode")],
    "neural_latents": [("family", "encode"), ("family", "decode")],
    "reference_exact_and_seek": [("exact", "encode32"), ("exact", "decode32"),
                                 ("coder", "decode")],
}


def example_script(name: str):
    """``examples_torch/<name>.py``, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(REPO, "examples_torch",
                                               f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def iid_planes(cdf, symbols):
    import numpy as np

    cdf64 = np.asarray(cdf, dtype=np.uint64)
    return cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols]


def example_checks(name: str, mod, out: dict) -> dict:
    """{check: ok} of one example's artifacts against the port's host
    oracles on the same input."""
    import numpy as np

    from constriction_tpu_torch import cuda as ctt
    from constriction_tpu_torch.models import QuantizedFamily
    from constriction_tpu_torch.ops import exact_family as ef
    from constriction_tpu_torch.ops import family, framing
    from constriction_tpu_torch.ops import interleaved2 as il2
    from constriction_tpu_torch.ops.ans import AnsCoderCore

    eq = same_arrays
    if name == "default_preset":
        x = mod.inputs()
        planes = iid_planes(x["cdf"], x["symbols"])
        exact = ef.exact_ecp(x["family_symbols"], x["means"], x["scales"],
                             "gaussian", -100, 100, 24)
        return {
            "v2_container": eq(out["container"], host_container(
                x["symbols"], x["cdf"], mod.CFG, True)),
            "range_pair": eq((out["points"], out["stream"]),
                             il2.encode_shared_range(*planes, mod.CFG)),
            "exact_planes_stream": eq(
                (out["family_states"], out["family_stream"]),
                il2.encode_shared(*exact, mod.CFG)),
            "decodes": bool(
                np.array_equal(out["decoded"], x["symbols"])
                and np.array_equal(out["range_decoded"], x["symbols"])
                and np.array_equal(out["family_decoded"],
                                   x["family_symbols"])),
        }
    if name == "compact_framing":
        x = mod.inputs()
        cdf64 = np.asarray(x["cdf"], dtype=np.float64)
        est = float(-np.log2((cdf64[x["symbols"] + 1] - cdf64[x["symbols"]])
                             / cdf64[-1]).sum())
        cfg = ctt._pick_cfg(mod.N, None, x["cdf"], est_bits=est)
        ref = AnsCoderCore(word_bits=32, state_bits=64)
        ref.encode_reverse_tables_plain(
            *(p.astype(np.uint32) for p in iid_planes(x["cdf"], x["symbols"])),
            mod.P)
        p = framing.parse_v2(out["v2"])
        ckpts = il2.build_checkpoints_plain(p.states_A, p.stream_A, p.n_A,
                                            x["cdf"], p.cfg, mod.INTERVAL)
        return {
            "v2_container": eq(out["v2"], host_container(
                x["symbols"], x["cdf"], cfg, True)),
            "v1_container": eq(out["v1"], host_container(
                x["symbols"], x["cdf"], cfg, False)),
            "reference_words": eq(out["reference_words"],
                                  ref.get_compressed()),
            "checkpoints": eq((out["offsets"], out["states"]), ckpts),
            "decodes": bool(
                np.array_equal(out["decoded"], x["symbols"])
                and np.array_equal(out["suffix"],
                                   x["symbols"][out["seek_start"]:])),
        }
    if name == "bits_back":
        x = mod.inputs()
        cdf = x["models12"][out["z"]].cdf
        return {
            "v1_container": eq(out["container"], host_container(
                x["message"], cdf, mod.CFG12, False)),
            "decodes": bool(
                np.array_equal(out["decoded"], x["message"])
                and np.array_equal(out["recovered_side_info"],
                                   x["side_info"])),
        }
    if name == "multichip_sharded":
        D = len(out["devices"])
        x = mod.inputs(D)
        blocks = x["message"].reshape(D, mod.BLOCK_LEN)
        return {
            "block_streams": all(
                eq((st, sw), il2.encode_shared(*iid_planes(x["cdf"], blk),
                                               mod.CFG))
                for st, sw, blk in zip(out["states"], out["streams"], blocks)),
            "decodes": bool(np.array_equal(out["decoded"], x["message"])),
        }
    if name == "neural_latents":
        x = mod.inputs()
        n = len(x["symbols"])
        fam = QuantizedFamily("gaussian", *mod.SUPPORT, x["means"],
                              x["stds"], precision=12)
        states, stream = il2.encode_shared_plain(
            *fam.ecp_all_plain(x["symbols"]), mod.CFG)
        args = (x["means"].astype(np.float32), x["stds"].astype(np.float32),
                "gaussian", *mod.SUPPORT)
        dstates, dstream = il2.encode_shared(
            *family.family_tables_host(x["symbols"], *args), mod.CFG)
        return {
            "v1_container": eq(out["container"], il2.pack_container2(
                states, stream, n, mod.CFG)),
            "host_decode_plain": eq(
                out["host_decoded"].astype(np.int32),
                ef.decode_family_exact_host(
                    states, stream, x["means"], x["stds"], "gaussian",
                    *mod.SUPPORT, mod.CFG, n).astype(np.int32)),
            "family_stream": eq((out["family_states"], out["family_stream"]),
                                (dstates, dstream)),
            "family_decode_host": eq(
                out["family_decoded"],
                family.decode_family_host(dstates, dstream, *args, mod.CFG,
                                          n)),
            "decodes": bool(
                np.array_equal(out["host_decoded"], x["symbols"])
                and np.array_equal(out["family_decoded"], x["symbols"])),
        }
    x = mod.inputs("cuda")
    cfg, n = x["cfg"], len(x["msg"])
    exact = ef.exact_ecp(x["symbols"], x["means"], x["stds"], "gaussian",
                         -100, 100, 12)
    states, stream = il2.encode_shared_plain(*iid_planes(x["cdf"], x["msg"]),
                                             cfg)
    return {
        "exact_planes_stream": eq((out["states"], out["stream"]),
                                  il2.encode_shared(*exact, cfg)),
        "iid_stream": eq((out["iid_states"], out["iid_stream"]),
                         (states, stream)),
        "checkpoints": eq(
            (out["offsets"], out["checkpoint_states"]),
            il2.build_checkpoints_plain(states, stream, n, x["cdf"], cfg,
                                        mod.INTERVAL)),
        "decodes": bool(
            np.array_equal(out["decoded"], x["symbols"])
            and np.array_equal(out["suffix"], x["msg"][out["seek_start"]:])),
    }


def phase_examples(device, gpu: str, modules: dict) -> dict:
    """Each script of ``examples_torch/`` through ``run("cuda")`` at its
    card size: lines, wall time, the launches read around it, and its
    artifacts against the port's host oracles."""
    import torch

    rec = {"phase": "examples", "gpu": gpu, "scripts": {}}
    bad = []
    t_phase = time.perf_counter()
    for name, want in EXAMPLE_KERNELS.items():
        mod = example_script(name)
        for counts in modules.values():
            for key in counts:
                counts[key] = 0
        t0 = time.perf_counter()
        out = mod.run("cuda")
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launched = {f"{m}.{k}": v for m, counts in modules.items()
                    for k, v in counts.items() if v}
        t0 = time.perf_counter()
        checks = example_checks(name, mod, out)
        rec["scripts"][name] = {
            "lines": out["lines"], "wall_s": wall, "launches": launched,
            "checks": checks, "oracle_s": time.perf_counter() - t0,
        }
        bad += [f"{name}: {c}" for c, ok in checks.items() if not ok]
        bad += [f"{name}: {m}.{k} never launched" for m, k in want
                if not launched.get(f"{m}.{k}")]
    rec["seconds"] = time.perf_counter() - t_phase
    if bad:
        emit(rec)
        fail(f"examples: {bad}")
    return rec


def run_main_path(modules: dict, table: dict, phase):
    """Runs ``phase()`` with every launch counter set to 0 just before it;
    returns its record with the launches of ``table``'s kernels, read just
    after it.  Fails if one of them never launched."""
    for counts in modules.values():
        for key in counts:
            counts[key] = 0
    record = phase()
    launches = {name: modules[mod][key]
                for name, (mod, key, _, _) in table.items()}
    record["launches"] = launches
    emit(record)
    if not all(launches.values()):
        fail(f"a kernel of {record['phase']} never launched: {launches}")
    return launches


def main(argv) -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "a CUDA device")
    if not os.path.isdir(os.path.join(REPO, "constriction_tpu_torch")):
        fail(f"constriction_tpu_torch not found next to {__file__}")
    if argv:
        fail(f"unknown arguments {argv}; usage: chip_smoke.py")
    sys.path.insert(0, REPO)
    from constriction_tpu_torch.ops import (coder, coder64, exact_family,
                                            family, range_enc, tchain)

    device = torch.device("cuda", 0)
    build = phase_build()
    emit(build)
    gpu = build["gpu"]
    emit(phase_native())
    modules = {"coder": coder.LAUNCHES, "coder64": coder64.LAUNCHES,
               "range_enc": range_enc.LAUNCHES, "family": family.LAUNCHES,
               "tchain": tchain.LAUNCHES, "exact": exact_family.LAUNCHES}

    emit(phase_geometry(device))
    kernels, errs = phase_kernels(device, N_KERNEL_CHECK, 32768)
    emit(kernels)
    probs, symbols = main_workload()
    containers: dict = {}
    launches = run_main_path(modules, KERNELS,
                             lambda: phase_main(device, probs, symbols,
                                                containers))
    times_rec, times = phase_times(device, probs, symbols, gpu, errs)
    emit(times_rec)
    emit(phase_sweep(device, gpu))

    range_rec, range_errs = phase_range_kernels(device, N_KERNEL_CHECK, 32768)
    emit(range_rec)
    errs.update(range_errs)
    launches.update(run_main_path(
        modules, RANGE_KERNELS,
        lambda: phase_range_main(device, probs, symbols)))
    range_times, more = phase_range_times(device, probs, symbols, gpu, errs)
    emit(range_times)
    times.update(more)
    emit(phase_range_sweep(device, gpu))

    emit(phase_family_math(device))
    family_rec, family_errs = phase_family_kernels(device, N_KERNEL_CHECK,
                                                   32768)
    emit(family_rec)
    errs.update(family_errs)
    work = family_workload(N_FAMILY)
    launches.update(run_main_path(
        modules, FAMILY_KERNELS, lambda: phase_family_main(device, work)))
    family_times, more = phase_family_times(device, work, gpu, errs)
    emit(family_times)
    times.update(more)
    emit(phase_checkpoints(
        device, symbols, containers,
        {"coder": coder.LAUNCHES, "coder64": coder64.LAUNCHES}))
    emit(phase_sharded_bytes(device, probs, symbols))
    sharded: dict = {}
    run_main_path(modules, SHARDED_KERNELS,
                  lambda: phase_sharded_main(device, probs, symbols,
                                             containers, sharded))
    emit(phase_sharded_times(device, sharded, gpu))
    run_main_path(modules, DRYRUN_KERNELS,
                  lambda: phase_sharded_dryrun(device))

    tchain_rec, tchain_errs = phase_tchain_kernels(device, N_KERNEL_CHECK_TCHAIN)
    emit(tchain_rec)
    errs.update(tchain_errs)
    work = cat_workload(N_TCHAIN)
    launches.update(run_main_path(
        modules, TCHAIN_KERNELS, lambda: phase_tchain_main(device, work)))
    tchain_times, more = phase_tchain_times(device, work, gpu, errs)
    emit(tchain_times)
    times.update(more)
    emit(phase_tchain_sweep(device, gpu))
    emit(phase_chain_decode(device, gpu))

    with host_pool() as pool:
        emit(phase_exact_builder(device, pool, errs))
        emit(phase_exact_kernels(device, pool, errs))
    work = exact_workload(N_EXACT)
    keep: dict = {}
    launches.update(run_main_path(
        modules, EXACT_KERNELS, lambda: phase_exact_main(device, work, keep)))
    exact_times, more = phase_exact_times(device, work, keep, gpu, errs)
    emit(exact_times)
    times.update(more)

    keep32: dict = {}
    with host_pool() as pool:
        emit(phase_exact32_kernels(device, pool, errs, keep32))
    work = exact_workload(N_EXACT32)
    launches.update(run_main_path(
        modules, EXACT32_KERNELS,
        lambda: phase_exact32_main(device, work, keep32)))
    exact32_times, more = phase_exact32_times(device, work, keep32, gpu, errs)
    emit(exact32_times)
    times.update(more)

    emit(phase_host_api(device, gpu))
    emit(phase_examples(device, gpu, modules))

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "constriction_tpu"))
    if foreign:
        fail(f"JAX or the JAX package was imported: {foreign}")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": site,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": times[name][2], "bound_by": times[name][3],
         "library_ms": None}
        for name, (_, _, site, source) in {
            **KERNELS, **RANGE_KERNELS, **FAMILY_KERNELS,
            **TCHAIN_KERNELS, **EXACT_KERNELS, **EXACT32_KERNELS}.items()
    ]})
    print(gpu, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
