#!/usr/bin/env python3
"""The DEFAULT-preset rANS decode (kernel 1, the cluster decode) timed in
several checkouts on one card, one after another in the order given.

    git archive <commit> | tar -x -C _scratch/parent
    python3 chip_ab.py _scratch/parent . . _scratch/parent

Each checkout runs in a process of its own (the packages share a name),
builds its kernels, codes bench.py's workload (2^25 symbols, K=100,
Dirichlet(2), seed 1234) at W=32/S=64, L=32768, P=24 and P=12, checks the
decode against the symbols, and prints one JSON line: the checkout and,
for each P, five CUDA-event timings of ten decode launches each (ms per
launch).  Give the checkouts in turns (parent, change, change, parent) to
compare two versions within one call.  Needs a CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

N = 1 << 25
K = 100
LANES = 32768
REPS, LAUNCHES = 5, 10


def time_decodes(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from constriction_tpu_torch import convert
    from constriction_tpu_torch.models import fast_quantized_cdf
    from constriction_tpu_torch.ops import _build, coder64
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
    for P in (24, 12):
        cdf = convert.cdf_to_torch(fast_quantized_cdf(probs, P), dev)
        cfg = LaneConfig(num_lanes=LANES, word_bits=32, state_bits=64,
                         precision=P)
        st, w = coder64.encode_iid64(syms, cdf, cfg)
        if not torch.equal(coder64.decode_shared64(st, w, cdf, cfg, N),
                           syms):
            sys.exit(f"chip_ab: {root} decodes wrong symbols at P={P}")
        torch.cuda.synchronize()
        ms = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(LAUNCHES):
                coder64.decode_shared64(st, w, cdf, cfg, N)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / LAUNCHES)
        out[f"decode_P{P}_ms"] = ms
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_decodes(argv[1])), flush=True)
        return 0
    if not argv:
        sys.exit("usage: chip_ab.py CHECKOUT [CHECKOUT ...]")
    for root in argv:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root])
        if done.returncode != 0:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
