"""The reference's DEFAULT preset (W=32 / S=64 / P=24) on a CUDA card.

constriction's Python API pins the "default" preset: 32-bit stream words,
64-bit coder states, 24-bit fixed-point probabilities (the reference's
src/stream/stack.rs:139).  This example codes that exact preset with the
port's kernels (``constriction_tpu_torch.cuda``):

1. i.i.d. categorical message against a P=24 CDF -> compact ILANS2
   container (encode kernel 2, decode kernel 1);
2. the same message through the default-preset RANGE coder (phase A and
   B, kernels 9 and 10; decode kernel 5);
3. a per-symbol Gaussian message against the REFERENCE-EXACT P=24
   LeakyQuantizer tables (host f64 model math identical to the
   reference's quantize.rs:525-568 at PRECISION=24; encode kernel 17,
   tables on the card by kernel 18, decode kernel 15).

Run: python examples_torch/default_preset.py [--device {cuda,cpu}]
(``cpu`` runs the kernels' plain PyTorch twins; ``cuda``, the default,
raises without a card).  JAX counterpart: ``examples/default_preset.py``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import constriction_tpu_torch.cuda as ctt  # noqa: E402
from constriction_tpu_torch.models import (  # noqa: E402
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu_torch.ops.interleaved import LaneConfig  # noqa: E402

K, N = 100, 20000
CFG = LaneConfig(num_lanes=256, word_bits=32, state_bits=64, precision=24)


def inputs() -> dict:
    """The seeded message, CDF and per-symbol Gaussians of :func:`run`."""
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf24 = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24
    ).cdf
    symbols = rng.choice(K, size=N, p=probs)
    m = rng.uniform(-60, 60, N)
    s = np.exp(rng.uniform(np.log(0.3), np.log(5.0), N))
    fsym = np.clip(np.round(m + rng.randn(N) * s), -100, 100).astype(np.int64)
    return {"cdf": cdf24, "symbols": symbols, "means": m, "scales": s,
            "family_symbols": fsym}


def run(device: str = "cuda") -> dict:
    x = inputs()
    cdf24, symbols = x["cdf"], x["symbols"]
    lines = []

    # 1. rANS at the default preset, both directions on the device
    container = ctt.encode_iid(symbols, cdf24, cfg=CFG, device=device)
    decoded = ctt.decode_iid(container, cdf24, device=device)
    assert np.array_equal(decoded, symbols)
    info = -np.sum(np.log2(
        (cdf24.astype(np.float64)[symbols + 1] - cdf24[symbols]) / 2.0**24
    ))
    lines.append(f"rANS default preset: {N} symbols, "
                 f"{len(container) * 32} container bits "
                 f"({len(container) * 32 / info - 1:+.3%} vs the information "
                 "bound, incl. the per-lane header)")

    # 2. range coding at the default preset
    points, stream = ctt.encode_iid_range(symbols, cdf24, cfg=CFG,
                                          device=device)
    rdecoded = ctt.decode_iid_range(points, stream, cdf24, N, cfg=CFG,
                                    device=device)
    assert np.array_equal(rdecoded, symbols)
    lines.append("range default preset: round trip OK "
                 f"({len(stream)} stream words + {len(points)} u64 points)")

    # 3. reference-exact P=24 per-symbol Gaussians on the device
    m, s, fsym = x["means"], x["scales"], x["family_symbols"]
    st, w = ctt.encode_family_exact(fsym, m, s, "gaussian", -100, 100,
                                    cfg=CFG, device=device)
    out = ctt.decode_family_exact(st, w, m, s, "gaussian", -100, 100, N,
                                  cfg=CFG, cmax=202, device=device)
    assert np.array_equal(out, fsym)
    lines.append("reference-exact P=24 Gaussian family: round trip OK "
                 "(tables bit-identical to constriction's default-preset "
                 "quantizer)")
    return {"lines": lines, "container": container, "decoded": decoded,
            "points": points, "stream": stream, "range_decoded": rdecoded,
            "family_states": st, "family_stream": w, "family_decoded": out}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    for line in run(args.device)["lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
