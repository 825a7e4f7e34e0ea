"""Reference-exact family coding and a checkpoint seek on a CUDA card.

Round-trip a constriction-modeled message, then seek-decode a stream.
Two capabilities in one walkthrough:

1. REFERENCE-EXACT per-symbol families (``ops/exact_family.py``): the
   model tables are the host f64 LeakyQuantizer's -- bit-identical to what
   `constriction.stream.model.QuantizedGaussian` would use -- while the
   whole rANS coding loop runs on the card (encode kernel 14, decode
   kernel 13 on host-built narrow tables).  A message modeled by the
   reference re-codes with ZERO rate change.

2. Random access (``interleaved2.build_checkpoints``): periodic decoder
   snapshots let any suffix of an ILANS2 stream be decoded from the
   middle, bit-exactly, without touching the prefix (kernel 4) -- the
   interleaved analog of the reference's Pos/Seek jump tables
   (stack.rs:643-700).

``--device cpu`` runs the kernels' plain PyTorch twins at the small size
(20,000 symbols, 256 lanes); ``--device cuda``, the default, runs the
kernels at the card size (2,000,000 symbols, 8192 lanes) and raises
without a card.

Run: python examples_torch/reference_exact_and_seek.py [--device {cuda,cpu}]
JAX counterpart: ``examples/reference_exact_and_seek.py``.
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
from constriction_tpu_torch.ops import exact_family as ef  # noqa: E402
from constriction_tpu_torch.ops import interleaved2 as il2  # noqa: E402
from constriction_tpu_torch.ops.interleaved import LaneConfig  # noqa: E402

# (symbols, lanes) on the CPU and on the card, as the JAX example's default
# and --tpu sizes
SIZES = {"cpu": (20_000, 256), "cuda": (2_000_000, 8192)}
INTERVAL = 8


def inputs(device: str) -> dict:
    """The seeded family message and i.i.d. message of :func:`run` at the
    device's size."""
    n, L = SIZES[device]
    rng = np.random.RandomState(0)
    # a toy "prior network" emits per-symbol Gaussian parameters
    means = rng.uniform(-40, 40, n)
    stds = np.exp(rng.uniform(np.log(0.5), np.log(6.0), n))
    symbols = np.clip(np.round(means + rng.randn(n) * stds), -100, 100).astype(
        np.int64
    )
    probs_c = rng.dirichlet(np.full(50, 1.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs_c, 12
    ).cdf
    msg = rng.choice(50, size=n, p=probs_c).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    return {"cfg": cfg, "means": means, "stds": stds, "symbols": symbols,
            "cdf": cdf, "msg": msg}


def run(device: str = "cuda") -> dict:
    x = inputs(device)
    cfg, means, stds, symbols = x["cfg"], x["means"], x["stds"], x["symbols"]
    n, L = len(symbols), cfg.num_lanes
    lines = []

    # --- 1. reference-exact neural-latents round trip -------------------
    states, stream = ctt.encode_family_exact(symbols, means, stds, "gaussian",
                                             -100, 100, cfg=cfg, device=device)
    bits = len(stream) * 16 + L * 32
    cums, probs = ef.exact_ecp(symbols, means, stds, "gaussian", -100, 100, 12)
    info = -np.sum(np.log2(probs.astype(np.float64) / 4096.0))
    lines.append(f"reference-exact gaussian family: {n} symbols, "
                 f"{bits / n:.3f} bits/sym (information content "
                 f"{info / n:.3f}; header amortizes with n)")
    out = ctt.decode_family_exact(states, stream, means, stds, "gaussian",
                                  -100, 100, n, cfg=cfg, cmax=128,
                                  device=device)
    assert np.array_equal(out, symbols)
    lines.append("on-device decode matches (tables == host f64 "
                 "LeakyQuantizer)")

    # --- 2. seek-decode an i.i.d. stream from the middle -----------------
    cdf, msg = x["cdf"], x["msg"]
    cdf64 = cdf.astype(np.uint64)
    st2, stream2 = il2.encode_shared(cdf64[msg], cdf64[msg + 1] - cdf64[msg],
                                     cfg)
    offs, cst = il2.build_checkpoints(st2, stream2, n, cdf, cfg, INTERVAL)
    c = len(offs) // 2
    start, suffix = il2.decode_from_checkpoint(c, offs, cst, stream2, n, cdf,
                                               cfg, INTERVAL, device=device)
    assert np.array_equal(suffix, msg[start:])
    lines.append(f"seek-decode from checkpoint {c}: symbols [{start}:{n}) "
                 f"recovered without decoding the prefix ({len(offs)} "
                 f"checkpoints, every {INTERVAL * L} symbols)")
    return {"lines": lines, "states": states, "stream": stream,
            "decoded": out, "iid_states": st2, "iid_stream": stream2,
            "offsets": offs, "checkpoint_states": cst, "seek_start": start,
            "suffix": suffix}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    for line in run(args.device)["lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
