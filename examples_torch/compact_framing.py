"""Whole-message rate parity: the compact (v2) container framing.

A reference (constriction) user's file is `stream + <= 2 flush words`.  A
parallel format keeps L independent lane states, which naively costs L*S
header bits per message.  The v2 framing (``ops/framing.py``) removes
almost all of it:

- lane states are stored at their exact variable widths;
- the last k_B symbols are encoded FIRST and their compressed stream
  rides inside the main region's seed states -- rANS decoding provably
  returns the lane states to the encoder's seeds, so those bits are
  recovered payload, not header.

This example encodes one message three ways and prints the byte counts:
the raw v1 container, the compact v2 container (the facade default; both
encoded by kernel 2, the v2 one decoded by kernel 1), and the bit-exact
host AnsCoder twin of the reference's own framing.  The byte counts
depend on the format alone.  A checkpoint seek (kernel 1 again) closes
it.

Run: python examples_torch/compact_framing.py [--device {cuda,cpu}]
(``cpu`` runs the kernels' plain PyTorch twins; ``cuda``, the default,
raises without a card).  JAX counterpart: ``examples/compact_framing.py``.
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
from constriction_tpu_torch.ops.ans import AnsCoderCore  # noqa: E402

P = 24
N = 1 << 20
INTERVAL = 16


def inputs() -> dict:
    """The seeded CDF and message of :func:`run`."""
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.full(100, 2.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    ).cdf
    p = np.diff(cdf.astype(np.float64)) / (1 << P)
    symbols = rng.choice(100, size=N, p=p).astype(np.int64)
    return {"cdf": cdf, "p": p, "symbols": symbols}


def run(device: str = "cuda") -> dict:
    x = inputs()
    cdf, p, symbols = x["cdf"], x["p"], x["symbols"]
    info_bytes = -np.log2(p[symbols]).sum() / 8

    v2 = ctt.encode_iid(symbols, cdf, device=device)  # compact default
    v1 = ctt.encode_iid(symbols, cdf, compact=False, device=device)
    decoded = ctt.decode_iid(v2, cdf, device=device)
    assert np.array_equal(decoded, symbols)

    ref = AnsCoderCore(word_bits=32, state_bits=64)
    cdf64 = cdf.astype(np.uint64)
    ref.encode_reverse_tables(
        cdf64[symbols].astype(np.uint32),
        (cdf64[symbols + 1] - cdf64[symbols]).astype(np.uint32), P,
    )
    ref_words = ref.get_compressed()
    ref_bytes = len(ref_words) * 4

    lines = [f"message: {N} symbols, information content {info_bytes:,.0f} B"]
    for name, nbytes in [
        ("reference framing (bit-exact host twin)", ref_bytes),
        ("container v1 (raw lane states)", len(v1) * 4),
        ("container v2 (compact, facade default)", len(v2) * 4),
    ]:
        lines.append(
            f"  {name:44s} {nbytes:>9,} B "
            f"(+{(nbytes - info_bytes) / info_bytes * 100:6.3f}% vs bound)"
        )
    lines.append(
        f"  v2 vs reference file size: {len(v2) * 4 / ref_bytes:.5f}x "
        "(the residual is the ~4 bits/lane ensemble entropy of "
        "independent lane states)"
    )

    # random access still works on the compact container
    offs, sts = ctt.build_checkpoints(v2, cdf, INTERVAL)
    start, suffix = ctt.decode_from_checkpoint(v2, cdf, INTERVAL,
                                               len(offs) // 2, offs, sts,
                                               device=device)
    assert np.array_equal(suffix, symbols[start:])
    lines.append(f"  checkpoint seek from symbol {start}: bit-exact suffix")
    return {"lines": lines, "v2": v2, "v1": v1, "decoded": decoded,
            "reference_words": ref_words, "offsets": offs, "states": sts,
            "seek_start": start, "suffix": suffix}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    for line in run(args.device)["lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
