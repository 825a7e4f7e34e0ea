"""Data-parallel entropy coding over a list of devices.

The scaling story for an entropy coder is embarrassingly parallel: split
the message into D independent blocks and give every device its own
lane-interleaved coder (``parallel.shard_encode2_cuda`` /
``shard_decode2_cuda``: encode kernel 3, decode kernel 4 on each card).
Each leg is one block program: one upload a device, every device's
blocks launched with nothing read back in between, so all D cards code
at once, then a fixed number of read-backs a device.  Each block comes
back as its own ``(lane states, stream)`` pair; the container is the
in-order concatenation of the block streams on the host (the JAX
example's ``all_gather`` becomes those read-backs; no collective runs
between the cards).

``--device cpu`` codes the blocks on eight "cpu" entries (the JAX
example's virtual 8-device mesh) with the kernels' plain PyTorch twins;
``--device cuda``, the default, on every card torch sees, and raises
without one.
Reference anchor: constriction has no distributed path; the closest seam
is its pluggable word-I/O backend (backends.rs).

Run: python examples_torch/multichip_sharded.py [--device {cuda,cpu}]
JAX counterpart: ``examples/multichip_sharded.py``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from constriction_tpu_torch.models import (  # noqa: E402
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu_torch.ops.interleaved import LaneConfig  # noqa: E402
from constriction_tpu_torch.parallel import (  # noqa: E402
    shard_decode2_cuda,
    shard_encode2_cuda,
)

K = 300  # > 255, as the JAX example (its kernels' two-level compare-sum)
CFG = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
BLOCK_LEN = 4000
CPU_DEVICES = 8


def devices(device: str) -> list:
    """Every card under ``"cuda"``, eight ``"cpu"`` entries under
    ``"cpu"``."""
    if device == "cpu":
        return ["cpu"] * CPU_DEVICES
    found = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if not found:
        raise RuntimeError("--device cuda but torch finds no CUDA device; "
                           "pass --device cpu to run the plain PyTorch coder")
    return found


def inputs(D: int) -> dict:
    """The seeded CDF and D-block message of :func:`run`."""
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.full(K, 1.5))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    ).cdf
    message = rng.choice(K, size=D * BLOCK_LEN, p=probs).astype(np.int64)
    return {"cdf": cdf, "message": message}


def run(device: str = "cuda") -> dict:
    devs = devices(device)
    D = len(devs)
    lines = [f"devices: {D} x {torch.device(devs[0]).type}"]
    x = inputs(D)
    cdf, message = x["cdf"], x["message"]
    n = len(message)

    # --- encode: one coder per device ---------------------------------------
    blocks = list(message.reshape(D, BLOCK_LEN))
    coded = shard_encode2_cuda(blocks, cdf, CFG, device=devs)
    states = [st for st, _ in coded]
    streams = [sw for _, sw in coded]
    total_bits = sum(len(s) for s in streams) * 16 + D * CFG.num_lanes * 32
    info = -np.sum(
        np.log2((cdf.astype(np.float64)[message + 1] - cdf[message]) / (1 << 12))
    )
    lines.append(f"encoded {n} symbols into {D} blocks: "
                 f"{total_bits / n:.3f} bits/sym (bound {info / n:.3f})")

    # --- decode: independent per device -----------------------------------
    out = shard_decode2_cuda(states, streams, cdf, CFG, BLOCK_LEN,
                             device=devs)
    decoded = np.concatenate(out)
    assert np.array_equal(decoded, message)
    lines.append("sharded decode: bit-exact round trip across the devices")

    # --- the container: in-order concatenation of the block streams -------
    container = np.concatenate(streams)
    lines.append(f"gathered container: {len(container)} words from {D} "
                 "devices (the block streams in order, on the host)")
    return {"lines": lines, "devices": devs, "states": states,
            "streams": streams, "decoded": decoded, "container": container,
            "bits_per_symbol": total_bits / n}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    for line in run(args.device)["lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
