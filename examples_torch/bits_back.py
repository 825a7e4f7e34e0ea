"""Bits-back coding with latent variables, end to end on a CUDA card.

The classic bits-back setup (the reference motivates its ChainCoder with
it; chain.rs:1-84): a sender compresses a message whose entropy model
depends on a latent variable z.  Instead of paying bits to transmit z, the
sender *decodes* z from the already-compressed tail of its own bitstream
(getting those bits back), encodes the message under model(z), and the
receiver reverses the steps.  Net cost: H(message | z) - H(z under
posterior) + H(z) = the joint optimum.

This demo uses the TChain-16 host coder (``ops/tchain.py``) for the "free
bits" stage and the ILANS2 rANS coder on the card for the payload (encode
kernel 3, decode kernel 4):

  sender:   z      = tchain_decode(tail_of_payload_so_far, posterior)
            stream = ilans2_encode(message, model[z])
  receiver: message = ilans2_decode(stream, model[z]) after recovering z
            and re-encoding the borrowed tail exactly (tchain_encode).

Run: python examples_torch/bits_back.py [--device {cuda,cpu}]
(``cpu`` runs the kernels' plain PyTorch twins; ``cuda``, the default,
raises without a card).  JAX counterpart: ``examples/bits_back.py``.
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
from constriction_tpu_torch.ops import interleaved2 as il2  # noqa: E402
from constriction_tpu_torch.ops import tchain  # noqa: E402
from constriction_tpu_torch.ops.interleaved import LaneConfig  # noqa: E402

L = 256
CFG16 = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=16)
CFG12 = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
NZ = 4
ALPHABET = 64


def inputs() -> dict:
    """The seeded regimes, posterior, message and side information of
    :func:`run`."""
    rng = np.random.RandomState(0)
    # a mixture source: each block is drawn from one of NZ regimes
    mix_probs = [rng.dirichlet(np.full(ALPHABET, c))
                 for c in (0.3, 1.0, 3.0, 10.0)]
    models12 = [
        ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(p, 12)
        for p in mix_probs
    ]
    # posterior over z given the block (here: uniform "free choice" -- the
    # sender may pick ANY z and the bits-back trick refunds the choice)
    posterior = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        np.full(NZ, 1.0 / NZ), 16
    )
    n = L * 64
    z_true = rng.randint(0, NZ)
    message = rng.choice(ALPHABET, size=n, p=mix_probs[z_true]).astype(np.int64)
    # L u16 quantiles of random side-information (in a real system: the
    # tail of previously compressed data)
    side_info = rng.randint(0, 1 << 16, size=L).astype(np.uint16)
    return {"models12": models12, "posterior": posterior, "z_true": z_true,
            "message": message, "side_info": side_info}


def run(device: str = "cuda") -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch finds no CUDA device; "
                           "pass --device cpu to run the plain PyTorch coder")
    x = inputs()
    models12, posterior = x["models12"], x["posterior"]
    message, side_info = x["message"], x["side_info"]
    n = len(message)
    lines = [f"device: {device}"]

    # --- sender ------------------------------------------------------------
    # 1. decode z from the borrowed side information
    z_lanes, rem, heads = tchain.tchain_decode_host(side_info, posterior.cdf,
                                                    CFG16)
    z = int(z_lanes[0])  # all lanes decode i.i.d.; use lane 0's draw
    lines.append(f"latent decoded from side-information: z={z} "
                 f"(true regime {x['z_true']})")

    # 2. encode the message under model[z] with the ILANS2 coder
    container = il2.encode_iid_categorical2(message, models12[z].cdf, CFG12,
                                            device=device)
    payload_bits = len(container) * 32
    cdf_z = models12[z].cdf.astype(np.float64)
    info_bits = -np.sum(np.log2((cdf_z[message + 1] - cdf_z[message]) / 4096.0))
    lines.append(
        f"payload: {payload_bits} bits for {info_bits:.0f} bits of information "
        f"({payload_bits / n:.3f} bits/sym vs {info_bits / n:.3f} optimal "
        "under model[z])"
    )

    # --- receiver ----------------------------------------------------------
    # recovers z the same way (same side information), decodes the message,
    # then returns the borrowed bits exactly
    z2_lanes, rem2, heads2 = tchain.tchain_decode_host(side_info,
                                                       posterior.cdf, CFG16)
    z2 = int(z2_lanes[0])
    assert z2 == z
    out = il2.decode_iid_categorical2(container, models12[z2].cdf,
                                      device=device)
    assert np.array_equal(out, message), "message round trip failed"

    recovered_side, h_final = tchain.tchain_encode_host(
        z2_lanes, rem2, heads2, posterior.cdf, CFG16
    )
    assert np.array_equal(recovered_side, side_info) and np.all(h_final == 1)
    lines.append("bits-back round trip exact: message recovered, "
                 "side-information returned")
    return {"lines": lines, "z": z, "remainders": rem, "heads": heads,
            "container": container, "decoded": out,
            "recovered_side_info": recovered_side}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    for line in run(args.device)["lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
