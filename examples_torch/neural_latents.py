"""Neural-compression latents end to end (BASELINE config 5).

Workload: a Q.npz-style tensor of latents modeled by per-element quantized
Gaussians (the standard deep-compression setup); here a synthetic
512 x 512 tensor made from a seed.  Pipeline:

1. quantize latents to integers (the "symbols");
2. build exact fixed-point (cum, prob) tables from the per-element
   Gaussian parameters (the host codec, C++, bit-exact with constriction);
3. encode with the ILANS v2 shared-stream interleaved format (the host
   codec) into a v1 container;
4. decode it on the host with the per-element models
   (``interleaved2.decode_shared_quantized``, the host codec inverting
   each symbol's model);
5. the device family codec: ``cuda.encode_family`` / ``decode_family``
   evaluate the leaky quantizer inside the kernels in exact integer
   arithmetic (encode kernel 12, decode kernel 11, gaussian), with the
   per-element parameters and no host tables.

Run: python examples_torch/neural_latents.py [--device {cuda,cpu}]
(``cpu`` runs the kernels' plain PyTorch twins; ``cuda``, the default,
raises without a card).  JAX counterpart: ``examples/neural_latents.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import constriction_tpu_torch.cuda as ctt  # noqa: E402
from constriction_tpu_torch.models import QuantizedFamily  # noqa: E402
from constriction_tpu_torch.ops import interleaved2 as il2  # noqa: E402
from constriction_tpu_torch.ops.interleaved import LaneConfig  # noqa: E402

CFG = LaneConfig(num_lanes=1024, word_bits=16, state_bits=32, precision=12)
SCALE = 40.0
SUPPORT = (-100, 100)


def inputs() -> dict:
    """The seeded latents, their per-element Gaussians and symbols."""
    rng = np.random.RandomState(0)
    q = rng.randn(512, 512) * 0.1
    stds = 0.05 + np.abs(q).reshape(-1) * 2.0
    means = np.zeros(q.size)
    symbols = np.clip(np.round(q.reshape(-1) * SCALE),
                      *SUPPORT).astype(np.int32)
    return {"q": q, "means": means, "stds": stds, "symbols": symbols}


def run(device: str = "cuda") -> dict:
    x = inputs()
    q, means, stds, symbols = x["q"], x["means"], x["stds"], x["symbols"]
    n = q.size
    lines = [f"device: {device}"]

    fam = QuantizedFamily("gaussian", *SUPPORT, means, stds, precision=12)
    t0 = time.perf_counter()
    cums, probs = fam.ecp_all(symbols)
    t_tables = time.perf_counter() - t0

    # --- encode (host codec, shared-stream interleaved) ---
    t0 = time.perf_counter()
    init_states, stream = il2.encode_shared(cums, probs, CFG)
    t_enc = time.perf_counter() - t0
    data = il2.pack_container2(init_states, stream, n, CFG)

    info_bits = -np.sum(np.log2(probs.astype(np.float64) / (1 << 12)))
    lines.append(f"latents: {n} symbols; tables {t_tables*1e3:.0f} ms; "
                 f"encode {t_enc*1e3:.0f} ms")
    lines.append(f"compressed: {len(data) * 4} bytes "
                 f"({len(data) * 32 / n:.3f} bits/symbol vs "
                 f"{info_bits / n:.3f} optimal)")

    # --- decode: exact per-element decode on the host (host codec) ---
    t0 = time.perf_counter()
    init2, stream2, n2, cfg2 = il2.unpack_container2(data)
    out_host = il2.decode_shared_quantized(init2, stream2, n2, fam,
                                           cfg2).astype(np.int64)
    t_dec = time.perf_counter() - t0
    assert np.array_equal(out_host, symbols)
    lines.append(f"host family decode: {t_dec*1e3:.0f} ms -- round trip exact")

    rec = out_host.astype(np.float64) / SCALE
    mse = float(np.mean((rec - q.reshape(-1)) ** 2))
    lines.append(f"reconstruction MSE from quantization: {mse:.2e} "
                 "(lossless coding verified)")

    # --- the device family codec (kernels 12 and 11) ---
    # Its bitstream is keyed to the integer CDF, i.e. distinct from the
    # host-f64 container above, but identical on every device.  The calls
    # return numpy arrays, so their times include the card's work.
    means32, stds32 = means.astype(np.float32), stds.astype(np.float32)
    t0 = time.perf_counter()
    dstates, dstream = ctt.encode_family(symbols, means32, stds32, "gaussian",
                                         *SUPPORT, cfg=CFG, device=device)
    t_enc_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_dev = ctt.decode_family(dstates, dstream, means32, stds32, "gaussian",
                                *SUPPORT, n, cfg=CFG, device=device)
    t_dec_dev = time.perf_counter() - t0
    assert np.array_equal(out_dev, symbols)
    dev_bits = (len(dstream) * 16 + CFG.num_lanes * 32) / n
    what = ("incl. the transfers and any first-call kernel build"
            if device == "cuda" else "the kernels' plain PyTorch twins")
    lines.append(
        f"device family codec ({device}): encode {t_enc_dev*1e3:.0f} ms, "
        f"decode {t_dec_dev*1e3:.0f} ms ({what}), {dev_bits:.3f} "
        "bits/symbol -- round trip exact"
    )
    return {"lines": lines, "container": data, "host_decoded": out_host,
            "family_states": dstates, "family_stream": dstream,
            "family_decoded": out_dev,
            "seconds": {"tables": t_tables, "encode": t_enc,
                        "host_decode": t_dec, "device_encode": t_enc_dev,
                        "device_decode": t_dec_dev}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    for line in run(args.device)["lines"]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
