#!/usr/bin/env python3
"""The S=32 reference-exact phases of chip_smoke.py alone, on one card.

    python3 chip_sweep32.py

Runs ``exact32_kernels`` (kernels 14 and 13 against their twins and the
host oracles), ``exact32_main_path`` (the facade's default exact call on
2^20 symbols) and ``exact32_times`` (kernel and twin times, bounds, the narrow
scan-or-search sweep that fixes ``exact_family.BISECT_FROM_PLANES_NARROW``
and kernel 13's time per step over L) as chip_smoke.py does, in a
few minutes instead of the whole script's; prints one JSON object per
phase, then the card's name and power limit.  Needs a CUDA device and
nvcc, as chip_smoke.py does.
"""

import sys

import chip_smoke as cs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a CUDA "
                "device")
    from constriction_tpu_torch.ops import (coder, coder64, exact_family,
                                            family, range_enc, tchain)

    device = torch.device("cuda", 0)
    gpu = cs.gpu_line()
    modules = {"coder": coder.LAUNCHES, "coder64": coder64.LAUNCHES,
               "range_enc": range_enc.LAUNCHES, "family": family.LAUNCHES,
               "tchain": tchain.LAUNCHES, "exact": exact_family.LAUNCHES}
    errs, keep = {}, {}
    with cs.host_pool() as pool:
        cs.emit(cs.phase_exact32_kernels(device, pool, errs, keep))
    work = cs.exact_workload(cs.N_EXACT32)
    cs.run_main_path(modules, cs.EXACT32_KERNELS,
                     lambda: cs.phase_exact32_main(device, work, keep))
    cs.emit(cs.phase_exact32_times(device, work, keep, gpu, errs)[0])
    print(gpu, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
