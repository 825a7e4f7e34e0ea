"""Range-coder inputs at the DEFAULT preset (W=32, S=64, P=24) that reach
the W=32 edge of phase B: a provisional word of 0xFFFFFFFF that a later
carry wraps to 0 (word + carry = 2^32).  Random data almost never does
(a lane's interval must hold a multiple of 2^64 as it renorms), so the
symbols are chosen.  Numpy only: the CPU tests and the card tests
(``tests/test_torch_cuda.py``, which imports no JAX) share it.
"""

import numpy as np

P = 24


def carry_through_ones(L, n, seed):
    """``(symbols int64[n], cdf u32[257])`` for L lanes of the S=64 range
    coder (P=24): symbols of a uniform 256-symbol model chosen per lane so
    that a word of 0xFFFFFFFF takes a carry.  The lane tracks the point
    a * 2^32 of its first window (a random), coding at each step the
    symbol whose interval holds it, so its first renorm emits a - 1 and
    the next ones, where the point sits at 2^64 of the window, emit
    0xFFFFFFFF while lower stays below it; after three renorms it codes the
    top symbol, whose interval lies above the point, and lower wraps (the
    carry).  The rest is uniform."""
    rng = np.random.RandomState(seed)
    K = 256
    cdf = (np.arange(K + 1, dtype=np.int64) << 16).astype(np.uint32)
    T = -(-n // L)
    syms = rng.randint(0, K, size=(T, L))
    for lane in range(L):
        rg = (1 << 64) - 1
        x = int(rng.randint(1 << 30, 3 << 30)) << 32  # the point - lower
        renorms = 0
        for t in range(T):
            scale = rg >> P
            s = K - 1
            if renorms < 3 or scale * int(cdf[s]) <= x:
                s = x // scale >> 16  # the symbol holding the point
            if s >= K:
                break  # the point fell in the range's rounding gap
            syms[t, lane] = s
            x -= scale * int(cdf[s])
            rg = scale * int(cdf[s + 1] - cdf[s])
            if x < 0:
                break  # lower passed the point
            if rg < 1 << 32:
                rg, x, renorms = rg << 32, x << 32, renorms + 1
    return syms.reshape(-1)[:n].astype(np.int64), cdf
