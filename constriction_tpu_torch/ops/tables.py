"""Entropy-model tables built on the tensor's device, in torch operations.

JAX counterpart: ``constriction_tpu.ops.tables_jax``.  None of these
needs a kernel: each is a handful of elementwise operations and one
cumulative sum, which run where their input tensors live.

Exactness: the host builder (``models.fast_quantized_cdf``, a copy of
the reference's) accumulates the probabilities with a *sequential*
left-to-right sum; ``torch.cumsum`` may associate differently (on the
CPU it accumulates in float64, on a CUDA device in a parallel scan), as
XLA's cumsum may in the JAX package.  So a table built here can differ
from the host-built one in the last ulp of the cumulative sum: it is a
valid leaky model, within 1 of the host's in every entry at P <= 16.  At
P = 24 one float32 ulp of a cumulative sum near 1 is one unit of the
table, so the two differ by up to 1 + 2^P (max_k |cumsum_k - host_k| +
|sum - host_sum|); the JAX builder's table differs from the host's in the
same way (by 2 for a seeded 250-symbol PMF, as the port's does).
Containers are keyed to the table that built them: use the host builder
where bit compatibility with constriction is needed, this one where the
model comes out of a network on the card (encode and decode take
explicit tables, so the codec is always self-consistent).

Tensor layout (constriction_tpu_torch/convert.py): CDF tables int64.
"""

from __future__ import annotations

import torch

from . import family as _family


def fast_quantized_cdf(probabilities: torch.Tensor,
                       precision: int) -> torch.Tensor:
    """Length-(n+1) fixed-point CDF, int64 on the tensor's device, last
    entry ``2**precision``: ``left_k = trunc(cumsum_{<k} * scale) + k``
    with ``scale = (2^P - n) / sum`` in float32; the ``+ k`` slack makes
    every symbol leaky (prob >= 1).  A float32 truncation that overshoots
    the free weight (possible for adversarial PMFs, where the host
    builder raises) is clamped to ``2^P - n + k``, so the table stays a
    valid leaky model.  JAX counterpart:
    ``tables_jax.fast_quantized_cdf_jax``."""
    if not isinstance(probabilities, torch.Tensor):
        raise TypeError("probabilities must be a torch.Tensor")
    probs = probabilities.reshape(-1).to(torch.float32)
    n = probs.numel()
    if n < 2 or n >= (1 << precision) - 1:
        raise ValueError("invalid number of probabilities")
    free_weight = (1 << precision) - n
    cumsum = torch.cumsum(probs, 0)
    # tensor / tensor: a correctly rounded float32 division on every device
    scale = torch.full_like(cumsum[-1], free_weight) / cumsum[-1]
    cumulative = torch.cat([cumsum.new_zeros(1), cumsum[:-1]])
    k = torch.arange(n, dtype=torch.int64, device=probs.device)
    left = torch.trunc(cumulative * scale).to(torch.int64) + k
    left = torch.minimum(left, free_weight + k)
    return torch.cat([left, left.new_full((1,), 1 << precision)])


def uniform_cdf(size: int, precision: int, device="cuda") -> torch.Tensor:
    """Closed-form uniform model table, int64 on ``device`` (reference
    uniform.rs:24-77): each bin gets ``2^P // size``, the last bin absorbs
    the remainder.  ``device`` as in ``cuda.py``: ``"cuda"`` (the default)
    raises without a card.  JAX counterpart: ``tables_jax.uniform_cdf_jax``."""
    from ..cuda import _device

    dev = _device(device)
    if size <= 1:
        raise ValueError("UniformModel requires range > 1")
    if size - 1 > (1 << precision) - 1:
        raise ValueError("range too large for precision")
    ppb = (1 << precision) // size
    left = torch.arange(size, dtype=torch.int64, device=dev) * ppb
    return torch.cat([left, left.new_full((1,), 1 << precision)])


def family_tables(symbols: torch.Tensor, means: torch.Tensor,
                  scales: torch.Tensor, family: str, min_sym: int,
                  max_sym: int):
    """``(cum, prob)`` int32 tensors (u32 values) of ``symbols`` under
    their per-symbol models of a device family (gaussian, laplace,
    logistic, cauchy) at P=12, with the pinned endpoints, on the tensors'
    device: ``ops.family.tables`` on int32 symbols, float32 means and the
    float32 reciprocals of the scales.  The integer CDF is device
    invariant, so the tables equal the host oracle's
    (``family.family_tables_host``) bit for bit.  JAX counterpart:
    ``tables_jax.family_tables_jax`` (its ``precision`` argument is the
    port's fixed 12)."""
    for name, t in (("symbols", symbols), ("means", means),
                    ("scales", scales)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if family not in _family.FAMILIES:
        raise ValueError(
            f"family must be one of {_family.FAMILIES}, got {family!r}")
    sym = symbols.to(torch.int32)
    scales32 = scales.to(torch.float32)
    # tensor / tensor: torch would multiply by a rounded reciprocal for a
    # Python scalar numerator on a CUDA tensor
    inv_scale = torch.ones_like(scales32) / scales32
    return _family.tables(torch, family, int(min_sym), int(max_sym), sym,
                          means.to(torch.float32), inv_scale)
