"""State carried between the JAX package and the port.

This system has no weights.  What crosses between the packages is integer
data, and the port holds it in signed torch dtypes as bit patterns, because
torch has few operations on unsigned integers:

- u32 data (stream words, S <= 32 lane states, range points and planes)
  -> ``torch.int32`` holding the same 32 bits;
- u64 data (S = 64 lane states, range points and planes) ->
  ``torch.int64`` holding the same 64 bits, so values >= 2^63 read as
  negative and come back unchanged;
- CDF tables -> ``torch.int64`` values (they are below 2^25);
- per-symbol model parameters (the device families' means and scales) ->
  ``torch.float32``, padded to whole coding steps;
- 12-bit quantiles (TChain-12 bits-back) -> the packed u32 planes of
  ``ops.tchain.pack_q12`` as int32 bit patterns;
- 16-bit quantiles (TChain-16) -> the planar u32 words of
  ``ops.tchain.pack_quantiles`` as int32 bit patterns;
- 24-bit quantiles (TChain-24) -> one u32 word each (:func:`u32_to_torch`);
  TChain-24 remainder heads are u64 data (:func:`u64_to_torch`);
- the reference-exact families' f64 means and scales -> ``torch.float64``
  (:func:`params64_to_torch`), their per-symbol (cum, prob) u32 planes ->
  int32 ``[T, L]`` (:func:`ecp_to_torch`) and their packed wide decode
  tables ``u32[T, CP1, R, 128]`` -> int32 ``[T, CP1, L]``
  (:func:`exact_tables_to_torch`);
- the JAX package's block-leg inputs (``parallel.sharding``): ``[..., 128]``
  u32 tiles (padded streams, planar quantile words) -> flat int32
  (:func:`rows_to_torch`), ``f32[T, 2, R, 128]`` family parameters ->
  two float32 ``[T * L]`` (:func:`family_params_to_torch`).

Kernels read these buffers as ``uint32_t`` / ``uint64_t``; the plain twins
widen them with :func:`u32_values` / :func:`u64_halves`.

A block program (``parallel``) moves its data in bulk: :func:`upload` puts
many tensors on a device in one transfer, and :func:`read_back` brings the
outputs of many launches back in at most two, through :func:`to_host`.

JAX counterpart of this module: the JAX package keeps the same data as
numpy u32/u64 arrays and moves them with ``jnp.asarray``; its S=64 kernels
split u64 states into (hi, lo) u32 tiles
(``pallas_coder64.decode_shared64_pallas``), as :func:`u64_halves` does.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.interleaved import LaneConfig

_M32 = 0xFFFFFFFF


def u32_to_torch(words, device="cpu") -> torch.Tensor:
    """u32 numpy data -> int32 tensor with the same bits on ``device``.
    JAX counterpart: ``jnp.asarray(words, jnp.uint32)``."""
    a = np.ascontiguousarray(np.asarray(words, dtype=np.uint32).reshape(-1))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def u32_from_torch(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`u32_to_torch`: u32 numpy array.  JAX
    counterpart: ``np.asarray(array, np.uint32)``."""
    return t.detach().to("cpu", torch.int32).contiguous().numpy().view(
        np.uint32
    ).copy()


def u64_to_torch(values, device="cpu") -> torch.Tensor:
    """u64 numpy data -> int64 tensor with the same bits on ``device``.
    JAX counterpart: the (hi, lo) u32 split in
    ``pallas_coder64.encode_iid64_pallas`` (JAX has no u64 on the TPU)."""
    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint64).reshape(-1))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def u64_from_torch(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`u64_to_torch`: u64 numpy array.  JAX
    counterpart: the (hi, lo) join in ``pallas_coder64`` wrappers."""
    return t.detach().to("cpu", torch.int64).contiguous().numpy().view(
        np.uint64
    ).copy()


def states_to_torch(states, cfg: LaneConfig, device="cpu") -> torch.Tensor:
    """Lane states (u32 for S <= 32, u64 for S = 64, as the JAX package
    returns them) -> the port's layout: int32 or int64 bit patterns.
    JAX counterpart: ``interleaved._state_dtype`` picks the same widths."""
    if cfg.state_bits > 32:
        return u64_to_torch(states, device)
    return u32_to_torch(states, device)


def states_from_torch(t: torch.Tensor, cfg: LaneConfig) -> np.ndarray:
    """Inverse of :func:`states_to_torch`: u32 or u64 numpy array, as
    ``interleaved2.encode_shared`` returns states."""
    if cfg.state_bits > 32:
        return u64_from_torch(t)
    return u32_from_torch(t)


def planes_to_torch(planes, cfg: LaneConfig, device="cpu") -> tuple:
    """Range-coder planes -> the port's layout, plane by plane as
    :func:`states_to_torch`: the points of an ILANS2-R stream, or a
    checkpoint's (lows, rngs, pts) rows, u32 for S <= 32 and u64 for S = 64
    (``interleaved2.build_checkpoints_range``).  JAX counterpart: the
    ``jnp.asarray(...).reshape(R, 128)`` planes (S=32) and (hi, lo) u32
    splits (S=64) in ``interleaved2.decode_range_from_checkpoint``."""
    return tuple(states_to_torch(p, cfg, device) for p in planes)


def planes_from_torch(tensors, cfg: LaneConfig) -> tuple:
    """Inverse of :func:`planes_to_torch`: u32 or u64 numpy arrays."""
    return tuple(states_from_torch(t, cfg) for t in tensors)


def cdf_to_torch(cdf, device="cpu") -> torch.Tensor:
    """Fixed-point CDF table (numpy, from
    ``constriction_tpu.models.categorical``) -> int64 tensor on ``device``.
    JAX counterpart: the Pallas ``_build_*`` functions take the CDF as a
    host tuple (``tuple(int(x) for x in cdf)``) baked into the kernel."""
    return torch.from_numpy(
        np.asarray(cdf, dtype=np.uint32).astype(np.int64)
    ).to(device)


def params_to_torch(means, scales, n: int, L: int, device="cpu") -> tuple:
    """Per-symbol (mean, scale) parameters of an n-symbol message on L
    lanes -> two float32 tensors of ceil(n / L) * L entries on ``device``,
    padded past n with mean 0 and scale 1 (the model of a lane that codes
    nothing in the last step).  The values are cast to float32, the type
    the integer CDF is defined on.  JAX counterpart:
    ``pallas_family._blocks3d`` (means with fill 0, scales with fill 1)."""
    total = -(-n // L) * L if n else 0
    out = []
    for name, values, fill in (("means", means, 0.0), ("scales", scales, 1.0)):
        a = np.asarray(values, dtype=np.float32).reshape(-1)
        if len(a) != n:
            raise ValueError(f"{name} must have {n} entries, got {len(a)}")
        padded = np.full(total, fill, dtype=np.float32)
        padded[:n] = a
        out.append(torch.from_numpy(padded).to(device))
    return tuple(out)


def params64_to_torch(means, scales, device="cpu") -> tuple:
    """f64 means and scales of the reference-exact families (numpy) ->
    two float64 tensors on ``device``, values unchanged.  JAX
    counterpart: ``np.asarray(..., np.float64)`` (the JAX package keeps
    them on the host, or ``jnp.asarray`` under ``jax.enable_x64``)."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, dtype=np.float64).reshape(-1)).copy()).to(device)
        for a in (means, scales))


def params64_from_torch(means: torch.Tensor, scales: torch.Tensor) -> tuple:
    """Inverse of :func:`params64_to_torch`: two f64 numpy arrays."""
    return tuple(t.detach().to("cpu", torch.float64).numpy().copy()
                 for t in (means, scales))


def ecp_to_torch(cums, probs, L: int, device="cpu") -> tuple:
    """Per-symbol (cum, prob) u32 planes of an n-symbol message (numpy,
    ``exact_family.exact_ecp``) -> two int32 bit-pattern tensors ``[T, L]``
    (T = ceil(n / L)) on ``device``, padded past n with (cum 0, prob 1) as
    ``exact_family.encode_tables_pallas`` pads them.  JAX counterpart:
    ``jnp.asarray(cpad).reshape(T, R, 128)`` there."""
    c = np.asarray(cums, dtype=np.uint32).reshape(-1)
    p = np.asarray(probs, dtype=np.uint32).reshape(-1)
    if len(c) != len(p):
        raise ValueError(
            f"cums and probs must have equal length, got {len(c)} vs "
            f"{len(p)}")
    T = -(-len(c) // L) if len(c) else 0
    out = []
    for a, fill in ((c, 0), (p, 1)):
        padded = np.full(T * L, fill, dtype=np.uint32)
        padded[:len(a)] = a
        out.append(u32_to_torch(padded, device).reshape(T, L))
    return tuple(out)


def ecp_from_torch(cums: torch.Tensor, probs: torch.Tensor,
                   n: int | None = None) -> tuple:
    """Inverse of :func:`ecp_to_torch`: the first ``n`` (default all)
    entries of each plane as u32 numpy arrays."""
    return tuple(u32_from_torch(t.reshape(-1))[:n] for t in (cums, probs))


def exact_tables_to_torch(tabs4, device="cpu") -> torch.Tensor:
    """Packed wide decode tables in the JAX package's device layout
    ``u32[T, CP1, R, 128]`` (``exact_family.packed_tables_device``) -> an
    int32 bit-pattern tensor ``[T, CP1, L]`` (L = 128 R) on ``device``:
    the same order, the lane axes merged.  JAX counterpart: the
    ``jnp.asarray(tabs4)`` handed to the Pallas decoders."""
    a = np.asarray(tabs4, dtype=np.uint32)
    T, CP1 = a.shape[:2]
    return u32_to_torch(a, device).reshape(T, CP1, -1)


def exact_tables_from_torch(tabs: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`exact_tables_to_torch`: ``u32[T, CP1, R, 128]``."""
    T, CP1, L = tabs.shape
    return u32_from_torch(tabs.reshape(-1)).reshape(T, CP1, L // 128, 128)


def rows_to_torch(rows, device="cpu") -> torch.Tensor:
    """u32 data in the JAX package's tile layout ``[..., 128]`` (a block's
    padded stream window ``[rows, 128]``, ``pallas_coder._pad_stream2d``;
    TChain-16 planar quantile words ``[T, R/2, 128]``,
    ``tchain.pack_quantiles``) -> the flat int32 tensor the port's wrappers
    take.  A stream window's zero padding past the stream's end reads as
    the zero words a decode past the end reads anyway.  JAX counterpart:
    the per-block slices of ``shard_*_pallas``'s inputs."""
    return u32_to_torch(np.asarray(rows, dtype=np.uint32).reshape(-1), device)


def rows_from_torch(t: torch.Tensor, rows: int) -> np.ndarray:
    """Inverse of :func:`rows_to_torch`: u32 ``[rows, 128]``, ``t``
    zero-padded to whole rows."""
    a = np.zeros(rows * 128, dtype=np.uint32)
    words = u32_from_torch(t)
    a[:len(words)] = words
    return a.reshape(rows, 128)


def family_params_to_torch(params, device="cpu") -> tuple:
    """A block's device-family parameters in the JAX package's layout
    ``f32[T, 2, R, 128]`` (means, then scales, ``pallas_family._blocks3d``
    stacked) -> two float32 tensors ``[T * L]`` (L = 128 R) on ``device``:
    the padded layout ``ops.family.decode_family`` takes
    (:func:`params_to_torch`).  JAX counterpart: the per-block ``params``
    of ``sharding.shard_decode_family_pallas``."""
    p = np.asarray(params, dtype=np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(p[:, k]).reshape(-1))
                 .to(device) for k in (0, 1))


def family_params_from_torch(means: torch.Tensor, scales: torch.Tensor,
                             L: int) -> np.ndarray:
    """Inverse of :func:`family_params_to_torch`: ``f32[T, 2, R, 128]``."""
    m, s = (t.detach().to("cpu", torch.float32).numpy().reshape(
        -1, L // 128, 128) for t in (means, scales))
    return np.stack([m, s], axis=1)


def quantiles_to_torch(quantiles, L: int, device="cpu") -> torch.Tensor:
    """12-bit quantiles (numpy, a whole number of L-lane steps) -> the
    packed planes of ``ops.tchain.pack_q12`` as a flat int32 tensor on
    ``device`` (1.5 bytes per quantile).  JAX counterpart:
    ``jnp.asarray(tchain.pack_q12(q, L))``."""
    from .ops.tchain import pack_q12

    return u32_to_torch(pack_q12(quantiles, L), device)


def quantiles_from_torch(qw: torch.Tensor, L: int) -> np.ndarray:
    """Inverse of :func:`quantiles_to_torch`: u16 numpy quantiles.  JAX
    counterpart: ``tchain.unpack_q12(np.asarray(qw))``."""
    from .ops.tchain import unpack_q12

    rows = 3 * (L // 1024)
    words = u32_from_torch(qw).reshape(qw.numel() // (rows * 128), rows, 128)
    return unpack_q12(words).reshape(-1).astype(np.uint16)


def quantiles16_to_torch(quantiles, L: int, device="cpu") -> torch.Tensor:
    """16-bit quantiles (numpy, a whole number of L-lane steps) -> the
    planar words of ``ops.tchain.pack_quantiles`` as a flat int32 tensor on
    ``device`` (2 bytes per quantile).  JAX counterpart:
    ``jnp.asarray(tchain.pack_quantiles(q, L))``."""
    from .ops.tchain import pack_quantiles

    return u32_to_torch(pack_quantiles(quantiles, L), device)


def quantiles16_from_torch(qw: torch.Tensor, L: int) -> np.ndarray:
    """Inverse of :func:`quantiles16_to_torch`: u16 numpy quantiles.  JAX
    counterpart: ``tchain.unpack_quantiles(np.asarray(qw))``."""
    from .ops.tchain import unpack_quantiles

    return unpack_quantiles(u32_from_torch(qw).reshape(-1, L // 256, 128))


def u32_values(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values as int64.  JAX counterpart:
    none needed (jnp.uint32 arithmetic)."""
    return t.to(torch.int64) & _M32


def u32_bits(values: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`u32_values`: u32 values (int64) -> int32 bits.
    JAX counterpart: none needed (jnp.uint32 arithmetic)."""
    return torch.where(values >= 1 << 31, values - (1 << 32), values).to(
        torch.int32
    )


def u64_halves(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 bit patterns -> (hi, lo) u32 values as int64.  JAX
    counterpart: the (hi, lo) tiles of ``pallas_coder64``."""
    return (t >> 32) & _M32, t & _M32


def u64_join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 values -> int64 bit pattern of hi * 2^32 + lo, without
    signed overflow: hi >= 2^31 is first moved into [-2^31, 0).  JAX
    counterpart: the (hi, lo) join in ``pallas_coder64`` wrappers."""
    signed_hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    return signed_hi * (1 << 32) + lo


# ---------------------------------------------------------------------------
# bulk transfers
# ---------------------------------------------------------------------------

# each tensor's bytes start at a multiple of this in a packed buffer, so
# every piece can be viewed back as its dtype
_ALIGN = 16


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 view (of a copy where its flat form
    has no unit stride, as a one-element tensor may have)."""
    t = t.reshape(-1)
    if t.stride(0) != 1:
        t = t.clone(memory_format=torch.contiguous_format)
    return t.view(torch.uint8)


def upload(tensors, device) -> list:
    """One host -> device transfer of several tensors: their bytes packed
    into one buffer, moved to ``device`` and viewed back as tensors of the
    inputs' dtypes and shapes (views of that buffer).  JAX counterpart: the
    ``jnp.asarray`` of a ``shard_map``'s inputs."""
    sizes = [t.numel() * t.element_size() for t in tensors]
    starts = np.cumsum([0] + [-(-b // _ALIGN) * _ALIGN for b in sizes])
    buf = torch.empty(int(starts[-1]), dtype=torch.uint8)
    for t, at, b in zip(tensors, starts, sizes):
        buf[at:at + b] = _bytes(t.detach().cpu())
    buf = buf.to(device)
    return [buf[at:at + b].view(t.dtype).reshape(t.shape)
            for t, at, b in zip(tensors, starts, sizes)]


def to_host(t: torch.Tensor) -> np.ndarray:
    """One device -> host transfer: ``t`` as a numpy array.  The gathers of
    the block programs read back through this function alone."""
    return t.detach().cpu().numpy()


def read_back(outputs) -> list:
    """The outputs of launches on one device as numpy arrays, in at most
    two transfers (:func:`to_host`) however many there are.  Each output
    is a tensor, read whole, or the ``(buf, end)`` pair of a launch form,
    read as ``buf[end:]`` (``end`` an int64[1] tensor).  The ends come back
    first, in one transfer; then every output, in one more.  The arrays
    keep the outputs' dtypes and shapes; they are views of that one host
    buffer, which none of them overlaps.  JAX counterpart: the
    ``all_gather`` and ``np.asarray`` closing a ``shard_map``."""
    if not outputs:
        return []
    ends = [o[1] for o in outputs if isinstance(o, tuple)]
    if ends:
        at = iter(to_host(torch.cat(ends)).tolist())
        outputs = [o[0][next(at):] if isinstance(o, tuple) else o
                   for o in outputs]
    pieces, starts, at = [], [], 0
    for o in outputs:
        b = _bytes(o)
        pad = -b.numel() % _ALIGN
        pieces += [b, b.new_zeros(pad)] if pad else [b]
        starts.append(at)
        at += b.numel() + pad
    flat = to_host(torch.cat(pieces))
    return [flat[at:at + o.numel() * o.element_size()]
            .view(torch.empty(0, dtype=o.dtype).numpy().dtype)
            .reshape(o.shape) for o, at in zip(outputs, starts)]
