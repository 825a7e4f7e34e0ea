"""Public facade of the port: the coders that run on a CUDA card.

The counterpart of ``constriction_tpu/tpu.py``'s ``encode_iid`` /
``decode_iid`` (ILANS2 rANS containers, with ``build_checkpoints`` /
``decode_from_checkpoint`` for random access), ``encode_iid_range`` /
``decode_iid_range`` (ILANS2-R range coding), ``encode_family`` /
``decode_family`` (per-symbol gaussian, laplace, logistic or cauchy
models), ``bits_back_decode`` / ``bits_back_encode`` and
``bits_back_decode24`` / ``bits_back_encode24`` (TChain-16 and TChain-24
categorical bits-back), ``bits_back_decode_family`` /
``bits_back_encode_family`` (TChain-12 bits-back under the family models)
``decode_chain_iid`` / ``decode_chain_rows`` (the chain coder's
parallel symbol decode), and ``encode_family_exact`` /
``decode_family_exact`` with ``encode_family_exact_container`` /
``decode_family_exact_container`` (reference-exact per-symbol gaussian,
laplace, cauchy or binomial models; W=16, S=32, P=12 by default, W=32,
S=64 grouped and in the container), writing and reading the same bytes.

    import constriction_tpu_torch.cuda as ctt

    data = ctt.encode_iid(symbols, cdf)      # ILANS2 container (u32 numpy)
    out = ctt.decode_iid(data, cdf)
    points, stream = ctt.encode_iid_range(symbols, cdf)
    out = ctt.decode_iid_range(points, stream, cdf, len(symbols))
    states, stream = ctt.encode_family(sym, mu, sigma, "gaussian", -100, 100)
    out = ctt.decode_family(states, stream, mu, sigma, "gaussian",
                            -100, 100, len(sym))
    states, stream = ctt.encode_family_exact(sym, mu, sigma, "gaussian",
                                             -100, 100)
    out = ctt.decode_family_exact(states, stream, mu, sigma, "gaussian",
                                  -100, 100, len(sym))
    sym, rem, heads = ctt.bits_back_decode(quantiles, cdf16)
    quantiles = ctt.bits_back_encode(sym, rem, heads, cdf16)[0]
    data = ctt.encode_family_exact_container(sym, mu, sigma, "gaussian",
                                             -100, 100)
    out = ctt.decode_family_exact_container(data, mu, sigma, "gaussian",
                                            -100, 100)

``device`` is explicit: ``"cuda"`` (the default) runs the hand-written
kernels and raises when no CUDA device is available; ``"cpu"`` runs their
plain PyTorch twins.  Nothing falls back from one to the other.

``_pick_cfg``, ``_pick_cfg_family`` and ``_check_cdf`` are copies of
``tpu.py``'s (the port
imports nothing of the JAX package): the lane count they pick decides the
container bytes, so they must stay equal to the originals in behaviour.
"""

from __future__ import annotations

import numpy as np
import torch

from . import convert as _convert
from .ops import chain as _chain
from .ops import exact_family as _exact
from .ops import family as _family
from .ops import framing as _framing
from .ops import framing_family as _ffam
from .ops import interleaved2 as _il2
from .ops import tchain as _tchain
from .ops.interleaved import LaneConfig

DEFAULT_CFG = LaneConfig(num_lanes=32768, word_bits=16, state_bits=32,
                         precision=12)


def _pick_cfg(n: int, cfg: LaneConfig | None,
              cdf=None, est_bits: float | None = None) -> LaneConfig:
    """Lane config for an n-symbol message.  Copy of ``tpu._pick_cfg``:
    up to 32768 lanes but no more than n/8, capped so the seed capacity
    L*(S-W) stays under a quarter of the message's information; P <= 16
    models take W=16/S=32, 16 < P <= 24 take W=32/S=64."""
    if cfg is not None:
        return cfg
    L = 128
    while L * 2 <= min(DEFAULT_CFG.num_lanes, max(n // 8, 128)):
        L *= 2
    if est_bits is not None and est_bits > 0:
        cap = 128
        while cap * 2 <= min(L, max(int(est_bits) // 32 // 4, 128)):
            cap *= 2
        L = cap
    P = 12
    if cdf is not None:
        top = int(np.asarray(cdf)[-1])
        if top & (top - 1) or not (1 << 2) <= top <= (1 << 24):
            raise ValueError(
                f"cdf[-1] == {top} is not a supported power of two "
                "(2^2 .. 2^24); rebuild the model with a fixed-point "
                "precision in that range"
            )
        P = top.bit_length() - 1
    if P <= 16:
        return LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                          precision=P)
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=P)


def _pick_cfg_family(n: int, cfg: LaneConfig | None,
                     grouped: bool) -> LaneConfig:
    """Copy of ``tpu._pick_cfg_family``: grouped coding exists only at
    S=64, so ``grouped=True`` with no cfg picks the DEFAULT-preset sizes
    (P=24, W=32, S=64) at ``_pick_cfg``'s lane count; otherwise
    ``_pick_cfg``'s config (W=16, S=32, P=12 without a CDF)."""
    if cfg is not None:
        return cfg
    base = _pick_cfg(n, None)
    if grouped:
        return LaneConfig(num_lanes=base.num_lanes, word_bits=32,
                          state_bits=64, precision=24)
    return base


def _check_cdf(cdf, cfg: LaneConfig) -> None:
    """Copy of ``tpu._check_cdf``: a CDF whose total is not 2^P would
    silently corrupt the container."""
    top = int(np.asarray(cdf)[-1])
    if top != 1 << cfg.precision:
        raise ValueError(
            f"cdf[-1] == {top} but the lane config uses precision "
            f"{cfg.precision} (expected {1 << cfg.precision}); rebuild the "
            f"model with precision={cfg.precision} or pass a matching "
            f"LaneConfig"
        )


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but torch finds no CUDA device; "
                "pass device='cpu' to run the plain PyTorch coder"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _check_symbols(symbols, cdf) -> None:
    if len(symbols) and (
        int(symbols.min()) < 0 or int(symbols.max()) >= len(cdf) - 1
    ):
        raise ValueError(
            f"symbols must be in [0, {len(cdf) - 1}), got range "
            f"[{int(symbols.min())}, {int(symbols.max())}]"
        )


def encode_iid(symbols, cdf, cfg: LaneConfig | None = None, alphabet=None,
               compact: bool = True, device="cuda") -> np.ndarray:
    """Encode i.i.d. categorical symbols into a self-describing ILANS2
    container (u32 numpy array).  JAX counterpart:
    ``constriction_tpu.tpu.encode_iid``.

    ``alphabet`` (optional, sorted-unique) maps non-contiguous symbols to
    their indices, which are coded against ``cdf``.  ``compact=True`` writes
    the v2 framing, ``False`` the v1 container.  ``device`` as in the module
    docstring."""
    dev = _device(device)
    symbols = np.asarray(symbols, dtype=np.int64)
    if alphabet is not None:
        alphabet = np.asarray(alphabet)
        idx = np.searchsorted(alphabet, symbols)
        bad_mask = (idx >= len(alphabet)) | (
            alphabet[np.minimum(idx, len(alphabet) - 1)] != symbols
        )
        if np.any(bad_mask):
            raise ValueError(
                f"symbol {int(symbols[bad_mask][0])} not in the alphabet"
            )
        symbols = idx.astype(np.int64)
    else:
        _check_symbols(symbols, cdf)
    est_bits = None
    sym_bits = None
    if cfg is None and len(symbols):
        cdf64 = np.asarray(cdf, dtype=np.float64)
        p = (cdf64[symbols + 1] - cdf64[symbols]) / cdf64[-1]
        sym_bits = -np.log2(p)
        est_bits = float(sym_bits.sum())
    cfg = _pick_cfg(len(symbols), cfg, cdf, est_bits=est_bits)
    _check_cdf(cdf, cfg)
    if compact:
        return _framing.encode_iid_v2(symbols, cdf, cfg, device=dev,
                                      sym_bits=sym_bits)
    return _il2.encode_iid_categorical2(symbols, cdf, cfg, device=dev)


def decode_iid(container, cdf, alphabet=None, device="cuda") -> np.ndarray:
    """Decode an ILANS2 container of either framing version.  JAX
    counterpart: ``constriction_tpu.tpu.decode_iid``.  With ``alphabet``,
    decoded indices map back to the non-contiguous symbols."""
    dev = _device(device)
    container = np.asarray(container)
    _check_cdf(cdf, _framing.peek_cfg(container))
    if _framing.container_version(container) == 2:
        out = _framing.decode_iid_v2(container, cdf, device=dev)
    else:
        out = _il2.decode_iid_categorical2(container, cdf, device=dev)
    if alphabet is not None:
        out = np.asarray(alphabet)[out]
    return out


def encode_iid_range(symbols, cdf, cfg: LaneConfig | None = None,
                     device="cuda"):
    """Range-coder twin of :func:`encode_iid`: returns ``(points, stream)``
    of the ILANS2-R format (u32 points at S=32, u64 at S=64; u32 words).
    JAX counterpart: ``constriction_tpu.tpu.encode_iid_range``, byte for
    byte; unlike it, symbols outside [0, K) raise ValueError.  The lane
    config is picked without the entropy cap of :func:`encode_iid`; P <= 16
    models run W=16/S=32, 16 < P <= 24 W=32/S=64.  Configs the kernels do
    not take are coded by the host encoder, as in the JAX package."""
    dev = _device(device)
    symbols = np.asarray(symbols, dtype=np.int64)
    _check_symbols(symbols, cdf)
    cfg = _pick_cfg(len(symbols), cfg, cdf)
    _check_cdf(cdf, cfg)
    return _il2.encode_iid_categorical_range(symbols, cdf, cfg, device=dev)


def decode_iid_range(points, stream, cdf, num_symbols: int,
                     cfg: LaneConfig | None = None,
                     device="cuda") -> np.ndarray:
    """Decode an ILANS2-R ``(points, stream)`` pair of ``num_symbols``
    symbols; returns int32 numpy.  JAX counterpart:
    ``constriction_tpu.tpu.decode_iid_range``.  ``cfg`` must be the
    encoder's (``None`` picks it again from ``num_symbols`` and ``cdf``)."""
    dev = _device(device)
    cfg = _pick_cfg(num_symbols, cfg, cdf)
    _check_cdf(cdf, cfg)
    if not _il2.kernel_eligible(cfg):
        return _il2.decode_shared_range_cdf(
            np.asarray(points), np.asarray(stream), num_symbols, cdf, cfg)
    return _il2.decode_range_lanes(np.asarray(points), np.asarray(stream),
                                   num_symbols, cdf, cfg, dev)


def build_checkpoints(container, cdf, interval: int):
    """Periodic decoder snapshots for an ILANS2 container of either
    framing version, made by one host decode (no ``device``: nothing runs
    on the card).  Returns ``(offsets, states)`` for
    :func:`decode_from_checkpoint`.  JAX counterpart:
    ``constriction_tpu.tpu.build_checkpoints``."""
    container = np.asarray(container)
    _check_cdf(cdf, _framing.peek_cfg(container))
    if _framing.container_version(container) == 2:
        return _framing.build_checkpoints_v2(container, cdf, interval)
    init_states, stream, n, cfg = _il2.unpack_container2(container)
    return _il2.build_checkpoints(init_states, stream, n, cdf, cfg, interval)


def decode_from_checkpoint(container, cdf, interval: int, ckpt_index: int,
                           offsets, states, device="cuda"):
    """Decode an ILANS2 container's suffix from checkpoint ``ckpt_index``
    (symbol ``(ckpt_index + 1) * interval * num_lanes``) without touching
    the prefix.  Returns ``(start_symbol, suffix)``, equal to the full
    decode's tail.  JAX counterpart:
    ``constriction_tpu.tpu.decode_from_checkpoint``."""
    dev = _device(device)
    container = np.asarray(container)
    _check_cdf(cdf, _framing.peek_cfg(container))
    if _framing.container_version(container) == 2:
        return _framing.decode_from_checkpoint_v2(
            container, cdf, interval, ckpt_index, offsets, states, device=dev)
    init_states, stream, n, cfg = _il2.unpack_container2(container)
    return _il2.decode_from_checkpoint(ckpt_index, offsets, states, stream,
                                       n, cdf, cfg, interval, device=dev)


def encode_family(symbols, means, scales, family: str, min_sym: int,
                  max_sym: int, cfg: LaneConfig | None = None,
                  device="cuda"):
    """Encode symbols under per-symbol (mean, scale) models of one family
    (gaussian, laplace, logistic or cauchy; exact-integer CDF, the same
    bits on every backend) at W=16, S=32, P=12.  Returns ``(init_states
    u32[L], stream u32[num_words])`` numpy arrays.  JAX counterpart:
    ``constriction_tpu.tpu.encode_family``, byte for byte; unlike it,
    symbols outside [min_sym, max_sym], means that are not finite and
    scales without a finite positive float32 reciprocal raise
    ValueError."""
    dev = _device(device)
    symbols = np.asarray(symbols)
    cfg = _pick_cfg(len(symbols), cfg)
    means_t, scales_t = _convert.params_to_torch(
        means, scales, len(symbols), cfg.num_lanes, dev)
    syms_t = torch.from_numpy(
        np.ascontiguousarray(symbols, dtype=np.int32)).to(dev)
    states, stream = _family.encode_family(
        syms_t, means_t, scales_t, family, int(min_sym), int(max_sym), cfg)
    return _convert.u32_from_torch(states), _convert.u32_from_torch(stream)


def decode_family(init_states, stream, means, scales, family: str,
                  min_sym: int, max_sym: int, num_symbols: int,
                  cfg: LaneConfig | None = None, device="cuda") -> np.ndarray:
    """Decode ``num_symbols`` symbols of an :func:`encode_family` stream
    under the same per-symbol models; returns int32 numpy.  JAX
    counterpart: ``constriction_tpu.tpu.decode_family``; on a CUDA device
    a ``cfg`` of more than ``ops.coder.MAX_DECODE_LANES`` lanes raises
    ValueError (the decode kernel's reach)."""
    dev = _device(device)
    cfg = _pick_cfg(num_symbols, cfg)
    means_t, scales_t = _convert.params_to_torch(
        means, scales, num_symbols, cfg.num_lanes, dev)
    syms = _family.decode_family(
        _convert.u32_to_torch(init_states, dev),
        _convert.u32_to_torch(stream, dev), means_t, scales_t, family,
        int(min_sym), int(max_sym), cfg, num_symbols)
    return syms.cpu().numpy()


def _steps(n: int, L: int) -> None:
    if n % L:
        raise ValueError(
            f"the message length must be a multiple of {L} lanes, got {n}")


def _chain_params(means, scales, n: int, dev):
    L = _tchain.TCHAIN12_CFG.num_lanes
    _steps(n, L)
    return _convert.params_to_torch(means, scales, n, L, dev)


def bits_back_decode_family(quantiles, means, scales, family: str,
                            min_sym: int, max_sym: int, device="cuda"):
    """Neural bits-back (TChain-12): decode 12-bit quantiles (their count
    a multiple of 32768) as symbols under per-symbol (mean, scale) models.
    Returns numpy ``(symbols int32, remainders u32, heads u32[32768])``;
    :func:`bits_back_encode_family` recovers the quantiles exactly.  JAX
    counterpart: ``constriction_tpu.tpu.bits_back_decode_family``."""
    dev = _device(device)
    q = np.asarray(quantiles, dtype=np.uint16)
    if not (q < (1 << 12)).all():
        raise ValueError("quantiles must be 12-bit values")
    means_t, scales_t = _chain_params(means, scales, len(q), dev)
    L = _tchain.TCHAIN12_CFG.num_lanes
    syms, stream, heads = _tchain.tchain12_family_decode(
        _convert.quantiles_to_torch(q, L, dev), means_t, scales_t, family,
        int(min_sym), int(max_sym))
    return (syms.cpu().numpy(), _convert.u32_from_torch(stream),
            _convert.u32_from_torch(heads))


def bits_back_encode_family(symbols, remainders, heads, means, scales,
                            family: str, min_sym: int, max_sym: int,
                            device="cuda"):
    """Reverse pass of :func:`bits_back_decode_family`: returns numpy
    ``(quantiles u16, heads u32[32768])``, the heads back at 16 after a
    full reverse.  JAX counterpart:
    ``constriction_tpu.tpu.bits_back_encode_family``."""
    dev = _device(device)
    symbols = np.ascontiguousarray(symbols, dtype=np.int32)
    means_t, scales_t = _chain_params(means, scales, len(symbols), dev)
    L = _tchain.TCHAIN12_CFG.num_lanes
    qw, out_heads = _tchain.tchain12_family_encode(
        torch.from_numpy(symbols).to(dev),
        _convert.u32_to_torch(remainders, dev),
        _convert.u32_to_torch(heads, dev), means_t, scales_t, family,
        int(min_sym), int(max_sym))
    return (_convert.quantiles_from_torch(qw, L),
            _convert.u32_from_torch(out_heads))


def bits_back_decode(quantiles, cdf, device="cuda"):
    """TChain-16 bits-back decode: 16-bit quantiles (their count a multiple
    of 32768) -> numpy ``(symbols int32, remainders u32, heads u32[32768])``
    under a fixed-point CDF at P=16; :func:`bits_back_encode` recovers the
    quantiles exactly.  JAX counterpart:
    ``constriction_tpu.tpu.bits_back_decode``; unlike it, quantiles outside
    [0, 2^16) and a CDF that does not rise from 0 to 2^16 raise
    ValueError."""
    dev = _device(device)
    q = np.asarray(quantiles)
    if q.size and (int(q.min()) < 0 or int(q.max()) >= 1 << 16):
        raise ValueError("quantiles must be 16-bit values")
    L = _tchain.TCHAIN_CFG.num_lanes
    _steps(len(q), L)
    syms, stream, heads = _tchain.tchain16_decode(
        _convert.quantiles16_to_torch(q.astype(np.uint16), L, dev),
        _convert.cdf_to_torch(cdf, dev))
    return (syms.cpu().numpy(), _convert.u32_from_torch(stream),
            _convert.u32_from_torch(heads))


def bits_back_encode(symbols, remainders, heads, cdf, device="cuda"):
    """Reverse pass of :func:`bits_back_decode`: numpy ``(quantiles u16,
    heads u32[32768])``, the heads back at 1 after a full reverse.  JAX
    counterpart: ``constriction_tpu.tpu.bits_back_encode``; unlike it,
    symbols outside [0, K) or of zero probability raise ValueError."""
    dev = _device(device)
    symbols = np.asarray(symbols, dtype=np.int64)
    _check_symbols(symbols, cdf)
    L = _tchain.TCHAIN_CFG.num_lanes
    _steps(len(symbols), L)
    qw, out_heads = _tchain.tchain16_encode(
        torch.from_numpy(symbols.astype(np.int32)).to(dev),
        _convert.u32_to_torch(remainders, dev),
        _convert.u32_to_torch(heads, dev), _convert.cdf_to_torch(cdf, dev))
    return (_convert.quantiles16_from_torch(qw, L),
            _convert.u32_from_torch(out_heads))


def bits_back_decode24(quantiles, cdf, device="cuda"):
    """TChain-24 bits-back decode at the reference's default precision
    (W=32, S=64, P=24): 24-bit quantiles in u32 (their count a multiple of
    32768) -> numpy ``(symbols int32, remainders u32, heads u64[32768])``;
    :func:`bits_back_encode24` recovers the quantiles exactly.  JAX
    counterpart: ``constriction_tpu.tpu.bits_back_decode24``; unlike it,
    a CDF that does not rise from 0 to 2^24 raises ValueError."""
    dev = _device(device)
    q = np.asarray(quantiles, dtype=np.uint32)
    if not (q < (1 << 24)).all():
        raise ValueError("quantiles must be 24-bit values")
    L = _tchain.TCHAIN24_CFG.num_lanes
    _steps(len(q), L)
    syms, stream, heads = _tchain.tchain24_decode(
        _convert.u32_to_torch(q, dev), _convert.cdf_to_torch(cdf, dev))
    return (syms.cpu().numpy(), _convert.u32_from_torch(stream),
            _convert.u64_from_torch(heads))


def bits_back_encode24(symbols, remainders, heads, cdf, device="cuda"):
    """Reverse pass of :func:`bits_back_decode24`: numpy ``(quantiles u32,
    heads u64[32768])``, the heads back at 256 after a full reverse.  JAX
    counterpart: ``constriction_tpu.tpu.bits_back_encode24``; unlike it,
    symbols outside [0, K) or of zero probability raise ValueError."""
    dev = _device(device)
    symbols = np.asarray(symbols, dtype=np.int64)
    _check_symbols(symbols, cdf)
    L = _tchain.TCHAIN24_CFG.num_lanes
    _steps(len(symbols), L)
    q, out_heads = _tchain.tchain24_encode(
        torch.from_numpy(symbols.astype(np.int32)).to(dev),
        _convert.u32_to_torch(remainders, dev),
        _convert.u64_to_torch(heads, dev), _convert.cdf_to_torch(cdf, dev))
    return _convert.u32_from_torch(q), _convert.u64_from_torch(out_heads)


def decode_chain_iid(data, num_symbols: int, cdf, device="cuda") -> np.ndarray:
    """Decode ``num_symbols`` i.i.d. symbols from chain-coder data (the
    reference's default preset, ``from_compressed`` framing) in one parallel
    pass; returns int32 numpy.  Data too short for ``num_symbols`` raises
    ``ops.chain.OutOfCompressedData``.  JAX counterpart:
    ``constriction_tpu.tpu.decode_chain_iid``."""
    dev = _device(device)
    return _chain.chain_decode_iid(np.asarray(data), num_symbols, cdf,
                                   torch, dev).cpu().numpy()


def decode_chain_rows(data, rows, device="cuda") -> np.ndarray:
    """Chain decode with one categorical model per symbol (``rows``: [n,
    K+1] fixed-point CDFs at P=24); returns int32 numpy.  JAX counterpart:
    ``constriction_tpu.tpu.decode_chain_rows``."""
    dev = _device(device)
    return _chain.chain_decode_rows(np.asarray(data), rows, torch,
                                    dev).cpu().numpy()


def encode_family_exact(symbols, means, scales, family: str, min_sym: int,
                        max_sym: int, cfg: LaneConfig | None = None,
                        grouped: bool = False, device="cuda"):
    """REFERENCE-EXACT per-symbol family encode: the model tables are the
    host f64 LeakyQuantizer's (bit-identical to the reference's
    QuantizedGaussian / Laplace / Cauchy / Binomial, quantize.rs:525-568),
    and the rANS loop runs in kernel 14 (W=16, S=32) or kernel 17 (W=32,
    S=64).  For ``family="binomial"`` pass ``(n_trials, p)`` in the (means,
    scales) slots.  Without a ``cfg`` the ungrouped call picks
    ``_pick_cfg``'s W=16, S=32, P=12 config and ``grouped=True`` the
    W=32, S=64, P=24 one, as the JAX facade does.  ``grouped=True``
    stable-sorts the symbols by core size (the wire order the grouped
    decoder expects; pass the same flag to :func:`decode_family_exact`).
    Returns ``(init_states, stream u32[num_words])`` numpy arrays, the
    states u32[L] at S=32 and u64[L] at S=64.  JAX counterpart:
    ``constriction_tpu.tpu.encode_family_exact``, byte for byte; unlike
    it, a model whose core exceeds the decode tables' cap, or whose
    support leaves the quantizer less than 2 of free mass, raises
    ValueError instead of writing a stream no decoder reads."""
    dev = _device(device)
    symbols = np.asarray(symbols)
    cfg = _pick_cfg_family(len(symbols), cfg, grouped)
    if grouped:
        states, stream = _exact.encode_family_exact_grouped(
            symbols, means, scales, family, int(min_sym), int(max_sym), cfg,
            dev)
    else:
        states, stream = _exact.encode_family_exact(
            symbols, means, scales, family, int(min_sym), int(max_sym), cfg,
            dev)
    return (_convert.states_from_torch(states, cfg),
            _convert.u32_from_torch(stream))


def decode_family_exact(init_states, stream, means, scales, family: str,
                        min_sym: int, max_sym: int, num_symbols: int,
                        cfg: LaneConfig | None = None,
                        cmax: int | None = None, grouped: bool = False,
                        device="cuda") -> np.ndarray:
    """REFERENCE-EXACT per-symbol family decode (twin of
    :func:`encode_family_exact`; ``init_states`` u32 at S=32, u64 at
    S=64): compact exact boundary tables, then quantile inversion and the
    state machine in one kernel.  Ungrouped at S=32 (the default config):
    narrow tables from the host builder, kernel 13.  Ungrouped at S=64:
    kernel 15.  Grouped (S=64): kernel 16, one launch per segment.
    ``cmax=None`` sizes the ungrouped tables to the batch's largest core.
    At S=64 on a CUDA device the tables of gaussian, laplace and cauchy
    models are built on the card with kernel 18, binomial tables (and
    every table on the CPU) on the host.  Returns int32 symbols (int64
    when grouped), as the JAX facade.  JAX counterpart:
    ``constriction_tpu.tpu.decode_family_exact``."""
    dev = _device(device)
    cfg = _pick_cfg_family(num_symbols, cfg, grouped)
    states = _convert.states_to_torch(init_states, cfg, dev)
    words = _convert.u32_to_torch(stream, dev)
    if grouped:
        out = _exact.decode_family_exact_grouped(
            states, words, means, scales, family, int(min_sym), int(max_sym),
            cfg, num_symbols)
        return out.cpu().numpy().astype(np.int64)
    return _exact.decode_family_exact(
        states, words, means, scales, family, int(min_sym), int(max_sym),
        cfg, num_symbols, cmax=cmax).cpu().numpy()


def encode_family_exact_container(symbols, means, scales, family: str,
                                  min_sym: int, max_sym: int,
                                  cfg: LaneConfig | None = None,
                                  device="cuda") -> np.ndarray:
    """REFERENCE-EXACT per-symbol family encode into a compact v2
    container (u32 numpy): core-size grouping, a region-B tail carried in
    region A's seeds, region A coded by kernel 17.  The lane count is
    ``_pick_cfg_family``'s, blind to the message's entropy, as in the JAX
    facade.  JAX counterpart:
    ``constriction_tpu.tpu.encode_family_exact_container``, byte for
    byte."""
    dev = _device(device)
    symbols = np.asarray(symbols)
    cfg = _pick_cfg_family(len(symbols), cfg, True)
    return _ffam.encode_family_v2(symbols, means, scales, family,
                                  int(min_sym), int(max_sym), cfg, dev)


def decode_family_exact_container(container, means, scales, family: str,
                                  min_sym: int, max_sym: int,
                                  device="cuda") -> np.ndarray:
    """Decode an :func:`encode_family_exact_container` container (int64
    numpy): region A through kernel 16 per segment (tables built on the
    card on a CUDA device), region B on the host oracle.  JAX counterpart:
    ``constriction_tpu.tpu.decode_family_exact_container``."""
    dev = _device(device)
    return _ffam.decode_family_v2(np.asarray(container), means, scales,
                                  family, int(min_sym), int(max_sym), dev)
