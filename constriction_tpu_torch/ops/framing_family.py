"""Compact v2 containers for the reference-exact per-symbol families.

The grouped exact-family coder (``ops/exact_family.py``) ships its L lane
states raw: L * 64 bits, 12.4% of the information of the JAX package's
Q.npz benchmark row at L = 32768.  This module applies the v2 framing of
``ops/framing.py`` to the family path:

- the symbols are core-size-grouped as in
  ``exact_family.encode_family_exact_grouped`` (the shared deterministic
  ``group_plan``, so the decoder rebuilds the order from (means, scales));
- the last k_B grouped symbols form region B, coded first on a few lanes
  by the host coder; its stream and packed states ride inside region A's
  encoder seeds, and a full decode of region A gives them back;
- region A is coded by kernel 17 with those seeds and decoded by kernel 16,
  one launch per segment of the plan clipped to region A's steps; region
  B, a short tail holding the widest-core symbols, decodes on the host
  oracle ``exact_family.decode_family_exact_host``.

Wire layout and parser are ``ops/framing.py``'s (``frame_planes_v2``,
``parse_v2``); only the region coders differ.

JAX counterpart: ``constriction_tpu/ops/framing_family.py``, byte for byte
(``tests/test_torch_framing_family.py``).  Where the JAX module asserts
(the (W, S) preset), the port raises ValueError, as it does for a lane
count that is not a multiple of 128, a precision outside (16, 24], a
family outside the grouping plan's four and a model count that differs
from the symbol count.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert
from . import exact_family as ef
from . import framing as fr
from .interleaved import LaneConfig


def _check_cfg(cfg: LaneConfig) -> None:
    if (cfg.word_bits, cfg.state_bits) != (32, 64):
        raise ValueError(
            "family v2 containers ride the wide-table (W=32, S=64) grouped "
            f"coders; got W={cfg.word_bits}, S={cfg.state_bits}")
    if not 16 < cfg.precision <= 24:
        raise ValueError(
            f"family v2 containers need 16 < P <= 24, got P={cfg.precision}")
    if cfg.num_lanes <= 0 or cfg.num_lanes % ef.LANES:
        raise ValueError(
            f"num_lanes must be a positive multiple of {ef.LANES}, got "
            f"{cfg.num_lanes}")


def _check_family(family: str) -> None:
    if family not in ef._EST_C:
        raise ValueError(
            f"grouped coding supports families {sorted(ef._EST_C)}, got "
            f"{family!r}; use the ungrouped encode_family_exact instead")


def _grouped_planes(symbols, means, scales, family, min_sym, max_sym, cfg,
                    max_segments):
    """(perm, segments, cums, probs) in the grouped wire order.  JAX
    counterpart: ``framing_family._grouped_planes``."""
    symbols = np.asarray(symbols).reshape(-1)
    means = np.asarray(means, np.float64).reshape(-1)
    scales = np.asarray(scales, np.float64).reshape(-1)
    if len(means) != len(symbols) or len(scales) != len(symbols):
        raise ValueError(
            f"{len(symbols)} symbols but {len(means)} means and "
            f"{len(scales)} scales given")
    perm, segments = ef.group_plan(
        means, scales, family, min_sym, max_sym, cfg.precision,
        cfg.num_lanes, len(symbols), max_segments,
    )
    cums, probs = ef.exact_ecp(
        symbols[perm], means[perm], scales[perm], family, min_sym, max_sym,
        cfg.precision,
    )
    return perm, segments, cums, probs


def encode_family_v2(symbols, means, scales, family: str, min_sym: int,
                     max_sym: int, cfg: LaneConfig, device,
                     max_segments: int = 10) -> np.ndarray:
    """Core-size-grouped reference-exact family encode into a compact v2
    container (u32 numpy); region A through :func:`exact_family.
    encode_tables` on ``device`` (kernel 17 on a CUDA device, its twin on
    the CPU).  JAX counterpart: ``framing_family.encode_family_v2``."""
    _check_family(family)
    _check_cfg(cfg)
    _perm, _segs, cums, probs = _grouped_planes(
        symbols, means, scales, family, min_sym, max_sym, cfg, max_segments)

    def encode_a(n_A, seeds):
        c_t, p_t = convert.ecp_to_torch(cums[:n_A], probs[:n_A],
                                        cfg.num_lanes, device)
        seeds_t = (None if seeds is None
                   else convert.u64_to_torch(seeds, device))
        states, stream = ef.encode_tables(c_t, p_t, cfg, seeds_t, n_A)
        return convert.u64_from_torch(states), convert.u32_from_torch(stream)

    return fr.frame_planes_v2(cums, probs, cfg, None, encode_a)


def decode_family_v2(data, means, scales, family: str, min_sym: int,
                     max_sym: int, device, max_segments: int = 10,
                     device_tables: bool | None = None) -> np.ndarray:
    """Decode an :func:`encode_family_v2` container on ``device``; returns
    int64 numpy symbols.  Region A runs kernel 16 per segment (tables from
    the on-card builder on a CUDA device, see
    ``exact_family.decode_family_exact_grouped``); region B is recovered
    from region A's final lane states and decoded on the host oracle.  JAX
    counterpart: ``framing_family.decode_family_v2``."""
    _check_family(family)
    p = fr.parse_v2(np.asarray(data))
    cfg = p.cfg
    _check_cfg(cfg)
    L, S, W = cfg.num_lanes, cfg.state_bits, cfg.word_bits
    n, n_A, k_B = p.n, p.n_A, p.k_B
    if n == 0:
        return np.zeros(0, np.int64)
    means = np.asarray(means, np.float64).reshape(-1)
    scales = np.asarray(scales, np.float64).reshape(-1)
    if len(means) != n or len(scales) != n:
        raise ValueError(
            f"container holds {n} symbols but {len(means)} models given"
        )
    device = torch.device(device)
    if device_tables is None:
        device_tables = ef._device_tables_default(family, min_sym, max_sym,
                                                  device)
    perm, segments = ef.group_plan(
        means, scales, family, min_sym, max_sym, cfg.precision, L, n,
        max_segments,
    )
    m_p, s_p = means[perm], scales[perm]

    # region A: the plan's segments clipped to its T_A steps.  Tables of
    # the boundary step's inactive lanes come from the REAL region-B
    # params at those positions, so the plan's widths stay valid; the
    # kernels never read inactive lanes' tables.
    T = -(-n // L)
    T_A = -(-n_A // L) if n_A else 0
    pm, ps = ef._pad_params(m_p, s_p, T * L, family, max_sym)
    segs_A = [
        (t0, min(ns, T_A - t0), cm) for t0, ns, cm in segments if t0 < T_A
    ]
    states_A = convert.u64_to_torch(p.states_A, device)
    syms_A, fin = ef.decode_segments(
        states_A, convert.u32_to_torch(p.stream_A, device), pm, ps, segs_A,
        family, min_sym, max_sym, cfg, n_A, device_tables)

    # region B: its stream and packed states from region A's final lane
    # states (the encoder's seeds after a full decode), then the host
    # oracle on the tail models
    if k_B:
        payload = fr._payload_from_seeds(convert.u64_from_torch(fin), cfg)
        stream_B = fr._bits_to_stream(payload, W, p.slen_B)
        sb_bits = p.slen_B * W
        psb = np.concatenate([
            payload[sb_bits: sb_bits + p.psb_in_seed], p.psb_rem
        ])
        cfg_B = LaneConfig(num_lanes=p.L_B, word_bits=W, state_bits=S,
                           precision=cfg.precision)
        states_B = fr.unpack_states(psb, cfg_B)
        syms_B = ef.decode_family_exact_host(
            states_B, stream_B, m_p[n_A:], s_p[n_A:], family, min_sym,
            max_sym, cfg_B, k_B,
        )
    else:
        syms_B = np.zeros(0, np.int64)

    out = np.empty(n, dtype=np.int64)
    out[perm] = np.concatenate([
        syms_A.cpu().numpy().astype(np.int64), np.asarray(syms_B, np.int64)
    ])
    return out
