"""ctypes bindings of the native host codec (``libctpu.so``).

:func:`library` builds the library on first use (:mod:`.build`: g++ into
``build/constriction_tpu_torch/native/<hash>/``), loads it once per
process and binds the entry points the port calls.  A failed build or
load raises RuntimeError; there is no numpy fallback and no switch.  The
library is opened with ``ctypes.CDLL``'s default ``RTLD_LOCAL``, so it
and the JAX package's ``libctpu.so`` (same ``ctpu_*`` names) can share a
process.

The codec's OpenMP loops write each element independently, so a result
never depends on the thread count.  libgomp is not fork-safe once its
threads have started: worker pools of a process that has called the
library are spawned, never forked.

JAX counterpart: ``constriction_tpu/native/__init__.py`` (whose ``LIB`` is
None where its build failed, and whose callers then take numpy paths).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build

u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


# the host coders' state records, as codec.cpp's RangeEncState,
# RangeDecState and ChainState (the JAX package's structs, field for field)
class RangeEncState(ctypes.Structure):
    _fields_ = [
        ("lower", ctypes.c_uint64),
        ("range", ctypes.c_uint64),
        ("num_inverted", ctypes.c_uint64),
        ("first_inverted", ctypes.c_uint32),
    ]


class RangeDecState(ctypes.Structure):
    _fields_ = [
        ("lower", ctypes.c_uint64),
        ("range", ctypes.c_uint64),
        ("point", ctypes.c_uint64),
        ("cursor", ctypes.c_int64),
    ]


class ChainState(ctypes.Structure):
    _fields_ = [
        ("head_compressed", ctypes.c_uint64),
        ("head_remainders", ctypes.c_uint64),
        ("compressed_len", ctypes.c_int64),
        ("remainders_len", ctypes.c_int64),
    ]


# the codec's distribution index of each exact family
DIST_KIND = {"gaussian": 0, "laplace": 1, "cauchy": 2, "binomial": 3}

_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_FAM = [_I32, _I32, _I32, _I32]  # kind, min_sym, max_sym, precision
# the shared-stream decoders' head: states, stream, stream length,
# num_symbols, L, T
_DEC = [u32p, u32p, _I64, _I64, _I32, _I32]
# the scalar coders' tail: W, S, P
_WSP = [_I32, _I32, _I32]
_U64P = ctypes.POINTER(ctypes.c_uint64)
# name: (restype, argtypes)
SIGNATURES = {
    "ctpu_erf_array": (None, [f64p, f64p, _I64]),
    "ctpu_erfc_array": (None, [f64p, f64p, _I64]),
    "ctpu_quantized_ecp": (_I32, [*_FAM, i32p, f64p, f64p, _I64, u32p, u32p]),
    "ctpu_exact_ncore": (None, [*_FAM, f64p, f64p, _I64, u32p]),
    "ctpu_exact_boundaries": (
        _I64, [*_FAM, f64p, f64p, _I64, _I32, u32p, u32p]),
    "ctpu_exact_tables_packed": (
        _I64, [*_FAM, f64p, f64p, _I64, _I32, u32p]),
    "ctpu_exact_tables_packed_t": (
        _I64, [*_FAM, f64p, f64p, _I64, _I64, _I32, u32p, i32p]),
    "ctpu_transpose_u32": (None, [u32p, u32p, _I64, _I64, _I64]),
    "ctpu_exact_tv_at": (None, [*_FAM, f64p, f64p, i64p, i32p, _I64, u32p]),
    "ctpu_ilans2_encode": (
        _I64, [u32p, u32p, _I64, _I32, _I32, _I32, _I32, _I32, u32p, u32p,
               _I64]),
    "ctpu_ilans2_encode_seeded": (
        _I64, [u32p, u32p, _I64, _I32, _I32, _I32, _I32, _I32, u32p, u32p,
               u32p, _I64]),
    "ctpu_ilans2_decode_lookup": (
        None, [*_DEC, u32p, u32p, _I32, _I32, _I32, i32p]),
    "ctpu_ilans2_decode_ckpt": (
        None, [*_DEC, u32p, u32p, _I32, _I32, _I32, i32p, _I64, i64p, u32p]),
    "ctpu_ilans2_decode_cdf64": (
        None, [*_DEC, u32p, _I32, _I32, _I32, _I32, i32p]),
    "ctpu_ilans2_decode_cdf64_l1": (
        None, [*_DEC, u32p, _I32, u32p, _I32, _I32, _I32, _I32, i32p]),
    "ctpu_ilans2_decode_quantized": (
        None, [*_DEC, _I32, _I32, _I32, f64p, f64p, *_WSP, i32p]),
    "ctpu_ilans2_range_encode": (
        _I64, [u32p, u32p, _I64, _I32, _I32, _I32, _I32, _I32, u32p, u32p]),
    "ctpu_ilans2_range_decode_cdf_l1": (
        _I64, [*_DEC, u32p, _I32, u32p, _I32, _I32, _I32, _I32, i32p]),
    # the host API's bulk paths (ops/ans.py, ops/range.py, ops/chain.py)
    "ctpu_ans_encode_reverse": (
        _I64, [_U64P, u32p, _I64, u32p, u32p, _I64, *_WSP]),
    "ctpu_ans_decode_lookup": (
        _I64, [_U64P, u32p, _I64, u32p, u32p, i32p, _I64, *_WSP]),
    "ctpu_ans_decode_cdf": (
        _I64, [_U64P, u32p, _I64, u32p, _I64, i32p, _I64, *_WSP]),
    "ctpu_ans_decode_quantized": (
        _I64, [_U64P, u32p, _I64, _I32, _I32, _I32, f64p, f64p, i32p, _I64,
               *_WSP]),
    "ctpu_range_encode": (
        _I64, [ctypes.POINTER(RangeEncState), u32p, _I64, u32p, u32p, _I64,
               *_WSP]),
    "ctpu_range_decode_lookup": (
        _I64, [ctypes.POINTER(RangeDecState), u32p, _I64, u32p, u32p, i32p,
               _I64, *_WSP]),
    "ctpu_range_decode_quantized": (
        _I64, [ctypes.POINTER(RangeDecState), u32p, _I64, _I32, _I32, _I32,
               f64p, f64p, i32p, _I64, *_WSP]),
    "ctpu_chain_decode_lookup": (
        _I64, [ctypes.POINTER(ChainState), u32p, u32p, _I64, u32p, u32p,
               i32p, _I64, *_WSP]),
    "ctpu_chain_encode_reverse": (
        _I64, [ctypes.POINTER(ChainState), u32p, _I64, u32p, u32p, u32p,
               _I64, *_WSP]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def load(path: str) -> ctypes.CDLL:
    """Open the library at ``path`` (``RTLD_LOCAL``) and bind
    :data:`SIGNATURES`.  Raises RuntimeError if it cannot be loaded or
    lacks an entry point."""
    try:
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"cannot load the host codec {path}: {e}") from e
    return lib


def library() -> ctypes.CDLL:
    """The host codec, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build.build())
        return _lib
