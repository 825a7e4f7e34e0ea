"""Builds the CUDA sources under ``ops/csrc`` and binds them with ctypes.

On first use, :func:`library` compiles every ``csrc/*.cu`` with nvcc for
``sm_90a`` (one nvcc per source, all started together) and links them into
one shared library with a plain C interface, under
``build/constriction_tpu_torch/<hash>/`` at the root of the checkout, keyed
by a hash of the sources (``*.cuh`` headers included) and flags so an
edited source never loads a stale binary.  A missing nvcc or a failed build
raises; nothing continues on a kernel's plain version.

Every C entry point returns ``cudaGetLastError()``; :func:`call` raises if
that is not 0.  Pointers and the CUDA stream travel as ``ctypes.c_void_p``.

JAX counterpart: none as such; the JAX package compiles each Pallas kernel
through ``jax.jit`` in a ``_build_*`` function (``pallas_coder._build_decoder``),
cached per (CDF, config) by ``inversion_keyed_cache``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "constriction_tpu_torch"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_DECODE_ARGS = [_P, _P, _I64, _P, _I32, _P, _I64, _I32, _I32, _P, _I32]
# the two-pass encoder: its scratch (words, flags, offsets, records) after
# end_out
_ENCODE_WIDE_ARGS = [_P, _P, _I64, _P, _I32, _P, _I64, _P, _P, _P, _P, _P,
                     _I32, _I32, _P, _I32]
_ENCODE_LANES_ARGS = [_P, _P, _I64, _P, _I32, _P, _P, _P, _I32, _I32, _P,
                      _I32]
_COMPACT_ARGS = [_P, _P, _I64, _P, _I64, _P, _P, _P, _I32]
_DECODE_CLUSTER_ARGS = [_P, _P, _I64, _P, _I32, _P, _I64, _I32, _I32, _I32,
                        _P, _I32]
_GEOMETRY_ARGS = [_I32, _I32, _I32, _I32, _P, _P, _I32]
_RANGE_RECORD_ARGS = [_P, _I64, _P, _I32, _P, _P, _P, _I32, _I32, _P, _I32]
# L, K, out[5]
_RANGE_RECORD_GEOMETRY_ARGS = [_I32, _I32, _P, _P, _I32]
# phase B (kernels 8 and 10): records, s0, seal carry, buf, cap, end_out,
# points; its scratch (words, flags, offsets)
_RANGE_RESOLVE_ARGS = [_P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I32, _I32,
                       _P, _I32]
_RANGE_RESOLVE_LANES_ARGS = [_P, _P, _P, _P, _P, _P, _I32, _I32, _P, _I32]
_RANGE_DECODE_ARGS = [_P, _P, _P, _P, _I64, _P, _I32, _P, _I64, _I32, _I32,
                      _P, _P, _I32]
# the cluster size after `bad`
_RANGE_DECODE_CLUSTER_ARGS = [*_RANGE_DECODE_ARGS[:12], _I32, _P, _I32]
# family index, min_sym, max_sym (or free); then the stream and the device
_FAMILY_TAIL = [_I32, _I32, _I32, _P, _I32]
_FAMILY_DECODE_ARGS = [_P, _P, _I64, _P, _P, _P, _I64, _I32, *_FAMILY_TAIL]
# the cluster size after max_sym
_FAMILY_DECODE_CLUSTER_ARGS = [*_FAMILY_DECODE_ARGS[:11], _I32, _P, _I32]
# L, family index, cluster size, out[5]
_FAMILY_GEOMETRY_ARGS = [_I32, _I32, _I32, _P, _P, _I32]
# kernel 12: states, syms, n, means, scales, records, buf, cap, end_out,
# then the compaction's scratch (dense words, ballots, offsets), L
_FAMILY_ENCODE_ARGS = [_P, _P, _I64, _P, _P, _P, _P, _I64, _P, _P, _P, _P,
                       _I32, *_FAMILY_TAIL]
# its tables pass: syms, means, scales, records, n
_FAMILY_TABLES_ARGS = [_P, _P, _P, _P, _I64, *_FAMILY_TAIL]
# its pass A: states, records, n, words, flags, L
_FAMILY_LANES_ARGS = [_P, _P, _I64, _P, _P, _I32, _P, _I32]
_FAMILY_LEFT_ARGS = [_P, _P, _P, _P, _I64, *_FAMILY_TAIL]
# after end_out: the scratch (records, dense words, ballots, compaction
# offsets)
_TCHAIN12_DECODE_ARGS = [_P, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P,
                         _I32, _I32, *_FAMILY_TAIL]
_TCHAIN12_INVERT_ARGS = [_P, _P, _P, _P, _P, _I32, _I32, *_FAMILY_TAIL]
_TCHAIN12_HEADS_ARGS = [_P, _P, _P, _P, _I32, _I32, _P, _I32]
# kernel 22: its scratch (records, u16 quantiles) after wlen
_TCHAIN12_ENCODE_ARGS = [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _I32, _I32,
                         *_FAMILY_TAIL]
# the cluster size after max_sym
_TCHAIN12_ENCODE_CLUSTER_ARGS = [*_TCHAIN12_ENCODE_ARGS[:14], _I32, _P, _I32]
# kernel 22's tables pass: syms, means, scales, recs, L, T
_TCHAIN12_TABLES_ARGS = [_P, _P, _P, _P, _I32, _I32, *_FAMILY_TAIL]
# kernel 22's cluster step and packing pass: heads, recs, words, wlen, q16,
# qw, L, T
_TCHAIN12_STEP_ARGS = [_P, _P, _P, _I64, _P, _P, _I32, _I32, _P, _I32]
# L, cluster size, out[7]
_TCHAIN12_GEOMETRY_ARGS = [_I32, _I32, _P, _P, _I32]
# kernels 19 and 23: heads, q, cdf, K, syms, buf, cap, end_out, then their
# scratch (dense words, ballots, compaction offsets), L, T
_TCHAIN_DECODE_ARGS = [_P, _P, _P, _I32, _P, _P, _I64, _P, _P, _P, _P, _I32,
                       _I32, _P, _I32]
# their head pass: heads, q, cdf, K, syms, words, flags, L, T
_TCHAIN_HEADS_ARGS = [_P, _P, _P, _I32, _P, _P, _P, _I32, _I32, _P, _I32]
# kernels 20 and 24: the division records' scratch after q
_TCHAIN_ENCODE_ARGS = [_P, _P, _P, _I32, _P, _I64, _P, _P, _I32, _I32, _P,
                       _I32]
# the cluster size after T
_TCHAIN_ENCODE_CLUSTER_ARGS = [*_TCHAIN_ENCODE_ARGS[:10], _I32, _P, _I32]
# L, K, cluster size, out[7]
_TCHAIN_GEOMETRY_ARGS = [_I32, _I32, _I32, _P, _P, _I32]
_D = ctypes.c_double
# kernels 17 and 14: states, cums, probs, n, buf, cap, end_out, their
# scratch (words, flags, offsets), L, P
_EXACT_ENCODE_ARGS = [_P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P, _I32, _I32,
                      _P, _I32]
# their pass A: states, cums, probs, n, words, flags, L, P
_EXACT_ENCODE_LANES_ARGS = [_P, _P, _P, _I64, _P, _P, _I32, _I32, _P, _I32]
_EXACT_DECODE_ARGS = [_P, _P, _I64, _P, _I32, _P, _I64, _I32, _I32, _I32,
                      _I32, _I32, _P, _P, _I32]
# the cluster size after base_io
_EXACT_DECODE_CLUSTER_ARGS = [*_EXACT_DECODE_ARGS[:13], _I32, _P, _I32]
# L, seg (kernel 16's instance), out[5]
_EXACT_GEOMETRY_ARGS = [_I32, _I32, _P, _P, _I32]
# kernel 13's: L, out[5]
_EXACT_GEOMETRY32_ARGS = [_I32, _P, _P, _I32]
_EXACT_EVAL_ARGS = [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _D, _D,
                    _I32, _P, _P, _P, _I32]
SIGNATURES = {
    "ctt_ilans2_decode_w16s32": _DECODE_ARGS,
    "ctt_ilans2_decode_w32s64": _DECODE_ARGS,
    "ctt_ilans2_decode_cluster_w16s32": _DECODE_CLUSTER_ARGS,
    "ctt_ilans2_decode_cluster_w32s64": _DECODE_CLUSTER_ARGS,
    "ctt_ilans2_geometry_w16s32": _GEOMETRY_ARGS,
    "ctt_ilans2_geometry_w32s64": _GEOMETRY_ARGS,
    "ctt_ilans2_encode_w16s32": _ENCODE_WIDE_ARGS,
    "ctt_ilans2_encode_w32s64": _ENCODE_WIDE_ARGS,
    "ctt_ilans2_encode_lanes_w16s32": _ENCODE_LANES_ARGS,
    "ctt_ilans2_encode_lanes_w32s64": _ENCODE_LANES_ARGS,
    "ctt_ilans2_compact": _COMPACT_ARGS,
    "ctt_ilans2_range_record_w16s32": _RANGE_RECORD_ARGS,
    "ctt_ilans2_range_record_w32s64": _RANGE_RECORD_ARGS,
    "ctt_ilans2_range_record_geometry": _RANGE_RECORD_GEOMETRY_ARGS,
    "ctt_ilans2_range_resolve_w16s32": _RANGE_RESOLVE_ARGS,
    "ctt_ilans2_range_resolve_w32s64": _RANGE_RESOLVE_ARGS,
    "ctt_ilans2_range_resolve_lanes_w16s32": _RANGE_RESOLVE_LANES_ARGS,
    "ctt_ilans2_range_resolve_lanes_w32s64": _RANGE_RESOLVE_LANES_ARGS,
    "ctt_ilans2_range_decode_w16s32": _RANGE_DECODE_ARGS,
    "ctt_ilans2_range_decode_w32s64": _RANGE_DECODE_ARGS,
    "ctt_ilans2_range_decode_cluster_w16s32": _RANGE_DECODE_CLUSTER_ARGS,
    "ctt_ilans2_range_decode_cluster_w32s64": _RANGE_DECODE_CLUSTER_ARGS,
    "ctt_ilans2_range_geometry_w16s32": _GEOMETRY_ARGS,
    "ctt_ilans2_range_geometry_w32s64": _GEOMETRY_ARGS,
    "ctt_family_decode": _FAMILY_DECODE_ARGS,
    "ctt_family_decode_cluster": _FAMILY_DECODE_CLUSTER_ARGS,
    "ctt_family_geometry": _FAMILY_GEOMETRY_ARGS,
    "ctt_family_encode": _FAMILY_ENCODE_ARGS,
    "ctt_family_tables_pass": _FAMILY_TABLES_ARGS,
    "ctt_family_encode_lanes": _FAMILY_LANES_ARGS,
    "ctt_family_left": _FAMILY_LEFT_ARGS,
    "ctt_tchain16_decode": _TCHAIN_DECODE_ARGS,
    "ctt_tchain16_head_pass": _TCHAIN_HEADS_ARGS,
    "ctt_tchain16_encode": _TCHAIN_ENCODE_ARGS,
    "ctt_tchain16_encode_cluster": _TCHAIN_ENCODE_CLUSTER_ARGS,
    "ctt_tchain16_geometry": _TCHAIN_GEOMETRY_ARGS,
    "ctt_tchain24_decode": _TCHAIN_DECODE_ARGS,
    "ctt_tchain24_head_pass": _TCHAIN_HEADS_ARGS,
    "ctt_tchain24_encode": _TCHAIN_ENCODE_ARGS,
    "ctt_tchain24_encode_cluster": _TCHAIN_ENCODE_CLUSTER_ARGS,
    "ctt_tchain24_geometry": _TCHAIN_GEOMETRY_ARGS,
    "ctt_tchain12_family_decode": _TCHAIN12_DECODE_ARGS,
    "ctt_tchain12_family_encode": _TCHAIN12_ENCODE_ARGS,
    "ctt_tchain12_family_encode_cluster": _TCHAIN12_ENCODE_CLUSTER_ARGS,
    "ctt_tchain12_tables_pass": _TCHAIN12_TABLES_ARGS,
    "ctt_tchain12_encode_step": _TCHAIN12_STEP_ARGS,
    "ctt_tchain12_geometry": _TCHAIN12_GEOMETRY_ARGS,
    "ctt_tchain12_invert_pass": _TCHAIN12_INVERT_ARGS,
    "ctt_tchain12_head_pass": _TCHAIN12_HEADS_ARGS,
    "ctt_exact_encode64": _EXACT_ENCODE_ARGS,
    "ctt_exact_encode_lanes64": _EXACT_ENCODE_LANES_ARGS,
    "ctt_exact_encode32": _EXACT_ENCODE_ARGS,
    "ctt_exact_encode_lanes32": _EXACT_ENCODE_LANES_ARGS,
    "ctt_exact_decode64": _EXACT_DECODE_ARGS,
    "ctt_exact_decode32": _EXACT_DECODE_ARGS,
    "ctt_exact_decode32_cluster": _EXACT_DECODE_CLUSTER_ARGS,
    "ctt_exact_decode64_seg": _EXACT_DECODE_ARGS,
    "ctt_exact_decode64_seg_cluster": _EXACT_DECODE_CLUSTER_ARGS,
    "ctt_exact_geometry64": _EXACT_GEOMETRY_ARGS,
    "ctt_exact_geometry32": _EXACT_GEOMETRY32_ARGS,
    "ctt_exact_eval_window": _EXACT_EVAL_ARGS,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build in this process did: seconds spent and nvcc's output
# (register and shared-memory use per kernel from -Xptxas -v); None when the
# library was already on disk
build_info: dict | None = None


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _key(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels of "
        "constriction_tpu_torch cannot be built"
    )


def _compile(sources: list[str], out: str) -> None:
    """One nvcc per ``.cu`` into an object, all running at once, then one
    link into ``out``."""
    global build_info
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    cus = [src for src in sources if src.endswith(".cu")]
    objs = [f"{tmp}.{i}.o" for i in range(len(cus))]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for obj, src in zip(objs, cus)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    done = subprocess.run(link, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if done.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({done.returncode}): {' '.join(link)}\n"
            f"{done.stdout}{done.stderr}")
    log = "".join(logs) + done.stdout + done.stderr
    with open(_log_path(out), "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    build_info = {
        "seconds": time.perf_counter() - t0,
        "command": "; ".join(" ".join(c) for c in (*cmds, link)),
        "log": log,
    }


def _log_path(out: str) -> str:
    return os.path.join(os.path.dirname(out), "nvcc.log")


def _library_path() -> str:
    sources = _sources()
    return os.path.join(BUILD_ROOT, _key(sources), "libctt_kernels.so")


def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process.
    JAX counterpart: the jit compile in the Pallas ``_build_*`` functions."""
    global _lib
    with _lock:
        if _lib is None:
            out = _library_path()
            if not os.path.exists(out):
                _compile(_sources(), out)
            lib = ctypes.CDLL(out)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ctt_error_string.argtypes = [ctypes.c_int]
            lib.ctt_error_string.restype = ctypes.c_char_p
            lib.ctt_clear_error.argtypes = []
            lib.ctt_clear_error.restype = ctypes.c_int
            _lib = lib
        return _lib


def ptxas_log() -> str:
    """nvcc's output for the library this process loads (building it
    first): ``-Xptxas -v`` gives each kernel's registers, shared memory and
    spill bytes.  Kept beside the library, so it is there when an earlier
    process built it."""
    library()
    with open(_log_path(_library_path())) as f:
        return f.read()


def ptxas_spills(log: str) -> dict:
    """{mangled kernel name: (spill store bytes, spill load bytes)} from
    nvcc's ``-Xptxas -v`` output (:func:`ptxas_log`)."""
    out = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln and "'" in ln:
            name = ln.split("'")[1]
        elif name is not None and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m:
                out[name] = (int(m.group(1)), int(m.group(2)))
    return out


def _arg(x):
    if isinstance(x, torch.Tensor):
        return ctypes.c_void_p(x.data_ptr())
    return x


def call(name: str, device: torch.device, *args) -> None:
    """Launch C entry ``name`` on ``device``'s current stream; tensors pass
    as their data pointers.  Raises RuntimeError on a nonzero CUDA error,
    after resetting the runtime's last error so that the next call does not
    report it again.
    JAX counterpart: calling a built Pallas kernel, ``fn(*arrays)``."""
    lib = library()
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = torch.cuda.current_stream(index).cuda_stream
    err = getattr(lib, name)(
        *(_arg(a) for a in args), ctypes.c_void_p(stream), index
    )
    if err != 0:
        lib.ctt_clear_error()
        msg = lib.ctt_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
