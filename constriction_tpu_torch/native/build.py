"""Builds the native host codec: ``python -m constriction_tpu_torch.native.build``.

Compiles ``codec.cpp`` and ``surrogate.cpp`` with g++ (both started
together) and links them into ``libctpu.so`` under
``build/constriction_tpu_torch/native/<hash>/`` at the root of the
checkout, keyed by a hash of the sources, the compiler and the flags, so
an edited source never loads a stale binary.  One process builds while
the others wait on a lock file, and the library is compiled to a
per-process temporary file and moved into place with ``os.replace``, so a
concurrent process never loads half a file.  A missing compiler or a
failed build raises RuntimeError with the compiler's output; nothing
continues on a numpy path.

The flags are part of the bit contract:

- ``codec.cpp``: ``-O3 -ffp-contract=off``.  GCC's default
  ``-ffp-contract=fast`` would fuse ``a*b+c`` under ``-mfma`` and change
  the CDF bits of the exact families;
- ``surrogate.cpp``: ``-O3 -ffast-math``.  Its only contract is an error
  bound, and codec.cpp re-derives every margin-close decision exactly;
- ``-mavx2 -mfma`` only where ``/proc/cpuinfo`` lists both.

JAX counterpart: ``constriction_tpu/native/build.py`` (same flags; it
writes ``libctpu.so`` beside the sources).
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("codec.cpp", "surrogate.cpp")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(HERE)), "build", "constriction_tpu_torch",
    "native",
)
CXX = "g++"
COMMON_FLAGS = ("-fopenmp", "-fPIC", "-std=c++17")
SOURCE_FLAGS = {
    "codec.cpp": ("-O3", "-ffp-contract=off"),
    "surrogate.cpp": ("-O3", "-ffast-math"),
}
# internal calls between the library's exports bind inside the library,
# whatever else the process has loaded
LINK_FLAGS = ("-shared", "-Wl,-Bsymbolic")

# what the last build in this process did: seconds and commands; None when
# the library was already on disk
build_info: dict | None = None


def simd_flags() -> tuple:
    """AVX2 + FMA where the building machine has both (the library is
    always built on the machine that runs it)."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = f.read()
    except OSError:
        return ()
    if " avx2" in flags and " fma" in flags:
        return ("-mavx2", "-mfma")
    return ()


def _commands(cxx: str, out: str) -> list:
    simd = simd_flags()
    objs = [f"{out}.{i}.o" for i in range(len(SOURCES))]
    compiles = [
        [cxx, *SOURCE_FLAGS[src], *simd, *COMMON_FLAGS, "-c",
         os.path.join(HERE, src), "-o", obj]
        for src, obj in zip(SOURCES, objs)
    ]
    link = [cxx, *COMMON_FLAGS, *LINK_FLAGS, "-o", out, *objs]
    return compiles, link, objs


def library_path(root: str = BUILD_ROOT, cxx: str = CXX) -> str:
    """Where :func:`build` puts the library for these sources and flags."""
    h = hashlib.sha256(repr((cxx, COMMON_FLAGS, SOURCE_FLAGS, LINK_FLAGS,
                             simd_flags())).encode())
    for src in SOURCES:
        h.update(src.encode())
        with open(os.path.join(HERE, src), "rb") as f:
            h.update(f.read())
    return os.path.join(root, h.hexdigest()[:16], "libctpu.so")


def _run(cmds: list) -> None:
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
    except OSError as e:
        raise RuntimeError(
            f"cannot run the C++ compiler {cmds[0][0]!r}: {e}; the host "
            "codec of constriction_tpu_torch needs g++") from e
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed ({proc.returncode}): {' '.join(cmd)}\n{log}")


def build(root: str = BUILD_ROOT, cxx: str = CXX) -> str:
    """Build the library unless it is on disk; returns its path.  ``cxx``
    is the compiler to run (the only way to pick another)."""
    global build_info
    out = library_path(root, cxx)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        compiles, link, objs = _commands(cxx, tmp)
        t0 = time.perf_counter()
        try:
            _run(compiles)
            _run([link])
            os.replace(tmp, out)
        finally:
            for path in (*objs, tmp):
                if os.path.exists(path):
                    os.remove(path)
        build_info = {
            "seconds": time.perf_counter() - t0,
            "command": "; ".join(" ".join(c) for c in (*compiles, link)),
        }
    return out


if __name__ == "__main__":
    print(build())
