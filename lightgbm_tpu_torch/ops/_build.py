"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, into ``build/torch_kernels/`` at the root of the
checkout (git-ignored), and is redone when the sources' hash changes.  One
``nvcc -c`` per source, all started together, then one link.

A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_kernels")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: no a*b+c contraction into FMA, so the wave kernel's scan
# rounds every product and sum as the plain version's separate torch ops do
CFLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: facts about the last build or load in this process (chip_smoke prints them)
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set NVCC or add it to PATH)")


def _sources():
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
    for p in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(p, "rb") as fh:
            h.update(os.path.basename(p).encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def _compile(srcs, out_dir: str, lib_path: str) -> str:
    """Compile every source in parallel, then link; returns the ptxas
    report (registers, shared memory, spills per kernel)."""
    nvcc = _nvcc()
    procs = []
    for src in srcs:
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", "-o", obj, src]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report, errors = [], []
    for src, _obj, proc in procs:
        text, _ = proc.communicate()
        report.append(text)
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(src)}:\n{text}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
         *[obj for _s, obj, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return "".join(report)


_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
#: every C entry point's argument types (all return an int CUDA error)
SIGNATURES = {
    "lgbt_traverse_table": [_P] * 5 + [_I64] + [_I32] * 9 + [_P],
    "lgbt_histogram": [_P, _P, _I64] + [_I32] * 6 + [_P] * 3,
    "lgbt_histogram_i8": [_P, _P, _I64] + [_I32] * 7 + [_P] * 3,
    "lgbt_histogram_u16": [_P, _P, _I64] + [_I32] * 5 + [_P] * 3,
    "lgbt_histogram_i8_u16": [_P, _P, _I64] + [_I32] * 6 + [_P] * 3,
    "lgbt_wave": ([_P] * 3 + [_I32] * 2 + [_P] + [_I32] * 3 + [_P] * 4
                  + [_F32] * 7 + [_I32] * 5 + [_P] * 4),
    "lgbt_wave_i8": ([_P] * 3 + [_I32] * 2 + [_P] + [_I32] * 5 + [_P] * 5
                     + [_F32] * 7 + [_I32] * 4 + [_P] * 4),
    "lgbt_wave_u16": ([_P] * 3 + [_I32] * 2 + [_P] + [_I32] * 3 + [_P] * 4
                      + [_F32] * 7 + [_I32] * 4 + [_P] * 4),
    "lgbt_wave_i8_u16": ([_P] * 3 + [_I32] * 2 + [_P] + [_I32] * 5
                         + [_P] * 5 + [_F32] * 7 + [_I32] * 3 + [_P] * 4),
    "lgbt_wave_node_table": [],
}
#: the position of the node table in each wave entry point's arguments
#: (the argument after ``meta``; builds before it lack it)
NODE_ARG = {"lgbt_wave": 12, "lgbt_wave_u16": 12, "lgbt_wave_i8": 14,
            "lgbt_wave_i8_u16": 14}


def _bind(lib: ctypes.CDLL, only_present: bool = False) -> None:
    """Set each entry point's ctypes signature; with ``only_present``
    (another commit's build, tools/torch_kernel_ab.py) skip those the
    library lacks."""
    for name, argtypes in SIGNATURES.items():
        if only_present and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.restype = _I32
        fn.argtypes = argtypes


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use (cached by hash)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        digest = _digest(srcs)
        out_dir = os.path.join(BUILD_DIR, digest)
        os.makedirs(out_dir, exist_ok=True)
        lib_path = os.path.join(out_dir, "liblgbt_kernels.so")
        report_path = os.path.join(out_dir, "ptxas.txt")
        t0 = time.perf_counter()
        built = False
        with open(os.path.join(out_dir, "lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if not os.path.exists(lib_path):
                    report = _compile(srcs, out_dir, lib_path)
                    with open(report_path, "w") as fh:
                        fh.write(report)
                    built = True
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
        lib = ctypes.CDLL(lib_path)
        _bind(lib)
        report = ""
        if os.path.exists(report_path):
            with open(report_path) as fh:
                report = fh.read()
        build_info.update(path=lib_path, digest=digest, built=built,
                          seconds=time.perf_counter() - t0,
                          sources=[os.path.relpath(s, os.path.dirname(
                              os.path.dirname(_HERE))) for s in srcs],
                          ptxas=report)
        _lib = lib
        return lib
