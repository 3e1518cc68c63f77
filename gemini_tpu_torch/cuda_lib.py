"""Build and bind the port's hand-written CUDA kernels.

Every `csrc/*.cu` source is compiled by its own `nvcc` (all started
together) for sm_90a into `_build/lib<stem>_<hash>.so`, a shared library
with a plain C interface, and loaded with ctypes.  The hash covers the
library's own `.cu`, the shared `csrc/*.cuh` headers and the flags, so
an edit rebuilds the libraries it reaches and no other; the build runs
under a file lock so concurrent processes share it.  Nothing is built
when a module is imported: the first launch builds.
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

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}
_lock = threading.Lock()


def _tag(cu: str) -> str:
    """Hash of the flags, the shared headers and the library's own source."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [cu]:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(stems=None) -> dict:
    """Compile each csrc/*.cu (or only those named in `stems`) that has
    no library for the current sources yet, one nvcc process per source,
    all running at once.  Returns {stem: (library path, ptxas's register
    and spill report, "" for a library built before)}; raises with
    nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    cus = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    libs = {os.path.splitext(os.path.basename(cu))[0]: cu for cu in cus}
    if stems is not None:
        libs = {stem: libs[stem] for stem in stems}
    out = {stem: os.path.join(BUILD_DIR, f"lib{stem}_{_tag(cu)}.so")
           for stem, cu in libs.items()}
    reports = dict.fromkeys(libs, "")
    with open(os.path.join(BUILD_DIR, "kernels.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        procs = {}
        for stem, cu in libs.items():
            if os.path.exists(out[stem]):
                continue
            tmp = f"{out[stem]}.tmp.{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, cu]
            procs[stem] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for stem, (tmp, proc) in procs.items():
            so, se = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{so}\n{se}")
                continue
            reports[stem] = se
            os.replace(tmp, out[stem])
        if errors:
            raise RuntimeError("\n".join(errors))
    return {stem: (out[stem], reports[stem]) for stem in libs}


def library(stem: str, bind) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu (built at first use);
    `bind(lib)` sets argtypes and restypes once."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(build(stems=[stem])[stem][0])
            bind(lib)
            _libs[stem] = lib
    return lib

