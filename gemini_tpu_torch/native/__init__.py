"""Native (C++) runtime components, loaded via ctypes.

The reference's native layer lives in its dependencies (ark-ff asm
Montgomery kernels, merlin's STROBE, rayon).  Here the TPU owns the
arithmetic; the native layer owns the host-side runtime hot paths —
currently the Fiat-Shamir transcript engine (transcript.cpp), which is
~100x the pure-Python Keccak.

The library is compiled on first use with g++ into the package's
`_build/` directory, once per source hash and under a file lock, so
concurrent processes share one build; everything degrades gracefully
to the pure-Python implementations if no toolchain is available.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SRC = os.path.join(_DIR, "transcript.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def build_shared(src: str, stem: str, timeout: int) -> str | None:
    """Compile `src` with g++ into `_build/<stem>_<hash>.so` unless that
    file exists; the build runs under an exclusive file lock, so the
    first process builds and the others wait and reuse it.  Returns the
    library path, or None when the toolchain fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    with open(os.path.join(BUILD_DIR, f"{stem}.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.tmp.{os.getpid()}"
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", src, "-o", tmp],
                check=True, capture_output=True, timeout=timeout,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, so)
    return so


def load():
    """The transcript library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build_shared(_SRC, "libgemini_transcript", 120)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.merlin_new.restype = ctypes.c_void_p
            lib.merlin_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.merlin_append.restype = None
            lib.merlin_append.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.merlin_challenge.restype = None
            lib.merlin_challenge.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.merlin_free.restype = None
            lib.merlin_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


class NativeTranscript:
    """ctypes wrapper with the same interface as transcript.Transcript."""

    def __init__(self, label: bytes):
        self._lib = load()
        assert self._lib is not None
        self._h = self._lib.merlin_new(label, len(label))

    def append_message(self, label: bytes, message: bytes) -> None:
        self._lib.merlin_append(
            self._h, label, len(label), message, len(message)
        )

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        out = ctypes.create_string_buffer(n)
        self._lib.merlin_challenge(self._h, label, len(label), out, n)
        return out.raw

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.merlin_free(self._h)
                self._h = None
        except Exception:
            pass
