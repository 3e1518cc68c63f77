"""ctypes wrapper for the native BLS12-381 host library
(bls12_381.cpp): G1/G2 group ops, Pippenger MSM, and the optimal ate
pairing, bit-identical to the refimpl Python ground truth (tested).

The loader mirrors native/__init__.py (transcript): compile on first
use with g++ into `_build/` (native.build_shared), degrade to None (the
callers fall back to refimpl) when no toolchain is available.  Disable
with GEMINI_TPU_NATIVE_BLS=0.

API mirrors refimpl signatures: G1 points are (x, y) int tuples or
None; G2 points are (Fq2, Fq2) tuples or None; pairings return
refimpl Fq12.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

from ..params import Q, R
from . import build_shared

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bls12_381.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GEMINI_TPU_NATIVE_BLS") == "0":
            return None
        so = build_shared(_SRC, "libgemini_bls", 240)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            u8p = ctypes.POINTER(ctypes.c_ubyte)
            for name, argn in (
                ("bls_g1_add", 3), ("bls_g1_mul", 3), ("bls_g2_add", 3),
                ("bls_g2_mul", 3), ("bls_pairing", 3),
            ):
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = [ctypes.c_char_p] * (argn - 1) + [u8p]
            lib.bls_g1_msm.restype = None
            lib.bls_g1_msm.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, u8p]
            lib.bls_g1_fixed_base.restype = None
            lib.bls_g1_fixed_base.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, u8p]
            lib.bls_multi_pairing.restype = None
            lib.bls_multi_pairing.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t, u8p]
            if not _selftest(lib):
                return None
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def _selftest(lib) -> bool:
    """Generator sanity: 2G via add == mul, on-curve, pairing
    bilinearity spot check is covered by the test suite; here just a
    cheap add/mul consistency gate so a miscompiled library is never
    used silently."""
    from ..refimpl import g1_generator, g1_add, g1_double

    g = g1_generator()
    out = (ctypes.c_ubyte * 97)()
    lib.bls_g1_add(_g1_bytes(g), _g1_bytes(g), out)
    return _g1_parse(bytes(out)) == g1_add(g, g1_double(None) or g)


# -- codecs -----------------------------------------------------------------


def _fq_bytes(x: int) -> bytes:
    return (x % Q).to_bytes(48, "little")


def _g1_bytes(p) -> bytes:
    if p is None:
        return b"\x01" + bytes(96)
    return b"\x00" + _fq_bytes(p[0]) + _fq_bytes(p[1])


def _g1_parse(b: bytes):
    if b[0]:
        return None
    return (int.from_bytes(b[1:49], "little"),
            int.from_bytes(b[49:97], "little"))


def _g2_bytes(p) -> bytes:
    if p is None:
        return b"\x01" + bytes(192)
    x, y = p
    return (b"\x00" + _fq_bytes(x.c0.n) + _fq_bytes(x.c1.n)
            + _fq_bytes(y.c0.n) + _fq_bytes(y.c1.n))


def _g2_parse(b: bytes):
    from ..refimpl.fields import Fq2

    if b[0]:
        return None
    vals = [int.from_bytes(b[1 + 48 * i:49 + 48 * i], "little")
            for i in range(4)]
    return (Fq2(vals[0], vals[1]), Fq2(vals[2], vals[3]))


def _fq12_parse(b: bytes):
    from ..refimpl.fields import Fq2, Fq6, Fq12

    vals = [int.from_bytes(b[48 * i:48 * (i + 1)], "little")
            for i in range(12)]
    f2 = [Fq2(vals[2 * i], vals[2 * i + 1]) for i in range(6)]
    return Fq12(Fq6(f2[0], f2[1], f2[2]), Fq6(f2[3], f2[4], f2[5]))


# -- API --------------------------------------------------------------------


def available() -> bool:
    return load() is not None


def g1_add(p, q):
    lib = load()
    out = (ctypes.c_ubyte * 97)()
    lib.bls_g1_add(_g1_bytes(p), _g1_bytes(q), out)
    return _g1_parse(bytes(out))


def g1_mul(p, k: int):
    lib = load()
    out = (ctypes.c_ubyte * 97)()
    lib.bls_g1_mul(_g1_bytes(p), (k % R).to_bytes(32, "little"), out)
    return _g1_parse(bytes(out))


def g2_add(p, q):
    lib = load()
    out = (ctypes.c_ubyte * 193)()
    lib.bls_g2_add(_g2_bytes(p), _g2_bytes(q), out)
    return _g2_parse(bytes(out))


def g2_mul(p, k: int):
    lib = load()
    out = (ctypes.c_ubyte * 193)()
    lib.bls_g2_mul(_g2_bytes(p), (k % R).to_bytes(32, "little"), out)
    return _g2_parse(bytes(out))


def g1_msm(points, scalars) -> Optional[Tuple[int, int]]:
    if len(points) != len(scalars):
        raise ValueError(f"g1_msm: {len(points)} points, {len(scalars)} scalars")
    lib = load()
    pts = b"".join(_g1_bytes(p) for p in points)
    ks = b"".join((k % R).to_bytes(32, "little") for k in scalars)
    out = (ctypes.c_ubyte * 97)()
    lib.bls_g1_msm(pts, ks, len(points), out)
    return _g1_parse(bytes(out))


def g1_fixed_base(base, scalars) -> List[Optional[Tuple[int, int]]]:
    """[k * base for k in scalars] via a shared window table (the SRS
    setup workload, kzg/time.rs:49-72)."""
    lib = load()
    ks = b"".join((k % R).to_bytes(32, "little") for k in scalars)
    out = (ctypes.c_ubyte * (97 * len(scalars)))()
    lib.bls_g1_fixed_base(_g1_bytes(base), ks, len(scalars), out)
    raw = bytes(out)
    return [_g1_parse(raw[97 * i:97 * (i + 1)])
            for i in range(len(scalars))]


def pairing(p, q):
    lib = load()
    out = (ctypes.c_ubyte * 576)()
    lib.bls_pairing(_g1_bytes(p), _g2_bytes(q), out)
    return _fq12_parse(bytes(out))


def multi_pairing(g1s: List, g2s: List):
    """prod_i e(P_i, Q_i) with ONE shared final exponentiation."""
    if len(g1s) != len(g2s):
        raise ValueError(f"multi_pairing: {len(g1s)} G1 points, {len(g2s)} G2 points")
    lib = load()
    ps = b"".join(_g1_bytes(p) for p in g1s)
    qs = b"".join(_g2_bytes(q) for q in g2s)
    out = (ctypes.c_ubyte * 576)()
    lib.bls_multi_pairing(ps, qs, len(g1s), out)
    return _fq12_parse(bytes(out))
