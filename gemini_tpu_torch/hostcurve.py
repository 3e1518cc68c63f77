"""Host-side curve/pairing dispatch: native C++ when available
(native/bls.py, ~100-1000x), pure-Python refimpl otherwise.

This is the host analog of the reference's ark-ec/ark-ff `asm` feature
(reference Cargo.toml:79): protocol code calls these names and
gets the fastest correct backend.  refimpl stays the untouched oracle;
tests/test_native.py pins native == refimpl on every exported op.

Force the Python path with GEMINI_TPU_NATIVE_BLS=0.
"""

from __future__ import annotations

from . import refimpl as _ri
from .refimpl import G1Affine, G2Affine  # re-export types


def _native():
    from .native import bls

    return bls if bls.available() else None


def g1_add(p, q):
    b = _native()
    return b.g1_add(p, q) if b else _ri.g1_add(p, q)


def g1_double(p):
    b = _native()
    return b.g1_add(p, p) if b else _ri.g1_double(p)


def g1_neg(p):
    return _ri.g1_neg(p)


def g1_mul(p, k):
    b = _native()
    return b.g1_mul(p, k) if b else _ri.g1_mul(p, k)


def g2_add(p, q):
    b = _native()
    return b.g2_add(p, q) if b else _ri.g2_add(p, q)


def g2_mul(p, k):
    b = _native()
    return b.g2_mul(p, k) if b else _ri.g2_mul(p, k)


def g2_neg(p):
    return _ri.g2_neg(p)


def g1_msm(points, scalars):
    b = _native()
    return b.g1_msm(points, scalars) if b else _ri.g1_msm_pippenger(
        points, scalars)


def g1_msm_pippenger(points, scalars, *a, **k):
    """Drop-in for refimpl.g1_msm_pippenger (extra window args are a
    refimpl tuning detail the native backend chooses itself)."""
    b = _native()
    return b.g1_msm(points, scalars) if b else _ri.g1_msm_pippenger(
        points, scalars, *a, **k)


def pairing(p, q):
    b = _native()
    return b.pairing(p, q) if b else _ri.pairing(p, q)


def multi_pairing(g1s, g2s):
    """prod_i e(P_i, Q_i) — one shared final exponentiation on the
    native path (the ark-ec `multi_pairing` analog)."""
    b = _native()
    if b:
        return b.multi_pairing(g1s, g2s)
    acc = _ri.Fq12.one()
    for p, q in zip(g1s, g2s):
        acc = acc * _ri.miller_loop(p, q)
    return _ri.final_exponentiation(acc)
