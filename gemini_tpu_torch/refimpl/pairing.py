"""Ground-truth optimal ate pairing for BLS12-381.

Used directly by the KZG verifier (a handful of pairings per proof —
speed-irrelevant, mirrors the reference's pairing checks in
reference src/kzg/mod.rs:155-244) and as oracle for any future
on-device pairing kernel.

Strategy: embed G2 into E(Fq12) through the sextic untwist
(x, y) -> (x / w^2, y / w^3), then run a plain affine Miller loop over
|BLS_X| with line evaluations in Fq12, conjugate (since BLS_X < 0), and
do the final exponentiation as easy part (q^6-1)(q^2+1) via
conjugation/Frobenius plus a naive square-and-multiply hard part.
"""

from __future__ import annotations

from ..params import Q, R, BLS_X_ABS
from .fields import Fq2, Fq6, Fq12
from .curve import G1Affine, G2Affine


def _untwist(p: G2Affine):
    """Map a twist point (Fq2 coords) into E(Fq12)."""
    x, y = p
    # w^2 and w^3 as Fq12 elements: w^2 = v (c0.c1), w^3 = v*w (c1.c1).
    w2 = Fq12(Fq6(Fq2.zero(), Fq2.one(), Fq2.zero()), Fq6.zero())
    w3 = Fq12(Fq6.zero(), Fq6(Fq2.zero(), Fq2.one(), Fq2.zero()))
    xe = Fq12(Fq6(x, Fq2.zero(), Fq2.zero()), Fq6.zero())
    ye = Fq12(Fq6(y, Fq2.zero(), Fq2.zero()), Fq6.zero())
    return (xe / w2, ye / w3)


def _fq12_scalar(n: int) -> Fq12:
    return Fq12(Fq6(Fq2(n, 0), Fq2.zero(), Fq2.zero()), Fq6.zero())


def _line(t, u, px: Fq12, py: Fq12) -> Fq12:
    """Evaluate the line through points t, u of E(Fq12) at (px, py)."""
    tx, ty = t
    ux, uy = u
    if tx == ux and ty == uy:
        lam = tx.square() * _fq12_scalar(3) / (ty * _fq12_scalar(2))
    elif tx == ux:
        # vertical line
        return px - tx
    else:
        lam = (uy - ty) / (ux - tx)
    return py - ty - lam * (px - tx)


def _ec_add12(t, u):
    if t is None:
        return u
    if u is None:
        return t
    tx, ty = t
    ux, uy = u
    if tx == ux:
        if (ty + uy).is_zero():
            return None
        lam = tx.square() * _fq12_scalar(3) / (ty * _fq12_scalar(2))
    else:
        lam = (uy - ty) / (ux - tx)
    x3 = lam.square() - tx - ux
    y3 = lam * (tx - x3) - ty
    return (x3, y3)


def miller_loop(p: G1Affine, q: G2Affine) -> Fq12:
    if p is None or q is None:
        return Fq12.one()
    px = _fq12_scalar(p[0])
    py = _fq12_scalar(p[1])
    qe = _untwist(q)
    t = qe
    f = Fq12.one()
    bits = bin(BLS_X_ABS)[3:]  # skip MSB
    for bit in bits:
        f = f.square() * _line(t, t, px, py)
        t = _ec_add12(t, t)
        if bit == "1":
            f = f * _line(t, qe, px, py)
            t = _ec_add12(t, qe)
    # BLS_X is negative: conjugate the Miller value.
    return f.conj()


_HARD_EXP = (Q**4 - Q**2 + 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    # Easy part: f^((q^6-1)(q^2+1)).
    f = f.conj() * f.inv()
    f = f.frobenius(2) * f
    # Hard part (naive; group order in the cyclotomic subgroup).
    return f**_HARD_EXP


def pairing(p: G1Affine, q: G2Affine) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def gt_pow(g: Fq12, e: int) -> Fq12:
    return g ** (e % R)
