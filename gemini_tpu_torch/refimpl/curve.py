"""Ground-truth G1/G2 group operations (affine, Python ints).

Points are `None` for the identity, else tuples:
  G1Affine = (Fq-int x, Fq-int y)        -- ints mod Q
  G2Affine = (Fq2 x, Fq2 y)

Mirrors the role of `ark-ec` short-Weierstrass ops in the reference
(SURVEY.md L0); formulas are the generic affine chord-and-tangent laws.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..params import Q, G1_X, G1_Y, G2_X0, G2_X1, G2_Y0, G2_Y1
from .fields import Fq2

G1Affine = Optional[Tuple[int, int]]
G2Affine = Optional[Tuple[Fq2, Fq2]]


def g1_generator() -> G1Affine:
    return (G1_X, G1_Y)


def g2_generator() -> G2Affine:
    return (Fq2(G2_X0, G2_X1), Fq2(G2_Y0, G2_Y1))


def g1_is_on_curve(p: G1Affine) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + 4)) % Q == 0


def g2_is_on_curve(p: G2Affine) -> bool:
    if p is None:
        return True
    x, y = p
    return y.square() == x * x.square() + Fq2(4, 4)


def g1_neg(p: G1Affine) -> G1Affine:
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def g1_double(p: G1Affine) -> G1Affine:
    if p is None or p[1] == 0:
        return None
    x, y = p
    lam = (3 * x * x) * pow(2 * y, -1, Q) % Q
    x3 = (lam * lam - 2 * x) % Q
    y3 = (lam * (x - x3) - y) % Q
    return (x3, y3)


def g1_add(p: G1Affine, q: G1Affine) -> G1Affine:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        return g1_double(p)
    lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_mul(p: G1Affine, k: int) -> G1Affine:
    if k < 0:
        return g1_mul(g1_neg(p), -k)
    r: G1Affine = None
    b = p
    while k:
        if k & 1:
            r = g1_add(r, b)
        b = g1_double(b)
        k >>= 1
    return r


def g1_msm(points, scalars) -> G1Affine:
    """Naive MSM: sum_i scalars[i] * points[i]."""
    acc: G1Affine = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, int(s)))
    return acc


def g1_msm_pippenger(points, scalars, c: int = 8,
                     n_bits: int = 255) -> G1Affine:
    """Bucketed host MSM (the variable_base.rs:99-136 algorithm:
    window digits -> bucket accumulation -> running-sum finalize).
    ~ceil(n_bits/c) * (n + 2^(c+1)) affine adds instead of the naive
    ~1.5*n_bits per scalar — the host fallback for protocol-scale MSMs
    on the CPU backend (ops/msm.py), where compiling the full TPU
    pipeline for a tiny n dominates fresh-environment suite time."""
    ks = [int(s) for s in scalars]
    acc: G1Affine = None
    for w0 in reversed(range(0, n_bits, c)):
        if acc is not None:
            for _ in range(c):
                acc = g1_double(acc)
        buckets: list = [None] * (1 << c)
        for p, k in zip(points, ks):
            d = (k >> w0) & ((1 << c) - 1)
            if d and p is not None:
                buckets[d] = g1_add(buckets[d], p)
        run: G1Affine = None
        win: G1Affine = None
        for b in reversed(range(1, 1 << c)):
            run = g1_add(run, buckets[b])
            win = g1_add(win, run)
        acc = g1_add(acc, win)
    return acc


def g2_neg(p: G2Affine) -> G2Affine:
    if p is None:
        return None
    return (p[0], -p[1])


def g2_double(p: G2Affine) -> G2Affine:
    if p is None or p[1].is_zero():
        return None
    x, y = p
    lam = (x.square() * 3) / (y * 2)
    x3 = lam.square() - x * 2
    y3 = lam * (x - x3) - y
    return (x3, y3)


def g2_add(p: G2Affine, q: G2Affine) -> G2Affine:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        return g2_double(p)
    lam = (y2 - y1) / (x2 - x1)
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_mul(p: G2Affine, k: int) -> G2Affine:
    if k < 0:
        return g2_mul(g2_neg(p), -k)
    r: G2Affine = None
    b = p
    while k:
        if k & 1:
            r = g2_add(r, b)
        b = g2_double(b)
        k >>= 1
    return r
