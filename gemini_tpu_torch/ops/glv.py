"""GLV endomorphism decomposition for BLS12-381 G1 MSM (port of
gemini_tpu/ops/glv.py).

BLS12-381's G1 carries the cube-root endomorphism phi(x, y) =
(beta*x, y) with phi(P) = lambda*P, lambda = z^2 - 1 (z the BLS
parameter), lambda^2 + lambda + 1 = 0 mod r.  Splitting every scalar
k = k1 + k2*lambda with |k1|, |k2| <= ~2^126.43 halves the Pippenger
window count: the points double (P and phi(P)), so the n adds per
window are unchanged, but the per-window bucket overhead, sorts, digit
extraction and Horner chain halve.

Decomposition (one exact rounded division, vectorized over the lanes):

    c1 = round(k * z^2 / r)            # Barrett + exact correction
    k2 = c1,  k1 = k - c1*(z^2 - 1)    # k1 + k2*lambda == k  (exactly)
    if k2 > z^2/2:  k2 -= z^2, k1 -= 1 # balance: z^2*lambda == -1 mod r

yielding |k1|, |k2| <= (z^2+1)/2, inside the signed-digit capacity of
128-bit windows.  Component signs fold into the per-digit negation
flags the MSM sort already consumes.

The limb arithmetic is the reference's: products against constants as
column sums, carries resolved by a sequential scan over the rows
(`_carry_norm`), every result mod 2^(16 * limbs).  The reference works
in uint32 with wraparound; here the rows are int64 and each step masks
to 16 bits and carries explicitly, which gives the same limbs and sign
flags.  `decompose` is plain torch on the scalars' device; `endo_x` is
one Fq Montgomery product, the `mont_mul` kernel on CUDA.
"""

from __future__ import annotations

import torch

from ..fields import fp
from ..fields.fp import FQ, I32, I64
from ..params import R

LIMB_BITS = 16
MASK = 0xFFFF

Z = -0xD201000000010000  # BLS12-381 parameter
Z2 = Z * Z  # 127.43 bits
LAMBDA = (Z2 - 1) % R  # cube root of unity mod r (== Z2 - 1, < r)
# beta: the cube root of unity in Fq with (beta*x, y) == lambda * (x, y)
BETA = 0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAC

# Barrett reciprocal: mu = floor(2^S / r).  t = k*z^2 + r//2 < 2^383;
# S = 512 makes the approximation error < 2, so two conditional
# corrections are exact.
_S = 512
_MU = (1 << _S) // R

# Per-component magnitude bound: (z^2+1)/2 + 1.
COMPONENT_BOUND = (Z2 + 1) // 2 + 1
GLV_BITS = 128  # signed windows over 128 bits cover +-2^127


def _limbs(x: int, n: int) -> list:
    return [(x >> (LIMB_BITS * i)) & MASK for i in range(n)]


def _scan(rows: torch.Tensor):
    """Sequential carry scan over the rows of an owned int64 tensor, in
    place: rows -> exact 16-bit limbs of sum_i rows[i] 2^(16 i) mod
    2^(16 L); returns (limbs, carry out of the top limb)."""
    carry = None
    for row in rows:  # views: three kernels per row, no copies
        if carry is not None:
            row.add_(carry)
        carry = row >> LIMB_BITS
        row.bitwise_and_(MASK)
    return rows, carry


def _carry_norm(rows: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """(L, n) non-negative int64 rows -> exact 16-bit limbs of the
    represented value mod 2^(16 * out_limbs) (rows past out_limbs are
    multiples of it and dropped)."""
    L, n = rows.shape
    out = rows.new_zeros((out_limbs, n))
    m = min(L, out_limbs)
    out[:m] = rows[:m]
    return _scan(out)[0]


def _const_mul(a: torch.Tensor, const: int, const_limbs: int,
               out_limbs: int) -> torch.Tensor:
    """(L, n) 16-bit limbs x constant -> (out_limbs, n) int64 column sums
    (each < 17 * 2^32) of the product's terms below 2^(16 * out_limbs):
    one row-slab multiply-add per nonzero constant limb."""
    L, n = a.shape
    rows = a.new_zeros((out_limbs, n), dtype=I64)
    for j, cj in enumerate(_limbs(const, const_limbs)):
        m = min(L, out_limbs - j)
        if m <= 0:
            break
        if cj:
            rows[j:j + m] += a[:m] * cj
    return rows


def _mul_norm(a, const: int, const_limbs: int, out_limbs: int):
    return _scan(_const_mul(a, const, const_limbs, out_limbs))[0]


def _add_const(a, const: int):
    """a + const, mod 2^(16 L) (no overflow past the top at the call
    site)."""
    cl = torch.tensor(_limbs(const, a.shape[0]), dtype=I64, device=a.device)
    return _scan(a + cl[:, None])[0]


def _sub(a, b_rows):
    """a - b (equal limb counts, both 16-bit limbs) as the complement
    add a + (MASK - b) + 1: (limbs of a - b mod 2^(16 L), borrow (n,)
    int64 = 1 - carry out)."""
    rows = a + (MASK - b_rows)
    rows[0] += 1
    out, carry = _scan(rows)
    return out, 1 - carry


def _sub_const(a, const: int):
    cl = torch.tensor(_limbs(const, a.shape[0]), dtype=I64, device=a.device)
    return _sub(a, cl[:, None])


def _neg(a):
    """2^(16 L) - a (two's complement), exact 16-bit limbs."""
    return _sub(torch.zeros_like(a), a)[0]


def _ge_const(a, const: int):
    """a >= const, per lane: (n,) bool."""
    return _sub_const(a, const)[1] == 0


def decompose(scalars: torch.Tensor):
    """(16, n) canonical Fr limbs (k < r) ->
    (k1_mags (8, n) int32, k1_neg (n,) bool, k2_mags (8, n) int32,
    k2_neg (n,) bool) with
    k == (-1)^k1_neg * k1 + (-1)^k2_neg * k2 * LAMBDA  (mod r) and both
    magnitudes < COMPONENT_BOUND."""
    s = scalars.to(I64)
    n = s.shape[1]
    # t = k*z^2 + r//2  (383 bits -> 24 limbs)
    t = _add_const(_mul_norm(s, Z2, 8, 24), R // 2)
    # Barrett quotient estimate: (t * mu) >> 512, mu 258 bits -> 17 limbs;
    # the product's limbs 32..40.
    q = _mul_norm(t, _MU, 17, 41)[32:]
    # Exact correction: rem = t - q*r; while rem >= r: q += 1, rem -= r.
    rem, _ = _sub(t, _mul_norm(q, R, 16, 24))
    for _ in range(2):
        ge = _ge_const(rem, R)
        rem = torch.where(ge, _sub_const(rem, R)[0], rem)
        q = q.clone()
        q[0] += ge.to(I64)
        q = _carry_norm(q, q.shape[0])
    # k2 = q (in [0, z^2)); balance: if k2 > z^2/2 then k2 -= z^2, k1 -= 1
    bal = _ge_const(q, Z2 // 2 + 1)
    k2_alt, _ = _sub_const(q, Z2)  # negative branch: |k2| = z^2 - q
    k2_mag = torch.where(bal, _neg(k2_alt), q)[:8]
    # k1 = k - q*lambda - bal  (17-limb two's complement)
    k17 = torch.cat([s, s.new_zeros((1, n))], dim=0)
    k1_rows, borrow = _sub(k17, _mul_norm(q, LAMBDA, 8, 17))
    balrow = k17.new_zeros((17, n))
    balrow[0] = bal.to(I64)
    k1_rows, borrow2 = _sub(k1_rows, balrow)
    k1_neg = (borrow + borrow2) == 1  # exactly one borrow: negative
    k1_mag = torch.where(k1_neg, _neg(k1_rows), k1_rows)[:8]
    return k1_mag.to(I32), k1_neg, k2_mag.to(I32), bal


def beta_mont(device) -> torch.Tensor:
    """beta in Fq Montgomery form, (24, 1) on `device`."""
    return FQ.tensor([BETA], device)


def endo_x(x: torch.Tensor) -> torch.Tensor:
    """x-coordinates (24, n) Montgomery -> beta * x (the phi map)."""
    return fp.mont_mul(FQ, x, beta_mont(x.device))
