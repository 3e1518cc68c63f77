"""Vectors over the BLS12-381 scalar field Fr in plain PyTorch.

A vector of n elements is an int32 tensor (16, n) of 16-bit
little-endian limbs holding x * 2^256 mod r (Montgomery form), each
value below r.  Products widen to int64 in blocks of lanes: a
schoolbook product of 16 x 16 limbs, then a limb-serial Montgomery
reduction with -r^-1 mod 2^16, then one conditional subtraction.
Scalars are canonical Python ints.

Written for the benchmark from the textbook algorithms (Montgomery
1985; Koc, Acar and Kaliski 1996); nothing here comes from the port.
"""

from __future__ import annotations

import torch

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
LIMBS = 16
MASK = 0xFFFF
MONT = pow(2, 256, R)
MONT_INV = pow(MONT, -1, R)
NINV = (-pow(R, -1, 1 << 16)) % (1 << 16)
BLOCK = 1 << 20  # lanes per int64 block of a product

I32, I64 = torch.int32, torch.int64


def limbs_of(x: int) -> list:
    return [(x >> (16 * k)) & MASK for k in range(LIMBS)]


def _const(x: int, device) -> torch.Tensor:
    return torch.tensor(limbs_of(x), dtype=I64, device=device).reshape(LIMBS, 1)


def _cond_sub(v: torch.Tensor, top: torch.Tensor, device) -> torch.Tensor:
    """v (16, m) int64 limbs < 2^16 with a carry-out limb `top` (m,):
    the value (top * 2^256 + v) reduced once by r, as (16, m) limbs."""
    p = limbs_of(R)
    d = torch.empty_like(v)
    borrow = torch.zeros_like(top)
    for k in range(LIMBS):
        t = v[k] - p[k] - borrow
        borrow = (t < 0).to(I64)
        d[k] = t + (borrow << 16)
    keep = (top - borrow) < 0  # value < r: keep v
    return torch.where(keep.unsqueeze(0), v, d)


def _mont_mul_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b * 2^-256) mod r on int64 blocks; b may be one column."""
    dev = a.device
    m = max(a.shape[1], b.shape[1])
    t = torch.zeros((2 * LIMBS + 2, m), dtype=I64, device=dev)
    if b.shape[1] == 1 and a.shape[1] != 1:
        a, b = b, a  # keep the wide operand in the (16, m) slot
    for i in range(LIMBS):
        t[i:i + LIMBS] += a[i] * b
    p = _const(R, dev)
    for i in range(LIMBS):
        u = (t[i] * NINV) & MASK
        t[i:i + LIMBS] += u * p
        t[i + 1] += t[i] >> 16
    v = t[LIMBS:2 * LIMBS + 1]
    for k in range(LIMBS):
        v[k + 1] += v[k] >> 16
        v[k] &= MASK
    return _cond_sub(v[:LIMBS], v[LIMBS], dev)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of (16, n) vectors (either may be a
    (16, 1) column), in blocks of BLOCK lanes."""
    n = max(a.shape[1], b.shape[1])
    out = torch.empty((LIMBS, n), dtype=I32, device=a.device)
    for s in range(0, n, BLOCK):
        ab = a if a.shape[1] == 1 else a[:, s:s + BLOCK]
        bb = b if b.shape[1] == 1 else b[:, s:s + BLOCK]
        out[:, s:s + BLOCK] = _mont_mul_block(ab.to(I64), bb.to(I64)).to(I32)
    return out


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a + b (either may be a (16, 1) column)."""
    n = max(a.shape[1], b.shape[1])
    out = torch.empty((LIMBS, n), dtype=I32, device=a.device)
    for s in range(0, n, BLOCK):
        x = (a if a.shape[1] == 1 else a[:, s:s + BLOCK]).to(I64)
        y = (b if b.shape[1] == 1 else b[:, s:s + BLOCK]).to(I64)
        v = (x + y).expand(LIMBS, max(x.shape[1], y.shape[1])).clone()
        for k in range(LIMBS - 1):
            v[k + 1] += v[k] >> 16
            v[k] &= MASK
        top = v[LIMBS - 1] >> 16  # a + b < 2r < 2^256: always 0
        v[LIMBS - 1] &= MASK
        out[:, s:s + BLOCK] = _cond_sub(v, top, a.device).to(I32)
    return out


def scalar(x: int, device) -> torch.Tensor:
    """One element (16, 1) in Montgomery form."""
    return torch.tensor(limbs_of(x % R * MONT % R), dtype=I32,
                        device=device).reshape(LIMBS, 1)


def zeros(n: int, device) -> torch.Tensor:
    return torch.zeros((LIMBS, n), dtype=I32, device=device)


def mul_scalar(a: torch.Tensor, x: int) -> torch.Tensor:
    return mont_mul(a, scalar(x, a.device))


def from_canonical(limbs: torch.Tensor) -> torch.Tensor:
    """(16, n) canonical limbs (values < r) -> Montgomery form."""
    return mont_mul(limbs, torch.tensor(limbs_of(MONT * MONT % R), dtype=I32,
                                        device=limbs.device).reshape(LIMBS, 1))


def to_ints(a: torch.Tensor) -> list:
    """A short vector's elements as canonical ints."""
    host = a.to(I64).cpu().tolist()
    n = len(host[0])
    return [sum(host[k][j] << (16 * k) for k in range(LIMBS)) * MONT_INV % R
            for j in range(n)]


def total(a: torch.Tensor) -> int:
    """The sum of the elements, canonical: exact limb sums (each below
    2^16 * n) recombined on the host."""
    sums = [0] * LIMBS
    for s in range(0, a.shape[1], BLOCK):
        part = a[:, s:s + BLOCK].to(I64).sum(dim=1).cpu().tolist()
        sums = [x + y for x, y in zip(sums, part)]
    return sum(x << (16 * k) for k, x in enumerate(sums)) * MONT_INV % R


def dot(a: torch.Tensor, b: torch.Tensor) -> int:
    return total(mont_mul(a, b))


def pad(a: torch.Tensor, n: int) -> torch.Tensor:
    if a.shape[1] == n:
        return a
    return torch.cat([a, zeros(n - a.shape[1], a.device)], dim=1)


def powers(x: int, n: int, device) -> torch.Tensor:
    """(1, x, x^2, ..., x^(n-1)) by doubling."""
    out = scalar(1, device)
    while out.shape[1] < n:
        m = out.shape[1]
        out = torch.cat([out, mul_scalar(out, pow(x, m, R))], dim=1)
    return out[:, :n].contiguous()


def tensor(challenges, device) -> torch.Tensor:
    """The expansion of the tensor product of (1, rho_j): length
    2^len, entry with bits (b_j) = prod rho_j^b_j (bit j = 2^j)."""
    out = scalar(1, device)
    for rho in challenges:
        out = torch.cat([out, mul_scalar(out, rho)], dim=1)
    return out


def evaluate(a: torch.Tensor, x: int) -> int:
    """sum_i a_i x^i."""
    return dot(a, powers(x, a.shape[1], a.device))


def even_odd(a: torch.Tensor):
    return a[:, 0::2], a[:, 1::2]


def fold(a: torch.Tensor, r: int) -> torch.Tensor:
    """out_k = a_2k + r a_2k+1 (a of even length)."""
    e, o = even_odd(a)
    return add(e, mul_scalar(o, r))
