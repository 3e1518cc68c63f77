"""BLS12-381 G1 on the host with Python integers, and its ark-serialize
encodings.

Affine points are (x, y) tuples of ints mod q, None is the identity.
Scalar multiplication is left-to-right double-and-add in Jacobian
coordinates (the dbl-2009-l and add-2007-bl formulas of the
Explicit-Formulas Database).  Encodings follow arkworks 0.4
`CanonicalSerialize`: uncompressed x || y (48 bytes each, little
endian), compressed x with the flags in its last byte (1 << 6 the
identity, 1 << 7 y > (q - 1) / 2).  Written for the benchmark; nothing
here comes from the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
G1 = (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
      0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)

Point = Optional[Tuple[int, int]]
_INF, _NEG = 1 << 6, 1 << 7


def _dbl(p):
    x, y, z = p
    if z == 0:
        return p
    a = x * x % Q
    b = y * y % Q
    c = b * b % Q
    d = 2 * ((x + b) ** 2 - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    return x3, (e * (d - x3) - 8 * c) % Q, 2 * y * z % Q


def _add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = z1 * z1 % Q, z2 * z2 % Q
    u1, u2 = x1 * z2z2 % Q, x2 * z1z1 % Q
    s1, s2 = y1 * z2 * z2z2 % Q, y2 * z1 * z1z1 % Q
    h = (u2 - u1) % Q
    r = 2 * (s2 - s1) % Q
    if h == 0:
        return _dbl(p) if r == 0 else (1, 1, 0)
    i = (2 * h) ** 2 % Q
    j = h * i % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = ((z1 + z2) ** 2 - z1z1 - z2z2) * h % Q
    return x3, y3, z3


def _affine(p) -> Point:
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, Q)
    zi2 = zi * zi % Q
    return x * zi2 % Q, y * zi2 * zi % Q


def mul(p: Point, k: int) -> Point:
    """k * p for k >= 0."""
    if p is None or k == 0:
        return None
    base = (p[0], p[1], 1)
    acc = (1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _dbl(acc)
        if bit == "1":
            acc = _add(acc, base)
    return _affine(acc)


def uncompressed(p: Point) -> bytes:
    if p is None:
        y = bytearray(48)
        y[-1] |= _INF
        return bytes(48) + bytes(y)
    return p[0].to_bytes(48, "little") + p[1].to_bytes(48, "little")


def compressed(p: Point) -> bytes:
    if p is None:
        x = bytearray(48)
        x[-1] |= _INF
        return bytes(x)
    out = bytearray(p[0].to_bytes(48, "little"))
    if p[1] > (Q - 1) // 2:
        out[-1] |= _NEG
    return bytes(out)
