"""Tower-field arithmetic over BLS12-381 with Python integers.

Tower: Fq2 = Fq[u]/(u^2+1);  Fq6 = Fq2[v]/(v^3 - xi), xi = 1+u;
Fq12 = Fq6[w]/(w^2 - v).

These mirror the semantics of the arithmetic backend the reference gets
from `ark-ff` (SURVEY.md L0); implementations are standard textbook
formulas, written from scratch.
"""

from __future__ import annotations

from ..params import Q, R


class _Fp:
    """Prime-field element; subclasses fix the modulus."""

    MOD: int = 0
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % self.MOD

    def __add__(self, o):
        return type(self)(self.n + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        return type(self)(self.n - _val(o))

    def __rsub__(self, o):
        return type(self)(_val(o) - self.n)

    def __mul__(self, o):
        return type(self)(self.n * _val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(-self.n)

    def __eq__(self, o):
        return self.n == _val(o) % self.MOD

    def __hash__(self):
        return hash((type(self).__name__, self.n))

    def inv(self):
        if self.n == 0:
            raise ZeroDivisionError("inverse of zero")
        return type(self)(pow(self.n, -1, self.MOD))

    def __truediv__(self, o):
        o = o if isinstance(o, _Fp) else type(self)(o)
        return self * o.inv()

    def __pow__(self, e: int):
        return type(self)(pow(self.n, e, self.MOD))

    def is_zero(self):
        return self.n == 0

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)

    def __repr__(self):
        return f"{type(self).__name__}(0x{self.n:x})"


def _val(o):
    return o.n if isinstance(o, _Fp) else int(o)


class Fq(_Fp):
    MOD = Q


class Fr(_Fp):
    MOD = R


class Fq2:
    """a + b*u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0 = c0 if isinstance(c0, Fq) else Fq(c0)
        self.c1 = c1 if isinstance(c1, Fq) else Fq(c1)

    @classmethod
    def zero(cls):
        return cls(0, 0)

    @classmethod
    def one(cls):
        return cls(1, 0)

    def __add__(self, o):
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o):
        if isinstance(o, (int, Fq)):
            return Fq2(self.c0 * o, self.c1 * o)
        a, b, c, d = self.c0, self.c1, o.c0, o.c1
        ac = a * c
        bd = b * d
        return Fq2(ac - bd, (a + b) * (c + d) - ac - bd)

    __rmul__ = __mul__

    def square(self):
        a, b = self.c0, self.c1
        return Fq2((a + b) * (a - b), (a * b) * 2)

    def inv(self):
        a, b = self.c0, self.c1
        t = (a * a + b * b).inv()
        return Fq2(a * t, -(b * t))

    def __truediv__(self, o):
        return self * o.inv()

    def conj(self):
        return Fq2(self.c0, -self.c1)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0.n, self.c1.n))

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def __pow__(self, e: int):
        r, b = Fq2.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def __repr__(self):
        return f"Fq2({self.c0!r}, {self.c1!r})"


XI = Fq2(1, 1)  # sextic-twist non-residue


class Fq6:
    """c0 + c1*v + c2*v^2 with v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @classmethod
    def zero(cls):
        return cls(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @classmethod
    def one(cls):
        return cls(Fq2.one(), Fq2.zero(), Fq2.zero())

    def __add__(self, o):
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, Fq2):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_v(self):
        """Multiply by v: (c0,c1,c2) -> (xi*c2, c0, c1)."""
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - a1 * a2 * XI
        t1 = a2.square() * XI - a0 * a1
        t2 = a1.square() - a0 * a2
        d = (a0 * t0 + (a2 * t1 + a1 * t2) * XI).inv()
        return Fq6(t0 * d, t1 * d, t2 * d)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


# Frobenius coefficients: w^q = g*w with g = xi^((q-1)/6); the w^i
# coefficient picks up g^i under one Frobenius application.
_FROB_G_POW = [XI ** (i * (Q - 1) // 6) for i in range(6)]


class Fq12:
    """c0 + c1*w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @classmethod
    def zero(cls):
        return cls(Fq6.zero(), Fq6.zero())

    @classmethod
    def one(cls):
        return cls(Fq6.one(), Fq6.zero())

    @classmethod
    def from_coeffs(cls, coeffs):
        """From 12 Fq2 coefficients of powers of w: sum coeffs[i] * w^i.

        w^(2k) = v^k in the c0 component; w^(2k+1) = v^k * w in c1.
        """
        c0 = Fq6(coeffs[0], coeffs[2], coeffs[4])
        c1 = Fq6(coeffs[1], coeffs[3], coeffs[5])
        return cls(c0, c1)

    def __add__(self, o):
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self):
        return self * self

    def conj(self):
        """Conjugation over Fq6 (= Frobenius^6): a + b*w -> a - b*w."""
        return Fq12(self.c0, -self.c1)

    def inv(self):
        a0, a1 = self.c0, self.c1
        d = (a0.square() - a1.square().mul_by_v()).inv()
        return Fq12(a0 * d, -(a1 * d))

    def __truediv__(self, o):
        return self * o.inv()

    def frobenius(self, power: int = 1):
        """x -> x^(q^power)."""
        r = self
        for _ in range(power % 12):
            r = r._frob1()
        return r

    def _frob1(self):
        def f2(x: Fq2) -> Fq2:
            return x.conj()

        # In the w-coefficient basis: (sum a_i w^i)^q = sum conj(a_i) * g^i * w^i
        # with g = xi^((q-1)/6).
        coeffs = [
            self.c0.c0, self.c1.c0, self.c0.c1,
            self.c1.c1, self.c0.c2, self.c1.c2,
        ]
        new = [f2(coeffs[i]) * _FROB_G_POW[i] for i in range(6)]
        return Fq12.from_coeffs(new)

    def __pow__(self, e: int):
        if e < 0:
            return self.inv() ** (-e)
        r, b = Fq12.one(), self
        while e:
            if e & 1:
                r = r * b
            b = b.square()
            e >>= 1
        return r

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero()

    def is_one(self):
        return self == Fq12.one()
