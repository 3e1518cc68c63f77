"""Bilinear-module instances (herring/module.rs:11-100).

Elements use additive notation regardless of the concrete group:
`add(a, b)`, `smul(a, scalar)`, `zero()`, with the bilinear map `p`.
Concrete carriers: Fr ints, host G1/G2 points (refimpl), GT = Fq12
(multiplicative, wrapped additively here, matching ark's
PairingOutput)."""

from __future__ import annotations

from ..params import R
from ..refimpl import Fq12, gt_pow, g1_generator, g2_generator
from ..hostcurve import g1_add, g1_mul, g2_add, g2_mul, pairing


class FModule:
    """F x F -> F."""

    @staticmethod
    def zero_lhs():
        return 0

    zero_rhs = zero_lhs

    @staticmethod
    def zero():
        return 0

    @staticmethod
    def add(a, b):
        return (a + b) % R

    @staticmethod
    def smul(a, s):
        return a * s % R

    lhs_add = staticmethod(lambda a, b: (a + b) % R)
    lhs_smul = staticmethod(lambda a, s: a * s % R)
    rhs_add = staticmethod(lambda a, b: (a + b) % R)
    rhs_smul = staticmethod(lambda a, s: a * s % R)

    @staticmethod
    def p(a, b):
        return a * b % R


class G1Module:
    """G1 x F -> G1."""

    @staticmethod
    def zero_lhs():
        return None

    @staticmethod
    def zero_rhs():
        return 0

    @staticmethod
    def zero():
        return None

    add = staticmethod(g1_add)
    smul = staticmethod(g1_mul)
    lhs_add = staticmethod(g1_add)
    lhs_smul = staticmethod(g1_mul)
    rhs_add = staticmethod(lambda a, b: (a + b) % R)
    rhs_smul = staticmethod(lambda a, s: a * s % R)

    @staticmethod
    def p(a, b):
        return g1_mul(a, b % R)


class G2Module:
    """F x G2 -> G2 (note: scalar side is the LHS, herring/module.rs)."""

    @staticmethod
    def zero_lhs():
        return 0

    @staticmethod
    def zero_rhs():
        return None

    @staticmethod
    def zero():
        return None

    add = staticmethod(g2_add)
    smul = staticmethod(g2_mul)
    lhs_add = staticmethod(lambda a, b: (a + b) % R)
    lhs_smul = staticmethod(lambda a, s: a * s % R)
    rhs_add = staticmethod(g2_add)
    rhs_smul = staticmethod(g2_mul)

    @staticmethod
    def p(a, b):
        return g2_mul(b, a % R)


class GT:
    """PairingOutput wrapper: GT (multiplicative Fq12) in additive
    notation."""

    __slots__ = ("v",)

    def __init__(self, v: Fq12):
        self.v = v

    @classmethod
    def zero(cls):
        return cls(Fq12.one())

    def __add__(self, o: "GT") -> "GT":
        return GT(self.v * o.v)

    def __sub__(self, o: "GT") -> "GT":
        return GT(self.v * o.v.inv())

    def smul(self, s: int) -> "GT":
        return GT(gt_pow(self.v, s % R))

    def __eq__(self, o) -> bool:
        return isinstance(o, GT) and self.v == o.v

    def __hash__(self):
        return hash(repr(self.v))


class GtModule:
    """GT x F -> GT."""

    @staticmethod
    def zero_lhs():
        return GT.zero()

    @staticmethod
    def zero_rhs():
        return 0

    zero = zero_lhs

    add = staticmethod(lambda a, b: a + b)
    smul = staticmethod(lambda a, s: a.smul(s))
    lhs_add = staticmethod(lambda a, b: a + b)
    lhs_smul = staticmethod(lambda a, s: a.smul(s))
    rhs_add = staticmethod(lambda a, b: (a + b) % R)
    rhs_smul = staticmethod(lambda a, s: a * s % R)

    @staticmethod
    def p(a: GT, b: int) -> GT:
        return a.smul(b)


class PModule:
    """G1 x G2 -> GT via the pairing (herring/module.rs:60-79)."""

    @staticmethod
    def zero_lhs():
        return None

    @staticmethod
    def zero_rhs():
        return None

    @staticmethod
    def zero():
        return GT.zero()

    add = staticmethod(lambda a, b: a + b)  # Target adds
    smul = staticmethod(lambda a, s: a.smul(s))
    lhs_add = staticmethod(g1_add)
    lhs_smul = staticmethod(g1_mul)
    rhs_add = staticmethod(g2_add)
    rhs_smul = staticmethod(g2_mul)

    @staticmethod
    def p(a, b) -> GT:
        if a is None or b is None:
            return GT.zero()
        return GT(pairing(a, b))


def po_from_g1(p) -> GT:
    return PModule.p(p, g2_generator())


def po_from_g2(q) -> GT:
    return PModule.p(g1_generator(), q)


def po_from_scalar(s: int) -> GT:
    return PModule.p(g1_generator(), g2_generator()).smul(s)
