"""Constraint-synthesizer frontend (port of
gemini_tpu/relation/builder.py; circuit.rs:152-175 `generate_relation`
over ark-relations' ConstraintSynthesizer, as a small native builder
API).  Host-only; `build()` puts the relation on its device.

Express a circuit as rank-1 constraints `⟨a,z⟩ · ⟨b,z⟩ = ⟨c,z⟩` over
linear combinations of variables; `build()` lowers to the COO `R1cs`
consumed by both SNARKs.  Variable 0 is the constant 1 (the
ark-relations convention), public inputs follow, witnesses after —
matching z = (x, w) (circuit.rs:45-52).

Example (prove knowledge of x with x^3 + x + 5 = 35):

    cs = ConstraintBuilder()
    out = cs.public_input(35)
    x = cs.witness(3)
    x2 = cs.mul(x, x)          # x2 = x*x
    x3 = cs.mul(x2, x)         # x3 = x2*x
    cs.enforce(x3 + x + 5, LinComb.one(), out)
    r1cs = cs.build()          # on the card; build(device="cpu") without one
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Union

from ..params import R
from .r1cs import R1cs, SparseMatrix


@dataclass(frozen=True)
class Var:
    """A variable handle (index into z)."""

    index: int

    def __add__(self, other):
        return LinComb.from_var(self) + other

    def __radd__(self, other):
        return LinComb.from_var(self) + other

    def __sub__(self, other):
        return LinComb.from_var(self) - other

    def __mul__(self, scalar: int):
        return LinComb.from_var(self) * scalar

    __rmul__ = __mul__


@dataclass
class LinComb:
    """Σ coeff_i · z[var_i] (+ constant via variable 0)."""

    terms: Dict[int, int] = field(default_factory=dict)

    @staticmethod
    def from_var(v: Var) -> "LinComb":
        return LinComb({v.index: 1})

    @staticmethod
    def constant(c: int) -> "LinComb":
        return LinComb({0: c % R})

    @staticmethod
    def one() -> "LinComb":
        return LinComb.constant(1)

    @staticmethod
    def _coerce(x: Union["LinComb", Var, int]) -> "LinComb":
        if isinstance(x, LinComb):
            return x
        if isinstance(x, Var):
            return LinComb.from_var(x)
        return LinComb.constant(x)

    def __add__(self, other):
        other = LinComb._coerce(other)
        out = dict(self.terms)
        for k, v in other.terms.items():
            out[k] = (out.get(k, 0) + v) % R
        return LinComb({k: v for k, v in out.items() if v})

    __radd__ = __add__

    def __sub__(self, other):
        return self + (LinComb._coerce(other) * (R - 1))

    def __mul__(self, scalar: int):
        s = scalar % R
        return LinComb({k: v * s % R for k, v in self.terms.items()})

    __rmul__ = __mul__

    def evaluate(self, z: List[int]) -> int:
        return sum(c * z[i] for i, c in self.terms.items()) % R


class ConstraintBuilder:
    """Accumulates variables and constraints; lowers to `R1cs`."""

    def __init__(self):
        self._publics: List[int] = []
        self._witnesses: List[int] = []
        self._constraints: List[tuple] = []  # (a_lc, b_lc, c_lc)

    # -- variables ---------------------------------------------------------

    def public_input(self, value: int) -> Var:
        self._publics.append(value % R)
        return Var(len(self._publics))  # slot after the constant 1

    def witness(self, value: int) -> Var:
        self._witnesses.append(value % R)
        return Var(-len(self._witnesses))  # resolved at build time

    # -- constraints -------------------------------------------------------

    def enforce(self, a, b, c) -> None:
        """⟨a,z⟩ · ⟨b,z⟩ = ⟨c,z⟩."""
        self._constraints.append(
            (LinComb._coerce(a), LinComb._coerce(b), LinComb._coerce(c))
        )

    def mul(self, a, b) -> Var:
        """New witness w = ⟨a,z⟩·⟨b,z⟩ with its defining constraint."""
        a = LinComb._coerce(a)
        b = LinComb._coerce(b)
        z = self._z_snapshot()
        w = self.witness(a.evaluate(z) * b.evaluate(z) % R)
        self.enforce(a, b, w)
        return w

    # -- lowering ----------------------------------------------------------

    def _z_snapshot(self) -> List[int]:
        return [1] + self._publics + self._witnesses

    def _resolve(self, idx: int) -> int:
        if idx >= 0:
            return idx
        return 1 + len(self._publics) + (-idx - 1)

    def build(self, pad_square: bool = True, device=None) -> R1cs:
        """Lower to the COO relation.  With `pad_square`, trivial
        0·0=0 rows and zero witnesses pad the system square
        (num_constraints == num_variables), the shape the reference's
        synthesizer emits for its test circuits (circuit.rs:269-282
        input padding plays the analogous role).  The relation lives on
        `device` (default the card)."""
        z = self._z_snapshot()
        rows_a, rows_b, rows_c = [], [], []
        for a, b, c in self._constraints:
            rows_a.append(
                [(v, self._resolve(k)) for k, v in sorted(a.terms.items())]
            )
            rows_b.append(
                [(v, self._resolve(k)) for k, v in sorted(b.terms.items())]
            )
            rows_c.append(
                [(v, self._resolve(k)) for k, v in sorted(c.terms.items())]
            )
        n_rows = len(rows_a)
        n_cols = len(z)
        if pad_square:
            n = max(n_rows, n_cols)
            z = z + [0] * (n - n_cols)
            for rows in (rows_a, rows_b, rows_c):
                rows.extend([[] for _ in range(n - n_rows)])
            n_rows = n_cols = n
        r1cs = R1cs(
            a=SparseMatrix.from_rows(rows_a, n_cols, device),
            b=SparseMatrix.from_rows(rows_b, n_cols, device),
            c=SparseMatrix.from_rows(rows_c, n_cols, device),
            z_int=z,
            x_int=z[: 1 + len(self._publics)],
            device=device,
        )
        assert r1cs.is_satisfied(), "constraint system not satisfied"
        return r1cs
