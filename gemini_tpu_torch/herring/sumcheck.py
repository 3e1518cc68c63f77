"""Sumcheck over bilinear modules (herring/{prover,time_prover,proof}.rs).

The untwisted claim ⟨f, g⟩ = Σ M.p(f_i, g_i) reduces over
log2(min(|f|, |g|)) rounds; round messages are (a, b) in the TARGET
module.  The module generalization is what lets the IPA spawn provers
whose sides are group elements (CRS folding cross-terms)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..params import R


def _log2_floor(n: int) -> int:
    assert n >= 1
    return n.bit_length() - 1


@dataclass
class ModuleWitness:
    """herring/time_prover.rs:14-40."""

    module: type
    f: list
    g: list
    twist: int = 1

    def required_rounds(self) -> int:
        return _log2_floor(min(len(self.f), len(self.g)))


class ModuleTimeProver:
    """herring/time_prover.rs:43-140."""

    def __init__(self, witness: ModuleWitness):
        self.m = witness.module
        self.f = list(witness.f)
        self.g = list(witness.g)
        self.twist = witness.twist % R
        self.round = 0
        self.tot_rounds = witness.required_rounds()

    def rounds(self) -> int:
        return self.tot_rounds

    def _split_fold_lhs(self, v: list, r: int) -> list:
        m = self.m
        out = []
        for i in range(0, len(v), 2):
            lo = v[i]
            if i + 1 < len(v):
                out.append(m.lhs_add(lo, m.lhs_smul(v[i + 1], r)))
            else:
                out.append(lo)
        return out

    def _split_fold_rhs(self, v: list, r: int) -> list:
        m = self.m
        out = []
        for i in range(0, len(v), 2):
            lo = v[i]
            if i + 1 < len(v):
                out.append(m.rhs_add(lo, m.rhs_smul(v[i + 1], r)))
            else:
                out.append(lo)
        return out

    def fold(self, r: int) -> None:
        self.f = self._split_fold_lhs(self.f, r * self.twist % R)
        self.g = self._split_fold_rhs(self.g, r)
        self.twist = self.twist * self.twist % R

    def next_message(self, verifier_message: Optional[int]):
        assert self.round <= self.tot_rounds
        if verifier_message is not None:
            self.fold(verifier_message)
        if self.round == self.tot_rounds:
            return None
        m = self.m
        a = m.zero()
        b = m.zero()
        n = min(len(self.f), len(self.g))
        for i in range(0, n, 2):
            a = m.add(a, m.p(self.f[i], self.g[i]))
        for i in range(0, n - 1, 2):
            b = m.add(b, m.p(self.f[i], self.g[i + 1]))
            b = m.add(b, m.p(self.f[i + 1], self.g[i]))
        # ragged tails: f longer than g or vice versa contribute via
        # the even side only (mirrors M::ip over zipped iterators)
        self.round += 1
        return (a, b)

    def final_foldings(self):
        if self.round != self.tot_rounds:
            return None
        return (self.f[0], self.g[0])


@dataclass
class ModuleSumcheck:
    """herring/proof.rs:20-31."""

    messages: List[Tuple[object, object]]
    challenges: List[int]
    rounds: int
    final_foldings: List[Tuple[object, object]]
