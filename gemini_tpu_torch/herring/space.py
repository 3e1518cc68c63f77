"""Streaming (space-efficient) sumcheck prover over bilinear modules
(herring/space_prover.rs:1-317 + herring/streams.rs:1-307 analogue).

The time prover (herring/sumcheck.py ModuleTimeProver) materializes
both sides; this prover stores only the challenge lists and, each
round, re-streams the folded sides from restartable sources through a
stack-automaton fold tree in O(log n) state — the module-generic twin
of the main protocol's streaming sumcheck (streaming/sumcheck.py).

Sources are anything re-iterable (list, or an object with __iter__
that can be called many times) yielding module elements in
LITTLE-ENDIAN coefficient order, matching ModuleTimeProver's layout.
Transcript equality with the time prover is the gate
(tests/test_herring.py), mirroring the reference's time/space idiom
(SURVEY.md §4).
"""

from __future__ import annotations

from typing import List, Optional

from ..params import R
from .sumcheck import ModuleWitness, _log2_floor


def folded_stream(src, challenges: List[int], add, smul):
    """Generator of the depth-len(challenges) folding of `src`:
    fold_r(v)[j] = v[2j] + r * v[2j+1], odd tails kept as-is, applied
    once per challenge (oldest first).  O(depth) live state — the
    little-endian stack automaton (streams.rs FoldedPolynomialTreeIter
    re-designed for little-endian sources)."""
    depth = len(challenges)
    if depth == 0:
        yield from src
        return
    pending = [None] * depth
    for v in src:
        level = 0
        while True:
            if level == depth:
                yield v
                break
            if pending[level] is None:
                pending[level] = v
                break
            v = add(pending[level], smul(v, challenges[level]))
            pending[level] = None
            level += 1
    # Odd tails: a lone element at level l folds with an implicit zero
    # (v + r*0 = v) and rises unchanged; a carry from below joins a
    # pending element as its high half.
    carry = None
    for level in range(depth):
        if pending[level] is not None:
            if carry is None:
                carry = pending[level]
            else:
                carry = add(pending[level], smul(carry, challenges[level]))
    if carry is not None:
        yield carry


def folded_len(n: int, depth: int) -> int:
    for _ in range(depth):
        n = (n + 1) // 2
    return n


class ModuleSpaceProver:
    """Streaming twin of ModuleTimeProver: identical messages, O(log n)
    memory (space_prover.rs:38-317)."""

    def __init__(self, witness: ModuleWitness):
        self.m = witness.module
        self.f_src = witness.f
        self.g_src = witness.g
        self.twist = witness.twist % R
        self.challenges: List[int] = []  # rhs folds
        self.t_challenges: List[int] = []  # lhs folds (r * twist)
        self.round = 0
        self.n_f = _src_len(witness.f)
        self.n_g = _src_len(witness.g)
        self.tot_rounds = _log2_floor(min(self.n_f, self.n_g))

    def rounds(self) -> int:
        return self.tot_rounds

    def fold(self, r: int) -> None:
        self.t_challenges.append(r * self.twist % R)
        self.challenges.append(r % R)
        self.twist = self.twist * self.twist % R

    def _folded_f(self):
        return folded_stream(self.f_src, self.t_challenges,
                             self.m.lhs_add, self.m.lhs_smul)

    def _folded_g(self):
        return folded_stream(self.g_src, self.challenges,
                             self.m.rhs_add, self.m.rhs_smul)

    def next_message(self, verifier_message: Optional[int]):
        assert self.round <= self.tot_rounds
        if verifier_message is not None:
            self.fold(verifier_message)
        if self.round == self.tot_rounds:
            return None
        m = self.m
        a = m.zero()
        b = m.zero()
        n = min(folded_len(self.n_f, len(self.challenges)),
                folded_len(self.n_g, len(self.challenges)))
        fi = self._folded_f()
        gi = self._folded_g()
        for i in range(0, n - 1, 2):
            f_e, f_o = next(fi), next(fi)
            g_e, g_o = next(gi), next(gi)
            a = m.add(a, m.p(f_e, g_e))
            b = m.add(b, m.p(f_e, g_o))
            b = m.add(b, m.p(f_o, g_e))
        if n % 2 == 1:  # lone trailing even position
            a = m.add(a, m.p(next(fi), next(gi)))
        self.round += 1
        return (a, b)

    def final_foldings(self):
        if self.round != self.tot_rounds:
            return None
        return (next(self._folded_f()), next(self._folded_g()))

    def to_time_prover(self):
        """Materialize the current foldings into a ModuleTimeProver —
        the elastic switch (space_prover.rs:269-307 idiom)."""
        from .sumcheck import ModuleTimeProver

        w = ModuleWitness(self.m, list(self._folded_f()),
                          list(self._folded_g()), self.twist)
        p = ModuleTimeProver(w)
        p.tot_rounds = self.tot_rounds - self.round
        return p


def _src_len(src) -> int:
    try:
        return len(src)
    except TypeError:
        return sum(1 for _ in src)


class ModuleElasticProver:
    """Space prover that transcribes itself to a time prover once the
    folded instance drops under `threshold` remaining rounds
    (elastic_prover.rs:44-57 idiom over modules)."""

    def __init__(self, witness: ModuleWitness, threshold: int = 8):
        self.inner = ModuleSpaceProver(witness)
        self.threshold = threshold
        self.is_time = False

    def rounds(self) -> int:
        return self.inner.rounds()

    def next_message(self, verifier_message: Optional[int]):
        if (not self.is_time
                and self.inner.tot_rounds - self.inner.round
                <= self.threshold):
            if verifier_message is not None:
                self.inner.fold(verifier_message)
                verifier_message = None
            time = self.inner.to_time_prover()
            rounds_done = self.inner.round
            self.inner = time
            self.inner.round = 0
            self.inner.tot_rounds = time.tot_rounds
            self._rounds_done = rounds_done
            self.is_time = True
        return self.inner.next_message(verifier_message)

    def final_foldings(self):
        return self.inner.final_foldings()


class CrsStream:
    """Streaming CRS view (herring/ipa.rs:74-146 CrsStream): lazy
    truncation/halving over restartable G1/G2 sources, with streaming
    chunked commits — never materializes more than one element beyond
    the accumulator."""

    def __init__(self, g1s, g2s, len1: Optional[int] = None,
                 len2: Optional[int] = None):
        self.g1s = g1s
        self.g2s = g2s
        self.len1 = _src_len(g1s) if len1 is None else len1
        self.len2 = _src_len(g2s) if len2 is None else len2

    def _take(self, src, n):
        it = iter(src)
        for _ in range(n):
            yield next(it)

    def commit_g1(self, scalars):
        from ..hostcurve import g1_add, g1_mul

        acc = None
        for g, s in zip(self._take(self.g1s, self.len1), scalars):
            acc = g1_add(acc, g1_mul(g, s % R))
        return acc

    def commit_g2(self, scalars):
        from ..hostcurve import g2_add, g2_mul

        acc = None
        for g, s in zip(self._take(self.g2s, self.len2), scalars):
            acc = g2_add(acc, g2_mul(g, s % R))
        return acc

    def truncate(self, rounds: int) -> "CrsStream":
        n = 1 << rounds
        return CrsStream(self.g1s, self.g2s,
                         min(self.len1, n), min(self.len2, n))

    def halve(self) -> "CrsStream":
        return CrsStream(self.g1s, self.g2s,
                         (self.len1 + 1) // 2, (self.len2 + 1) // 2)

    def materialize(self):
        """-> dense Crs (the space->time switch for the IPA)."""
        from .ipa import Crs

        return Crs(list(self._take(self.g1s, self.len1)),
                   list(self._take(self.g2s, self.len2)))
