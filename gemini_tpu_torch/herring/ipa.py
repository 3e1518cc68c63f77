"""Pairing-based split-and-fold inner-product argument
(herring/ipa.rs, Dory/BMMTV-style).

Commit a in G1, b in G2; per round fold the CRS and spawn PModule
provers for the folded-CRS cross terms; the verifier holds
precomputed per-level pairings (Vrs) and performs one batched GT
check.  Upstream status ⚠️ WIP (debug prints at ipa.rs:352,421);
implemented here host-side at parity."""

from __future__ import annotations

import random as _random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..params import R
from ..refimpl import g1_generator, g2_generator
from ..hostcurve import g1_mul, g2_mul
from ..serialize import fq_to_bytes
from ..transcript import GeminiTranscript
from .modules import (
    FModule, G1Module, G2Module, GT, GtModule, PModule,
    po_from_g1, po_from_g2, po_from_scalar,
)
from .sumcheck import ModuleSumcheck, ModuleTimeProver, ModuleWitness


class HerringVerificationError(Exception):
    pass


def _fq2_bytes(x) -> bytes:
    return fq_to_bytes(x.c0.n) + fq_to_bytes(x.c1.n)


def _fq6_bytes(x) -> bytes:
    return _fq2_bytes(x.c0) + _fq2_bytes(x.c1) + _fq2_bytes(x.c2)


def gt_bytes(g: GT) -> bytes:
    """ark-serialize of PairingOutput (Fq12: c0 then c1)."""
    return _fq6_bytes(g.v.c0) + _fq6_bytes(g.v.c1)


def _append_gt_msg(transcript: GeminiTranscript, label: bytes,
                   msg: Tuple[GT, GT]) -> None:
    transcript.append_message(label, gt_bytes(msg[0]) + gt_bytes(msg[1]))


def _ip(module, f: list, g: list):
    acc = module.zero()
    for a, b in zip(f, g):
        acc = module.add(acc, module.p(a, b))
    return acc


@dataclass
class Crs:
    """herring/ipa.rs:63-66, 172-214."""

    g1s: List
    g2s: List

    @classmethod
    def new(cls, rng: _random.Random, d: int) -> "Crs":
        g1s = [g1_mul(g1_generator(), rng.randrange(1, R)) for _ in range(d)]
        g2s = [g2_mul(g2_generator(), rng.randrange(1, R)) for _ in range(d)]
        return cls(g1s, g2s)

    def commit_g1(self, scalars: List[int]):
        assert len(self.g1s) > len(scalars)
        acc = None
        from ..hostcurve import g1_add
        for g, s in zip(self.g1s, scalars):
            acc = g1_add(acc, g1_mul(g, s % R))
        return acc

    def commit_g2(self, scalars: List[int]):
        assert len(self.g2s) > len(scalars)
        from ..hostcurve import g2_add
        acc = None
        for g, s in zip(self.g2s, scalars):
            acc = g2_add(acc, g2_mul(g, s % R))
        return acc

    def truncate(self, rounds: int) -> "Crs":
        return Crs(self.g1s[: 1 << rounds], self.g2s[: 1 << rounds])

    def halve(self) -> "Crs":
        h1 = (len(self.g1s) + 1) // 2
        h2 = (len(self.g2s) + 1) // 2
        return Crs(self.g1s[:h1], self.g2s[:h2])

    def fold(self, challenge: int) -> "Crs":
        from ..hostcurve import g1_add, g2_add
        g1s, g2s = [], []
        for i in range(0, len(self.g1s), 2):
            lo = self.g1s[i]
            if i + 1 < len(self.g1s):
                lo = g1_add(lo, g1_mul(self.g1s[i + 1], challenge % R))
            g1s.append(lo)
        for i in range(0, len(self.g2s), 2):
            lo = self.g2s[i]
            if i + 1 < len(self.g2s):
                lo = g2_add(lo, g2_mul(self.g2s[i + 1], challenge % R))
            g2s.append(lo)
        return Crs(g1s, g2s)


@dataclass
class Vrs:
    """Per-level CRS pairings (herring/ipa.rs:68-71, 216-247)."""

    vk1: List[Tuple[GT, GT]]
    vk2: List[Tuple[GT, GT]]

    @classmethod
    def from_crs(cls, crs: Crs) -> "Vrs":
        vk1, vk2 = [], []
        n = len(crs.g1s)
        log = (n - 1).bit_length()  # == ark_std::log2 (ceil) for n >= 2
        for j in range(1, log):
            size = 1 << j
            g1e = _ip(PModule, crs.g1s[0::2][:size], crs.g2s[:size])
            g1o = _ip(PModule, crs.g1s[1::2][:size], crs.g2s[:size])
            g2e = _ip(PModule, crs.g1s[:size], crs.g2s[0::2][:size])
            g2o = _ip(PModule, crs.g1s[:size], crs.g2s[1::2][:size])
            vk1.append((g1e, g1o))
            vk2.append((g2e, g2o))
        return cls(vk1, vk2)


@dataclass
class InnerProductProof:
    """herring/ipa.rs:55-61."""

    sumcheck: ModuleSumcheck
    batch_challenges: List[int]
    foldings_ff: List[Tuple[int, int]]
    foldings_fg1: List[Tuple[object, int]]
    foldings_fg2: List[Tuple[int, object]]

    # -- prover (ipa.rs:533-649 via :345-530) -----------------------------

    @staticmethod
    def new(transcript: GeminiTranscript, crs: Crs,
            a: List[int], b: List[int]) -> "InnerProductProof":
        return InnerProductProof.generic(
            transcript, crs,
            [ModuleWitness(FModule, list(a), list(b))],
            [ModuleWitness(G1Module, list(crs.g1s[: len(a)]), list(a))],
            [ModuleWitness(G2Module, list(b), list(crs.g2s[: len(b)]))],
        )

    @staticmethod
    def generic(transcript: GeminiTranscript, crs: Crs,
                f_ip: List[ModuleWitness], g1_ip: List[ModuleWitness],
                g2_ip: List[ModuleWitness]) -> "InnerProductProof":
        messages: List[Tuple[GT, GT]] = []
        challenges: List[int] = []
        provers_ff = [ModuleTimeProver(w) for w in f_ip]
        provers_fg1 = [ModuleTimeProver(w) for w in g1_ip]
        provers_fg2 = [ModuleTimeProver(w) for w in g2_ip]

        verifier_message: Optional[int] = None
        batch_challenge = transcript.get_challenge(b"batch-chal")
        n_init = len(provers_ff) + len(provers_fg1) + len(provers_fg2)
        batch_challenges = [
            pow(batch_challenge, i, R) for i in range(n_init)
        ]

        # round 0 message: batched across the three initial provers
        i = 0
        acc = GT.zero()
        acc_b = GT.zero()
        for p in provers_ff:
            m = p.next_message(verifier_message)
            acc = acc + po_from_scalar(m[0]).smul(batch_challenges[i])
            acc_b = acc_b + po_from_scalar(m[1]).smul(batch_challenges[i])
            i += 1
        for p in provers_fg1:
            m = p.next_message(verifier_message)
            acc = acc + po_from_g1(m[0]).smul(batch_challenges[i])
            acc_b = acc_b + po_from_g1(m[1]).smul(batch_challenges[i])
            i += 1
        for p in provers_fg2:
            m = p.next_message(verifier_message)
            acc = acc + po_from_g2(m[0]).smul(batch_challenges[i])
            acc_b = acc_b + po_from_g2(m[1]).smul(batch_challenges[i])
            i += 1
        prover_message = (acc, acc_b)
        _append_gt_msg(transcript, b"prover_message", prover_message)
        messages.append(prover_message)

        rounds = max(
            p.rounds() for p in provers_ff + provers_fg1 + provers_fg2
        )
        crs_chop = crs.truncate(rounds)
        provers_gg: List[ModuleTimeProver] = []

        for _ in range(rounds - 1):
            challenge = transcript.get_challenge(b"sumcheck-chal")
            verifier_message = challenge
            bc = transcript.get_challenge(b"batch-chal")
            challenges.append(challenge)
            batch_challenges.append(bc)
            batch_challenges.append(bc * bc % R)

            crs_fold = crs_chop.fold(challenge)
            crs_chop = crs_chop.halve()
            prover_g1fold = ModuleTimeProver(
                ModuleWitness(PModule, crs_fold.g1s, crs_chop.g2s))
            prover_g2fold = ModuleTimeProver(
                ModuleWitness(PModule, crs_chop.g1s, crs_fold.g2s))

            parts: List[Tuple[GT, GT]] = []
            for p in provers_ff:
                m = p.next_message(verifier_message)
                parts.append((po_from_scalar(m[0]), po_from_scalar(m[1])))
            for p in provers_fg1:
                m = p.next_message(verifier_message)
                parts.append((po_from_g1(m[0]), po_from_g1(m[1])))
            for p in provers_fg2:
                m = p.next_message(verifier_message)
                parts.append((po_from_g2(m[0]), po_from_g2(m[1])))
            g1f = prover_g1fold.next_message(None)
            g2f = prover_g2fold.next_message(None)
            for p in provers_gg:
                m = p.next_message(verifier_message)
                parts.append(m)
            if g1f is not None:
                parts.append(g1f)
            if g2f is not None:
                parts.append(g2f)
            provers_gg.append(prover_g1fold)
            provers_gg.append(prover_g2fold)

            ra = GT.zero()
            rb = GT.zero()
            for (ma, mb), c in zip(parts, batch_challenges):
                ra = ra + ma.smul(c)
                rb = rb + mb.smul(c)
            round_message = (ra, rb)
            _append_gt_msg(transcript, b"sumcheck-round", round_message)
            messages.append(round_message)

        challenge = transcript.get_challenge(b"sumcheck-chal")
        challenges.append(challenge)

        final_foldings = []
        for p in provers_gg:
            p.fold(challenge)
            final_foldings.append(p.final_foldings())
        sumcheck = ModuleSumcheck(
            messages=messages, challenges=challenges, rounds=rounds,
            final_foldings=final_foldings,
        )
        foldings_ff = []
        for p in provers_ff:
            p.fold(challenge)
            foldings_ff.append(p.final_foldings())
        foldings_fg1 = []
        for p in provers_fg1:
            p.fold(challenge)
            foldings_fg1.append(p.final_foldings())
        foldings_fg2 = []
        for p in provers_fg2:
            p.fold(challenge)
            foldings_fg2.append(p.final_foldings())
        return InnerProductProof(
            sumcheck=sumcheck,
            batch_challenges=batch_challenges,
            foldings_ff=foldings_ff,
            foldings_fg1=foldings_fg1,
            foldings_fg2=foldings_fg2,
        )

    # -- verifier (ipa.rs:250-343) ----------------------------------------

    def verify_transcript(self, vrs: Vrs, comm_a, comm_b,
                          y: int) -> None:
        challenges = list(reversed(self.sumcheck.challenges[:-1]))
        g1s = [
            e + o.smul(c)
            for (e, o), c in zip(vrs.vk1, challenges)
        ]
        g2s = [
            e + o.smul(c)
            for (e, o), c in zip(vrs.vk2, challenges)
        ]
        g1s.reverse()
        g2s.reverse()
        g1s.append(GT.zero())
        g2s.append(GT.zero())

        claim_ff = po_from_scalar(y)
        claim_fg1 = PModule.p(comm_a, g2_generator())
        claim_fg2 = PModule.p(g1_generator(), comm_b)
        reduced = (
            claim_ff.smul(self.batch_challenges[0])
            + claim_fg1.smul(self.batch_challenges[1])
            + claim_fg2.smul(self.batch_challenges[2])
        )
        rounds = len(self.sumcheck.messages)
        assert rounds == len(self.sumcheck.challenges)
        for i in range(rounds - 1):
            a, b = self.sumcheck.messages[i]
            challenge = self.sumcheck.challenges[i]
            c = reduced - a
            evaln = a + b.smul(challenge) + c.smul(challenge * challenge % R)
            reduced = (
                evaln
                + g1s[i].smul(self.batch_challenges[3 + i * 2])
                + g2s[i].smul(self.batch_challenges[3 + i * 2 + 1])
            )
        a, b = self.sumcheck.messages[rounds - 1]
        challenge = self.sumcheck.challenges[rounds - 1]
        c = reduced - a
        reduced = a + b.smul(challenge) + c.smul(challenge * challenge % R)

        final = [
            po_from_scalar(
                FModule.p(self.foldings_ff[0][0], self.foldings_ff[0][1])),
            po_from_g1(
                G1Module.p(self.foldings_fg1[0][0], self.foldings_fg1[0][1])),
            po_from_g2(
                G2Module.p(self.foldings_fg2[0][0], self.foldings_fg2[0][1])),
        ]
        for (lhs, rhs) in self.sumcheck.final_foldings:
            final.append(PModule.p(lhs, rhs))
        assert len(self.batch_challenges) == len(final)
        expected = GT.zero()
        for f, c in zip(final, self.batch_challenges):
            expected = expected + f.smul(c)
        if reduced != expected:
            raise HerringVerificationError("IPA batched GT check failed")
