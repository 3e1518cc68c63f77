"""Twisted scalar-product sumcheck (port of
gemini_tpu/subprotocols/sumcheck.py; subprotocols/sumcheck analogue).

Protocol (reference mod.rs:1-12): reduce the claim
    < f o (1, a, a^2, ...), g > = u
to claims about f, g via log(N) rounds.  Round messages are the two low
coefficients (a, b) of the quadratic partial-sum polynomial; the
verifier reconstructs c = claim - a (subclaim.rs:91-94).

The time prover keeps f, g on the device: each round is elementwise
Montgomery products of the even/odd planes against a maintained vector
of twist powers T_k = twist^(2k), then a lane sum read back to the
host (two scalars down, one challenge up per round).  After a fold,
twist' = twist^2 needs T'_k = T_(2k): a subsample, no new powers.
Inputs are zero-padded to 2^rounds, which is transcript-identical to
the reference's ragged chunking.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..fields import fp
from ..fields.fp import FR
from ..ops import poly
from ..params import R
from ..serialize import fr_to_bytes
from ..transcript import GeminiTranscript


def required_rounds(max_len: int) -> int:
    """ceil(log2(max_len)) with required_rounds(1) == 0 (ark_std::log2)."""
    if max_len <= 1:
        return 0
    return (max_len - 1).bit_length()


def _round_partials(f_e, f_o, g_e, g_o, t_pow, twist):
    a_vec = fp.mont_mul(FR, fp.mont_mul(FR, f_e, g_e), t_pow)
    cross = fp.add(FR, fp.mont_mul(FR, f_e, g_o),
                   fp.mont_mul(FR, fp.mont_mul(FR, g_e, f_o), twist))
    b_vec = fp.mont_mul(FR, cross, t_pow)
    return fp.lane_sum(FR, a_vec, axis=1), fp.lane_sum(FR, b_vec, axis=1)


def _round_message_kernel(f, g, t_pow, twist):
    """(a, b) relaxed limb columns for the current round:
    a = sum_k f[2k] g[2k] T_k,
    b = sum_k (f[2k] g[2k+1] + g[2k] f[2k+1] twist) T_k."""
    f_e, f_o = poly.eo_split(f)
    g_e, g_o = poly.eo_split(g)
    return _round_partials(f_e, f_o, g_e, g_o, t_pow, twist)


def _fold_kernel(f, g, t_pow, r, r_twist):
    """Fold f (by r * twist) and g (by r) and subsample the twist powers
    (T_k = twist^(2k); the next round needs (twist^2)^(2k) = T_(2k))."""
    f2 = poly.fold_polynomial(FR, f, r_twist)
    g2 = poly.fold_polynomial(FR, g, r)
    return f2, g2, t_pow[:, 0::2]


class TimeProver:
    """Dense on-device prover for one twisted scalar product."""

    def __init__(self, f, g, twist: int):
        n = 1 << required_rounds(max(f.shape[1], g.shape[1]))
        self.n = n
        self.f = poly.pad_to(FR, f, max(n, 2))
        self.g = poly.pad_to(FR, g, max(n, 2))
        self.twist = twist % R
        self.tot_rounds = required_rounds(n)
        self.round = 0
        self.t_pow = poly.powers(FR, self.twist * self.twist % R,
                                 max(n // 2, 1), f.device)

    @property
    def device(self):
        return self.f.device

    def rounds(self) -> int:
        return self.tot_rounds

    def fold(self, r: int) -> None:
        dev = self.device
        if self.n > 1:
            self.n //= 2
            self.f, self.g, self.t_pow = _fold_kernel(
                self.f, self.g, self.t_pow, poly.scalar(FR, r, dev),
                poly.scalar(FR, r * self.twist % R, dev))
            if self.n == 1:  # keep an even physical length
                self.f = poly.pad_to(FR, self.f, 2)
                self.g = poly.pad_to(FR, self.g, 2)
        self.twist = self.twist * self.twist % R

    def next_message(self, challenge: Optional[int]):
        """Advance one round: fold by the challenge (if any), then return
        the round message (a, b) as canonical ints (None when the rounds
        are exhausted).  The lane sums come back in one readback."""
        if challenge is not None:
            self.fold(challenge)
        if self.round == self.tot_rounds:
            return None
        a, b = _round_message_kernel(self.f, self.g, self.t_pow,
                                     poly.scalar(FR, self.twist, self.device))
        self.round += 1
        return tuple(FR.decode_relaxed(torch.stack([a, b], dim=1).cpu()))

    def final_foldings(self) -> Optional[Tuple[int, int]]:
        if self.round != self.tot_rounds:
            return None
        return (FR.decode(self.f[:, :1])[0], FR.decode(self.g[:, :1])[0])


def ElasticProver(f, g, twist: int, block_size: int = 1 << 20,
                  threshold: int | None = None):
    """Resource-adaptive prover entry (elastic_prover.rs:10-57), the one
    `snark.Proof.new_elastic` calls: HostVector inputs run the streaming
    space prover with the dense switch under SPACE_TIME_THRESHOLD
    (streaming/sumcheck.py); device tensors run the dense TimeProver
    directly."""
    from ..streaming.host import HostVector

    if isinstance(f, HostVector) or isinstance(g, HostVector):
        from .. import SPACE_TIME_THRESHOLD
        from ..streaming.sumcheck import ElasticProver as _StreamElastic

        if threshold is None:
            threshold = SPACE_TIME_THRESHOLD
        return _StreamElastic(f, g, twist, block_size, threshold)
    return TimeProver(f, g, twist)


def _append_round_msg(transcript: GeminiTranscript, msg: Tuple[int, int]):
    # RoundMsg derives CanonicalSerialize: a || b, 64 bytes
    # (prover.rs:10; appended at proof.rs:44).
    transcript.append_message(
        b"evaluations", fr_to_bytes(msg[0]) + fr_to_bytes(msg[1]))


@dataclass
class Sumcheck:
    """Transcript of a (possibly batched) sumcheck (proof.rs:20-29)."""

    messages: List[Tuple[int, int]]
    challenges: List[int]
    rounds: int
    final_foldings: List[Tuple[int, int]]

    @staticmethod
    def prove(transcript: GeminiTranscript, prover) -> "Sumcheck":
        messages: List[Tuple[int, int]] = []
        challenges: List[int] = []
        verifier_message = None
        while (message := prover.next_message(verifier_message)) is not None:
            _append_round_msg(transcript, message)
            challenge = transcript.get_challenge(b"challenge")
            verifier_message = challenge
            messages.append(message)
            challenges.append(challenge)
        final = prover.final_foldings()
        transcript.append_message(b"final-folding", fr_to_bytes(final[0]))
        transcript.append_message(b"final-folding", fr_to_bytes(final[1]))
        return Sumcheck(messages, challenges, prover.rounds(), [final])

    @staticmethod
    def prove_batch(transcript: GeminiTranscript, provers: Sequence) -> "Sumcheck":
        """Batched sumcheck over instances of different sizes
        (proof.rs:69-122): per-instance random coefficients, one extra
        round, finished instances contribute the constant f0*g0."""
        rounds = max(p.rounds() for p in provers) + 1
        coefficients = [
            transcript.get_challenge(b"batch-sumcheck") for _ in provers
        ]
        messages: List[Tuple[int, int]] = []
        challenges: List[int] = []
        verifier_message = None
        for _ in range(rounds):
            msg_a, msg_b = 0, 0
            for p, c in zip(provers, coefficients):
                m = p.next_message(verifier_message)
                if m is None:
                    ff = p.final_foldings()
                    m = (ff[0] * ff[1] % R, 0)
                msg_a = (msg_a + m[0] * c) % R
                msg_b = (msg_b + m[1] * c) % R
            message = (msg_a, msg_b)
            _append_round_msg(transcript, message)
            challenge = transcript.get_challenge(b"challenge")
            verifier_message = challenge
            messages.append(message)
            challenges.append(challenge)
        final_foldings = []
        for p in provers:
            ff = p.final_foldings()
            transcript.append_message(b"final-folding-lhs", fr_to_bytes(ff[0]))
            transcript.append_message(b"final-folding-rhs", fr_to_bytes(ff[1]))
            final_foldings.append(ff)
        return Sumcheck(messages, challenges, rounds, final_foldings)


class VerificationError(Exception):
    pass


@dataclass
class Subclaim:
    """Verifier-side claim reduction (subclaim.rs:13-18)."""

    challenges: List[int]
    final_foldings: List[Tuple[int, int]]

    @staticmethod
    def _reduce(transcript, messages, asserted_sum: int):
        reduced = asserted_sum % R
        challenges = []
        for (a, b) in messages:
            _append_round_msg(transcript, (a, b))
            r = transcript.get_challenge(b"challenge")
            challenges.append(r)
            c = (reduced - a) % R
            reduced = (a + r * b + c * r * r) % R
        return challenges, reduced

    @staticmethod
    def new(transcript, messages, final_foldings, asserted_sum: int) -> "Subclaim":
        challenges, reduced = Subclaim._reduce(transcript, messages, asserted_sum)
        ff = final_foldings[0]
        transcript.append_message(b"final-folding", fr_to_bytes(ff[0]))
        transcript.append_message(b"final-folding", fr_to_bytes(ff[1]))
        if ff[0] * ff[1] % R != reduced:
            raise VerificationError("sumcheck final folding mismatch")
        return Subclaim(challenges, list(final_foldings))

    @staticmethod
    def new_batch(transcript, messages, final_foldings,
                  asserted_sums: Sequence[int]) -> "Subclaim":
        coefficients = [
            transcript.get_challenge(b"batch-sumcheck") for _ in asserted_sums
        ]
        asserted = sum(c * s for c, s in zip(coefficients, asserted_sums)) % R
        challenges, reduced = Subclaim._reduce(transcript, messages, asserted)
        expected = 0
        for ff, c in zip(final_foldings, coefficients):
            transcript.append_message(b"final-folding-lhs", fr_to_bytes(ff[0]))
            transcript.append_message(b"final-folding-rhs", fr_to_bytes(ff[1]))
            expected = (expected + ff[0] * ff[1] % R * c) % R
        if expected != reduced:
            raise VerificationError("batched sumcheck final folding mismatch")
        return Subclaim(challenges, list(final_foldings))
