"""Tensorcheck: reduce multivariate evaluations ⟨f, ⊗(1,ρ_j)⟩ = t to
univariate KZG openings (subprotocols/tensorcheck/mod.rs analogue).

Protocol (mod.rs:1-37): the prover commits to every even/odd folding
f^(j) of the (batched) polynomial, the verifier checks the chain

    f^(j+1)(β²) = (f^(j)(β) + f^(j)(−β))/2 + ρ_j (f^(j)(β) − f^(j)(−β))/(2β)

at a random β, with all commitments opened at {β², β, −β} in one
batched KZG multi-point proof.

Port of gemini_tpu/subprotocols/tensorcheck.py: foldings are log(N)
halving passes of the device `fold_polynomial`; evaluations are device
inner products against power vectors; the chain check is O(log N) host
arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..fields.fp import FR
from ..kzg.commit import CommitterKey, VerifierKey
from ..ops import poly
from ..params import R
from ..serialize import ScalarMsg, G1Msg
from ..transcript import GeminiTranscript

G1Host = Optional[Tuple[int, int]]


class TensorcheckError(Exception):
    pass


def evaluate_sq_fp(pos: int, neg: int, rho: int, two_inv: int,
                   two_beta_inv: int) -> int:
    """f'(β²) from f(±β) (tensorcheck/mod.rs:98-107)."""
    return ((pos + neg) * two_inv + (pos - neg) * rho * two_beta_inv) % R


def foldings_polynomial(polynomial: torch.Tensor,
                        challenges: Sequence[int]) -> List[torch.Tensor]:
    """All foldings f^(1..len-1), skipping the last challenge
    (tensorcheck/mod.rs:124-135).  Odd lengths are zero-padded to even
    first (identical to the reference's ragged chunking)."""
    out = []
    cur = polynomial
    for ch in challenges[:-1]:
        if cur.shape[1] % 2:
            cur = poly.pad_to(FR, cur, cur.shape[1] + 1)
        cur = poly.fold_polynomial(FR, cur, poly.scalar(FR, ch, cur.device))
        out.append(cur)
    return out


@dataclass
class TensorcheckProof:
    """tensorcheck/mod.rs:111-121."""

    folded_polynomials_commitments: List[G1Host]
    folded_polynomials_evaluations: List[Tuple[int, int]]  # (f(β), f(−β))
    evaluation_proof: G1Host
    base_polynomials_evaluations: List[Tuple[int, int, int]]  # (β², β, −β)

    @staticmethod
    def new_time(transcript: GeminiTranscript, ck: CommitterKey,
                 base_polynomials: Sequence[torch.Tensor],
                 body_polynomials: Sequence[
                     Tuple[Sequence[torch.Tensor], Sequence[int]]],
                 ) -> "TensorcheckProof":
        """Time-efficient prover (tensorcheck/mod.rs:190-275).

        body_polynomials: per tensorcheck instance, (polynomials sharing
        fold challenges, the challenges).  Instances are batched with
        powers of one batch challenge.
        """
        from ..utils.trace import start_timer, end_timer

        max_len = max(len(polys) for polys, _ in body_polynomials)
        batch_challenge = transcript.get_challenge(b"batch_challenge")
        batch_challenges = poly.powers_host(batch_challenge, max_len)

        t = start_timer("tensorcheck::foldings")
        foldings: List[torch.Tensor] = []
        for polys, challenges in body_polynomials:
            batched = poly.linear_combination(
                FR, list(polys), batch_challenges[: len(polys)]
            )
            foldings.extend(foldings_polynomial(batched, challenges))
        end_timer(t)

        t = start_timer("tensorcheck::batch_commit")
        folded_polynomials_commitments = ck.batch_commit(foldings)
        end_timer(t)
        for c in folded_polynomials_commitments:
            transcript.append_serializable(b"commitment", G1Msg(c))

        beta = transcript.get_challenge(b"evaluation-chal")
        minus_beta = (-beta) % R
        beta2 = beta * beta % R

        t = start_timer("tensorcheck::evaluations")
        base_polynomials_evaluations = [
            (
                poly.evaluate_le(FR, p, beta2),
                poly.evaluate_le(FR, p, beta),
                poly.evaluate_le(FR, p, minus_beta),
            )
            for p in base_polynomials
        ]
        folded_polynomials_evaluations = [
            (poly.evaluate_le(FR, f, beta), poly.evaluate_le(FR, f, minus_beta))
            for f in foldings
        ]
        end_timer(t)

        for evs in base_polynomials_evaluations:
            for e in evs:
                transcript.append_serializable(b"eval", ScalarMsg(e))
        for evs in folded_polynomials_evaluations:
            for e in evs:
                transcript.append_serializable(b"eval", ScalarMsg(e))
        open_chal = transcript.get_challenge(b"open-chal")

        t = start_timer("tensorcheck::batch_open")
        all_polynomials = list(base_polynomials) + foldings
        evaluation_proof = ck.batch_open_multi_points(
            all_polynomials, [beta2, beta, minus_beta], open_chal
        )
        end_timer(t)
        return TensorcheckProof(
            folded_polynomials_commitments=folded_polynomials_commitments,
            folded_polynomials_evaluations=folded_polynomials_evaluations,
            evaluation_proof=evaluation_proof,
            base_polynomials_evaluations=base_polynomials_evaluations,
        )

    def verify(self, transcript: GeminiTranscript, vk: VerifierKey,
               asserted_res_vec: Sequence[Sequence[int]],
               base_polynomials_commitments: Sequence[G1Host],
               direct_base_polynomials_evaluations: Sequence[Tuple[int, int]],
               fold_randomness: Sequence[Sequence[int]],
               eval_chal: int, batch_challenge: int) -> None:
        """tensorcheck/mod.rs:286-385.  Raises on failure."""
        beta = eval_chal % R
        minus_beta = (-beta) % R
        beta2 = beta * beta % R
        two_inv = pow(2, -1, R)
        two_beta_inv = pow(2 * beta % R, -1, R)

        evaluations: List[List[int]] = [
            list(e) for e in self.base_polynomials_evaluations
        ]

        offset = 0
        for instance, randomness in enumerate(fold_randomness):
            rounds = len(randomness) - 1
            base_evals = direct_base_polynomials_evaluations[instance]
            fevals = self.folded_polynomials_evaluations[
                offset: offset + rounds
            ]
            asserted_res = asserted_res_vec[instance]
            offset += rounds

            evaluations.append([
                evaluate_sq_fp(base_evals[0], base_evals[1], randomness[0],
                               two_inv, two_beta_inv),
                fevals[0][0],
                fevals[0][1],
            ])
            for i in range(1, rounds):
                evaluations.append([
                    evaluate_sq_fp(fevals[i - 1][0], fevals[i - 1][1],
                                   randomness[i], two_inv, two_beta_inv),
                    fevals[i][0],
                    fevals[i][1],
                ])
            subclaim = evaluate_sq_fp(
                fevals[rounds - 1][0], fevals[rounds - 1][1],
                randomness[rounds], two_inv, two_beta_inv,
            )
            batch_challenges = poly.powers_host(
                batch_challenge, len(asserted_res)
            )
            lc_asserted = sum(
                a * c for a, c in zip(asserted_res, batch_challenges)
            ) % R
            if subclaim != lc_asserted:
                raise TensorcheckError(
                    f"fold-chain subclaim mismatch (instance {instance})"
                )

        all_commitments = (
            list(base_polynomials_commitments)
            + list(self.folded_polynomials_commitments)
        )
        for evs in self.base_polynomials_evaluations:
            for e in evs:
                transcript.append_serializable(b"eval", ScalarMsg(e))
        for evs in self.folded_polynomials_evaluations:
            for e in evs:
                transcript.append_serializable(b"eval", ScalarMsg(e))
        open_chal = transcript.get_challenge(b"open-chal")

        vk.verify_multi_points(
            all_commitments,
            [beta2, beta, minus_beta],
            evaluations,
            self.evaluation_proof,
            open_chal,
        )
