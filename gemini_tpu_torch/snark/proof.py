"""SNARK provers and verifier (port of gemini_tpu/snark/proof.py;
snark/{time,elastic}_prover.rs, snark/verifier.rs analogues).

The time prover's hot path is three sparse matvecs, one witness-MSM,
two sumchecks, and the tensorcheck (log-N MSMs + one quotient MSM) —
every O(N) step is a batched device kernel; the Fiat-Shamir transcript
stays host-side (a few KB).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..fields import fp
from ..fields.fp import FR
from ..kzg.commit import CommitterKey, VerifierKey
from ..ops import poly
from ..params import R
from ..relation import R1cs
from ..serialize import ScalarMsg, G1Msg
from ..subprotocols.sumcheck import (ElasticProver, Sumcheck, Subclaim,
                                     TimeProver)
from ..subprotocols.tensorcheck import TensorcheckProof
from ..transcript import GeminiTranscript, PROTOCOL_NAME

G1Host = Optional[Tuple[int, int]]


class SnarkVerificationError(Exception):
    pass


@dataclass
class Proof:
    """snark/mod.rs:76-82."""

    witness_commitment: G1Host
    zc_alpha: int
    first_sumcheck_msgs: Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]
    second_sumcheck_msgs: Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]
    tensorcheck_proof: TensorcheckProof

    @staticmethod
    def new_time(r1cs: R1cs, ck: CommitterKey, mesh=None) -> "Proof":
        """Time-efficient prover (snark/time_prover.rs:19-118), on the
        device of the relation's tensors.

        `mesh`: an optional `parallel.Mesh`; both sumchecks then run the
        sharded prover and every commit MSM splits its lanes across the
        mesh's devices.  The proof is the single-device one, byte for
        byte."""
        from ..utils.trace import start_timer, end_timer

        if mesh is not None:
            from ..parallel.sumcheck import ShardedTimeProver

            ck = ck.with_devices(mesh.devices)
            mk_prover = lambda f, g, tw: ShardedTimeProver(mesh, f, g, tw)
        else:
            mk_prover = TimeProver
        dev = r1cs.z.device
        t = start_timer("snark::matvecs")
        z_a = r1cs.a.matvec(r1cs.z)
        z_b = r1cs.b.matvec(r1cs.z)
        z_c = r1cs.c.matvec(r1cs.z)
        end_timer(t)

        transcript = GeminiTranscript(PROTOCOL_NAME)
        t = start_timer("snark::commit w")
        witness_commitment = ck.commit(r1cs.w)
        end_timer(t)
        transcript.append_serializable(b"witness", G1Msg(witness_commitment))
        alpha = transcript.get_challenge(b"alpha")

        t = start_timer("snark::zc(alpha)")
        zc_alpha = poly.evaluate_le(FR, z_c, alpha)
        end_timer(t)
        transcript.append_serializable(b"zc(alpha)", ScalarMsg(zc_alpha))

        t = start_timer("snark::sumcheck 1")
        first_proof = Sumcheck.prove(
            transcript, mk_prover(z_a, z_b, alpha)
        )
        end_timer(t)

        # r_B = ⊗(1, ρ_j); r_C = powers(α); r_A = r_B ∘ r_C
        # (tensor length 2^rounds >= num_constraints; sparse gathers
        # only touch the first num_constraints entries).
        b_challenges = poly.tensor_device(FR, first_proof.challenges, dev)
        c_challenges = poly.powers(FR, alpha, b_challenges.shape[1], dev)
        a_challenges = fp.mont_mul(FR, b_challenges, c_challenges)

        eta = transcript.get_challenge(b"eta")
        eta2 = eta * eta % R

        # abc_tensored = A^T r_A + η B^T r_B + η² C^T r_C
        # (the scatter-build of snark/time_prover.rs:63-81, expressed as
        # three transposed sparse matvecs).
        t = start_timer("snark::abc_tensored")
        part_a = r1cs.a.rmatvec(a_challenges)
        part_b = r1cs.b.rmatvec(b_challenges)
        part_c = r1cs.c.rmatvec(c_challenges)
        abc_tensored = fp.add(
            FR,
            part_a,
            fp.add(
                FR,
                fp.mont_mul(FR, part_b, poly.scalar(FR, eta, dev)),
                fp.mont_mul(FR, part_c, poly.scalar(FR, eta2, dev)),
            ),
        )
        end_timer(t)

        t = start_timer("snark::sumcheck 2")
        second_proof = Sumcheck.prove(
            transcript, mk_prover(abc_tensored, r1cs.z, 1)
        )
        end_timer(t)

        t = start_timer("snark::tensorcheck")
        tensorcheck_proof = TensorcheckProof.new_time(
            transcript,
            ck,
            [r1cs.w],
            [((abc_tensored, r1cs.z), second_proof.challenges)],
        )
        end_timer(t)
        return Proof(
            witness_commitment=witness_commitment,
            zc_alpha=zc_alpha,
            first_sumcheck_msgs=(
                first_proof.messages, first_proof.final_foldings
            ),
            second_sumcheck_msgs=(
                second_proof.messages, second_proof.final_foldings
            ),
            tensorcheck_proof=tensorcheck_proof,
        )

    @staticmethod
    def new_elastic(r1cs, ck_stream, block_size: int = 1 << 20,
                    threshold: int | None = None) -> "Proof":
        """Space-efficient prover (snark/elastic_prover.rs:174): the
        proof of `new_time`, with device memory bounded by the blocks.
        The witness commitment streams host-RAM blocks through chunked
        MSMs, zc(α) is a streaming evaluation, both sumchecks run the
        elastic prover (host-resident coefficients, per-round block
        contraction, dense switch at `threshold` rounds, default
        SPACE_TIME_THRESHOLD), and the tensorcheck streams through the
        fold-tree commit and open (streaming/tensorcheck.py).

        `r1cs` is a dense `R1cs` or a relation stream (`DummyR1csStream`,
        `HostR1csStream`); `ck_stream` a `CommitterKeyStream` or
        `FakeCommitterKeyStream` on the relation's device."""
        from .. import SPACE_TIME_THRESHOLD
        from ..relation.stream import as_stream
        from ..streaming import tensorcheck as tc_stream
        from ..utils.trace import start_timer, end_timer

        if threshold is None:
            threshold = SPACE_TIME_THRESHOLD
        t = start_timer("snark::matvecs")
        rs = as_stream(r1cs)
        end_timer(t)

        transcript = GeminiTranscript(PROTOCOL_NAME)
        t = start_timer("snark::commit w")
        witness_commitment = ck_stream.commit(rs.w)
        end_timer(t)
        transcript.append_serializable(b"witness", G1Msg(witness_commitment))
        alpha = transcript.get_challenge(b"alpha")

        t = start_timer("snark::zc(alpha)")
        zc_alpha = ck_stream.evaluate(rs.z_c, alpha)
        end_timer(t)
        transcript.append_serializable(b"zc(alpha)", ScalarMsg(zc_alpha))

        t = start_timer("snark::sumcheck 1")
        first_proof = Sumcheck.prove(
            transcript,
            ElasticProver(rs.z_a, rs.z_b, alpha, block_size, threshold))
        end_timer(t)

        eta = transcript.get_challenge(b"eta")
        t = start_timer("snark::abc_tensored")
        abc_host = rs.abc_tensored(first_proof.challenges, alpha, eta,
                                   block_size)
        end_timer(t)

        t = start_timer("snark::sumcheck 2")
        second_proof = Sumcheck.prove(
            transcript, ElasticProver(abc_host, rs.z, 1, block_size, threshold))
        end_timer(t)

        t = start_timer("snark::tensorcheck")
        tensorcheck_proof = tc_stream.new_space(
            transcript, ck_stream, [rs.w],
            [((abc_host, rs.z), second_proof.challenges)])
        end_timer(t)
        return Proof(
            witness_commitment=witness_commitment,
            zc_alpha=zc_alpha,
            first_sumcheck_msgs=(
                first_proof.messages, first_proof.final_foldings),
            second_sumcheck_msgs=(
                second_proof.messages, second_proof.final_foldings),
            tensorcheck_proof=tensorcheck_proof,
        )

    def verify(self, r1cs: R1cs, vk: VerifierKey) -> None:
        """Linear-time verifier (snark/verifier.rs:19-120); raises
        SnarkVerificationError on failure."""
        transcript = GeminiTranscript(PROTOCOL_NAME)
        transcript.append_serializable(
            b"witness", G1Msg(self.witness_commitment)
        )
        alpha = transcript.get_challenge(b"alpha")
        transcript.append_serializable(b"zc(alpha)", ScalarMsg(self.zc_alpha))

        try:
            subclaim_1 = Subclaim.new(
                transcript,
                self.first_sumcheck_msgs[0],
                self.first_sumcheck_msgs[1],
                self.zc_alpha,
            )
        except Exception as e:
            raise SnarkVerificationError(f"first sumcheck: {e}") from e

        eta = transcript.get_challenge(b"eta")
        eta2 = eta * eta % R

        dev = r1cs.z.device
        tensor_challenges = poly.tensor_device(FR, subclaim_1.challenges, dev)
        alpha_powers = poly.powers(
            FR, alpha, tensor_challenges.shape[1], dev
        )
        hadamard_randomness = fp.mont_mul(
            FR, tensor_challenges, alpha_powers
        )

        ff1 = subclaim_1.final_foldings[0]
        asserted_sum_2 = (
            ff1[0] + eta * ff1[1] + eta2 * self.zc_alpha
        ) % R
        try:
            subclaim_2 = Subclaim.new(
                transcript,
                self.second_sumcheck_msgs[0],
                self.second_sumcheck_msgs[1],
                asserted_sum_2,
            )
        except Exception as e:
            raise SnarkVerificationError(f"second sumcheck: {e}") from e

        gamma = transcript.get_challenge(b"batch_challenge")
        for c in self.tensorcheck_proof.folded_polynomials_commitments:
            transcript.append_serializable(b"commitment", G1Msg(c))
        beta = transcript.get_challenge(b"evaluation-chal")

        # m(±β) = Σ η^i ⟨M_i β-powers, randomness_i⟩ — the verifier
        # evaluates the matrix polynomials itself (O(nnz), verifier.rs:64-89).
        n_cols = r1cs.a.n_cols
        beta_powers = poly.powers(FR, beta, n_cols, dev)
        minus_beta_powers = poly.powers(FR, (-beta) % R, n_cols, dev)

        def m_eval(bp):
            a_bp = r1cs.a.matvec(bp)
            b_bp = r1cs.b.matvec(bp)
            c_bp = r1cs.c.matvec(bp)
            nr = a_bp.shape[1]
            ip_a = poly.ip(FR, a_bp, hadamard_randomness[:, :nr])
            ip_b = poly.ip(FR, b_bp, tensor_challenges[:, :nr])
            ip_c = poly.ip(FR, c_bp, alpha_powers[:, :nr])
            return (ip_a + eta * ip_b + eta2 * ip_c) % R

        m_pos = m_eval(beta_powers)
        m_neg = m_eval(minus_beta_powers)

        # z(±β) from public input + claimed w(±β) (verifier.rs:91-103).
        x = r1cs.x_int
        x_beta = sum(c * pow(beta, i, R) for i, c in enumerate(x)) % R
        x_minus_beta = sum(
            c * pow((-beta) % R, i, R) for i, c in enumerate(x)
        ) % R
        beta_power = pow(beta, len(x), R)
        base_evals = self.tensorcheck_proof.base_polynomials_evaluations[0]
        z_pos = (x_beta + beta_power * base_evals[1]) % R
        if len(x) % 2:
            beta_power = (-beta_power) % R
        z_neg = (x_minus_beta + beta_power * base_evals[2]) % R

        direct_base_polynomials_evaluations = [
            ((m_pos + gamma * z_pos) % R, (m_neg + gamma * z_neg) % R)
        ]

        try:
            self.tensorcheck_proof.verify(
                transcript,
                vk,
                [list(subclaim_2.final_foldings[0])],
                [self.witness_commitment],
                direct_base_polynomials_evaluations,
                [subclaim_2.challenges],
                beta,
                gamma,
            )
        except Exception as e:
            raise SnarkVerificationError(f"tensorcheck: {e}") from e
