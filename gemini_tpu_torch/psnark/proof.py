"""Preprocessing SNARK prover and verifier (port of
gemini_tpu/psnark/proof.py; psnark/time_prover.rs, psnark/verifier.rs
analogues).

Pipeline (time_prover.rs:69-385): commit w -> sumcheck 1 ⟨z_a, z_b⟩_α
-> joint-sparsity lookups (device gathers) r* = r[row], z* = z[col]
-> sumcheck 2 ⟨z*, Σ ηⁱ valᵢ ∘ rᵢ*⟩ -> plookup on (r*, α*, z*) -> 9
batched entry products -> ψ-openings of the accumulators -> batched
sumcheck 3 (13 provers) -> one tensorcheck (22 base polynomials, 4
instance groups).

Every O(N) and O(nnz) vector lives on the relation's device; lookups
are gathers by int64 index tensors there; grand products and
accumulators are log-depth multiplicative scans.  The reference's
`index_by` commitments (kzg/time.rs:86-95) are commitments to the
gathered vectors, which give the same group elements.  The prover's
`psnark::*` spans (utils/trace) say where its time goes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..fields import fp
from ..fields.fp import FR
from ..kzg.commit import CommitterKey, VerifierKey
from ..ops import poly
from ..params import R
from ..relation import R1cs
from ..relation.r1cs import joint_matrices
from ..serialize import G1Msg, G2Msg, ScalarMsg
from ..subprotocols import plookup as pl
from ..subprotocols.entry_product import EntryProduct, ProverMsgs as EpMsgs
from ..subprotocols.entry_product import monic, right_rotation
from ..subprotocols.sumcheck import Subclaim, Sumcheck, TimeProver
from ..subprotocols.tensorcheck import TensorcheckProof
from ..transcript import GeminiTranscript, PROTOCOL_NAME
from ..utils.trace import end_timer, start_timer

G1Host = Optional[Tuple[int, int]]


class PsnarkVerificationError(Exception):
    pass


def index(ck: CommitterKey, r1cs: R1cs) -> List[G1Host]:
    """Commit to the joint sparsity pattern: row, col, val_a, val_b,
    val_c (time_prover.rs:49-64)."""
    jm = joint_matrices(r1cs)
    return ck.batch_commit([jm.row, jm.col, jm.val_a, jm.val_b, jm.val_c])


def index_stream(ck_stream, r1cs_stream) -> List[G1Host]:
    """Streaming indexer: the 5 joint-sparsity commitments of `index`,
    from a relation stream through the streaming committer's chunked
    MSMs (the same group elements as `index` on the dense relation)."""
    jm = r1cs_stream.joint()
    return [ck_stream.commit(v)
            for v in (jm.row, jm.col, jm.val_a, jm.val_b, jm.val_c)]


def _append_index(transcript: GeminiTranscript, ck_g2: Sequence,
                  idx: Sequence[G1Host]) -> None:
    transcript.append_serializable(b"ck", [G2Msg(p) for p in ck_g2])
    transcript.append_serializable(b"instance", [G1Msg(c) for c in idx])


def _hadamard(a, b):
    return fp.mont_mul(FR, a, b)


@dataclass
class Proof:
    """psnark/mod.rs:29-51 (21 fields)."""

    witness_commitment: G1Host
    zc_alpha: int
    first_sumcheck_msgs: Tuple[list, list]
    r_star_commitments: List[G1Host]  # [ra*, rb*, rc*]
    z_star_commitment: G1Host
    second_sumcheck_msgs: Tuple[list, list]
    set_r_ep: int
    subset_r_ep: int
    sorted_r_commitment: G1Host
    set_alpha_ep: int
    subset_alpha_ep: int
    sorted_alpha_commitment: G1Host
    set_z_ep: int
    subset_z_ep: int
    sorted_z_commitment: G1Host
    ep_msgs: EpMsgs
    ralpha_star_acc_mu_evals: List[int]
    ralpha_star_acc_mu_proof: G1Host
    rstars_vals: List[int]  # [s_0', s_1']
    third_sumcheck_msgs: Tuple[list, list]
    tensorcheck_proof: TensorcheckProof

    # -- prover -----------------------------------------------------------

    @staticmethod
    def new_time(ck: CommitterKey, r1cs: R1cs,
                 idx: Sequence[G1Host], mesh=None) -> "Proof":
        """Time-efficient prover (psnark/time_prover.rs:69-385), on the
        device of the relation's tensors.

        `mesh`: an optional `parallel.Mesh`; sumchecks 1 and 2 then run
        the sharded prover and every commit MSM splits its lanes across
        the mesh's devices (sumcheck 3 stays the dense batch).  The
        proof is the single-device one, byte for byte."""
        if mesh is not None:
            from ..parallel.sumcheck import ShardedTimeProver

            ck = ck.with_devices(mesh.devices)
            mk_prover = lambda f, g, tw: ShardedTimeProver(mesh, f, g, tw)
        else:
            mk_prover = TimeProver
        dev = r1cs.z.device
        t = start_timer("psnark::matvecs")
        z_a = r1cs.a.matvec(r1cs.z)
        z_b = r1cs.b.matvec(r1cs.z)
        z_c = r1cs.c.matvec(r1cs.z)
        end_timer(t)

        transcript = GeminiTranscript(PROTOCOL_NAME)

        t = start_timer("psnark::commit w")
        witness_commitment = ck.commit(r1cs.w)
        transcript.append_serializable(b"witness", G1Msg(witness_commitment))
        _append_index(transcript, ck.powers_of_g2, idx)
        alpha = transcript.get_challenge(b"alpha")
        end_timer(t)

        t = start_timer("psnark::zc(alpha)")
        zc_alpha = poly.evaluate_le(FR, z_c, alpha)
        transcript.append_serializable(b"zc(alpha)", ScalarMsg(zc_alpha))
        end_timer(t)

        t = start_timer("psnark::sumcheck 1")
        first_proof = Sumcheck.prove(transcript, mk_prover(z_a, z_b, alpha))
        end_timer(t)

        t = start_timer("psnark::joint matrices")
        jm = joint_matrices(r1cs)
        num_non_zero = jm.num_non_zero
        end_timer(t)

        t = start_timer("psnark::lookups")
        b_challenges = poly.tensor_device(FR, first_proof.challenges, dev)
        c_challenges = poly.powers(FR, alpha, b_challenges.shape[1], dev)
        a_challenges = _hadamard(b_challenges, c_challenges)
        row_idx, col_idx = jm.row_index_d, jm.col_index_d
        ralpha_star = a_challenges[:, row_idx]
        r_star = b_challenges[:, row_idx]
        alpha_star = c_challenges[:, row_idx]
        z_star = r1cs.z[:, col_idx]
        end_timer(t)

        # Commitments to the looked-up vectors (== the reference's
        # `index_by` commitments, time_prover.rs:118-126).
        t = start_timer("psnark::lookup commits")
        z_r_commitments = ck.batch_commit([ralpha_star, r_star, alpha_star, z_star])
        transcript.append_serializable(b"ra*", G1Msg(z_r_commitments[0]))
        transcript.append_serializable(b"rb*", G1Msg(z_r_commitments[1]))
        transcript.append_serializable(b"rc*", G1Msg(z_r_commitments[2]))
        transcript.append_serializable(b"z*", G1Msg(z_r_commitments[3]))

        eta = transcript.get_challenge(b"chal")
        eta2 = eta * eta % R
        end_timer(t)

        t = start_timer("psnark::sumcheck 2")
        r_star_val = poly.linear_combination(
            FR,
            [_hadamard(ralpha_star, jm.val_a), _hadamard(r_star, jm.val_b),
             _hadamard(alpha_star, jm.val_c)],
            [1, eta, eta2],
        )
        second_proof = Sumcheck.prove(transcript, mk_prover(z_star, r_star_val, 1))
        second_challenges = poly.tensor_device(FR, second_proof.challenges, dev)
        sc_head = second_challenges[:, :num_non_zero]
        end_timer(t)

        zeta = transcript.get_challenge(b"zeta")

        # Sorted vectors (positions bound by the ζ-hash).
        t = start_timer("psnark::sorted vectors")
        set_b = pl.alg_hash(b_challenges, range(b_challenges.shape[1]), zeta)
        set_c = pl.alg_hash(c_challenges, range(c_challenges.shape[1]), zeta)
        set_z = pl.alg_hash(r1cs.z, range(r1cs.z.shape[1]), zeta)
        freq_row = pl.compute_frequency(b_challenges.shape[1], jm.row_index)
        freq_col = pl.compute_frequency(r1cs.z.shape[1], jm.col_index)
        sorted_r = pl.sorted_vector(set_b, freq_row)
        sorted_alpha = pl.sorted_vector(set_c, freq_row)
        sorted_z = pl.sorted_vector(set_z, freq_col)
        end_timer(t)

        t = start_timer("psnark::sorted commits")
        sorted_commitments = ck.batch_commit([sorted_r, sorted_alpha, sorted_z])

        # The reference's order: alpha, r, z (time_prover.rs).
        transcript.append_serializable(
            b"sorted_alpha_commitment", G1Msg(sorted_commitments[1]))
        transcript.append_serializable(
            b"sorted_r_commitment", G1Msg(sorted_commitments[0]))
        transcript.append_serializable(
            b"sorted_z_commitment", G1Msg(sorted_commitments[2]))

        gamma = transcript.get_challenge(b"gamma")
        chi = transcript.get_challenge(b"chi")
        end_timer(t)

        t = start_timer("psnark::plookup")
        r_lookup_vec = pl.plookup(
            r_star, b_challenges, jm.row_index, gamma, chi, zeta)
        alpha_lookup_vec = pl.plookup(
            alpha_star, c_challenges, jm.row_index, gamma, chi, zeta)
        z_lookup_vec = pl.plookup(z_star, r1cs.z, jm.col_index, gamma, chi, zeta)
        r_prod_vec = [poly.lane_prod(FR, v) for v in r_lookup_vec]
        alpha_prod_vec = [poly.lane_prod(FR, v) for v in alpha_lookup_vec]
        z_prod_vec = [poly.lane_prod(FR, v) for v in z_lookup_vec]

        lookup_vec = list(r_lookup_vec) + list(alpha_lookup_vec) + list(z_lookup_vec)

        # The alpha products go under the r labels first, as the
        # reference appends them.
        transcript.append_serializable(b"set_r_ep", ScalarMsg(alpha_prod_vec[0]))
        transcript.append_serializable(b"subset_r_ep", ScalarMsg(alpha_prod_vec[1]))
        transcript.append_serializable(b"set_r_ep", ScalarMsg(r_prod_vec[0]))
        transcript.append_serializable(b"subset_r_ep", ScalarMsg(r_prod_vec[1]))
        transcript.append_serializable(b"set_z_ep", ScalarMsg(z_prod_vec[0]))
        transcript.append_serializable(b"subset_z_ep", ScalarMsg(z_prod_vec[1]))
        end_timer(t)

        t = start_timer("psnark::entry products")
        entry_products = EntryProduct.new_time_batch(
            transcript, ck, lookup_vec, r_prod_vec + alpha_prod_vec + z_prod_vec)
        accumulated_vec = entry_products.acc_vs  # unpadded (SRS-sized)
        psi = entry_products.chal
        open_chal = transcript.get_challenge(b"open-chal")
        end_timer(t)

        t = start_timer("psnark::mu opening")
        polynomials = [ralpha_star] + accumulated_vec
        ralpha_star_acc_mu_proof = ck.batch_open_multi_points(
            polynomials, [psi], open_chal)
        ralpha_star_acc_mu_evals = [poly.evaluate_le(FR, v, psi) for v in polynomials]

        s_0_prime = poly.ip(FR, _hadamard(ralpha_star, jm.val_a), sc_head)
        s_1_prime = poly.ip(FR, _hadamard(r_star, jm.val_b), sc_head)
        for e in ralpha_star_acc_mu_evals:
            transcript.append_serializable(b"ralpha_star_acc_mu", ScalarMsg(e))
        transcript.append_serializable(
            b"ralpha_star_mu_proof", G1Msg(ralpha_star_acc_mu_proof))
        end_timer(t)

        t = start_timer("psnark::sumcheck 3")
        provers = list(entry_products.provers)
        provers.append(TimeProver(_hadamard(ralpha_star, sc_head), jm.val_a, 1))
        provers.append(TimeProver(_hadamard(r_star, sc_head), jm.val_b, 1))
        provers.append(TimeProver(_hadamard(alpha_star, sc_head), jm.val_c, 1))
        provers.append(TimeProver(r_star, alpha_star, psi))
        third_proof = Sumcheck.prove_batch(transcript, provers)
        end_timer(t)

        t = start_timer("psnark::tensorcheck")
        tc_base_polynomials = [
            r1cs.w, ralpha_star, r_star, alpha_star, z_star,
            jm.row, jm.col, jm.val_a, jm.val_b, jm.val_c,
            sorted_r, sorted_alpha, sorted_z,
        ] + accumulated_vec

        twist_powers2 = poly.powers2_host(psi, len(third_proof.challenges))
        shift_monic_lookup_vec = [right_rotation(monic(v)) for v in lookup_vec]
        third_proof_vec = shift_monic_lookup_vec + [
            jm.val_a, jm.val_b, jm.val_c, alpha_star]
        tpc_head = third_proof.challenges[: len(second_proof.challenges)]
        hadamard_host = lambda a, b: [x * y % R for x, y in zip(a, b)]
        tc_body_polynomials = [
            (accumulated_vec + [r_star],
             hadamard_host(third_proof.challenges, twist_powers2)),
            (third_proof_vec, list(third_proof.challenges)),
            ([z_star], list(second_proof.challenges)),
            ([ralpha_star, r_star, alpha_star],
             hadamard_host(second_proof.challenges, tpc_head)),
        ]
        tensorcheck_proof = TensorcheckProof.new_time(
            transcript, ck, tc_base_polynomials, tc_body_polynomials)
        end_timer(t)

        return Proof(
            witness_commitment=witness_commitment,
            zc_alpha=zc_alpha,
            first_sumcheck_msgs=(first_proof.messages, first_proof.final_foldings),
            r_star_commitments=z_r_commitments[:3],
            z_star_commitment=z_r_commitments[3],
            second_sumcheck_msgs=(second_proof.messages, second_proof.final_foldings),
            set_r_ep=r_prod_vec[0],
            subset_r_ep=r_prod_vec[1],
            sorted_r_commitment=sorted_commitments[0],
            set_alpha_ep=alpha_prod_vec[0],
            subset_alpha_ep=alpha_prod_vec[1],
            sorted_alpha_commitment=sorted_commitments[1],
            set_z_ep=z_prod_vec[0],
            subset_z_ep=z_prod_vec[1],
            sorted_z_commitment=sorted_commitments[2],
            ep_msgs=entry_products.msgs,
            ralpha_star_acc_mu_evals=ralpha_star_acc_mu_evals,
            ralpha_star_acc_mu_proof=ralpha_star_acc_mu_proof,
            rstars_vals=[s_0_prime, s_1_prime],
            third_sumcheck_msgs=(third_proof.messages, third_proof.final_foldings),
            tensorcheck_proof=tensorcheck_proof,
        )

    @staticmethod
    def new_elastic(ck_stream, r1cs, idx: Sequence[G1Host],
                    block_size: int = 1 << 20,
                    threshold: int | None = None) -> "Proof":
        """Space-efficient prover (psnark/elastic_prover.rs:60-635): the
        proof of `new_time` from host-RAM block streams, with device
        memory bounded by the blocks and the dense switch at `threshold`
        rounds (default SPACE_TIME_THRESHOLD).  `r1cs` is a dense `R1cs`
        or a relation stream (`DummyR1csStream`, `HostR1csStream`): the
        giant-instance path of examples/psnark.rs:54-68.  See
        psnark/elastic.py."""
        from .elastic import new_elastic

        return new_elastic(ck_stream, r1cs, idx, block_size, threshold)

    # -- verifier ---------------------------------------------------------

    def verify(self, r1cs: R1cs, vk: VerifierKey,
               idx: Sequence[G1Host], num_non_zero: int) -> None:
        """psnark/verifier.rs:88-566 (host arithmetic and pairings);
        raises PsnarkVerificationError on failure."""
        transcript = GeminiTranscript(PROTOCOL_NAME)
        transcript.append_serializable(b"witness", G1Msg(self.witness_commitment))
        _append_index(transcript, vk.powers_of_g2, idx)
        alpha = transcript.get_challenge(b"alpha")
        transcript.append_serializable(b"zc(alpha)", ScalarMsg(self.zc_alpha))

        try:
            subclaim_1 = Subclaim.new(
                transcript, self.first_sumcheck_msgs[0],
                self.first_sumcheck_msgs[1], self.zc_alpha)
        except Exception as e:
            raise PsnarkVerificationError(f"first sumcheck: {e}") from e

        num_variables = len(r1cs.z_int)
        for cm, lbl in zip(self.r_star_commitments, (b"ra*", b"rb*", b"rc*")):
            transcript.append_serializable(lbl, G1Msg(cm))
        transcript.append_serializable(b"z*", G1Msg(self.z_star_commitment))

        eta = transcript.get_challenge(b"chal")
        eta2 = eta * eta % R

        ff1 = subclaim_1.final_foldings[0]
        asserted_sum_2 = (ff1[0] + ff1[1] * eta + self.zc_alpha * eta2) % R
        try:
            subclaim_2 = Subclaim.new(
                transcript, self.second_sumcheck_msgs[0],
                self.second_sumcheck_msgs[1], asserted_sum_2)
        except Exception as e:
            raise PsnarkVerificationError(f"second sumcheck: {e}") from e

        zeta = transcript.get_challenge(b"zeta")
        for cm, lbl in (
            (self.sorted_alpha_commitment, b"sorted_alpha_commitment"),
            (self.sorted_r_commitment, b"sorted_r_commitment"),
            (self.sorted_z_commitment, b"sorted_z_commitment"),
        ):
            transcript.append_serializable(lbl, G1Msg(cm))

        y = transcript.get_challenge(b"gamma")
        z = transcript.get_challenge(b"chi")

        for val, lbl in (
            (self.set_alpha_ep, b"set_r_ep"),
            (self.subset_alpha_ep, b"subset_r_ep"),
            (self.set_r_ep, b"set_r_ep"),
            (self.subset_r_ep, b"subset_r_ep"),
            (self.set_z_ep, b"set_z_ep"),
            (self.subset_z_ep, b"subset_z_ep"),
        ):
            transcript.append_serializable(lbl, ScalarMsg(val))

        for cm in self.ep_msgs.acc_v_commitments:
            transcript.append_serializable(b"acc_v", G1Msg(cm))

        mu = transcript.get_challenge(b"ep-chal")
        open_chal = transcript.get_challenge(b"open-chal")

        commitments = [self.r_star_commitments[0]] + list(self.ep_msgs.acc_v_commitments)
        evaluations = [[e] for e in self.ralpha_star_acc_mu_evals]
        try:
            vk.verify_multi_points(
                commitments, [mu], evaluations,
                self.ralpha_star_acc_mu_proof, open_chal)
        except Exception as e:
            raise PsnarkVerificationError(f"mu opening: {e}") from e

        for e in self.ralpha_star_acc_mu_evals:
            transcript.append_serializable(b"ralpha_star_acc_mu", ScalarMsg(e))
        transcript.append_serializable(
            b"ralpha_star_mu_proof", G1Msg(self.ralpha_star_acc_mu_proof))

        asserted_sum_3 = list(self.ep_msgs.claimed_sumchecks)
        asserted_sum_3.extend(self.rstars_vals)
        asserted_sum_3.append(
            (subclaim_2.final_foldings[0][1] - self.rstars_vals[0]
             - self.rstars_vals[1] * eta)
            * pow(eta2, -1, R) % R
        )
        asserted_sum_3.append(self.ralpha_star_acc_mu_evals[0])
        try:
            subclaim_3 = Subclaim.new_batch(
                transcript, self.third_sumcheck_msgs[0],
                self.third_sumcheck_msgs[1], asserted_sum_3)
        except Exception as e:
            raise PsnarkVerificationError(f"third sumcheck: {e}") from e

        batch_consistency = transcript.get_challenge(b"batch_challenge")
        for cm in self.tensorcheck_proof.folded_polynomials_commitments:
            transcript.append_serializable(b"commitment", G1Msg(cm))
        beta = transcript.get_challenge(b"evaluation-chal")

        s3f = subclaim_3.final_foldings
        asserted_res_vec_1 = [s3f[i][0] for i in range(9)] + [s3f[12][0]]
        asserted_res_vec_2 = [s3f[i][1] for i in range(9)] + \
            [s3f[i][1] for i in range(9, 13)]
        asserted_res_vec_3 = [subclaim_2.final_foldings[0][0]]
        asserted_res_vec_4 = [s3f[9][0], s3f[10][0], s3f[11][0]]

        bev = self.tensorcheck_proof.base_polynomials_evaluations
        minus_beta = (-beta) % R

        # Group 1: accumulators + r_star at (β, −β).
        d1 = [0, 0]
        tmp = 1
        for i in range(13, 22):
            d1[0] = (d1[0] + tmp * bev[i][1]) % R
            d1[1] = (d1[1] + tmp * bev[i][2]) % R
            tmp = tmp * batch_consistency % R
        d1[0] = (d1[0] + tmp * bev[2][1]) % R
        d1[1] = (d1[1] + tmp * bev[2][2]) % R

        # Group 2: the 13 shifted/monic lookup + val/alpha* oracles.
        set_len = 1 << len(subclaim_1.challenges)

        def pset(ev, pt, n):
            inner = ((1 + z) * y % R
                     * poly.evaluate_geometric_poly(pt, n + 1)
                     + (pt + z) * ev) % R
            return (pt * inner + 1) % R  # eval_shift

        def psubset(ev, idx_ev, pt, n):
            inner = (ev + zeta * idx_ev
                     + y * poly.evaluate_geometric_poly(pt, n)) % R
            return (pt * inner + 1) % R

        d2 = [0, 0]
        tmp = 1

        def acc2(pos, neg):
            nonlocal tmp
            d2[0] = (d2[0] + tmp * pos) % R
            d2[1] = (d2[1] + tmp * neg) % R
            tmp = tmp * batch_consistency % R

        # lookup r*: set (tensor poly), subset, sorted
        acc2(
            pset((poly.evaluate_tensor_poly(subclaim_1.challenges, beta)
                  + zeta * poly.evaluate_index_poly(beta, set_len)) % R,
                 beta, set_len),
            pset((poly.evaluate_tensor_poly(subclaim_1.challenges, minus_beta)
                  + zeta * poly.evaluate_index_poly(minus_beta, set_len)) % R,
                 minus_beta, set_len),
        )
        acc2(psubset(bev[2][1], bev[5][1], beta, num_non_zero),
             psubset(bev[2][2], bev[5][2], minus_beta, num_non_zero))
        acc2(pset(bev[10][1], beta, set_len + num_non_zero),
             pset(bev[10][2], minus_beta, set_len + num_non_zero))
        # lookup alpha*: set (geometric in αx), subset, sorted
        acc2(
            pset((poly.evaluate_geometric_poly(alpha * beta % R, set_len)
                  + zeta * poly.evaluate_index_poly(beta, set_len)) % R,
                 beta, set_len),
            pset((poly.evaluate_geometric_poly(alpha * minus_beta % R, set_len)
                  + zeta * poly.evaluate_index_poly(minus_beta, set_len)) % R,
                 minus_beta, set_len),
        )
        acc2(psubset(bev[3][1], bev[5][1], beta, num_non_zero),
             psubset(bev[3][2], bev[5][2], minus_beta, num_non_zero))
        acc2(pset(bev[11][1], beta, set_len + num_non_zero),
             pset(bev[11][2], minus_beta, set_len + num_non_zero))
        # lookup z*: set from public input + w claim, subset, sorted
        x_int = r1cs.x_int
        beta_power = pow(beta, len(x_int), R)
        x_beta = sum(c * pow(beta, i, R) for i, c in enumerate(x_int)) % R
        x_mbeta = sum(c * pow(minus_beta, i, R) for i, c in enumerate(x_int)) % R
        z_pos = (x_beta + beta_power * bev[0][1]) % R
        sign = 1 if len(x_int) % 2 == 0 else -1
        z_neg = (x_mbeta + sign * beta_power * bev[0][2]) % R
        acc2(
            pset((z_pos + zeta * poly.evaluate_index_poly(beta, num_variables)) % R,
                 beta, num_variables),
            pset((z_neg + zeta * poly.evaluate_index_poly(minus_beta, num_variables))
                 % R, minus_beta, num_variables),
        )
        acc2(psubset(bev[4][1], bev[6][1], beta, num_non_zero),
             psubset(bev[4][2], bev[6][2], minus_beta, num_non_zero))
        acc2(pset(bev[12][1], beta, num_variables + num_non_zero),
             pset(bev[12][2], minus_beta, num_variables + num_non_zero))
        # val_a, val_b, val_c, alpha*
        for i in range(7, 10):
            acc2(bev[i][1], bev[i][2])
        acc2(bev[3][1], bev[3][2])

        d3 = [bev[4][1], bev[4][2]]

        d4 = [0, 0]
        tmp = 1
        for i in (1, 2, 3):
            d4[0] = (d4[0] + tmp * bev[i][1]) % R
            d4[1] = (d4[1] + tmp * bev[i][2]) % R
            tmp = tmp * batch_consistency % R

        base_polynomials_commitments = [
            self.witness_commitment,
            *self.r_star_commitments,
            self.z_star_commitment,
            *idx,
            self.sorted_r_commitment,
            self.sorted_alpha_commitment,
            self.sorted_z_commitment,
            *self.ep_msgs.acc_v_commitments,
        ]

        mu_powers2 = poly.powers2_host(mu, len(subclaim_3.challenges))
        s3_head = subclaim_3.challenges[: len(subclaim_2.challenges)]
        had = lambda a, b: [p * q % R for p, q in zip(a, b)]
        try:
            self.tensorcheck_proof.verify(
                transcript, vk,
                [asserted_res_vec_1, asserted_res_vec_2,
                 asserted_res_vec_3, asserted_res_vec_4],
                base_polynomials_commitments,
                [tuple(d1), tuple(d2), tuple(d3), tuple(d4)],
                [
                    had(subclaim_3.challenges, mu_powers2),
                    list(subclaim_3.challenges),
                    list(subclaim_2.challenges),
                    had(subclaim_2.challenges, s3_head),
                ],
                beta,
                batch_consistency,
            )
        except Exception as e:
            raise PsnarkVerificationError(f"tensorcheck: {e}") from e
