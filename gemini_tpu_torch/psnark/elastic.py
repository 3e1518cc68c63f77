"""Space-efficient preprocessing-SNARK prover (port of
gemini_tpu/psnark/elastic.py; psnark/elastic_prover.rs:60-635).

Every O(N) and O(nnz) protocol vector (the tensor challenge expansions,
the looked-up star vectors, the plookup grand-product vectors, the
entry-product accumulators and the tensorcheck fold tree) lives in host
RAM as a `HostVector`, or is generated on the device, and visits the
device in bounded blocks:

  reference stream                      here
  ------------------------------------  --------------------------------
  Tensor / LookupTensorStreamer         hv_tensor / hv_powers, made
    (tensor_stream.rs:12-220)             block by block on the device
  JointVal/Row/ColStream                the relation stream's joint()
    (val_stream.rs:8-551)
  LookupStreamer (lookup_stream.rs)     hv_gather (host fancy indexing)
  plookup set/subset/sorted streams     hv_plookup block pipeline
  ProductStream/RightRotationStreamer   hv_accumulated_product carry
    (entryproduct/streams)                stitch + hv_right_rotation
  FoldedPolynomialTree commit/open      streaming/tensorcheck.new_space
    (kzg/space.rs:192-285)

The proof is `Proof.new_time`'s, bit for bit, and so are the transcript
labels and their order.  The spans are `new_time`'s `psnark::*`.
"""

from __future__ import annotations

from typing import Sequence

from .. import SPACE_TIME_THRESHOLD
from ..ops import poly
from ..params import R
from ..relation.stream import as_stream
from ..serialize import G1Msg, ScalarMsg
from ..streaming import tensorcheck as tc_stream
from ..streaming.ops import (
    hv_alg_hash, hv_evaluate, hv_gather, hv_hadamard, hv_ip, hv_lincomb,
    hv_monic, hv_plookup, hv_powers, hv_prod, hv_right_rotation, hv_slice,
    hv_tensor,
)
from ..subprotocols import plookup as pl
from ..subprotocols.entry_product import EntryProduct
from ..subprotocols.sumcheck import ElasticProver, Sumcheck
from ..transcript import GeminiTranscript, PROTOCOL_NAME
from ..utils.trace import end_timer, start_timer


def new_elastic(ck_stream, r1cs, idx: Sequence, block_size: int = 1 << 20,
                threshold: int | None = None):
    """Streaming twin of `Proof.new_time`: the same transcript and
    proof, device memory bounded by the block size.

    `r1cs` is a dense `R1cs` or a relation stream; the prover reads the
    relation only through its `z_a/z_b/z_c/z/w` block sources and the
    `joint()` union-sparsity stream, so a giant instance never becomes a
    dense relation.  The protocol's vectors are made on the device of
    the relation's `z`."""
    from .proof import Proof, _append_index

    if threshold is None:
        threshold = SPACE_TIME_THRESHOLD
    blk = block_size

    t = start_timer("psnark::matvecs")
    stream = as_stream(r1cs)
    z_a, z_b, z_c = stream.z_a, stream.z_b, stream.z_c
    z_host, w_host = stream.z, stream.w
    dev = z_host.device
    end_timer(t)

    transcript = GeminiTranscript(PROTOCOL_NAME)

    t = start_timer("psnark::commit w")
    witness_commitment = ck_stream.commit(w_host)
    transcript.append_serializable(b"witness", G1Msg(witness_commitment))
    _append_index(transcript, ck_stream.ck.powers_of_g2, idx)
    alpha = transcript.get_challenge(b"alpha")
    end_timer(t)

    t = start_timer("psnark::zc(alpha)")
    zc_alpha = hv_evaluate(z_c, alpha, blk)
    transcript.append_serializable(b"zc(alpha)", ScalarMsg(zc_alpha))
    end_timer(t)

    t = start_timer("psnark::sumcheck 1")
    first_proof = Sumcheck.prove(
        transcript, ElasticProver(z_a, z_b, alpha, blk, threshold))
    end_timer(t)

    t = start_timer("psnark::joint matrices")
    jm = stream.joint()
    num_non_zero = jm.num_non_zero
    row_idx, col_idx = jm.row_index, jm.col_index
    val_a, val_b, val_c = jm.val_a, jm.val_b, jm.val_c
    end_timer(t)

    # Tensor challenge expansions as block-generated host streams.
    t = start_timer("psnark::lookups")
    b_hv = hv_tensor(first_proof.challenges, blk, dev)
    c_hv = hv_powers(alpha, len(b_hv), blk, dev)
    a_hv = hv_hadamard(b_hv, c_hv, blk)
    ralpha_star = hv_gather(a_hv, row_idx)
    r_star = hv_gather(b_hv, row_idx)
    alpha_star = hv_gather(c_hv, row_idx)
    z_star = hv_gather(z_host, col_idx)
    end_timer(t)

    t = start_timer("psnark::lookup commits")
    z_r_commitments = [ck_stream.commit(v)
                       for v in (ralpha_star, r_star, alpha_star, z_star)]
    transcript.append_serializable(b"ra*", G1Msg(z_r_commitments[0]))
    transcript.append_serializable(b"rb*", G1Msg(z_r_commitments[1]))
    transcript.append_serializable(b"rc*", G1Msg(z_r_commitments[2]))
    transcript.append_serializable(b"z*", G1Msg(z_r_commitments[3]))

    eta = transcript.get_challenge(b"chal")
    eta2 = eta * eta % R
    end_timer(t)

    t = start_timer("psnark::sumcheck 2")
    r_star_val = hv_lincomb(
        [hv_hadamard(ralpha_star, val_a, blk), hv_hadamard(r_star, val_b, blk),
         hv_hadamard(alpha_star, val_c, blk)],
        [1, eta, eta2], blk)
    second_proof = Sumcheck.prove(
        transcript, ElasticProver(z_star, r_star_val, 1, blk, threshold))
    sc_head = hv_slice(hv_tensor(second_proof.challenges, blk, dev), num_non_zero)
    end_timer(t)

    zeta = transcript.get_challenge(b"zeta")

    # Sorted vectors (positions bound by the ζ-hash).
    t = start_timer("psnark::sorted vectors")
    if zeta % R != 0:
        set_b = hv_alg_hash(b_hv, None, zeta, blk)
        set_c = hv_alg_hash(c_hv, None, zeta, blk)
        set_z = hv_alg_hash(z_host, None, zeta, blk)
    else:  # the dense prover's degenerate-ζ branch
        set_b, set_c, set_z = b_hv, c_hv, z_host
    freq_row = pl.compute_frequency(len(b_hv), row_idx)
    freq_col = pl.compute_frequency(len(z_host), col_idx)
    addr_row = pl.extend_frequency(freq_row)
    sorted_r = hv_gather(set_b, addr_row)
    sorted_alpha = hv_gather(set_c, addr_row)
    sorted_z = hv_gather(set_z, pl.extend_frequency(freq_col))
    end_timer(t)

    t = start_timer("psnark::sorted commits")
    sorted_commitments = [ck_stream.commit(v)
                          for v in (sorted_r, sorted_alpha, sorted_z)]

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
    r_lookup_vec = hv_plookup(r_star, set_b, row_idx, gamma, chi, zeta,
                              freq_row, blk)
    alpha_lookup_vec = hv_plookup(alpha_star, set_c, row_idx, gamma, chi, zeta,
                                  freq_row, blk)
    z_lookup_vec = hv_plookup(z_star, set_z, col_idx, gamma, chi, zeta,
                              freq_col, blk)
    r_prod_vec = [hv_prod(v, blk) for v in r_lookup_vec]
    alpha_prod_vec = [hv_prod(v, blk) for v in alpha_lookup_vec]
    z_prod_vec = [hv_prod(v, blk) for v in z_lookup_vec]

    lookup_vec = list(r_lookup_vec) + list(alpha_lookup_vec) + list(z_lookup_vec)

    # The alpha products go under the r labels first, as the reference
    # appends them.
    transcript.append_serializable(b"set_r_ep", ScalarMsg(alpha_prod_vec[0]))
    transcript.append_serializable(b"subset_r_ep", ScalarMsg(alpha_prod_vec[1]))
    transcript.append_serializable(b"set_r_ep", ScalarMsg(r_prod_vec[0]))
    transcript.append_serializable(b"subset_r_ep", ScalarMsg(r_prod_vec[1]))
    transcript.append_serializable(b"set_z_ep", ScalarMsg(z_prod_vec[0]))
    transcript.append_serializable(b"subset_z_ep", ScalarMsg(z_prod_vec[1]))
    end_timer(t)

    t = start_timer("psnark::entry products")
    entry_products = EntryProduct.new_elastic_batch(
        transcript, ck_stream, lookup_vec, r_prod_vec + alpha_prod_vec + z_prod_vec,
        blk, threshold)
    accumulated_vec = entry_products.acc_vs  # HostVectors
    psi = entry_products.chal
    open_chal = transcript.get_challenge(b"open-chal")
    end_timer(t)

    t = start_timer("psnark::mu opening")
    ralpha_star_acc_mu_proof = ck_stream.batch_open_multi_points(
        [ralpha_star] + accumulated_vec, [psi], open_chal)
    ralpha_star_acc_mu_evals = [hv_evaluate(v, psi, blk)
                                for v in [ralpha_star] + accumulated_vec]

    s_0_prime = hv_ip(hv_hadamard(ralpha_star, val_a, blk), sc_head, blk)
    s_1_prime = hv_ip(hv_hadamard(r_star, val_b, blk), sc_head, blk)
    for e in ralpha_star_acc_mu_evals:
        transcript.append_serializable(b"ralpha_star_acc_mu", ScalarMsg(e))
    transcript.append_serializable(
        b"ralpha_star_mu_proof", G1Msg(ralpha_star_acc_mu_proof))
    end_timer(t)

    t = start_timer("psnark::sumcheck 3")
    provers = list(entry_products.provers)
    provers.append(ElasticProver(hv_hadamard(ralpha_star, sc_head, blk), val_a, 1,
                                 blk, threshold))
    provers.append(ElasticProver(hv_hadamard(r_star, sc_head, blk), val_b, 1,
                                 blk, threshold))
    provers.append(ElasticProver(hv_hadamard(alpha_star, sc_head, blk), val_c, 1,
                                 blk, threshold))
    provers.append(ElasticProver(r_star, alpha_star, psi, blk, threshold))
    third_proof = Sumcheck.prove_batch(transcript, provers)
    end_timer(t)

    t = start_timer("psnark::tensorcheck")
    tc_base_polynomials = [
        w_host, ralpha_star, r_star, alpha_star, z_star,
        jm.row, jm.col, val_a, val_b, val_c,
        sorted_r, sorted_alpha, sorted_z,
    ] + accumulated_vec

    twist_powers2 = poly.powers2_host(psi, len(third_proof.challenges))
    shift_monic_lookup_vec = [hv_right_rotation(hv_monic(v)) for v in lookup_vec]
    third_proof_vec = shift_monic_lookup_vec + [val_a, val_b, val_c, alpha_star]
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
    tensorcheck_proof = tc_stream.new_space(
        transcript, ck_stream, tc_base_polynomials, tc_body_polynomials)
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
