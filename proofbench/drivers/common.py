"""What the SNARK drivers share: the port's proof read as the
reference's parts and bytes, and the verifier's answer to a tampered
proof."""

from __future__ import annotations

import dataclasses


def _item(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


def parts(proof) -> dict:
    """The port's `snark.Proof` in the layout of `reference.snark.parts`."""
    tc = proof.tensorcheck_proof
    msgs1, fin1 = proof.first_sumcheck_msgs
    msgs2, fin2 = proof.second_sumcheck_msgs
    out = {
        "commitments": [proof.witness_commitment,
                        *tc.folded_polynomials_commitments, tc.evaluation_proof],
        "sumchecks": [*msgs1, *fin1, *msgs2, *fin2],
        "evaluations": [proof.zc_alpha, *tc.folded_polynomials_evaluations,
                        *tc.base_polynomials_evaluations],
    }
    return {k: [_item(x) for x in v] for k, v in out.items()}


def proof_bytes(proof) -> bytes:
    from gemini_tpu_torch.serialize import snark_proof_bytes

    return snark_proof_bytes(proof)


def tamper_rejected(proof, r1cs, vk) -> bool:
    """The verifier's answer to the proof with zc(alpha) + 1: True when
    it raises SnarkVerificationError."""
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.snark.proof import SnarkVerificationError

    bad = dataclasses.replace(proof, zc_alpha=(proof.zc_alpha + 1) % R)
    try:
        bad.verify(r1cs, vk)
    except SnarkVerificationError:
        return True
    return False
