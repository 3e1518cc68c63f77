"""Streaming tensorcheck prover (port of
gemini_tpu/streaming/tensorcheck.py; tensorcheck/mod.rs:136-178, on
the streaming fold-tree commit and open of kzg/space.rs:192-285).

Produces the `TensorcheckProof` of `TensorcheckProof.new_time` while
every O(N) object (the batched body polynomials, their foldings, the
opening quotient) lives in host RAM, or is generated on the device,
and visits the device only in bounded blocks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..ops import poly
from ..params import R
from ..serialize import G1Msg, ScalarMsg
from ..subprotocols.tensorcheck import TensorcheckProof
from ..transcript import GeminiTranscript
from ..utils.trace import end_timer, start_timer
from .host import HostVector
from .kzg import CommitterKeyStream
from .ops import hv_lincomb_lazy


def new_space(transcript: GeminiTranscript, ck_stream: CommitterKeyStream,
              base_polynomials: Sequence[HostVector],
              body_polynomials: Sequence[Tuple[Sequence[HostVector], Sequence[int]]],
              ) -> TensorcheckProof:
    """Space-efficient tensorcheck: the transcript interactions of
    `TensorcheckProof.new_time` (tensorcheck/mod.rs:190-275), streaming
    throughout."""
    max_len = max(len(polys) for polys, _ in body_polynomials)
    batch_challenge = transcript.get_challenge(b"batch_challenge")
    batch_challenges = poly.powers_host(batch_challenge, max_len)

    t = start_timer("tensorcheck::commit_folding")
    foldings: List[HostVector] = []
    folded_polynomials_commitments = []
    for polys, challenges in body_polynomials:
        batched = hv_lincomb_lazy(list(polys), batch_challenges[: len(polys)])
        cms, folds = ck_stream.commit_folding(batched, challenges)
        folded_polynomials_commitments.extend(cms)
        foldings.extend(folds)
    end_timer(t)

    for c in folded_polynomials_commitments:
        transcript.append_serializable(b"commitment", G1Msg(c))

    beta = transcript.get_challenge(b"evaluation-chal")
    minus_beta = (-beta) % R
    beta2 = beta * beta % R

    t = start_timer("tensorcheck::evaluations")
    base_polynomials_evaluations = [
        (ck_stream.evaluate(p, beta2), ck_stream.evaluate(p, beta),
         ck_stream.evaluate(p, minus_beta))
        for p in base_polynomials
    ]
    folded_polynomials_evaluations = [
        (ck_stream.evaluate(f, beta), ck_stream.evaluate(f, minus_beta))
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
    evaluation_proof = ck_stream.batch_open_multi_points(
        list(base_polynomials) + foldings, [beta2, beta, minus_beta], open_chal)
    end_timer(t)
    return TensorcheckProof(
        folded_polynomials_commitments=folded_polynomials_commitments,
        folded_polynomials_evaluations=folded_polynomials_evaluations,
        evaluation_proof=evaluation_proof,
        base_polynomials_evaluations=base_polynomials_evaluations,
    )
