"""Entry (grand) product argument (port of
gemini_tpu/subprotocols/entry_product.py; subprotocols/entryproduct).

Reduces ∏ f = t to the twisted sumcheck
    ⟨g ∘ y, rrot(monic(f))⟩ = ψ·g(ψ) + t − ψ^N
with g the suffix-product accumulator of monic(f) and y = (1, ψ, ...)
(mod.rs:7-23).

The suffix products are a reverse multiplicative scan (ops/scan.py,
log depth, Fr Montgomery products as the combine); monic and the right
rotation are one-lane concatenations; everything stays on the device
until the accumulator commitment (one MSM).  `new_elastic_batch` is the
streaming flavour over host-RAM vectors (streaming/ops.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..fields import fp
from ..fields.fp import FR
from ..kzg.commit import CommitterKey
from ..ops import poly, scan
from ..params import R
from ..serialize import G1Msg
from ..subprotocols.sumcheck import TimeProver
from ..transcript import GeminiTranscript

G1Host = Optional[Tuple[int, int]]


def _fr_mul(a, b):
    return fp.mont_mul(FR, a, b)


def monic(v: torch.Tensor) -> torch.Tensor:
    """f(x) + x^N: append a trailing 1 (time_prover.rs:47-53)."""
    return torch.cat([v, FR.ones_mont((1,), v.device)], dim=1)


def right_rotation(v: torch.Tensor) -> torch.Tensor:
    """(f_{n-1}, f_0, ..., f_{n-2}) (time_prover.rs:15-24)."""
    return torch.cat([v[:, -1:], v[:, :-1]], dim=1)


def accumulated_product(v: torch.Tensor) -> torch.Tensor:
    """Suffix products acc[i] = prod_{j >= i} v[j]
    (time_prover.rs:34-44) by a reverse multiplicative scan over v
    padded with ones to a power of two (the suffix products of the
    first n lanes do not change)."""
    n = v.shape[1]
    npad = scan.next_pow2(n)
    if npad != n:
        v = torch.cat([v, FR.ones_mont((npad - n,), v.device)], dim=1)
    out = scan.inclusive_scan(_fr_mul, v, axis=1, reverse=True)
    return out[:, :n]


@dataclass
class ProverMsgs:
    """entryproduct ProverMsgs: the claimed product t itself is never
    added to the transcript (the upper protocol layer's job, mod.rs:41-47)."""

    acc_v_commitments: List[G1Host]
    claimed_sumchecks: List[int]


@dataclass
class EntryProduct:
    msgs: ProverMsgs
    chal: int
    provers: list  # TimeProvers, or elastic provers (new_elastic_batch)
    acc_vs: list  # unpadded accumulators (committed form): tensors or HostVectors

    @staticmethod
    def new_time(transcript: GeminiTranscript, ck: CommitterKey,
                 v: torch.Tensor, claimed_product: int) -> "EntryProduct":
        return EntryProduct.new_time_batch(transcript, ck, [v], [claimed_product])

    @staticmethod
    def new_time_batch(transcript: GeminiTranscript, ck: CommitterKey,
                       vs: Sequence[torch.Tensor],
                       claimed_products: Sequence[int]) -> "EntryProduct":
        """time_prover.rs:61-117."""
        if len(vs) != len(claimed_products):
            raise ValueError(f"{len(vs)} vectors, {len(claimed_products)} products")
        monic_vs = [monic(v) for v in vs]
        rrot_vs = [right_rotation(m) for m in monic_vs]
        acc_vs = [accumulated_product(m) for m in monic_vs]
        acc_v_commitments = ck.batch_commit(acc_vs)
        for cm in acc_v_commitments:
            transcript.append_serializable(b"acc_v", G1Msg(cm))
        chal = transcript.get_challenge(b"ep-chal")

        provers = [TimeProver(acc_v, rrot_v, chal)
                   for acc_v, rrot_v in zip(acc_vs, rrot_vs)]
        claimed_sumchecks = []
        for cp, acc_v in zip(claimed_products, acc_vs):
            acc_v_chal = poly.evaluate_le(FR, acc_v, chal)
            chal_n = pow(chal, acc_v.shape[1], R)
            claimed_sumchecks.append((acc_v_chal * chal + cp - chal_n) % R)
        return EntryProduct(
            msgs=ProverMsgs(acc_v_commitments, claimed_sumchecks),
            chal=chal,
            provers=provers,
            acc_vs=acc_vs,
        )

    @staticmethod
    def new_elastic_batch(transcript: GeminiTranscript, ck_stream,
                          vs: Sequence, claimed_products: Sequence[int],
                          block_size: int = 1 << 20,
                          threshold: int | None = None) -> "EntryProduct":
        """Streaming flavour over HostVectors
        (entryproduct/elastic_prover.rs:68-135): accumulators from
        block-stitched suffix products, commitments through the streaming
        committer's bounded MSMs, elastic sumcheck provers (the
        `ElasticProver` dispatch).  The transcript of `new_time_batch`;
        `acc_vs` are HostVectors."""
        from ..streaming.ops import (
            hv_accumulated_product, hv_evaluate, hv_monic, hv_right_rotation)
        from .sumcheck import ElasticProver

        if len(vs) != len(claimed_products):
            raise ValueError(f"{len(vs)} vectors, {len(claimed_products)} products")
        monic_vs = [hv_monic(v) for v in vs]
        rrot_vs = [hv_right_rotation(m) for m in monic_vs]
        acc_vs = [hv_accumulated_product(m, block_size) for m in monic_vs]
        acc_v_commitments = [ck_stream.commit(a) for a in acc_vs]
        for cm in acc_v_commitments:
            transcript.append_serializable(b"acc_v", G1Msg(cm))
        chal = transcript.get_challenge(b"ep-chal")

        provers = [ElasticProver(acc_v, rrot_v, chal, block_size, threshold)
                   for acc_v, rrot_v in zip(acc_vs, rrot_vs)]
        claimed_sumchecks = []
        for cp, acc_v in zip(claimed_products, acc_vs):
            acc_v_chal = hv_evaluate(acc_v, chal, block_size)
            chal_n = pow(chal, len(acc_v), R)
            claimed_sumchecks.append((acc_v_chal * chal + cp - chal_n) % R)
        return EntryProduct(
            msgs=ProverMsgs(acc_v_commitments, claimed_sumchecks),
            chal=chal,
            provers=provers,
            acc_vs=acc_vs,
        )
