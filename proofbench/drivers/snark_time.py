"""The time-efficient SNARK prover (`snark.Proof.new_time`) and its
verifier (`Proof.verify`), with the test-trapdoor key
`kzg.commit.CommitterKey.new` made on the card.

Set-up makes the traffic's instances (`instances.DiagonalInstance`,
cycled so that no two consecutive jobs share a witness) and the key;
job k proves instance k mod m and verifies the proof."""

from __future__ import annotations

import functools

import numpy as np

from proofbench import instances
from proofbench.drivers import common


@functools.lru_cache(maxsize=4)
def _diagonal(seed: int, index: int, n: int) -> instances.DiagonalInstance:
    """Instance `index` of the seed, made once for set-up and the check."""
    return instances.DiagonalInstance(seed, index, n)


def inputs(traffic: dict, seed: int, k: int, device):
    """The reference's statement and key of job k: instance k mod m and
    the trapdoor of the key that set-up makes."""
    n = 1 << int(traffic["constraints_log2"])
    inst = _diagonal(seed, k % int(traffic["instances"]), n)
    return inst.statement(device), instances.time_key(seed)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
        from gemini_tpu_torch.relation.r1cs import R1cs, SparseMatrix

        n = 1 << int(traffic["constraints_log2"])
        insts = [_diagonal(seed, i, n) for i in range(int(traffic["instances"]))]
        idx = np.arange(n, dtype=np.int32)

        def diag(vals):
            return SparseMatrix(n, n, idx, idx, vals, device=device)

        self.r1cs = [R1cs(diag(x.a), diag(x.b), diag(x.c), z_int=x.z,
                          x_int=x.z[:1], device=device) for x in insts]
        self.ck = CommitterKey.new(max_degree=n,
                                   max_eval_points=int(config["max_eval_points"]),
                                   seed=instances.key_seed(seed), device=device)
        self.vk = VerifierKey.from_committer_key(self.ck)

    def _r1cs(self, k: int):
        return self.r1cs[k % len(self.r1cs)]

    def call(self, phase: str, k: int, previous):
        from gemini_tpu_torch.snark import Proof

        if phase == "prove":
            return Proof.new_time(self._r1cs(k), self.ck)
        if phase == "verify":
            previous.verify(self._r1cs(k), self.vk)
            return previous
        raise ValueError(f"snark_time has no phase {phase!r}")

    parts = staticmethod(common.parts)
    proof_bytes = staticmethod(common.proof_bytes)

    def tamper_rejected(self, proof, k: int) -> bool:
        return common.tamper_rejected(proof, self._r1cs(k), self.vk)

    def release(self) -> None:
        self.r1cs = self.ck = self.vk = None


def setup(config, traffic, seed, device):
    return Driver(config, traffic, seed, device)
