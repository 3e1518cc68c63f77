"""The elastic SNARK prover (`snark.Proof.new_elastic`) over the
reference's giant-instance inputs: the O(1)-memory relation
`relation.DummyR1csStream(n, e)` and the constant-base key
`streaming.FakeCommitterKeyStream` (tau = 1), with the configuration's
block size and space-time threshold.

Job k proves the relation with e drawn from the seed and k
(`instances.DummyInstance`), so no two jobs share a witness."""

from __future__ import annotations

from proofbench import instances
from proofbench.drivers import common


def inputs(traffic: dict, seed: int, k: int, device):
    """The reference's statement and key of job k: its relation and the
    constant-base key's trapdoor."""
    n = 1 << int(traffic["constraints_log2"])
    return instances.DummyInstance(seed, k, n).statement(device), instances.fake_key(seed)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from gemini_tpu_torch.streaming import FakeCommitterKeyStream

        self.seed = seed
        self.device = device
        self.n = 1 << int(traffic["constraints_log2"])
        self.block = 1 << int(config["block_size_log2"])
        self.threshold = int(config["space_time_threshold"])
        self.fake = FakeCommitterKeyStream(
            max_eval_points=int(config["max_eval_points"]),
            seed=instances.key_seed(seed),
            max_msm_buffer=1 << int(config["max_msm_buffer_log2"]), device=device)

    def call(self, phase: str, k: int, previous):
        from gemini_tpu_torch.relation.stream import DummyR1csStream
        from gemini_tpu_torch.snark import Proof

        if phase != "prove":
            raise ValueError(f"snark_elastic has no phase {phase!r}")
        stream = DummyR1csStream(self.n, instances.DummyInstance(self.seed, k, self.n).e,
                                 device=self.device)
        return Proof.new_elastic(stream, self.fake, block_size=self.block,
                                 threshold=self.threshold)

    parts = staticmethod(common.parts)
    proof_bytes = staticmethod(common.proof_bytes)

    def release(self) -> None:
        self.fake = None


def setup(config, traffic, seed, device):
    return Driver(config, traffic, seed, device)
