"""Preprocessing SNARK benchmark driver (examples/psnark.rs analogue).

    python -m gemini_tpu_torch.examples.psnark -i 10               # time prover
    python -m gemini_tpu_torch.examples.psnark -i 10 --elastic     # space prover
    python -m gemini_tpu_torch.examples.psnark -i 20 --giant       # streaming relation

Runs on the card; `--cpu` runs on the CPU.
"""

import argparse
import random
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gemini_tpu_torch.examples.psnark")
    ap.add_argument("-i", "--instance-logsize", type=int, default=8)
    ap.add_argument("--elastic", action="store_true",
                    help="space-efficient prover (bounded device memory)")
    ap.add_argument("--giant", action="store_true",
                    help="elastic prover over a streaming relation with "
                    "the tau=1 synthetic SRS (examples/psnark.rs:54-68 "
                    "giant-instance path; no dense relation or real key "
                    "is ever materialized)")
    ap.add_argument("--msm-buffer-log", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    if not 1 <= args.instance_logsize <= 30:
        ap.error("--instance-logsize must be in [1, 30]")

    from .. import device as _device
    from ..kzg.commit import CommitterKey, VerifierKey
    from ..psnark import Proof, index
    from ..relation import dummy_r1cs
    from ..relation.r1cs import joint_matrices
    from ..serialize import psnark_proof_bytes
    from ..utils.trace import MemoryWatcher

    dev = _device.resolve("cpu" if args.cpu else None)
    print(f"device: {_device.name(dev)}")
    n = 1 << args.instance_logsize
    rng = random.Random(0)

    if args.giant:
        from ..params import R
        from ..psnark import index_stream
        from ..relation.stream import DummyR1csStream
        from ..streaming import FakeCommitterKeyStream

        stream = DummyR1csStream(n, rng.randrange(1, R), device=dev)
        cks = FakeCommitterKeyStream(
            max_eval_points=3, seed=0,
            max_msm_buffer=1 << args.msm_buffer_log, device=dev)
        t0 = time.time()
        idx = index_stream(cks, stream)
        index_t = time.time() - t0
        with MemoryWatcher() as mem:
            t0 = time.time()
            proof = Proof.new_elastic(
                cks, stream, idx, block_size=1 << args.msm_buffer_log)
            prove_t = time.time() - t0
        size = len(psnark_proof_bytes(proof))
        print(f"indexer time:  {index_t:.2f} s")
        print(f"prover time:   {prove_t:.2f} s")
        print(f"proof size:    {size} B (compressed)")
        print(f"peak rss:      {mem.peak / 2**20:.1f} MiB")
        return {"proof": proof, "proof_size": size, "stream": stream,
                "ck_stream": cks, "index": idx, "prove_s": prove_t}

    r1cs = dummy_r1cs(rng, n, device=dev)
    jm = joint_matrices(r1cs)
    ck = CommitterKey.new(
        max_degree=2 * n + jm.num_non_zero + 2, max_eval_points=3, seed=0,
        device=dev)
    vk = VerifierKey.from_committer_key(ck)

    t0 = time.time()
    idx = index(ck, r1cs)
    index_t = time.time() - t0
    with MemoryWatcher() as mem:
        t0 = time.time()
        if args.elastic:
            from ..streaming import CommitterKeyStream

            cks = CommitterKeyStream(ck, 1 << args.msm_buffer_log)
            proof = Proof.new_elastic(
                cks, r1cs, idx, block_size=1 << args.msm_buffer_log)
        else:
            proof = Proof.new_time(ck, r1cs, idx)
        prove_t = time.time() - t0
    t0 = time.time()
    proof.verify(r1cs, vk, idx, jm.num_non_zero)
    verify_t = time.time() - t0
    size = len(psnark_proof_bytes(proof))
    print(f"indexer time:  {index_t:.2f} s")
    print(f"prover time:   {prove_t:.2f} s")
    print(f"verifier time: {verify_t:.2f} s")
    print(f"proof size:    {size} B (compressed)")
    print(f"peak rss:      {mem.peak / 2**20:.1f} MiB")
    return {"proof": proof, "proof_size": size, "verified": True,
            "prove_s": prove_t}


if __name__ == "__main__":
    main()
