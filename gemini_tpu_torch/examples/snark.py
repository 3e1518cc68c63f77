"""SNARK benchmark driver (examples/snark.rs analogue).

    python -m gemini_tpu_torch.examples.snark -i 12 --time-prover
    python -m gemini_tpu_torch.examples.snark -i 24    # elastic (space) prover

The time prover uses a real (test-trapdoor) SRS and the dense diagonal
dummy R1CS (circuit.rs:349).  The elastic prover mirrors the
reference's giant-instance setup (examples/snark.rs:55-67): an
O(1)-memory `DummyR1csStream` relation and the constant-base τ=1
`FakeCommitterKeyStream` SRS, so instance sizes far beyond any
materializable key can run.  Verification runs when the dense relation
fits (the SNARK verifier is linear in the circuit, like the
reference's); above --verify-max-log it is skipped.

Runs on the card; `--cpu` runs on the CPU.  GEMINI_TPU_TRACE=1 enables
span tracing.
"""

import argparse
import random
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gemini_tpu_torch.examples.snark")
    ap.add_argument("-i", "--instance-logsize", type=int, default=10)
    ap.add_argument("--time-prover", action="store_true")
    ap.add_argument("--msm-buffer-log", type=int, default=20)
    ap.add_argument("--verify-max-log", type=int, default=16,
                    help="skip verification above this logsize")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    if not 1 <= args.instance_logsize <= 35:
        ap.error("--instance-logsize must be in [1, 35]")

    from .. import device as _device
    from ..kzg.commit import CommitterKey, VerifierKey
    from ..params import R
    from ..relation import dummy_r1cs
    from ..relation.stream import DummyR1csStream
    from ..serialize import snark_proof_bytes
    from ..snark import Proof
    from ..streaming import FakeCommitterKeyStream
    from ..utils.trace import MemoryWatcher

    dev = _device.resolve("cpu" if args.cpu else None)
    print(f"device: {_device.name(dev)}")
    n = 1 << args.instance_logsize
    rng = random.Random(0)
    print(f"instance: dummy R1CS, 2^{args.instance_logsize} constraints "
          f"({'time' if args.time_prover else 'elastic'} prover)")

    do_verify = args.instance_logsize <= args.verify_max_log
    with MemoryWatcher() as mem:
        t0 = time.time()
        if args.time_prover:
            r1cs = dummy_r1cs(rng, n, device=dev)
            ck = CommitterKey.new(max_degree=n, max_eval_points=3, seed=0,
                                  device=dev)
            vk = VerifierKey.from_committer_key(ck)
            setup_t = time.time() - t0
            print(f"setup time:    {setup_t:.2f} s "
                  f"(instance + SRS + verifier key)")
            t0 = time.time()
            proof = Proof.new_time(r1cs, ck)
        else:
            e = rng.randrange(1, R)
            stream = DummyR1csStream(n, e, device=dev)
            fake = FakeCommitterKeyStream(
                max_eval_points=3, seed=0,
                max_msm_buffer=1 << args.msm_buffer_log, device=dev)
            proof = Proof.new_elastic(
                stream, fake, block_size=1 << args.msm_buffer_log)
            vk = fake.verifier_key()
            r1cs = stream.to_dense() if do_verify else None
        prove_t = time.time() - t0
    if do_verify:
        t0 = time.time()
        proof.verify(r1cs, vk)
        verify_t = time.time() - t0
        print(f"verifier time: {verify_t:.2f} s")
    else:
        print("verification skipped (instance above --verify-max-log; "
              "the SNARK verifier is linear in the circuit)")
    size = len(snark_proof_bytes(proof))
    print(f"prover time:   {prove_t:.2f} s")
    print(f"proof size:    {size} B (compressed)")
    print(f"peak rss:      {mem.peak / 2**20:.1f} MiB")
    return {"proof": proof, "proof_size": size, "verified": do_verify,
            "prove_s": prove_t}


if __name__ == "__main__":
    main()
