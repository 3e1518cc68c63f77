"""Multi-polynomial multi-point KZG demo (examples/pc.rs analogue).

    python -m gemini_tpu_torch.examples.pc -d 12 -p 4 -m 3

Runs on the card; `--cpu` runs on the CPU.
"""

import argparse
import random
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gemini_tpu_torch.examples.pc")
    ap.add_argument("-d", "--logdegree", type=int, default=10)
    ap.add_argument("-p", "--polynomials", type=int, default=4)
    ap.add_argument("-m", "--points", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from .. import device as _device
    from ..fields.fp import FR
    from ..kzg.commit import CommitterKey, VerifierKey
    from ..ops import poly
    from ..params import R

    dev = _device.resolve("cpu" if args.cpu else None)
    print(f"device: {_device.name(dev)}")
    d = 1 << args.logdegree
    rng = random.Random(0)
    ck = CommitterKey.new(max_degree=d, max_eval_points=args.points,
                          seed=0, device=dev)
    vk = VerifierKey.from_committer_key(ck)
    polys = [FR.tensor([rng.randrange(R) for _ in range(d)], dev)
             for _ in range(args.polynomials)]
    pts = [rng.randrange(R) for _ in range(args.points)]

    t0 = time.time()
    commitments = ck.batch_commit(polys)
    commit_t = time.time() - t0
    eta = rng.randrange(R)
    t0 = time.time()
    proof = ck.batch_open_multi_points(polys, pts, eta)
    open_t = time.time() - t0
    evals = [[poly.evaluate_le(FR, p, x) for x in pts] for p in polys]
    t0 = time.time()
    vk.verify_multi_points(commitments, pts, evals, proof, eta)
    verify_t = time.time() - t0
    print(f"commit ({args.polynomials} x 2^{args.logdegree}): "
          f"{commit_t:.2f} s")
    print(f"batch open at {args.points} points: {open_t:.2f} s")
    print(f"verify: {verify_t:.2f} s  (OK)")
    return {"commitments": commitments, "proof": proof, "evals": evals,
            "verified": True}


if __name__ == "__main__":
    main()
