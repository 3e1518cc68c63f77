"""The control of the comparison that decides `correct`.

The system states no precision; its guarantee is that a proof's bytes
are the protocol's.  The control breaks it where a later change to the
MSM pipeline would be tempted to: the reference is put in the program's
place with every commitment worked out from scalars cut to their low 253
bits, as an MSM that leaves out its top window would.  The comparison
has to find it not correct on every seed.

    python3 proofbench/control.py --workload <cell> --seeds <n> <n> <n>

prints, for each seed, the proof of the cell's first job by the
reference and by the control, the mismatch counts of the control (the
upper readings of the limits) and the reference's seconds.  It runs at
the cell's own size, on the card where there is one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from proofbench import correct, instances, spec  # noqa: E402
from proofbench.reference import fr, snark as ref  # noqa: E402

KEPT_BITS = 253


def truncate(v: torch.Tensor) -> torch.Tensor:
    """Each element cut to its low KEPT_BITS bits (canonical values)."""
    one = torch.tensor(fr.limbs_of(1), dtype=torch.int32, device=v.device).reshape(16, 1)
    canon = fr.mont_mul(v, one)
    top = KEPT_BITS - 16 * (fr.LIMBS - 1)
    canon[fr.LIMBS - 1] &= (1 << top) - 1
    return fr.from_canonical(canon)


def control_proof(statement, key):
    p = ref.prove(statement, key, commit_filter=truncate)
    return ref.parts(p), ref.proof_bytes(p)


def cell_inputs(cell, seed: int, device):
    """The statement and key of the cell's first job, as a run makes
    them, without the program."""
    n = 1 << int(cell.traffic["constraints_log2"])
    if cell.config["driver"] == "snark_time":
        return (instances.DiagonalInstance(seed, 0, n).statement(device),
                instances.time_key(seed))
    return instances.DummyInstance(seed, 0, n).statement(device), instances.fake_key(seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 proofbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        st, key = cell_inputs(cell, seed, device)
        t0 = time.perf_counter()
        good = correct.reference_proof(st, key)
        ref_s = time.perf_counter() - t0
        bad = control_proof(st, key)
        counts = correct.mismatches(bad[0], good[0], bad[1], good[1])
        print(json.dumps({"workload": args.workload, "seed": seed, "device": device,
                          "reference_s": ref_s, "control": counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
