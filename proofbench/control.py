"""The control of the comparison that decides `correct`.

The system states no precision; its guarantee is that a proof's bytes
are the protocol's.  The control breaks it where a later change to the
MSM pipeline would be tempted to: the configuration's reference is put
in the program's place with every commitment worked out from scalars cut
to their low 253 bits, as an MSM that leaves out its top window would.
The comparison has to find it not correct on every seed.

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

from proofbench import correct, spec  # noqa: E402
from proofbench.reference import fr  # noqa: E402

KEPT_BITS = 253


def truncate(v: torch.Tensor) -> torch.Tensor:
    """Each element cut to its low KEPT_BITS bits (canonical values)."""
    one = torch.tensor(fr.limbs_of(1), dtype=torch.int32, device=v.device).reshape(16, 1)
    canon = fr.mont_mul(v, one)
    top = KEPT_BITS - 16 * (fr.LIMBS - 1)
    canon[fr.LIMBS - 1] &= (1 << top) - 1
    return fr.from_canonical(canon)


def control_proof(reference, statement, key):
    """The parts and bytes of `reference`'s proof with every committed
    vector truncated."""
    p = reference.prove(statement, key, commit_filter=truncate)
    return reference.parts(p), reference.proof_bytes(p)


def readings(cell, seed: int, device) -> dict:
    """The control's mismatch counts on the cell's first job (its inputs
    as a run makes them, by the driver's `inputs`, without the program)
    and the reference's seconds."""
    reference = spec.reference(cell.config)
    st, key = spec.driver(cell.config).inputs(cell.traffic, seed, 0, device)
    t0 = time.perf_counter()
    good = correct.reference_proof(reference, st, key)
    ref_s = time.perf_counter() - t0
    bad = control_proof(reference, st, key)
    return {"reference_s": ref_s,
            "control": correct.mismatches(bad[0], good[0], bad[1], good[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 proofbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.find_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed, "device": device,
                          **readings(cell, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
