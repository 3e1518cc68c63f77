"""Time one checkout of the port for a parent/change comparison: the MSM
at 2^20 lanes on bench.py's inputs in both configurations (best and
median of 7) and the 2^18 SNARK time prove (best and median of 5), on
the host clock ending in a synchronize.  Prints one JSON line with the
card's name and power limit.

It times the checkout in the working directory (its `gemini_tpu_torch`
and `chip_smoke.py`), whichever checkout the script itself lies in, so
two commits compare on one card in one process each, in turns:

    for t in parent change change parent; do
      (cd <checkout of $t> && python3 <this file> $t)
    done
"""

import json
import os
import random
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gemini_tpu_torch.kzg.commit import CommitterKey  # noqa: E402
from gemini_tpu_torch.ops.msm import msm  # noqa: E402
from gemini_tpu_torch.relation import dummy_r1cs  # noqa: E402
from gemini_tpu_torch.snark import Proof  # noqa: E402


def best_and_median(fn, k):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(k):
        t = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t)
    return min(times), sorted(times)[len(times) // 2]


def main(label):
    t0 = time.time()
    pts, sc, _, _ = chip_smoke.bench_msm_inputs(1 << 20)
    res = {"tree": label}
    res["msm_2^20_projective_s"] = best_and_median(lambda: msm(pts, sc), 7)
    with chip_smoke.jacobian_config():
        res["msm_2^20_jacobian_s"] = best_and_median(lambda: msm(pts, sc), 7)
    n = 1 << 18
    r1cs = dummy_r1cs(random.Random(0), n, device="cuda")
    ck = CommitterKey.new(max_degree=n, max_eval_points=3, seed=0, device="cuda")
    res["prove_2^18_s"] = best_and_median(lambda: Proof.new_time(r1cs, ck), 5)
    res["process_s"] = time.time() - t0
    res["card"] = chip_smoke.card_line()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
