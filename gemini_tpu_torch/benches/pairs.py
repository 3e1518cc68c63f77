"""Time one checkout of the port for a parent/change comparison: the MSM
at 2^20 lanes on bench.py's inputs in both configurations (best and
median of 7), the 2^18 SNARK time prove (best and median of 5), on the
host clock ending in a synchronize, and the device ms of the glue
kernels msm_sort_gather and msm_walk_down (both configurations) at the
MSM 2^20, 2^18 and 2^14 plans, with the gather's attribution at 2^20
(chip_smoke.py `glue_split_ms`, each plan first checked against the
plain versions).  Prints one JSON line with the card's name and power
limit.

It times the package of the working directory (its `gemini_tpu_torch`)
with the chip_smoke.py of the checkout this file lies in, so two commits
compare on one card with the same measuring code, one process each, in
turns:

    for t in parent change change parent; do
      (cd <checkout of $t> && python3 <this file> $t)
    done

A second argument `glue` times the glue kernels only.
"""

import importlib.util
import json
import os
import random
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               os.path.join(_ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
from gemini_tpu_torch.kzg.commit import CommitterKey  # noqa: E402
from gemini_tpu_torch.ops import msm as msm_ops  # noqa: E402
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


def glue_times():
    """Device ms of msm_sort_gather and msm_walk_down at each plan of
    chip_smoke.GLUE_TIMED (plan_window's), after chip_smoke's bit-exact
    check of the plan."""
    gen = torch.Generator(device="cuda").manual_seed(20261020)
    out = {}
    for n in chip_smoke.GLUE_TIMED:
        keep = {}
        plan = (n, *msm_ops.plan_window(n), msm_ops.N_BITS)
        chip_smoke.check_glue_plan({}, gen, plan, "random", (True, False), keep)
        out[f"2^{n.bit_length() - 1}"] = chip_smoke.glue_split_ms(
            keep, n == chip_smoke.GLUE_TIMED[0])
    return out


def main(label, glue_only=False):
    t0 = time.time()
    res = {"tree": label, "glue_kernel_ms": glue_times()}
    if glue_only:
        res["card"] = chip_smoke.card_line()
        print(json.dumps(res), flush=True)
        return
    pts, sc, _, _ = chip_smoke.bench_msm_inputs(1 << 20)
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
    main(sys.argv[1], sys.argv[2:] == ["glue"])
