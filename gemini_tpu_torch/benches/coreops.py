"""Core-operation micro-benchmarks (port of benches/coreops.py, the
benches/coreops_bench.rs analogue): Fr add and mul, and G1 batched add
(one Jacobian add kernel launch), on the card.

    python -m gemini_tpu_torch.benches.coreops [--cpu] [--lanes N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..curve import g1
from ..device import name as device_name, resolve
from ..fields import fp
from ..fields.fp import FQ, FR, to_tensor


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--lanes", type=int, default=1 << 18)
    args = ap.parse_args(argv)
    dev = resolve("cpu" if args.cpu else None)

    n = args.lanes
    rng = np.random.RandomState(0)

    def rand_fr():
        a = rng.randint(0, 1 << 16, (FR.n_limbs, n)).astype(np.uint32)
        a[-1] &= 0x7FFF
        return to_tensor(a, dev)

    a, b = rand_fr(), rand_fr()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(f, reps=10):
        f()
        sync()
        t0 = time.time()
        for _ in range(reps):
            f()
        sync()
        return (time.time() - t0) / reps

    out = {}
    t = out["fr_add_s"] = timed(lambda: fp.add(FR, a, b))
    print(f"fr add  ({n} lanes): {t * 1e6:9.1f} us  ({n / t / 1e9:.2f} G ops/s)"
          f" on {device_name(dev)}")
    t = out["fr_mul_s"] = timed(lambda: fp.mont_mul(FR, a, b))
    print(f"fr mul  ({n} lanes): {t * 1e6:9.1f} us  ({n / t / 1e6:.1f} M ops/s)"
          f" on {device_name(dev)}")

    m = n // 16
    px = to_tensor(rng.randint(0, 1 << 16, (FQ.n_limbs, m)).astype(np.uint32), dev)
    p = g1.JPoint(px, px, px)  # synthetic coords (not all < p): timing only
    t = out["g1_add_s"] = timed(lambda: g1.add(p, p), reps=3)
    print(f"g1 add  ({m} lanes): {t * 1e3:9.2f} ms  ({t / m * 1e9:.0f} ns/add)"
          f" on {device_name(dev)}", flush=True)
    return out


if __name__ == "__main__":
    main()
