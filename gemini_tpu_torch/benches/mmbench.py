"""Isolate per-launch cost (port of benches/mmbench.py): chain K
launches of (a) the copy_add kernel and (b) the mont_mul kernel at the
group-law kernels' shapes, each launch taking the previous output.  The
copy chain is launch latency plus bytes; the difference is the
Montgomery product's arithmetic.

    python -m gemini_tpu_torch.benches.mmbench          (on cuda)
Env: MM_CHAIN (64), MM_LOGN (16).
"""

from __future__ import annotations

import os

import torch

from ..curve import g1_kernels
from ..device import name as device_name, resolve
from ..fields.fp import FQ
from . import probes, timing

K = int(os.environ.get("MM_CHAIN", "64"))
LOGN = int(os.environ.get("MM_LOGN", "16"))


def run_chain(name, kernel, n, device, k: int = K) -> dict:
    a = FQ.tensor([3] * n, device)
    b = FQ.tensor([5] * n, device)

    def chain():
        acc = a
        for _ in range(k):
            acc = kernel(acc, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return acc

    best, warm = timing.wall_s(chain)
    per = best / (k * n)
    print(f"{name:>12} n=2^{n.bit_length() - 1} block=128: {best * 1e3:8.3f} ms "
          f"chain({k}) -> {per * 1e9:8.4f} ns/lane  "
          f"{best / k * 1e6:8.2f} us/launch  (warm {warm:.1f}s) on {device_name(device)}",
          flush=True)
    return {"chain_s": best, "ns_per_lane": per * 1e9,
            "us_per_launch": best / k * 1e6, "launches": k, "lanes": n}


def main(device=None) -> dict:
    dev = resolve(device)
    n = 1 << LOGN
    return {"copy_add": run_chain("copy+add", probes.copy_add, n, dev),
            "mont_mul": run_chain("montmul", g1_kernels.mont_mul, n, dev)}


if __name__ == "__main__":
    main()
