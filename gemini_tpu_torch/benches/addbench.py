"""Microbenchmark: G1 add throughput of the port's two group-law
kernels (port of benches/addbench.py).

Measures ns per lane-add for:
  * add   the complete Jacobian add kernel (curve/g1.py `add`)
  * padd  the complete projective RCB add kernel (`padd`)

Each measurement chains K adds, acc = acc + q, one launch each, and
ends in a synchronize.  (The JAX script's tape VM and flat XLA paths
have no counterpart: they existed for JAX's compile times.)

    python -m gemini_tpu_torch.benches.addbench [lanes_log2 ...]
Env: ADD_CHAIN (8), ADD_WHICH (add,padd).
"""

from __future__ import annotations

import os
import random
import sys

import torch

from ..curve import g1, g1_kernels
from ..curve.g1 import JPoint
from ..device import name as device_name, resolve
from ..hostcurve import g1_mul
from ..refimpl import g1_generator
from . import timing

K = int(os.environ.get("ADD_CHAIN", "8"))


def make_points(n, device):
    """Valid points: 64 random multiples of G, tiled, with z = 1."""
    rnd = random.Random(42)
    base = [g1_mul(g1_generator(), rnd.randrange(1, 1 << 60)) for _ in range(64)]
    ap = g1.encode_affine(base, device)
    reps = -(-n // 64)
    big = g1.APoint(ap.x.repeat(1, reps)[:, :n], ap.y.repeat(1, reps)[:, :n],
                    ap.inf.repeat(reps)[:n])
    return g1.from_affine(big)


def bench_path(label, add_fn, p, q, n, device):
    def chain():
        acc = p
        for _ in range(K):
            acc = add_fn(acc, q)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return acc

    best, tw = timing.wall_s(chain)
    per_add = best / (K * n)
    print(f"{label:>28} n=2^{n.bit_length() - 1:2d}: {best * 1e3:9.3f} ms chain "
          f"({K} adds)  -> {per_add * 1e9:9.3f} ns/lane-add "
          f"({1 / per_add / 1e6:8.2f} M adds/s)   [warm {tw:.1f}s] on {device_name(device)}",
          flush=True)
    return per_add


def jacobian_add(p, q):
    return g1.add(p, q)


def projective_padd(p, q):
    return JPoint(*g1_kernels.padd(p, q))


def main(argv=None, device=None) -> dict:
    dev = resolve(device)
    logs = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or [14, 16]
    which = os.environ.get("ADD_WHICH", "add,padd").split(",")
    out = {}
    for lg in logs:
        n = 1 << lg
        p = make_points(n, dev)
        q = make_points(n, dev)
        if "add" in which:
            out[("add", lg)] = bench_path("Jacobian add kernel", jacobian_add,
                                          p, q, n, dev)
        if "padd" in which:
            out[("padd", lg)] = bench_path("RCB projective padd kernel",
                                           projective_padd, p, q, n, dev)
    return out


if __name__ == "__main__":
    main()
