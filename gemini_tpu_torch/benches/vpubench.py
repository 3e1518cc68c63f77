"""Measure the card's raw multiply-add issue rate with the vpu_chain
kernel (port of benches/vpubench.py).

A chain of K dependent multiply-adds per element of a (ROWS,
TILE * GRID) block, one thread per element.  The marginal time between
K/4 and K gives lane-ops/s (a multiply and an add counted apart, as the
JAX script counts them): for uint32 twice the IMAD rate, the ceiling
of any limb-arithmetic kernel; for float32 twice the FFMA rate.

    python -m gemini_tpu_torch.benches.vpubench        (on cuda)
Env: VPU_CHAIN (512), VPU_ROWS (32), VPU_TILE (1024), VPU_GRID (64),
VPU_DTYPE (uint32 | float32).
"""

from __future__ import annotations

import os
import time

import torch

from ..device import name as device_name, resolve
from . import probes, timing

K = int(os.environ.get("VPU_CHAIN", "512"))  # dependent mul-adds
ROWS = int(os.environ.get("VPU_ROWS", "32"))
TILE = int(os.environ.get("VPU_TILE", "1024"))
GRID = int(os.environ.get("VPU_GRID", "64"))
DTYPE = os.environ.get("VPU_DTYPE", "uint32")


def inputs(dtype: str, rows: int, n: int, device):
    """The JAX script's operands: for uint32 odd multipliers
    (iota | 1, 7 iota | 1) held as int32 bits, for float32 values just
    above and below 1."""
    if dtype == "float32":
        a = torch.full((rows, n), 1.0000001, dtype=torch.float32, device=device)
        b = torch.full((rows, n), 0.9999999, dtype=torch.float32, device=device)
        return a, b
    if dtype != "uint32":
        raise ValueError(f"VPU_DTYPE must be uint32 or float32, got {dtype}")
    iota = torch.arange(rows * n, dtype=torch.int64, device=device).reshape(rows, n)
    return probes.to_i32(iota | 1), probes.to_i32((iota * 7) | 1)


def run(k: int, a, b, reps: int = 10):
    """(best seconds per launch over 5 rounds of `reps` launches, first
    call's wall seconds).  On CUDA each round is timed with events
    (`timing.event_ms`), so the launches queue up and the events measure
    the kernels, not the host's launch overhead."""
    dev = a.device
    cuda = dev.type == "cuda"

    def once():
        probes.vpu_chain(a, b, k)
        if cuda:
            torch.cuda.synchronize(dev)

    if not cuda:
        return timing.wall_s(once, rounds=5)
    t0 = time.time()
    once()
    warm = time.time() - t0
    best = min(timing.event_ms(lambda: probes.vpu_chain(a, b, k), reps,
                               warm=False, device=dev) / 1e3
               for _ in range(5))
    return best, warm


def measure(dtype: str = DTYPE, k: int = K, rows: int = ROWS, tile: int = TILE,
            grid: int = GRID, device=None) -> dict:
    dev = resolve(device)
    n = tile * grid
    a, b = inputs(dtype, rows, n, dev)
    k1, k2 = k // 4, k
    t_short, w1 = run(k1, a, b)
    t_long, w2 = run(k2, a, b)
    extra_ops = 2.0 * (k2 - k1) * rows * n
    rate = extra_ops / (t_long - t_short)
    print(f"dtype={dtype} rows={rows} tile={tile} grid={grid}: "
          f"K{k1}={t_short * 1e3:.4f}ms K{k2}={t_long * 1e3:.4f}ms "
          f"-> {rate / 1e12:.3f} T lane-ops/s marginal "
          f"(warm {w1:.1f}/{w2:.1f}s) on {device_name(dev)}", flush=True)
    return {"dtype": dtype, "rows": rows, "n": n, "k1": k1, "k2": k2,
            "t_short_s": t_short, "t_long_s": t_long,
            "lane_ops_per_s": rate, "device": str(dev)}


def main():
    return measure()


if __name__ == "__main__":
    main()
