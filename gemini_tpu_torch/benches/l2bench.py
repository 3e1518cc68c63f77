"""The card's L2 read-write rate, and copy_add's launch shapes, beside
copy_add and torch.add (kernels in csrc/l2bench.cu).

  l2_rate  the bytes per second of the sweep kernel (REPS passes of
           out = a + b over one working set in one launch, with L2-only
           loads and stores) beside those of single moves of the same
           bytes (copy_add, torch.add, a device-to-device copy), each
           from torch.profiler's device time; chip_smoke.py takes
           copy_add's bound at its L2-resident shape from the fastest.
  shapes   copy_add's kernel in other launch shapes (SHAPES: vectors per
           thread, threads per block, a grid that covers the vectors
           once or one wave of resident blocks striding over them),
           copy_add and torch.add, each by the guarded event timer and
           by the profiler.

At mmbench's 24 x 2^16 limbs (18.9 MB, which stay in the 50 MB L2) and
at 24 x 2^20 (302 MB, from HBM; shapes only).

    python -m gemini_tpu_torch.benches.l2bench          (on cuda)
"""

from __future__ import annotations

import ctypes
import json

import torch

from .. import cuda_lib
from ..device import name as device_name, resolve
from . import probes, timing

REPS = 100  # passes in the sweep's one launch, which spread the launch's ramp
LOGNS = (16, 20)
# (16-byte vectors per thread, threads per block, grid): "once" covers
# the vectors once, "wave" is the SM count times the blocks an SM holds
SHAPES = ((1, 128, "once"), (2, 128, "once"), (4, 128, "once"), (2, 256, "once"),
          (4, 256, "once"), (2, 128, "wave"), (4, 256, "wave"), (2, 512, "wave"))


def _bind(lib):
    p, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.l2bench_sweep.argtypes = [p, p, p, n, i, i, p]
    lib.l2bench_copy_add.argtypes = [p, p, p, n, i, i, i, p]
    lib.l2bench_sweep.restype = lib.l2bench_copy_add.restype = i


def _launch(fn, a, b, *shape):
    for t in (a, b):
        if t.device.type != "cuda" or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: contiguous 16-byte aligned CUDA tensors only")
    if a.shape != b.shape or a.numel() % 4:
        raise ValueError(f"{fn}: operands of one shape, a multiple of 4 elements")
    out = torch.empty_like(a)
    lib = cuda_lib.library("l2bench", _bind)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, fn)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               a.numel() // 4, *shape, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed (cudaError {err})")
    return out


def _wave(threads: int, device) -> int:
    """Blocks of `threads` that fill every SM (2048 threads each)."""
    return torch.cuda.get_device_properties(device).multi_processor_count * (2048 // threads)


def sweep(a, b):
    return _launch("l2bench_sweep", a, b, REPS, _wave(256, a.device))


def copy_add_shape(a, b, vecs: int, threads: int, grid: str):
    blocks = 0 if grid == "once" else _wave(threads, a.device)
    return _launch("l2bench_copy_add", a, b, vecs, threads, blocks)


def limbs(logn: int, seed: int, device):
    """(24, 2^logn) random int32 limbs, from `seed`."""
    return probes.to_i32(torch.randint(
        0, 1 << 32, (24, 1 << logn), dtype=torch.int64, device=device,
        generator=torch.Generator(device).manual_seed(seed)))


def _check(what, got, a, b):
    if not torch.equal(got, probes.copy_add_plain(a, b)):
        raise AssertionError(f"l2bench: {what} differs from copy_add's plain version")


def l2_rate(a, b) -> dict:
    """Bytes per second of each move of a + b's bytes (a, b read once,
    out written once; the sweep moves them REPS times) from its device
    time under the profiler; `rate` is the fastest, `rate_from` names it."""
    _check("sweep", sweep(a, b), a, b)
    nbytes = 3 * 4 * a.numel()
    src = torch.empty(3 * a.numel() // 2, dtype=torch.int32, device=a.device)
    dst = torch.empty_like(src)  # the copy reads and writes half the bytes each
    moves = {f"sweep ({REPS} passes in one launch)": (lambda: sweep(a, b), REPS),
             "copy_add": (lambda: probes.copy_add(a, b), 1),
             "torch.add": (lambda: torch.add(a, b), 1),
             "device-to-device copy": (lambda: dst.copy_(src), 1)}
    rates = {k: nbytes * passes / timing.profiler_ms(fn, 5 if passes > 1 else 20) * 1e3
             for k, (fn, passes) in moves.items()}
    fastest = max(rates, key=rates.get)
    return {"bytes": nbytes, "bytes_per_s": rates, "rate": rates[fastest],
            "rate_from": fastest}


def shapes(a, b) -> dict:
    """{label: {"ms": guarded event timer, "device_ms": profiler}} for
    copy_add, torch.add and copy_add's kernel in each of SHAPES (outputs
    checked against the plain version)."""
    fns = {"copy_add": lambda: probes.copy_add(a, b), "torch.add": lambda: torch.add(a, b)}
    for vecs, threads, grid in SHAPES:
        label = f"{threads} threads x {vecs} vectors, grid {grid}"
        _check(label, copy_add_shape(a, b, vecs, threads, grid), a, b)
        fns[label] = lambda v=vecs, t=threads, g=grid: copy_add_shape(a, b, v, t, g)
    return {k: {"ms": timing.event_ms(fn, 50), "device_ms": timing.profiler_ms(fn)}
            for k, fn in fns.items()}


def main(device=None) -> dict:
    dev = resolve(device)
    out = {"device": device_name(dev)}
    for logn in LOGNS:
        a, b = limbs(logn, 6, dev), limbs(logn, 7, dev)
        row = {"bytes": 3 * 4 * a.numel(), "shapes": shapes(a, b)}
        if logn == 16:
            row["l2"] = l2_rate(a, b)
        out[f"24x2^{logn}"] = row
        del a, b
    print(json.dumps({"l2bench": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
