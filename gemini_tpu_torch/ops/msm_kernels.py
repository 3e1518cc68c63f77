"""The MSM window chunk's glue, hand-written for Hopper.

ops/msm.py and ops/ec_scan.py send the chunk's glue on CUDA tensors here:

  digits       <- gemini_tpu/ops/msm.py `extract_digits` +
                  `extract_signed_digits` (:110-150): every window's
                  signed digit as the chunk sort's key, in one launch
  pack         <- `_pack_xy` (:178-196): each point's x and y as one
                  96-byte row, once per MSM
  sort_gather  <- `_sort_gather_proj` (:198-243) after the sort: the
                  flipped, partial bit-reversed gather of the packed rows,
                  the negation and the identity selects, the mask and sd
  walk_down    <- gemini_tpu/ops/ec_scan.py `prefix_sums_at`'s walk-down
                  (:265): the top gather and every level's add, one
                  launch per chunk (per MAX_LEVELS levels)
  combine      <- gemini_tpu/ops/msm.py `_horner_host` (:153): each set's
                  sum_w 2^(c w) T_w over its window totals, one launch
                  per MSM, the result left on the card

The reference has no Pallas kernel there (each is inside one jitted
program per chunk, and the combine runs on the host).  The kernels are
CUDA C++ (csrc/msm_kernels.cu over csrc/g1_core.cuh and csrc/fq.cuh),
compiled with nvcc for sm_90a at first use into `_build/` and bound with
ctypes; their plain versions are
ops/msm.py's `_digits_plain`, `_pack_plain` and `_sort_gather_plain` and
ops/ec_scan.py's `_walk_down_plain`, which they equal bit for bit; the
combine equals the chain of padd plain versions, and `_horner_host`
once normalized.  Those modules take the plain versions
only for CPU tensors; these wrappers launch on the current stream or
raise.

`LAUNCHES` counts kernel launches and `LANES` the lanes they covered (the
digits and the pack: scalars and points; the gather: output lanes; the
walk-down: positions; the combine: sets); the plain path counts
neither.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..curve.g1_kernels import lane_strides

L = 24  # Fq limbs
MAX_LEVELS = 8  # csrc/msm_kernels.cu kMaxLevels: reduce-chain levels a walk-down launch takes

LAUNCHES = {"msm_digits": 0, "msm_pack": 0, "msm_sort_gather": 0, "msm_walk_down": 0,
            "msm_combine": 0}
LANES = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LANES[k] = 0


def _bind(lib):
    p, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.msm_digits.argtypes = [p, n, n, i, n, i, i, p, n, p, n, p, p]
    lib.msm_pack.argtypes = [p, n, n, p, n, n, n, p, p]
    lib.msm_sort_gather.argtypes = [p, p, p, i, i, n, p, p, p, p, p]
    lib.msm_walk_down.argtypes = [p, i, i, i, p, p, n, n, p, p, p, i, p]
    lib.msm_combine.argtypes = [p, i, i, i, p, p, p, p]
    lib.msm_walk_down_occupancy.argtypes = [p]
    lib.msm_sort_gather_blocked.argtypes = [i, i]
    for fn in (lib.msm_digits, lib.msm_pack, lib.msm_sort_gather, lib.msm_walk_down,
               lib.msm_combine, lib.msm_walk_down_occupancy,
               lib.msm_sort_gather_blocked):
        fn.restype = ctypes.c_int


def _device(name, *tensors):
    """The one CUDA device of `tensors`; raises on a CPU tensor and on
    tensors on two devices."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel launch needs CUDA tensors, got {dev}")
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {x.device}")
    return dev


def _dtype(name, t, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")


def _run(name, dev, fn, *args):
    lib = cuda_lib.library("msm_kernels", _bind)
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def digits(scalars, c: int, windows: int, pinf=None, flip=None):
    """Signed c-bit digits of (limbs, n) int32 canonical scalars over
    `windows` windows, as the sort keys mag << 2 | (neg ^ flip) << 1 | inf:
    one (W, n) int64 tensor (pinf, flip: (n,) bool, each optional and
    read as False where absent)."""
    name = "msm_digits"
    dev = _device(name, scalars, *(t for t in (pinf, flip) if t is not None))
    _dtype(name, scalars, torch.int32)
    if scalars.ndim != 2:
        raise ValueError(f"{name}: scalars must be (limbs, n), got {tuple(scalars.shape)}")
    if not 2 <= c <= 31:
        raise ValueError(f"{name}: window of {c} bits, the kernel takes 2-31")
    limbs, n = scalars.shape
    for t in (pinf, flip):
        if t is not None:
            _dtype(name, t, torch.bool)
            if tuple(t.shape) != (n,):
                raise ValueError(f"{name}: flags must be ({n},), got {tuple(t.shape)}")
    key = torch.empty((windows, n), dtype=torch.int64, device=dev)
    if n and windows:
        _run(name, dev, name, scalars.data_ptr(), scalars.stride(0), scalars.stride(1),
             limbs, n, c, windows, _ptr(pinf), pinf.stride(0) if pinf is not None else 0,
             _ptr(flip), flip.stride(0) if flip is not None else 0, key.data_ptr())
        LAUNCHES[name] += 1
        LANES[name] += n
    return key


def pack(px, py):
    """(24, N) int32 x and y limbs (any strides) -> (N, 24) int32 rows:
    x's 12 words, then y's, word k = limb 2k | limb 2k+1 << 16."""
    name = "msm_pack"
    dev = _device(name, px, py)
    for t in (px, py):
        _dtype(name, t, torch.int32)
    if px.ndim != 2 or py.shape != px.shape or px.shape[0] != L:
        raise ValueError(f"{name}: points must be ({L}, N), got {tuple(px.shape)}, "
                         f"{tuple(py.shape)}")
    n = px.shape[1]
    out = torch.empty((n, L), dtype=torch.int32, device=dev)
    if n:
        _run(name, dev, name, px.data_ptr(), px.stride(0), px.stride(1), py.data_ptr(),
             py.stride(0), py.stride(1), n, out.data_ptr())
        LAUNCHES[name] += 1
        LANES[name] += n
    return out


def sort_gather(pp, skey, order, rev_bits: int):
    """_sort_gather_proj after the sort: pp the (N, 24) packed points
    (`pack`), skey and order (Wc, n) int64 from torch.sort of the keys
    along the lanes, n a power of two.  Returns x, y (24, Wc, n) in the
    flipped, partial bit-reversed order (ec_scan.partial_bitrev_last with
    `rev_bits`), the live mask (Wc, n) bool, and sd = skey >> 2."""
    name = "msm_sort_gather"
    dev = _device(name, pp, skey, order)
    for t, dt in ((pp, torch.int32), (skey, torch.int64), (order, torch.int64)):
        _dtype(name, t, dt)
    if pp.ndim != 2 or pp.shape[1] != L or not pp.is_contiguous():
        raise ValueError(f"{name}: packed points must be contiguous (N, {L}), got "
                         f"{tuple(pp.shape)}")
    skey, order = skey.contiguous(), order.contiguous()
    if skey.ndim != 2 or order.shape != skey.shape:
        raise ValueError(f"{name}: keys and order must be (Wc, n), got "
                         f"{tuple(skey.shape)}, {tuple(order.shape)}")
    wc, n = skey.shape
    log_n = n.bit_length() - 1
    if n != 1 << log_n or log_n > 30 or not 0 <= rev_bits <= log_n:
        raise ValueError(f"{name}: {n} lanes with {rev_bits} reversed bits")
    x = torch.empty((L, wc, n), dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    mask = torch.empty((wc, n), dtype=torch.bool, device=dev)
    sd = torch.empty((wc, n), dtype=torch.int64, device=dev)
    if wc * n:
        _run(name, dev, name, pp.data_ptr(), skey.data_ptr(), order.data_ptr(), log_n,
             rev_bits, wc * n, x.data_ptr(), y.data_ptr(), mask.data_ptr(),
             sd.data_ptr())
        LAUNCHES[name] += 1
        LANES[name] += wc * n
    return x, y, mask, sd


def sort_gather_blocked(n: int, rev_bits: int) -> bool:
    """Whether the sort_gather kernel fills windows of n lanes with
    `rev_bits` reversed bits by its block mapping (keys and order read as
    whole sectors into shared memory, whole lines stored) or a thread a
    lane: the kernel's own rule."""
    lib = cuda_lib.library("msm_kernels", _bind)
    return bool(lib.msm_sort_gather_blocked(n.bit_length() - 1, rev_bits))


def walk_down(pos, scanned, levels, rev_bits: int, proj: bool):
    """prefix_sums_at's walk-down: pos (Wc, m) or (m,) int64 positions in
    [-1, n - 1]; `scanned` the stop level's inclusive scan (x, y, z) of
    (24, *batch, s); `levels` the reduce chain's kept levels, the lanes
    first, each (x, y, z or bool mask, is01) of (24, *batch, n_k) (views
    as laid out).  Level k has rev_bits - k reversed bits (none with
    rev_bits = 0).  Adds with padd (`proj`: each lane's padd split over
    three threads) or the Jacobian add (a thread a lane).  One
    launch per MAX_LEVELS levels, the highest first, each after the first
    starting from the one before's sums.  Returns (x, y, z) of
    (24, *batch, m), contiguous."""
    name = "msm_walk_down"
    tensors = [pos, *scanned] + [t for lv in levels for t in lv[:3]]
    dev = _device(name, *tensors)
    _dtype(name, pos, torch.int64)
    if pos.ndim not in (1, 2):
        raise ValueError(f"{name}: positions must be (m,) or (Wc, m)")
    pos = pos.contiguous()
    batch, m = tuple(pos.shape[:-1]), pos.shape[-1]
    if pos.numel() >= 1 << 31:
        raise ValueError(f"{name}: {pos.numel()} lanes, at most 2^31 - 1 per launch")
    for k, (lx, ly, lz, is01) in enumerate(levels):
        n_k = lx.shape[-1]
        want = (L, *batch, n_k)
        for t, dt, shape in ((lx, torch.int32, want), (ly, torch.int32, want),
                             (lz, torch.bool if is01 else torch.int32,
                              want[1:] if is01 else want)):
            _dtype(name, t, dt)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}: level {k} operand {tuple(t.shape)}, "
                                 f"expected {shape}")
        if n_k & (n_k - 1):
            raise ValueError(f"{name}: level {k} has {n_k} lanes, not a power of two")
    for t in scanned:
        _dtype(name, t, torch.int32)
        if tuple(t.shape[:-1]) != (L, *batch):
            raise ValueError(f"{name}: scan output {tuple(t.shape)}")
    acc = None
    for lo in reversed(range(0, max(len(levels), 1), MAX_LEVELS)):
        acc = _walk_down_launch(dev, pos, scanned if acc is None else acc,
                                levels[lo:lo + MAX_LEVELS], lo, acc is not None,
                                rev_bits, proj)
    return acc


def combine(totals, sets: int, c: int):
    """sum_w 2^(c w) T_w for each of `sets` sets of W window totals:
    `totals` (x, y, z) of (24, sets * W) int32, set s's window w at
    column s * W + w (as ops/msm.py `_run_chunks` returns them),
    projective and relaxed (< 2p), identity (0 : y : 0) with y nonzero.
    Returns (x, y, z) of (24, sets), projective and relaxed: c doublings
    and one add a window from the highest down, each padd split over
    three threads."""
    name = "msm_combine"
    dev = _device(name, *totals)
    for t in totals:
        _dtype(name, t, torch.int32)
        if t.ndim != 2 or t.shape != totals[0].shape or t.shape[0] != L:
            raise ValueError(f"{name}: totals must be ({L}, sets * W), got "
                             f"{[tuple(u.shape) for u in totals]}")
    n = totals[0].shape[1]
    if sets < 1 or n % sets or n == 0:
        raise ValueError(f"{name}: {n} totals do not split into {sets} sets")
    if c < 1:
        raise ValueError(f"{name}: window of {c} bits")
    w = n // sets
    desc = [v for t in totals for v in (t.data_ptr(), t.stride(0), w * t.stride(1),
                                        t.stride(1))]
    out = [torch.empty((L, sets), dtype=torch.int32, device=dev) for _ in range(3)]
    _run(name, dev, name, (ctypes.c_longlong * 12)(*desc), sets, w, c,
         *(o.data_ptr() for o in out))
    LAUNCHES[name] += 1
    LANES[name] += sets
    return tuple(out)


def walk_down_occupancy(dev=None) -> dict:
    """The projective walk-down kernel's resources on a CUDA device (the
    current one by default): blocks of 96 threads an SM holds (the
    occupancy API), registers and local (spill) bytes a thread, static
    shared bytes a block."""
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    lib = cuda_lib.library("msm_kernels", _bind)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        err = lib.msm_walk_down_occupancy(out)
    if err != 0:
        raise RuntimeError(f"msm_walk_down: occupancy query failed (cudaError {err})")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "shared_bytes"), out))


def _walk_down_launch(dev, pos, top, levels, lo, chained, rev_bits, proj):
    """One msm_walk_down launch over `levels`, the chain's levels lo.., on
    checked operands; `top` the stop level's scan, or with `chained` the
    sums at level lo + len(levels) per lane."""
    name = "msm_walk_down"
    desc = []
    for k, (lx, ly, lz, is01) in enumerate(levels, start=lo):
        for t, rows in ((lx, L), (ly, L), (lz, 0 if is01 else L)):
            desc += [t.data_ptr(), *lane_strides(t, rows)]
        desc += [lx.shape[-1].bit_length() - 1, rev_bits - k if rev_bits else 0,
                 int(is01)]
    tops = [v for t in top for v in (t.data_ptr(), *lane_strides(t, L))]
    m, lanes = pos.shape[-1], pos.numel()
    out = [torch.empty((L, *pos.shape[:-1], m), dtype=torch.int32, device=dev)
           for _ in range(3)]
    if lanes:
        _run(name, dev, name, (ctypes.c_longlong * max(len(desc), 1))(*desc),
             len(levels), lo, int(chained), (ctypes.c_longlong * 12)(*tops),
             pos.data_ptr(), m, lanes, *(o.data_ptr() for o in out), int(proj))
        LAUNCHES[name] += 1
        LANES[name] += lanes
    return tuple(out)
