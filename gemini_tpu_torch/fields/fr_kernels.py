"""The scalar field's vector ops, hand-written for Hopper.

fields/fp.py sends every Fr op on a CUDA tensor here:

  mul      <- gemini_tpu/fields/fp.py `mont_mul` (:273; the CIOS at
              :224-271): canonical Montgomery product
  addsub   <- `add` (:199), `sub` (:206), and `neg` (:219) as 0 - a
  reduce   <- `reduce_relaxed` (:327): V mod r of relaxed limb rows
  lane_sum <- `lane_sum` (:412), and `lane_sum(mont_mul(a, b))` as one
              pass: exact sums over one batch axis

The reference has no Pallas kernel there (XLA fuses each jitted op).  The
kernels are CUDA C++ (csrc/fr_kernels.cu over csrc/fr.cuh), compiled with
nvcc for sm_90a at first use into `_build/` and bound with ctypes; their
plain versions are fp.py's `_mont_mul_plain`, `_add_plain`, `_sub_plain`,
`_reduce_relaxed_plain` and `_lane_sum_plain`, which they equal bit for
bit.  fp.py takes the plain versions only for CPU tensors; these
wrappers launch or raise.

Operands are (16, *batch) int32 limbs (the reduction's rows (E, *batch),
int32 or int64), read through their strides: the batch dims of each
operand, broadcast as the plain versions broadcast them, must merge into
(outer, inner) (the lane sum: the summed axis, and the other dims into
one), else ValueError; nothing is copied.  Outputs are contiguous.
Products need their second operand below r (fp.mont_mul's contract).
A lane sum's groups share a scratch buffer and tickets that the last
block resets, so launches run in stream order: every launch goes on the
current stream.

`LAUNCHES` counts kernel launches and `LANES` the elements they wrote
(the lane sum: the terms it read); the plain path counts neither.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import cuda_lib
from ..params import R

L = 16  # limbs of an element
SUM_LIMBS = 18  # limbs of an exact lane sum
THREADS = 256  # csrc/fr_kernels.cu kThreads
TERMS_PER_THREAD = 4  # a lane sum's target share of a thread
BLOCKS_PER_SM = 8  # a lane sum spread over whole blocks fills this many per SM
MAX_TERMS = 1 << 31  # a group's terms stay below this (288-bit exact sums)
_MAX_BLOCKS = 4096  # csrc/fr_kernels.cu kMaxBlocks

LAUNCHES = {"fr_mul": 0, "fr_addsub": 0, "fr_reduce": 0, "fr_lane_sum": 0}
LANES = dict.fromkeys(LAUNCHES, 0)

_scratch: dict = {}  # device -> (partials, tickets)
_sms: dict = {}  # device -> SM count


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LANES[k] = 0


def _bind(lib):
    p, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fr_mul.argtypes = [p, n, n, p, p]
    lib.fr_addsub.argtypes = [p, n, n, i, p, p]
    lib.fr_reduce.argtypes = [p, i, i, i, p, n, n, p, p]
    lib.fr_lane_sum.argtypes = [p, i, n, n, i, i, p, p, p, p]
    for fn in (lib.fr_mul, lib.fr_addsub, lib.fr_reduce, lib.fr_lane_sum):
        fn.restype = ctypes.c_int


def _lib():
    return cuda_lib.library("fr_kernels", _bind)


def _device(name, *tensors, dtypes=(torch.int32,)):
    """The one CUDA device of `tensors`; raises on a CPU tensor, on
    tensors on two devices and on another dtype."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel launch needs CUDA tensors, got {dev}")
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {x.device}")
        if x.dtype not in dtypes:
            raise TypeError(f"{name}: operands must be {' or '.join(map(str, dtypes))}, "
                            f"got {x.dtype}")
    return dev


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _run(name, dev, fn, *args):
    with torch.cuda.device(dev):
        err = fn(*args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _words(x: int):
    return (ctypes.c_uint32 * 8)(*((x >> (32 * k)) & 0xFFFFFFFF for k in range(8)))


def _broadcast(name, a, b):
    """a and b (16, *batch) expanded to their common batch shape, batch
    dims aligned from the right as the plain versions broadcast them."""
    for x in (a, b):
        if x.ndim < 1 or x.shape[0] != L:
            raise ValueError(f"{name}: operands must be ({L}, *batch), got "
                             f"{tuple(x.shape)}")
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])

    def expand(x):
        lead = (1,) * (len(batch) - (x.ndim - 1))
        return x.reshape(L, *lead, *x.shape[1:]).expand(L, *batch)

    return tuple(batch), expand(a), expand(b)


def merge_dims(sizes, strides):
    """Batch dims (sizes, and per operand its strides) merged where every
    operand lays them out as one: [(size, [stride per operand])], size-1
    dims dropped, outermost first."""
    out = []
    for d, size in enumerate(sizes):
        if size == 1:
            continue
        st = [s[d] for s in strides]
        if out and all(ps == s * size for ps, s in zip(out[-1][1], st)):
            out[-1] = (out[-1][0] * size, st)
        else:
            out.append((size, st))
    return out


def lane_strides(name, batch, ops):
    """(inner, [(outer stride, inner stride) per operand]) of operands laid
    over `batch` as outer x inner; raises ValueError where their batch dims
    do not merge into two."""
    dims = merge_dims(batch, [x.stride()[1:] for x in ops])
    if len(dims) > 2:
        raise ValueError(f"{name}: batch dims {tuple(batch)} with strides "
                         f"{[x.stride() for x in ops]} do not merge into outer x inner")
    dims = [(1, [0] * len(ops))] * (2 - len(dims)) + dims
    (_, so), (inner, si) = dims
    return inner, list(zip(so, si))


def _desc(ops, strides):
    out = []
    for x, (os_, is_) in zip(ops, strides):
        out.extend((x.data_ptr(), x.stride(0), os_, is_))
    return (ctypes.c_longlong * len(out))(*out)


def _elementwise(name, a, b, launch):
    dev = _device(name, a, b)
    batch, ea, eb = _broadcast(name, a, b)
    out = torch.empty((L, *batch), dtype=torch.int32, device=dev)
    n = math.prod(batch)
    if n == 0:
        return out
    inner, strides = lane_strides(name, batch, (ea, eb))
    launch(dev, _desc((ea, eb), strides), n, inner, out)
    LAUNCHES[name] += 1
    LANES[name] += n
    return out


def mul(a, b):
    """Canonical a * b * 2^-256 mod r, (16, *batch) int32 limbs, batch
    shapes broadcast; b below r, a any normalized value."""
    return _elementwise("fr_mul", a, b, lambda dev, desc, n, inner, out: _run(
        "fr_mul", dev, _lib().fr_mul, desc, n, inner, out.data_ptr()))


def addsub(a, b, subtract: bool):
    """Canonical a + b (a - b when `subtract`) mod r."""
    return _elementwise("fr_addsub", a, b, lambda dev, desc, n, inner, out: _run(
        "fr_addsub", dev, _lib().fr_addsub, desc, n, inner, int(subtract),
        out.data_ptr()))


def reduce_words(rows: int) -> int:
    """32-bit words fr_reduce feeds its product for `rows` relaxed rows
    below 2^47: E + 2 16-bit limbs hold V < 2^(16 E + 32), rounded up to
    an even word count."""
    words = (rows + 3) // 2
    return words + words % 2


def reduce(v):
    """(E, *batch) relaxed rows (int32 or int64, each in [0, 2^47)) ->
    (16, *batch) canonical V mod r, V = sum_k v[k] 2^(16 k)."""
    dev = _device("fr_reduce", v, dtypes=(torch.int32, torch.int64))
    if v.ndim < 1 or v.shape[0] < 1:
        raise ValueError(f"fr_reduce: rows must be (E, *batch), got {tuple(v.shape)}")
    batch = tuple(v.shape[1:])
    out = torch.empty((L, *batch), dtype=torch.int32, device=dev)
    n = math.prod(batch)
    if n == 0:
        return out
    inner, strides = lane_strides("fr_reduce", batch, (v,))
    rows, words = v.shape[0], reduce_words(v.shape[0])
    _run("fr_reduce", dev, _lib().fr_reduce, _desc((v,), strides),
         int(v.dtype == torch.int64), rows, words, _words(pow(2, 32 * words, R)), n,
         inner, out.data_ptr())
    LAUNCHES["fr_reduce"] += 1
    LANES["fr_reduce"] += n
    return out


def lane_sum_shape(groups: int, m: int, sms: int) -> tuple:
    """(seg, parts) of a lane sum over `groups` groups of m terms on a
    card of `sms` SMs: up to 32 lanes a group, a power of two, so that a
    lane takes about TERMS_PER_THREAD terms (seg, parts = 1); beyond,
    whole 256-thread blocks (seg = 0), `parts` a group: a term a thread
    while BLOCKS_PER_SM blocks an SM allow (a thread's terms are loaded
    one after another, so a small sum pays each as a round trip), else
    that many blocks in all."""
    need = -(-m // TERMS_PER_THREAD)
    if need <= 32:
        return 1 << (need - 1).bit_length(), 1
    cap = max(1, min(BLOCKS_PER_SM * sms, _MAX_BLOCKS) // groups)
    return 0, min(-(-m // THREADS), cap)


def _scratch_for(dev):
    s = _scratch.get(dev)
    if s is None:
        s = _scratch[dev] = (
            torch.empty(_MAX_BLOCKS * 9, dtype=torch.int32, device=dev),
            torch.zeros(_MAX_BLOCKS, dtype=torch.int32, device=dev))
    return s


def _sm_count(dev) -> int:
    n = _sms.get(dev)
    if n is None:
        n = _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def lane_sum(a, axis: int = 1, b=None):
    """Exact sums over batch axis `axis` of a (16, *batch), or of the
    canonical products a * b (b below r, broadcast as in mul): (18, *rest)
    int32 carry-normalized limbs, fp.lane_sum's output."""
    name = "fr_lane_sum"
    ops = (a,) if b is None else (a, b)
    dev = _device(name, *ops)
    if b is None:
        if a.ndim < 2 or a.shape[0] != L:
            raise ValueError(f"{name}: a must be ({L}, *batch), got {tuple(a.shape)}")
        batch = tuple(a.shape[1:])
    else:
        batch, a, b = _broadcast(name, a, b)
        ops = (a, b)
    if not 1 <= axis <= len(batch):
        raise ValueError(f"{name}: axis {axis} outside batch {batch}")
    m = batch[axis - 1]
    rest = batch[:axis - 1] + batch[axis:]
    groups = math.prod(rest)
    if m >= MAX_TERMS:
        raise ValueError(f"{name}: {m} terms a group, at most 2^31 - 1")
    if m == 0 or groups == 0:
        return torch.zeros((SUM_LIMBS, *rest), dtype=torch.int32, device=dev)
    moved = [x.movedim(axis, -1) for x in ops]
    dims = merge_dims(rest, [x.stride()[1:-1] for x in moved])
    if len(dims) > 1:
        raise ValueError(f"{name}: group dims {rest} with strides "
                         f"{[x.stride() for x in ops]} do not merge into one")
    gs = dims[0][1] if dims else [0] * len(ops)
    strides = [(g, x.stride(-1)) for g, x in zip(gs, moved)]
    desc = _desc(moved + moved[:1], strides + strides[:1]) if b is None else \
        _desc(moved, strides)
    partials, tickets = _scratch_for(dev)
    out = torch.empty((SUM_LIMBS, groups), dtype=torch.int32, device=dev)
    seg, parts = lane_sum_shape(groups, m, _sm_count(dev))
    _run(name, dev, _lib().fr_lane_sum, desc, int(b is not None), groups, m, seg, parts,
         out.data_ptr(), partials.data_ptr(), tickets.data_ptr())
    LAUNCHES[name] += 1
    LANES[name] += groups * m
    return out.reshape(SUM_LIMBS, *rest)

