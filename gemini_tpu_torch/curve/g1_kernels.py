"""The G1 group-law and Fq Montgomery kernels, hand-written for Hopper.

Port of gemini_tpu/curve/pallas_g1.py's kernels:

  padd      <- `_padd_kernel`   complete RCB projective add, relaxed
  padd01    <- `_padd01_kernel` the same add for z in {0, 1} operands
  mont_mul  <- `_mm_kernel`     canonical Fq Montgomery product
  add       <- `_add_kernel`    complete Jacobian add, canonical
  dbl       <- `_dbl_kernel`    Jacobian doubling, canonical

The kernels are CUDA C++ (csrc/g1_kernels.cu, csrc/fq.cuh), compiled
with nvcc for sm_90a at first use into `_build/` and bound with ctypes.
Each has a plain PyTorch version in this module (int64 limbs) that
computes the same integers bit for bit, relaxed values included.  A
wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.

Contracts (the Pallas kernels'): coordinates are (24, *batch) int32
16-bit limbs; `mont_mul` takes inputs < p and returns canonical
output; `padd` takes inputs < 2p, returns outputs < 2p, identity
(0 : y : 0); `padd01` takes (x, y, mask) operands with z = mask in
{0, 1} and dead lanes (0 : y : 0); `add` and `double` take Jacobian
(x, y, z) inputs < p, return outputs < p, identity z = 0.  The padd,
padd01 and add kernels read their operands as laid out, views included
(`lane_strides`), and bool masks as they are, and write into `out`
views the same way when given (else fresh contiguous outputs; outputs
must not overlap the operands); mont_mul and dbl take contiguous copies
and return contiguous outputs.

`LAUNCHES` counts kernel launches and `LANES` the lanes they covered
(the plain path counts neither), so a run can show that the main path
went through the kernels, and how much work it gave each.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib
from ..fields import fp
from ..fields.fp import FQ, I32, I64, _carry, _col, _mul_wide, _redc

L = FQ.n_limbs  # 24

LAUNCHES = {"padd": 0, "padd01": 0, "mont_mul": 0, "add": 0, "dbl": 0}
LANES = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LANES[k] = 0


STRIDED = ("padd", "padd01", "add")  # kernels that read their operands' strides
_Desc = ctypes.c_longlong * 24  # 6 operands x (pointer, 3 strides)
_OutDesc = ctypes.c_longlong * 12  # 3 outputs x (pointer, 3 strides)


def _bind(lib):
    p, n = ctypes.c_void_p, ctypes.c_longlong
    lib.g1_mont_mul.argtypes = [p, p, p, n, p]
    for fn in (lib.g1_padd, lib.g1_padd01, lib.g1_add):
        fn.argtypes = [p, p, n, n, p]
    lib.g1_dbl.argtypes = [p] * 6 + [n, p]
    for fn in (lib.g1_mont_mul, lib.g1_padd, lib.g1_padd01, lib.g1_add,
               lib.g1_dbl):
        fn.restype = ctypes.c_int


def lane_strides(t, rows: int):
    """(limb stride, batch stride, lane stride), in elements, of a padd,
    padd01 or add operand: a (rows, *batch) coordinate view, or with rows = 0 a
    (*batch) mask.  The kernel reads the batch as rows x cols, cols its
    last dim: the leading dims must merge into one stride (halves, even/odd
    splits and transposes of the MSM's (24, W, n) tensors do).  Raises
    ValueError on a layout the kernel does not take."""
    shape, strides = t.shape, t.stride()
    ls = strides[0] if rows else 0
    if rows:
        shape, strides = shape[1:], strides[1:]
    if len(shape) == 1:
        return ls, 0, strides[0]
    if len(shape) == 2:
        return ls, (strides[0] if shape[0] != 1 else 0), strides[1]
    if not shape:
        raise ValueError("strided operands need a batch dimension")
    lead = [(s, st) for s, st in zip(shape[:-1], strides[:-1]) if s != 1]
    for (_, st0), (s1, st1) in zip(lead, lead[1:]):
        if st0 != st1 * s1:
            raise ValueError(f"batch dims {tuple(shape)} with strides {strides} "
                             "do not merge into rows x lanes")
    return ls, (lead[-1][1] if lead else 0), strides[-1]


def _check(name, tensors, rows):
    dev = tensors[0].device
    batch = tuple(tensors[0].shape[1:])
    for t, r in zip(tensors, rows):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if dev.type != "cuda":
            raise ValueError(f"{name}: kernel launch needs CUDA tensors, got {dev}")
        want = torch.bool if (name in STRIDED and not r) else I32
        if t.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")
        if tuple(t.shape) != (((r,) if r else ()) + batch):
            raise ValueError(f"{name}: bad shape {tuple(t.shape)}")
        if name not in STRIDED and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev, batch


def _launch(name, fn, ins, n_out, rows, out=None):
    """Launch `fn` on `ins` ((rows, *batch) int32 coordinates; rows = 0 for
    a mask); returns n_out (24, *batch) outputs: `out` (padd, padd01 and
    add: views written as laid out) or fresh contiguous tensors.  padd,
    padd01 and add take their operands as laid out (lane_strides); the
    other kernels take contiguous tensors."""
    dev, batch = _check(name, ins, rows)
    if out is None:
        outs = [torch.empty((L, *batch), dtype=I32, device=dev) for _ in range(n_out)]
    else:
        if name not in STRIDED:
            raise ValueError(f"{name}: takes no output views")
        outs = list(out)
        _check(name, outs, [L] * n_out)
        if tuple(outs[0].shape[1:]) != batch:
            raise ValueError(f"{name}: outputs {tuple(outs[0].shape)} for operands "
                             f"of batch {batch}")
    n = outs[0].numel() // L
    if n == 0:
        return outs
    if name in STRIDED:
        if n >= 1 << 31:
            raise ValueError(f"{name}: {n} lanes, at most 2^31 - 1 per launch")
        desc, odesc = [], []
        for t, r in zip(ins, rows):
            desc.append(t.data_ptr())
            desc.extend(lane_strides(t, r))
        for o in outs:
            odesc.append(o.data_ptr())
            odesc.extend(lane_strides(o, L))
        args = [_Desc(*desc), _OutDesc(*odesc), n, batch[-1]]
    else:
        args = [t.data_ptr() for t in ins + outs] + [n]
    lib = cuda_lib.library("g1_kernels", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    LANES[name] += n
    return outs


# ---------------------------------------------------------------------------
# Plain versions (int64 limbs; the relaxed-domain ops of pallas_g1._F)
# ---------------------------------------------------------------------------


def _k(which, like):
    return _col(FQ.const(which, like.device), like.ndim - 1)


def _rmm(a, b):
    return _redc(FQ, _mul_wide(a, b), L)


def _rmm_add(a, b, c, d):
    return _redc(FQ, _mul_wide(a, b) + _mul_wide(c, d), L)


def _rneg(a):
    return _carry(_k("mod2", a) - a, FQ)[0]


def _rmm_sub(a, b, c, d):
    return _rmm_add(a, b, c, _rneg(d))


def _radd(a, b):
    s, _ = _carry(a + b, FQ)
    d, c = _carry(s - _k("mod2", s), FQ)
    return torch.where((c < 0).unsqueeze(0), s, d)


def _rsub(a, b):
    d, c = _carry(a - b, FQ)
    f, _ = _carry(d + _k("mod2", d), FQ)
    return torch.where((c < 0).unsqueeze(0), f, d)


def _rmul12(x):
    x2 = _radd(x, x)
    x4 = _radd(x2, x2)
    x8 = _radd(x4, x4)
    return _radd(x8, x4)


def mont_mul_plain(a, b):
    """(24, n) int32 canonical a, b -> a*b*2^-384 mod p, canonical."""
    return fp.mont_mul_wide(FQ, a.to(I64), b.to(I64)).to(I32)


def padd_plain(x1, y1, z1, x2, y2, z2):
    """_padd_core on (24, n) int32 limbs (inputs < 2p, outputs < 2p)."""
    x1, y1, z1, x2, y2, z2 = (t.to(I64) for t in (x1, y1, z1, x2, y2, z2))
    t0 = _rmm(x1, x2)
    t1 = _rmm(y1, y2)
    t2 = _rmm(z1, z2)
    t3 = _rmm(_radd(x1, y1), _radd(x2, y2))
    t3 = _rsub(_rsub(t3, t0), t1)
    t4 = _rmm(_radd(y1, z1), _radd(y2, z2))
    t4 = _rsub(_rsub(t4, t1), t2)
    x3 = _rmm(_radd(x1, z1), _radd(x2, z2))
    y3 = _rsub(_rsub(x3, t0), t2)
    t0 = _radd(_radd(t0, t0), t0)
    t2 = _rmul12(t2)
    z3 = _radd(t1, t2)
    t1 = _rsub(t1, t2)
    y3 = _rmul12(y3)
    return (_rmm_sub(t3, t1, t4, y3).to(I32),
            _rmm_add(t1, z3, y3, t0).to(I32),
            _rmm_add(z3, t4, t0, t3).to(I32))


def padd01_plain(x1, y1, m1, x2, y2, m2):
    """_padd01_core on (24, n) int32 limbs with (n,) masks."""
    x1, y1, x2, y2 = (t.to(I64) for t in (x1, y1, x2, y2))
    live1 = (m1 != 0).unsqueeze(0)
    live2 = (m2 != 0).unsqueeze(0)
    zero = torch.zeros_like(x1)
    t0 = _rmm(x1, x2)
    t1 = _rmm(y1, y2)
    t3 = _rmm(_radd(x1, y1), _radd(x2, y2))
    t3 = _rsub(_rsub(t3, t0), t1)
    t4 = _radd(torch.where(live2, y1, zero), torch.where(live1, y2, zero))
    y3 = _radd(torch.where(live2, x1, zero), torch.where(live1, x2, zero))
    t0 = _radd(_radd(t0, t0), t0)
    twelve = _col(torch.from_numpy(
        np.array([(12 * FQ.mont_r % FQ.modulus >> (16 * i)) & 0xFFFF
                  for i in range(L)], np.int64)).to(x1.device), 1)
    t2 = torch.where(live1 & live2, twelve, zero)
    z3 = _radd(t1, t2)
    t1 = _rsub(t1, t2)
    y3 = _rmul12(y3)
    return (_rmm_sub(t3, t1, t4, y3).to(I32),
            _rmm_add(t1, z3, y3, t0).to(I32),
            _rmm_add(z3, t4, t0, t3).to(I32))


# Canonical-domain ops of pallas_g1._F (the Jacobian group law), with
# their integer semantics for any 384-bit input.


def _mm(a, b):
    return fp.mont_mul_wide(FQ, a, b)


def _fadd(a, b):
    """a + b mod 2^384, minus p when that is >= p or the sum carried out."""
    s, cout = _carry(a + b, FQ)
    d, c = _carry(s - _k("mod", s), FQ)
    return torch.where(((c >= 0) | (cout > 0)).unsqueeze(0), d, s)


def _fsub(a, b):
    """a - b mod 2^384, plus p (mod 2^384) on a borrow."""
    d, c = _carry(a - b, FQ)
    f, _ = _carry(d + _k("mod", d), FQ)
    return torch.where((c < 0).unsqueeze(0), f, d)


def _fdbl(a):
    return _fadd(a, a)


def _is_zero(a):
    return (a == 0).all(dim=0).unsqueeze(0)


def _dbl_core(x, y, z):
    a = _mm(x, x)
    b = _mm(y, y)
    c = _mm(b, b)
    xb = _fadd(x, b)
    d = _fdbl(_fsub(_mm(xb, xb), _fadd(a, c)))
    e = _fadd(_fdbl(a), a)
    f = _mm(e, e)
    x3 = _fsub(f, _fdbl(d))
    c8 = _fdbl(_fdbl(_fdbl(c)))
    y3 = _fsub(_mm(e, _fsub(d, x3)), c8)
    z3 = _fdbl(_mm(y, z))
    return x3, y3, z3


def double_plain(x, y, z):
    """_dbl_core (dbl-2009-l) on (24, n) int32 limbs."""
    return tuple(o.to(I32) for o in _dbl_core(*(t.to(I64) for t in (x, y, z))))


def add_plain(x1, y1, z1, x2, y2, z2):
    """_add_core (add-2007-bl, the doubling where h = r = 0, then the
    identity selects on z1 = 0 and z2 = 0) on (24, n) int32 limbs."""
    x1, y1, z1, x2, y2, z2 = (t.to(I64) for t in (x1, y1, z1, x2, y2, z2))
    z1z1 = _mm(z1, z1)
    z2z2 = _mm(z2, z2)
    u1 = _mm(x1, z2z2)
    u2 = _mm(x2, z1z1)
    s1 = _mm(_mm(y1, z2), z2z2)
    s2 = _mm(_mm(y2, z1), z1z1)
    h = _fsub(u2, u1)
    h2 = _fdbl(h)
    i = _mm(h2, h2)
    j = _mm(h, i)
    r = _fdbl(_fsub(s2, s1))
    v = _mm(u1, i)
    x3 = _fsub(_fsub(_mm(r, r), j), _fdbl(v))
    y3 = _fsub(_mm(r, _fsub(v, x3)), _fdbl(_mm(s1, j)))
    zs = _fadd(z1, z2)
    z3 = _mm(_fsub(_mm(zs, zs), _fadd(z1z1, z2z2)), h)
    out = (x3, y3, z3)
    same = _is_zero(h) & _is_zero(r)
    out = [torch.where(same, d, o) for d, o in zip(_dbl_core(x1, y1, z1), out)]
    out = [torch.where(_is_zero(z1), q, o) for q, o in zip((x2, y2, z2), out)]
    out = [torch.where(_is_zero(z2), p, o) for p, o in zip((x1, y1, z1), out)]
    return tuple(o.to(I32) for o in out)


# ---------------------------------------------------------------------------
# Wrappers: (L, *batch) in, (L, *batch) out; CPU tensors -> plain
# version, CUDA tensors -> kernel.
# ---------------------------------------------------------------------------


def _flat(a):
    return a.reshape(L, -1).contiguous()


def mont_mul(a, b):
    """Canonical Fq Montgomery product of (24, *batch) int32 limbs."""
    shape = a.shape
    af, bf = _flat(a), _flat(b)
    if af.device.type == "cpu":
        out = mont_mul_plain(af, bf)
    else:
        (out,) = _launch("mont_mul", "g1_mont_mul", [af, bf], 1, [L, L])
    return out.reshape(shape)


def _plain_out(outs, shape, out):
    """A plain version's flat outputs as (24, *batch), written into `out`
    when given."""
    outs = tuple(o.reshape(shape) for o in outs)
    if out is None:
        return outs
    for o, r in zip(out, outs):
        o.copy_(r)
    return tuple(out)


def padd(p, q, out=None):
    """Complete projective add: p, q are (x, y, z) tuples of (24, *batch)
    coords; identity is (0 : y : 0).  Relaxed: outputs < 2p.  The kernel
    reads the operands as laid out (views included, lane_strides) and
    writes `out`, three (24, *batch) views, as laid out (fresh contiguous
    outputs without it)."""
    shape = p[0].shape
    if p[0].device.type == "cpu":
        return _plain_out(padd_plain(*(_flat(t) for t in (*p, *q))), shape, out)
    return tuple(_launch("padd", "g1_padd", [*p, *q], 3, [L] * 6, out))


def padd01(p, q, out=None):
    """Complete projective add for operands with z in {0, 1}: p, q are
    (x, y, mask) with coords (24, *batch) and mask (*batch) bool/int
    (nonzero = live, zero = the identity (0 : y : 0)).  The kernel reads
    coordinates and bool masks as laid out (other mask types are
    converted first) and writes `out` as padd does."""
    shape = p[0].shape
    m1, m2 = (m if m.dtype == torch.bool else m != 0 for m in (p[2], q[2]))
    if p[0].device.type == "cpu":
        x1, y1, x2, y2 = (_flat(t) for t in (p[0], p[1], q[0], q[1]))
        return _plain_out(padd01_plain(x1, y1, m1.reshape(-1), x2, y2, m2.reshape(-1)),
                          shape, out)
    return tuple(_launch("padd01", "g1_padd01", [p[0], p[1], m1, q[0], q[1], m2],
                         3, [L, L, 0, L, L, 0], out))


def add(p, q, out=None):
    """Complete Jacobian add: p, q are (x, y, z) tuples of (24, *batch)
    canonical coords; identity z = 0.  Canonical outputs.  The kernel
    reads the operands as laid out (views included, lane_strides) and
    writes `out` as padd does."""
    shape = p[0].shape
    if p[0].device.type == "cpu":
        return _plain_out(add_plain(*(_flat(t) for t in (*p, *q))), shape, out)
    return tuple(_launch("add", "g1_add", [*p, *q], 3, [L] * 6, out))


def double(p):
    """Jacobian doubling of an (x, y, z) tuple of (24, *batch) canonical
    coords (identity and 2-torsion map to z = 0)."""
    shape = p[0].shape
    ins = [_flat(t) for t in p]
    if ins[0].device.type == "cpu":
        outs = double_plain(*ins)
    else:
        outs = _launch("dbl", "g1_dbl", ins, 3, [L] * 3)
    return tuple(o.reshape(shape) for o in outs)
