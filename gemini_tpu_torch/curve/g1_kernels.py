"""The G1 group-law and Fq Montgomery kernels, hand-written for Hopper.

Port of gemini_tpu/curve/pallas_g1.py's main-path kernels:

  padd      <- `_padd_kernel`   complete RCB projective add, relaxed
  padd01    <- `_padd01_kernel` the same add for z in {0, 1} operands
  mont_mul  <- `_mm_kernel`     canonical Fq Montgomery product

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
{0, 1} and dead lanes (0 : y : 0).

`LAUNCHES` counts kernel launches (the plain path does not count), so
a run can show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from ..fields import fp
from ..fields.fp import FQ, I32, I64, _carry, _col, _mul_wide, _redc

L = FQ.n_limbs  # 24

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {"padd": 0, "padd01": 0, "mont_mul": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build and bind (nvcc -> shared library with a C interface -> ctypes)
# ---------------------------------------------------------------------------


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(verbose: bool = False) -> str:
    """Compile csrc/g1_kernels.cu into `_build/libg1_kernels_<hash>.so`
    unless it exists (the hash covers every source and the flags); the
    build runs under a file lock so concurrent processes share it.
    Returns the library path; raises with nvcc's output on failure."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libg1_kernels_{h.hexdigest()[:12]}.so")
    with open(os.path.join(BUILD_DIR, "g1_kernels.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.tmp.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC, "g1_kernels.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stderr.strip(), flush=True)
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, n = ctypes.c_void_p, ctypes.c_longlong
            lib.g1_mont_mul.argtypes = [p, p, p, n, p]
            lib.g1_padd.argtypes = [p] * 9 + [n, p]
            lib.g1_padd01.argtypes = [p] * 9 + [n, p]
            for fn in (lib.g1_mont_mul, lib.g1_padd, lib.g1_padd01):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name, tensors, rows):
    dev = tensors[0].device
    n = tensors[0].shape[-1]
    for t, r in zip(tensors, rows):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if dev.type != "cuda":
            raise ValueError(f"{name}: kernel launch needs CUDA tensors, got {dev}")
        if t.dtype != I32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if tuple(t.shape) != ((r, n) if r else (n,)):
            raise ValueError(f"{name}: bad shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev, n


def _launch(name, fn, ins, n_out, rows):
    dev, n = _check(name, ins, rows)
    outs = [torch.empty((L, n), dtype=I32, device=dev) for _ in range(n_out)]
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*[t.data_ptr() for t in ins + outs], n, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    LAUNCHES[name] += 1
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
    return _carry(_k("mod2", a) - a)[0]


def _rmm_sub(a, b, c, d):
    return _rmm_add(a, b, c, _rneg(d))


def _radd(a, b):
    s, _ = _carry(a + b)
    d, c = _carry(s - _k("mod2", s))
    return torch.where((c < 0).unsqueeze(0), s, d)


def _rsub(a, b):
    d, c = _carry(a - b)
    f, _ = _carry(d + _k("mod2", d))
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


def padd(p, q):
    """Complete projective add: p, q are (x, y, z) tuples of (24, *batch)
    coords; identity is (0 : y : 0).  Relaxed: outputs < 2p."""
    shape = p[0].shape
    ins = [_flat(t) for t in (*p, *q)]
    if ins[0].device.type == "cpu":
        outs = padd_plain(*ins)
    else:
        outs = _launch("padd", "g1_padd", ins, 3, [L] * 6)
    return tuple(o.reshape(shape) for o in outs)


def padd01(p, q):
    """Complete projective add for operands with z in {0, 1}: p, q are
    (x, y, mask) with coords (24, *batch) and mask (*batch) bool/int
    (nonzero = live, zero = the identity (0 : y : 0))."""
    shape = p[0].shape
    x1, y1, x2, y2 = (_flat(t) for t in (p[0], p[1], q[0], q[1]))
    m1 = p[2].reshape(-1).to(I32).contiguous()
    m2 = q[2].reshape(-1).to(I32).contiguous()
    if x1.device.type == "cpu":
        outs = padd01_plain(x1, y1, m1, x2, y2, m2)
    else:
        outs = _launch("padd01", "g1_padd01", [x1, y1, m1, x2, y2, m2], 3,
                       [L, L, 0, L, L, 0])
    return tuple(o.reshape(shape) for o in outs)
