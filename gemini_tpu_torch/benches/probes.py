"""The two benchmark-probe kernels, hand-written for Hopper
(csrc/probes.cu), with their plain PyTorch versions.

  vpu_chain  <- benches/vpubench.py `make_kernel`: K dependent
                `acc = acc * b + a` per element; int32 tensors hold the
                bits of the uint32 chain (wrapping), float32 tensors run
                it as fused multiply-adds.
  copy_add   <- benches/mmbench.py `_copy_kernel`: o = a + b on (24, n)
                int32 limbs, wrapping.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.  `LAUNCHES` counts kernel
launches.  The plain versions are bit-exact for the integer types; for
float32 the plain chain rounds each step's exact a*b + a from float64
to float32, which equals a fused multiply-add except where the float64
sum itself rounds onto a float32 halfway point.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib

LAUNCHES = {"vpu_chain": 0, "copy_add": 0}

_U32 = 0xFFFFFFFF


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib):
    p, n = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.probe_vpu_chain_u32, lib.probe_vpu_chain_f32):
        fn.argtypes = [p, p, p, n, ctypes.c_int, p]
    lib.probe_copy_add.argtypes = [p, p, p, n, p]
    for fn in (lib.probe_vpu_chain_u32, lib.probe_vpu_chain_f32,
               lib.probe_copy_add):
        fn.restype = ctypes.c_int


def _launch(name, fn, a, b, *extra):
    for t in (a, b):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name}: kernel launch needs CUDA tensors on one "
                             f"device, got {t.device}")
        if t.dtype != a.dtype or t.shape != a.shape or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous and alike")
    out = torch.empty_like(a)  # fresh, so 16-byte aligned as copy_add's kernel needs
    lib = cuda_lib.library("probes", _bind)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, fn)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               a.numel(), *extra, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    LAUNCHES[name] += 1
    return out


def to_i32(x):
    """int64 holding a 32-bit pattern -> int32 with the same bits."""
    x = x & _U32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def vpu_chain_plain(a, b, k: int):
    if a.dtype == torch.float32:
        a64, b64 = a.double(), b.double()
        acc = a
        for _ in range(k):
            acc = (acc.double() * b64 + a64).float()
        return acc
    a64, b64 = a.to(torch.int64) & _U32, b.to(torch.int64) & _U32
    b_lo, b_hi = b64 & 0xFFFF, b64 >> 16
    acc = a64
    for _ in range(k):  # acc * b mod 2^32 from 16-bit halves (no int64 overflow)
        acc = (acc * b_lo + (((acc * b_hi) & 0xFFFF) << 16) + a64) & _U32
    return to_i32(acc)


def vpu_chain(a, b, k: int):
    """K dependent multiply-adds per element of int32 (uint32 bits) or
    float32 tensors a, b of one shape; returns the final acc."""
    if a.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"vpu_chain: int32 or float32, got {a.dtype}")
    if a.device.type == "cpu":
        return vpu_chain_plain(a, b, k)
    fn = "probe_vpu_chain_f32" if a.dtype == torch.float32 else "probe_vpu_chain_u32"
    return _launch("vpu_chain", fn, a.contiguous(), b.contiguous(), int(k))


def copy_add_plain(a, b):
    return to_i32(a.to(torch.int64) + b.to(torch.int64))


def copy_add(a, b):
    """o = a + b on int32 tensors (wrapping, as uint32)."""
    if a.dtype != torch.int32:
        raise TypeError(f"copy_add: int32 limbs, got {a.dtype}")
    if a.device.type == "cpu":
        return copy_add_plain(a, b)
    return _launch("copy_add", "probe_copy_add", a.contiguous(), b.contiguous())
