"""The sumcheck round's Fr kernels, hand-written for Hopper.

The time prover's round (subprotocols/sumcheck.py) on the card:

  message     <- gemini_tpu/subprotocols/sumcheck.py `_round_message_kernel`
                 (:77-114): the round's (a, b) as a (2, 18) int32 tensor
  fused_round <- `_fused_round_body` (:117-127): fold f, g by the
                 challenge and the next round's (a, b), one launch
  fold        <- `_fold_kernel` (:186-202): the terminal fold, no message

The reference has no Pallas kernel there (XLA fuses the round).  The
kernels are CUDA C++ (csrc/sumcheck_kernels.cu, csrc/fr.cuh), compiled
with nvcc for sm_90a at first use into `_build/` and bound with ctypes;
their plain versions are subprotocols/sumcheck.py's `_round_message_plain`,
`_fused_round_plain` and `_fold_plain`, which they equal bit for bit.
The dispatching functions there take the plain versions only for CPU
tensors; these wrappers launch or raise.

Operands are (16, lanes) int32 canonical Montgomery limbs, read through
their (limb, lane) strides, views included; outputs are contiguous.
Scalars are canonical Python ints, passed by value in Montgomery form.
(a, b) is each an 18-limb carry-normalized exact sum, as fp.lane_sum
returns it.  The launches on one device share a scratch buffer and a
ticket that the last block resets, so they must run in stream order:
every launch goes on the current stream.

`LAUNCHES` counts kernel launches and `LANES` the input lanes they
covered (the plain path counts neither).
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_lib
from ..fields.fp import FR, I32

L = FR.n_limbs  # 16
MSG_LIMBS = L + 2

LAUNCHES = {"sc_message": 0, "sc_fused": 0, "sc_fold": 0}
LANES = dict.fromkeys(LAUNCHES, 0)

_MAX_PAIRS = 1 << 31  # u64 word sums and 18 limbs hold the exact sum below this
_Desc = ctypes.c_longlong * 9  # f, g, t x (pointer, limb stride, lane stride)
_scratch: dict = {}  # device -> (u64 partials, u32 ticket)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LANES[k] = 0


def _bind(lib):
    p, n = ctypes.c_void_p, ctypes.c_longlong
    lib.sc_max_partials.argtypes = []
    lib.sc_message.argtypes = [p, p, n, p, p, n, p, p]
    lib.sc_fused.argtypes = [p, p, n, p, p, p, p, n, p, p]
    lib.sc_fold.argtypes = [p, p, n, p, p, p]
    for fn in (lib.sc_max_partials, lib.sc_message, lib.sc_fused, lib.sc_fold):
        fn.restype = ctypes.c_int


def _lib():
    return cuda_lib.library("sumcheck_kernels", _bind)


def _words(*values: int):
    """Montgomery form of canonical ints, 8 little-endian u32 words each."""
    words = []
    for x in values:
        m = x % FR.modulus * FR.mont_r % FR.modulus
        words.extend((m >> (32 * k)) & 0xFFFFFFFF for k in range(8))
    return (ctypes.c_uint32 * len(words))(*words)


def _check(name, f, g, t=None):
    """f, g: (16, n) int32 on one CUDA device, n even; t (when given):
    (16, >= n / 2) int32 there.  Returns (device, n)."""
    dev = f.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel launch needs CUDA tensors, got {dev}")
    for what, x in (("f", f), ("g", g), ("t", t)):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name}: {what} on {x.device}, f on {dev}")
        if x.dtype != I32:
            raise TypeError(f"{name}: {what} must be int32, got {x.dtype}")
        if x.ndim != 2 or x.shape[0] != L:
            raise ValueError(f"{name}: {what} must be ({L}, lanes), got "
                             f"{tuple(x.shape)}")
    n = f.shape[1]
    if g.shape[1] != n or n % 2:
        raise ValueError(f"{name}: f {tuple(f.shape)} and g {tuple(g.shape)} must "
                         "have one even lane count")
    if t is not None and t.shape[1] < n // 2:
        raise ValueError(f"{name}: t has {t.shape[1]} lanes, needs {n // 2}")
    return dev, n


def _desc(f, g, t):
    out = []
    for x in (f, g, t if t is not None else f):
        out.extend((x.data_ptr(), x.stride(0), x.stride(1)))
    return _Desc(*out)


def _scratch_for(dev, lib):
    s = _scratch.get(dev)
    if s is None:
        s = (torch.empty(lib.sc_max_partials(), dtype=torch.int64, device=dev),
             torch.zeros(1, dtype=I32, device=dev))
        _scratch[dev] = s
    return s


def _run(name, dev, fn, *args):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def message(f, g, t, twist: int) -> torch.Tensor:
    """(2, 18) int32 (a, b) of the round over f, g (n lanes) and the
    twist powers t (n / 2 lanes)."""
    dev, n = _check("sc_message", f, g, t)
    pairs = n // 2
    if pairs >= _MAX_PAIRS:
        raise ValueError(f"sc_message: {pairs} pairs, at most 2^31 - 1")
    lib = _lib()
    partials, ticket = _scratch_for(dev, lib)
    out = torch.empty((2, MSG_LIMBS), dtype=I32, device=dev)
    _run("sc_message", dev, lib.sc_message, _desc(f, g, t), _words(twist), pairs,
         out.data_ptr(), partials.data_ptr(), partials.numel(), ticket.data_ptr())
    LAUNCHES["sc_message"] += 1
    LANES["sc_message"] += n
    return out


def fused_round(f, g, t, r: int, r_twist: int, twist_next: int):
    """Fold f by r_twist and g by r, and the next round's (a, b) with
    twist_next over the folded vectors and t[:, 0::2]: returns
    (f2, g2, t[:, 0::2], ab).  n lanes in, a multiple of 4."""
    dev, n = _check("sc_fused", f, g, t)
    if n % 4:
        raise ValueError(f"sc_fused: {n} lanes, a multiple of 4 needed")
    pairs = n // 4
    if pairs >= _MAX_PAIRS:
        raise ValueError(f"sc_fused: {pairs} pairs, at most 2^31 - 1")
    lib = _lib()
    partials, ticket = _scratch_for(dev, lib)
    f2 = torch.empty((L, n // 2), dtype=I32, device=dev)
    g2 = torch.empty((L, n // 2), dtype=I32, device=dev)
    out = torch.empty((2, MSG_LIMBS), dtype=I32, device=dev)
    _run("sc_fused", dev, lib.sc_fused, _desc(f, g, t),
         _words(r, r_twist, twist_next), pairs, f2.data_ptr(), g2.data_ptr(),
         out.data_ptr(), partials.data_ptr(), partials.numel(), ticket.data_ptr())
    LAUNCHES["sc_fused"] += 1
    LANES["sc_fused"] += n
    return f2, g2, t[:, 0::2], out


def fold(f, g, r: int, r_twist: int):
    """f2[k] = f[2k] + r_twist f[2k+1], g2[k] = g[2k] + r g[2k+1]."""
    dev, n = _check("sc_fold", f, g)
    f2 = torch.empty((L, n // 2), dtype=I32, device=dev)
    g2 = torch.empty((L, n // 2), dtype=I32, device=dev)
    _run("sc_fold", dev, _lib().sc_fold, _desc(f, g, None), _words(r, r_twist),
         n // 2, f2.data_ptr(), g2.data_ptr())
    LAUNCHES["sc_fold"] += 1
    LANES["sc_fold"] += n
    return f2, g2
