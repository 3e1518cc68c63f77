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

A message or fused launch takes the shape `launch_shape` picks: a
pair to two lanes in every fused round and in a small message round, a
pair to a lane in a larger message round; 128-thread blocks, one unit a
thread, while they fit one per SM, else 256-thread blocks and never
more than the card holds at once (the SM count and the occupancy API's
resident blocks per SM, read once per device).

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

SMALL_THREADS, LARGE_THREADS = 128, 256  # a block of a small round, of a large one

_MAX_PAIRS = 1 << 31  # 288-bit sums and 18 limbs hold the exact sum below this
_MAX_BLOCKS = 4096  # csrc/sumcheck_kernels.cu kMaxBlocks
_KERNEL_ID = {"sc_message": 0, "sc_fused": 1}
_Desc = ctypes.c_longlong * 9  # f, g, t x (pointer, limb stride, lane stride)
_scratch: dict = {}  # device -> (u32 partials, u32 ticket)
_shapes: dict = {}  # device -> (SM count, {kernel: {split: {threads: blocks per SM}}})


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LANES[k] = 0


def _bind(lib):
    p, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sc_max_partials.argtypes = []
    lib.sc_occupancy.argtypes = [i, i, i, i, p, p, p]
    lib.sc_message.argtypes = [p, p, n, i, i, i, p, p, n, p, p]
    lib.sc_fused.argtypes = [p, p, n, i, i, p, p, p, p, n, p, p]
    lib.sc_fold.argtypes = [p, p, n, p, p, p]
    for fn in (lib.sc_max_partials, lib.sc_occupancy, lib.sc_message, lib.sc_fused,
               lib.sc_fold):
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
        s = (torch.empty(lib.sc_max_partials(), dtype=I32, device=dev),
             torch.zeros(1, dtype=I32, device=dev))
        _scratch[dev] = s
    return s


def occupancy(name: str, vec: bool, split: bool, threads: int, device=None) -> dict:
    """Round kernel `name` (sc_message or sc_fused), the instance with
    vector loads or scalar ones, a pair to a lane or to two: resident
    blocks per SM at `threads` a block (the occupancy API), registers and
    local (spill) bytes per thread, on `device` (default the current
    card)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    lib = _lib()
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(dev):
        err = lib.sc_occupancy(_KERNEL_ID[name], int(vec), int(split), threads,
                               *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"{name}: occupancy query failed (cudaError {err})")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes"),
                    (v.value for v in vals)))


def launch_shape(name: str, pairs: int, sms: int, resident: dict) -> tuple:
    """(split, threads, blocks) of a launch of round kernel `name` over
    `pairs` pairs on a card of `sms` SMs, where resident[split][threads]
    is the kernel's resident blocks per SM.  The fused round always gives
    a pair to two lanes; the message does while those lanes fit one
    128-thread block per SM (a small round, whose chain of products then
    halves), else one lane a pair.  Up to one 128-thread block per SM
    (one warp a scheduler: the latency of one unit) the launch takes
    128-thread blocks, one unit a thread; beyond, 256-thread blocks, and
    no more than the card holds at once (the kernels walk the units in a
    grid-stride loop)."""
    split = name == "sc_fused" or 2 * pairs <= SMALL_THREADS * sms
    return (split, *unit_grid(2 * pairs if split else pairs, sms, resident[split]))


def unit_grid(units: int, sms: int, resident: dict) -> tuple:
    """(threads, blocks) for `units` units of one thread each, with
    resident[threads] blocks per SM (launch_shape's rule)."""
    threads = SMALL_THREADS if units <= SMALL_THREADS * sms else LARGE_THREADS
    blocks = min(-(-units // threads), resident[threads] * sms, _MAX_BLOCKS)
    return threads, max(1, blocks)


def _shape(dev, name: str, pairs: int) -> tuple:
    """launch_shape on `dev`, its SM count and resident blocks read once
    (the fewer of each kernel's two load instances)."""
    s = _shapes.get(dev)
    if s is None:
        resident = {k: {sp: {t: min(occupancy(k, v, sp, t, dev)["blocks_per_sm"]
                                    for v in (False, True))
                             for t in (SMALL_THREADS, LARGE_THREADS)}
                        for sp in (False, True)} for k in _KERNEL_ID}
        s = _shapes[dev] = (torch.cuda.get_device_properties(dev).multi_processor_count,
                            resident)
    sms, resident = s
    return launch_shape(name, pairs, sms, resident[name])


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
         *_shape(dev, "sc_message", pairs), out.data_ptr(), partials.data_ptr(),
         partials.numel(), ticket.data_ptr())
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
         _words(r, r_twist, twist_next), pairs, *_shape(dev, "sc_fused", pairs)[1:],
         f2.data_ptr(), g2.data_ptr(), out.data_ptr(), partials.data_ptr(),
         partials.numel(), ticket.data_ptr())
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
