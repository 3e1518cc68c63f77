"""Batched prime-field arithmetic on 16-bit limb tensors (PyTorch).

Port of gemini_tpu/fields/fp.py with the same public layout: a field
vector of N elements is an int32 tensor of shape (n_limbs, *batch),
16-bit little-endian limbs, Montgomery form, normalized (< p, limbs
< 2^16) at API boundaries.  The parity check between the packages is
`np.array_equal` on the limbs.

Arithmetic widens to int64 (torch on the CPU implements neither add,
`>>` nor `>` on uint32).  A 16x16-bit product is < 2^32, so a column
of up to 2^31 products fits and carries are resolved once per op
(`_carry`).  Montgomery multiplication is a schoolbook product
followed by a limb-serial REDC; its result is the unique
(a*b + m*p) / 2^(16L) with m in [0, 2^(16L)), whatever the limb width,
so it agrees bit for bit with the reference's CIOS.

On CUDA, every Fr op (add, sub, neg, mont_mul and what is built on it,
reduce_relaxed, lane_sum, mul_lane_sum) launches a hand-written kernel
(fields/fr_kernels.py) and Fq Montgomery products another
(curve/g1_kernels.py); the `_*_plain` functions below are those
kernels' plain versions, which run on CPU tensors (and for Fq's
additive ops on the card).  `CUDA_CARRIES` counts `_carry` calls on
CUDA tensors by field: with the kernels in place an Fr count stays 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .. import params
from . import fr_kernels

MASK = params.LIMB_MASK
LIMB_BITS = params.LIMB_BITS
I64 = torch.int64
I32 = torch.int32


def _int_to_limbs(x: int, n: int) -> np.ndarray:
    return np.array(
        [(x >> (LIMB_BITS * i)) & params.LIMB_MASK for i in range(n)],
        dtype=np.uint32,
    )


def _numpy(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Static per-field constants, precomputed on host."""

    name: str
    modulus: int
    n_limbs: int
    mont_r: int
    mont_r2: int
    n0inv: int
    mod_limbs: np.ndarray = field(init=False, repr=False)
    r2_limbs: np.ndarray = field(init=False, repr=False)
    one_mont_limbs: np.ndarray = field(init=False, repr=False)
    _consts: dict = field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(
            self, "mod_limbs", _int_to_limbs(self.modulus, self.n_limbs))
        object.__setattr__(
            self, "r2_limbs", _int_to_limbs(self.mont_r2, self.n_limbs))
        object.__setattr__(
            self, "one_mont_limbs", _int_to_limbs(self.mont_r, self.n_limbs))
        object.__setattr__(self, "_consts", {})

    # -- host-side encode/decode (numpy, identical to gemini_tpu) ---------

    def encode(self, values: Sequence[int] | int, mont: bool = True) -> np.ndarray:
        """ints -> (L, N) uint32 limb array (Montgomery form by default)."""
        if isinstance(values, (int, np.integer)):
            values = [int(values)]
        values = list(values)
        if len(values) > 1 and values.count(values[0]) == len(values):
            # one value repeated (the dummy relations): encode it once
            col = self.encode(values[:1], mont)
            return np.ascontiguousarray(
                np.broadcast_to(col, (self.n_limbs, len(values))))
        m = self.modulus
        r = self.mont_r if mont else 1
        nbytes = self.n_limbs * LIMB_BITS // 8
        buf = b"".join(
            ((v % m) * r % m).to_bytes(nbytes, "little") for v in values
        )
        arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), self.n_limbs)
        return np.ascontiguousarray(arr.T).astype(np.uint32)

    def decode(self, arr, mont: bool = True) -> list[int]:
        """(L, *batch) limb array or tensor -> flat list of canonical ints."""
        a = _numpy(arr).astype(np.uint16).reshape(self.n_limbs, -1)
        buf = np.ascontiguousarray(a.T.astype("<u2")).tobytes()
        nbytes = self.n_limbs * LIMB_BITS // 8
        rinv = pow(self.mont_r, -1, self.modulus) if mont else 1
        m = self.modulus
        return [
            int.from_bytes(buf[j * nbytes:(j + 1) * nbytes], "little")
            * rinv % m
            for j in range(a.shape[1])
        ]

    def decode_relaxed(self, arr, mont: bool = True) -> list[int]:
        """Decode limbs that may exceed 16 bits / the modulus (lane-sum
        outputs): full-precision recombination mod p."""
        a = _numpy(arr).astype(np.uint64)
        a = a.reshape(a.shape[0], -1)
        rinv = pow(self.mont_r, -1, self.modulus) if mont else 1
        vals = []
        for j in range(a.shape[1]):
            v = sum(int(a[i, j]) << (LIMB_BITS * i) for i in range(a.shape[0]))
            vals.append(v % self.modulus * rinv % self.modulus)
        return vals

    def tensor(self, values: Sequence[int] | int, device, mont: bool = True):
        """ints -> (L, N) int32 limb tensor on `device`."""
        return to_tensor(self.encode(values, mont), device)

    # -- constants on device ------------------------------------------------

    def const(self, which: str, device) -> torch.Tensor:
        """(L,) int64 limb column of a field constant on `device`
        ("mod", "mod2" = 2p, "one" = Montgomery one, "r2")."""
        device = torch.device(device)
        key = (which, str(device))
        t = self._consts.get(key)
        if t is None:
            src = {
                "mod": self.mod_limbs,
                "mod2": _int_to_limbs(2 * self.modulus, self.n_limbs),
                "one": self.one_mont_limbs,
                "r2": self.r2_limbs,
            }[which]
            t = torch.from_numpy(src.astype(np.int64)).to(device)
            self._consts[key] = t
        return t

    def zeros(self, batch_shape, device) -> torch.Tensor:
        if isinstance(batch_shape, int):
            batch_shape = (batch_shape,)
        return torch.zeros((self.n_limbs, *batch_shape), dtype=I32,
                           device=device)

    def ones_mont(self, batch_shape, device) -> torch.Tensor:
        if isinstance(batch_shape, int):
            batch_shape = (batch_shape,)
        one = _col(self.const("one", device), len(batch_shape))
        return one.to(I32).expand(self.n_limbs, *batch_shape).contiguous()


FQ = FieldSpec(
    "Fq", params.Q, params.FQ_LIMBS, params.FQ_MONT_R, params.FQ_MONT_R2,
    params.FQ_N0INV,
)
FR = FieldSpec(
    "Fr", params.R, params.FR_LIMBS, params.FR_MONT_R, params.FR_MONT_R2,
    params.FR_N0INV,
)


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """numpy limb array (uint32 16-bit limbs) -> int32 tensor on device."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# int64 limb primitives
# ---------------------------------------------------------------------------


def _col(limbs: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """(L,) -> (L, 1, ..., 1) broadcastable against (L, *batch)."""
    return limbs.reshape(limbs.shape[0], *([1] * batch_ndim))


CUDA_CARRIES = {"Fr": 0, "Fq": 0}


def _carry(t: torch.Tensor, spec: FieldSpec):
    """Resolve carries of int64 limbs (E, *batch) of a `spec` value, any
    sign: returns (limbs in [0, 2^16), signed carry out of the top limb).
    A negative carry is a borrow: the limbs then hold the value mod
    2^(16E).

    Whole-tensor passes (split every limb, add each carry one limb up)
    until no limb carries: pass k leaves limb k-1 final, so at most E+1
    passes, and random data settles in three or four.  Each pass reads a
    flag on the host, so on a CUDA tensor the call is counted in
    CUDA_CARRIES."""
    if t.is_cuda:
        CUDA_CARRIES[spec.name] += 1
    x = t
    c = torch.zeros_like(t[0])
    while True:
        hi = x >> LIMB_BITS
        if not bool(hi.any()):
            return x, c
        x = x & MASK
        x[1:] += hi[:-1]
        c = c + hi[-1]


def _cond_sub(spec: FieldSpec, limbs: torch.Tensor) -> torch.Tensor:
    """Normalized value < 2p -> [0, p)."""
    d, c = _carry(limbs - _col(spec.const("mod", limbs.device), limbs.ndim - 1), spec)
    return torch.where((c < 0).unsqueeze(0), limbs, d)


def _mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column sums of the schoolbook product of int64 limb tensors a
    (E, ...) and b (L, ...): (E + L, *batch), unnormalized (each column
    < min(E, L) * 2^32)."""
    E, L = a.shape[0], b.shape[0]
    bshape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    t = torch.zeros((E + L, *bshape), dtype=I64, device=a.device)
    if E <= L:
        for i in range(E):
            t[i:i + L] += a[i] * b
    else:
        for j in range(L):
            t[j:j + E] += a * b[j]
    return t


def _redc(spec: FieldSpec, t: torch.Tensor, e: int) -> torch.Tensor:
    """Montgomery-reduce column sums t (e + L rows, modified in place)
    by 2^(16e): returns the normalized L limbs of (T + m*p) / 2^(16e)
    with the unique m in [0, 2^(16e)), no final subtraction (carries off
    the top are dropped, as in the reference)."""
    L = spec.n_limbs
    q = _col(spec.const("mod", t.device), t.ndim - 1)
    for i in range(e):
        m = (t[i] * spec.n0inv) & MASK
        t[i:i + L] += m.unsqueeze(0) * q
        t[i + 1] += t[i] >> LIMB_BITS
    out, _ = _carry(t[e:e + L], spec)
    return out


def mont_mul_wide(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^(-16E) mod p on int64 limbs, canonical: a (E, ...)
    normalized, b (L, ...) normalized < p."""
    return _cond_sub(spec, _redc(spec, _mul_wide(a, b), a.shape[0]))


def _w(a: torch.Tensor) -> torch.Tensor:
    return a.to(I64)


# ---------------------------------------------------------------------------
# Public ops: (L, *batch) int32 normalized Montgomery tensors.  Fr on a
# CUDA tensor goes to fields/fr_kernels.py; anything else to the plain
# versions.
# ---------------------------------------------------------------------------


def _fr_kernel(spec: FieldSpec, a) -> bool:
    return spec is FR and a.is_cuda


def _add_plain(spec: FieldSpec, a, b):
    s, _ = _carry(_w(a) + _w(b), spec)  # < 2p < 2^(16L): no carry out
    return _cond_sub(spec, s).to(I32)


def _sub_plain(spec: FieldSpec, a, b):
    d, c = _carry(_w(a) - _w(b), spec)
    q = _col(spec.const("mod", d.device), d.ndim - 1)
    fixed, _ = _carry(d + q, spec)  # a - b + p, wrapping the borrow away
    return torch.where((c < 0).unsqueeze(0), fixed, d).to(I32)


def _mont_mul_plain(spec: FieldSpec, a, b):
    return mont_mul_wide(spec, _w(a), _w(b)).to(I32)


def add(spec: FieldSpec, a, b):
    if _fr_kernel(spec, a):
        return fr_kernels.addsub(a, b, False)
    return _add_plain(spec, a, b)


def sub(spec: FieldSpec, a, b):
    if _fr_kernel(spec, a):
        return fr_kernels.addsub(a, b, True)
    return _sub_plain(spec, a, b)


def neg(spec: FieldSpec, a):
    if _fr_kernel(spec, a):
        return sub(spec, a.new_zeros((spec.n_limbs,) + (1,) * (a.ndim - 1)), a)
    return sub(spec, torch.zeros_like(a), a)


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a*b*R^{-1} mod p, elementwise over the batch
    (batch shapes broadcast): a normalized, b below p.  On CUDA, Fq and
    Fr run hand-written kernels; on the CPU this is plain torch."""
    if spec is FQ:
        from ..curve import g1_kernels

        shape = torch.broadcast_shapes(a.shape, b.shape)
        out = g1_kernels.mont_mul(
            a.expand(shape).reshape(spec.n_limbs, -1).contiguous(),
            b.expand(shape).reshape(spec.n_limbs, -1).contiguous())
        return out.reshape(shape)
    if _fr_kernel(spec, a):
        return fr_kernels.mul(a, b)
    return _mont_mul_plain(spec, a, b)


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def reduce_relaxed(spec: FieldSpec, v):
    """Reduce relaxed non-negative limbs (E rows, each < 2^47) into a
    normalized element of [0, p): value-preserving mod p, so relaxed
    sums of Montgomery elements reduce to the Montgomery field sum."""
    if _fr_kernel(spec, v):
        return fr_kernels.reduce(v)
    return _reduce_relaxed_plain(spec, v)


def _reduce_relaxed_plain(spec: FieldSpec, v):
    """Method (the reference's, with three spare limbs for int64 sums):
    carry-propagate to E+3 16-bit limbs, then one Montgomery pass
    against K = 2^(16(E+3)) mod p, which computes
    V * K * 2^(-16(E+3)) = V mod p."""
    v = _w(v)
    ext = torch.cat([v, v.new_zeros((3, *v.shape[1:]))], dim=0)
    limbs, _ = _carry(ext, spec)
    E = limbs.shape[0]
    K = pow(2, LIMB_BITS * E, spec.modulus)
    k = _col(torch.from_numpy(_int_to_limbs(K, spec.n_limbs).astype(np.int64))
             .to(v.device), v.ndim - 1)
    return mont_mul_wide(spec, limbs, k).to(I32)


def to_mont(spec: FieldSpec, a):
    r2 = _col(spec.const("r2", a.device), a.ndim - 1).to(I32)
    return mont_mul(spec, a, r2)


def from_mont(spec: FieldSpec, a):
    one = torch.zeros((spec.n_limbs,) + (1,) * (a.ndim - 1), dtype=I32,
                      device=a.device)
    one[0] = 1
    return mont_mul(spec, a, one)


def pow_fixed(spec: FieldSpec, a, exponent: int):
    """a^exponent (Montgomery in/out) for a Python-int exponent:
    square-and-multiply over the exponent bits, LSB first."""
    result = spec.ones_mont(a.shape[1:], a.device)
    if exponent == 0:
        return result
    base = a
    for i in range(exponent.bit_length()):
        if (exponent >> i) & 1:
            result = mont_mul(spec, result, base)
        if i + 1 < exponent.bit_length():
            base = mont_sqr(spec, base)
    return result


def inv(spec: FieldSpec, a):
    """Batched inversion via Fermat (a^(p-2)); inverse of 0 is 0."""
    return pow_fixed(spec, a, spec.modulus - 2)


def lane_sum(spec: FieldSpec, a, axis: int = 1):
    """Sum of field elements along a batch axis WITHOUT modular
    reduction: (L+2, *rest) int32 limbs of the exact integer sum of the
    Montgomery limb values (16-bit normalized; the two extra limbs hold
    the overflow) — the same limbs as the reference's lane_sum.  Decode
    on host with `decode_relaxed`."""
    if _fr_kernel(spec, a):
        return fr_kernels.lane_sum(a, axis)
    return _lane_sum_plain(spec, a, axis)


def _lane_sum_plain(spec: FieldSpec, a, axis: int = 1):
    assert axis >= 1
    s = _w(a).sum(dim=axis)
    s = torch.cat([s, s.new_zeros((2, *s.shape[1:]))], dim=0)
    limbs, _ = _carry(s, spec)
    return limbs.to(I32)


def mul_lane_sum(spec: FieldSpec, a, b, axis: int = 1):
    """lane_sum(spec, mont_mul(spec, a, b), axis): on CUDA (Fr) one
    kernel pass that never writes the products."""
    if _fr_kernel(spec, a):
        return fr_kernels.lane_sum(a, axis, b)
    return lane_sum(spec, mont_mul(spec, a, b), axis)


def is_zero(spec: FieldSpec, a):
    """Boolean mask over the batch: element == 0 (normalized input)."""
    return (a == 0).all(dim=0)


def eq(spec: FieldSpec, a, b):
    return (a == b).all(dim=0)


def select(mask, a, b):
    """Elementwise select over the batch: mask ? a : b (mask: batch-shaped)."""
    return torch.where(mask.unsqueeze(0), a, b)
