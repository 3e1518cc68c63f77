"""Batched G1 points over limb tensors (PyTorch).

Port of gemini_tpu/curve/g1.py.  Points are structure-of-arrays:
Jacobian (X, Y, Z) with each coordinate an (L, *batch) Fq Montgomery
limb tensor, infinity iff Z == 0; affine points carry an explicit
infinity mask.

The Jacobian group law (`add`, `double`) is one launch of the
hand-written kernels `add` / `dbl` (curve/g1_kernels.py) on CUDA
tensors and their plain versions on CPU tensors; the reference's tape
VM and flat formulas exist only to bound JAX compile time and are not
ported.  Every op is canonical, so the limbs equal the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields import fp
from ..fields.fp import FQ
from . import g1_kernels

S = FQ  # field spec for coordinates


class JPoint(NamedTuple):
    """Jacobian point batch; coords (L, *batch) int32 Montgomery."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class APoint(NamedTuple):
    """Affine point batch with explicit infinity mask (*batch,) bool."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor


def infinity(batch_shape, device) -> JPoint:
    z = S.zeros(batch_shape, device)
    return JPoint(S.ones_mont(batch_shape, device),
                  S.ones_mont(batch_shape, device), z)


def is_infinity(p: JPoint):
    return fp.is_zero(S, p.z)


def select_point(mask, a: JPoint | APoint, b: JPoint | APoint):
    """mask ? a : b, elementwise over the batch."""
    if isinstance(a, JPoint):
        return JPoint(fp.select(mask, a.x, b.x), fp.select(mask, a.y, b.y),
                      fp.select(mask, a.z, b.z))
    return APoint(fp.select(mask, a.x, b.x), fp.select(mask, a.y, b.y),
                  torch.where(mask, a.inf, b.inf))


def double(p: JPoint) -> JPoint:
    """dbl-2009-l (2M + 5S).  Maps infinity to infinity and 2-torsion
    (y = 0) to infinity via z3 = 2 y z."""
    return JPoint(*g1_kernels.double(p))


def add(p: JPoint, q: JPoint) -> JPoint:
    """Complete Jacobian addition (add-2007-bl + doubling fallback +
    identity selects)."""
    return JPoint(*g1_kernels.add(p, q))


def add_mixed(p: JPoint, q: APoint) -> JPoint:
    """Complete mixed addition: add(p, from_affine(q)), the reference's
    kernel branch; equal limb for limb to its madd-2007-bl, since every
    op is canonical."""
    return add(p, from_affine(q))


def neg(p: JPoint) -> JPoint:
    return JPoint(p.x, fp.neg(S, p.y), p.z)


def to_affine(p: JPoint) -> APoint:
    """Batch normalization: x = X/Z^2, y = Y/Z^3 (Fermat inversion; on
    CUDA every Montgomery product is the mont_mul kernel)."""
    zinv = fp.inv(S, p.z)
    zinv2 = fp.mont_sqr(S, zinv)
    zinv3 = fp.mont_mul(S, zinv2, zinv)
    return APoint(fp.mont_mul(S, p.x, zinv2), fp.mont_mul(S, p.y, zinv3),
                  is_infinity(p))


def from_affine(a: APoint) -> JPoint:
    dev = a.x.device
    one = S.ones_mont(a.x.shape[1:], dev)
    z = fp.select(a.inf, S.zeros(a.x.shape[1:], dev), one)
    return JPoint(a.x, a.y, z)


def scalar_mul(p: JPoint, k_bits) -> JPoint:
    """Per-element scalar multiplication; k_bits is a (nbits, *batch)
    bool tensor, LSB first.  Double-and-add, one add and one double
    launch per bit."""
    acc, base = infinity(p.x.shape[1:], p.x.device), p
    for bits in k_bits:
        acc = select_point(bits, add(acc, base), acc)
        base = double(base)
    return acc


# ---------------------------------------------------------------------------
# Host <-> device conversion (setup and readback paths)
# ---------------------------------------------------------------------------


def encode_affine(points, device) -> APoint:
    """List of refimpl affine points (or None) -> APoint batch on device."""
    xs, ys, infs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(0)
            infs.append(True)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            infs.append(False)
    return APoint(S.tensor(xs, device), S.tensor(ys, device),
                  torch.from_numpy(np.array(infs, dtype=bool)).to(device))


def decode_affine(a: APoint):
    """APoint batch -> list of refimpl affine points."""
    xs = S.decode(a.x)
    ys = S.decode(a.y)
    infs = a.inf.detach().cpu().numpy().reshape(-1)
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def decode_jacobian(p: JPoint):
    """JPoint batch -> list of refimpl affine points, normalized on the
    host (a readback path: O(batch) Python inversions)."""
    q = S.modulus
    out = []
    for x, y, z in zip(S.decode(p.x), S.decode(p.y), S.decode(p.z)):
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, q)
        zi2 = zi * zi % q
        out.append((x * zi2 % q, y * zi2 % q * zi % q))
    return out
