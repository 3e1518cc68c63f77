"""Batched G1 points over limb tensors (PyTorch).

Port of gemini_tpu/curve/g1.py's point types and conversions.  Points
are structure-of-arrays: Jacobian (X, Y, Z) with each coordinate an
(L, *batch) Fq Montgomery limb tensor, infinity iff Z == 0; affine
points carry an explicit infinity mask.

The group law itself lives in the MSM's projective kernels
(curve/g1_kernels.py); the reference's tape-VM Jacobian formulas exist
only to bound JAX compile time and are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..fields import fp
from ..fields.fp import FQ

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


def is_infinity(p: JPoint):
    return fp.is_zero(S, p.z)


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
