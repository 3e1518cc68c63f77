"""Carry state from gemini_tpu into the port.

Functions here take the JAX package's arrays as numpy (and host ints
and points, which both packages share as plain Python values) and build
the port's objects, so that both packages prove against the same SRS
and the same relation.  Nothing here imports gemini_tpu: the caller
converts with `np.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve.g1 import APoint
from .device import resolve
from .fields.fp import to_tensor
from .kzg.commit import CommitterKey
from .refimpl.fields import Fq2
from .relation.r1cs import R1cs, SparseMatrix


def g2_point(p):
    """A host G2 point ((x.c0, x.c1), (y.c0, y.c1) field objects with an
    integer `.n`, or None) as the port's refimpl Fq2 pair."""
    if p is None:
        return None
    x, y = p
    return (Fq2(x.c0.n, x.c1.n), Fq2(y.c0.n, y.c1.n))


def committer_key(powers_x: np.ndarray, powers_y: np.ndarray,
                  powers_inf: np.ndarray, powers_of_g2, tau=None,
                  device=None) -> CommitterKey:
    """A CommitterKey from gemini_tpu's `powers_of_g.x`, `.y`, `.inf`
    (numpy limb arrays / bool mask) and its host G2 powers."""
    dev = resolve(device)
    inf = np.array(powers_inf, dtype=bool)  # a writable copy
    g = APoint(to_tensor(powers_x, dev), to_tensor(powers_y, dev),
               torch.from_numpy(inf).to(dev))
    return CommitterKey(g, [g2_point(q) for q in powers_of_g2], tau=tau)


def sparse_matrix(n_rows: int, n_cols: int, rows: np.ndarray,
                  cols: np.ndarray, vals_int, device=None) -> SparseMatrix:
    """A SparseMatrix from COO triples (host rows, cols, canonical ints)."""
    return SparseMatrix(n_rows, n_cols, np.asarray(rows, dtype=np.int32),
                        np.asarray(cols, dtype=np.int32), list(vals_int),
                        device=device)


def r1cs(a, b, c, z_int, x_int, device=None) -> R1cs:
    """An R1cs from three (n_rows, n_cols, rows, cols, vals_int) COO
    tuples plus z and the public-input prefix x (canonical ints)."""
    dev = resolve(device)
    mats = [sparse_matrix(*m, device=dev) for m in (a, b, c)]
    return R1cs(*mats, z_int=list(z_int), x_int=list(x_int), device=dev)
