"""Plookup helpers (port of gemini_tpu/subprotocols/plookup.py;
Gabizon-Williamson, subprotocols/plookup).

Reduces the lookup claim "subset = set[index]" to three grand products
over randomized vectors (time_prover.rs:89-113):

    set'    : y(1+z) + w_i + z·w_{i+1}         (with head/tail terms)
    subset' : f*_i + y
    sorted' : the set merged with lookup multiplicities

satisfying  ∏sorted' = ∏set' · ∏subset' · (1+z)^|subset|.

Position binding uses the algebraic hash v_i + ζ·i (time_prover.rs:11).

The randomized vectors are elementwise device ops plus one-lane
concatenations on the vectors' device; multiplicity bookkeeping
(frequency, sorted merge) is O(N) integer work in host numpy; gathers
take int64 index tensors on the device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..fields import fp
from ..fields.fp import FR, to_tensor
from ..ops import poly
from ..params import R


def lookup(v: torch.Tensor, index: Sequence[int]) -> torch.Tensor:
    """v[:, index], a gather on v's device (time_prover.rs:6)."""
    return v[:, torch.from_numpy(np.asarray(index, dtype=np.int64)).to(v.device)]


def index_to_field(index: Sequence[int], device) -> torch.Tensor:
    """Indices (< 2^64) -> (L, n) Montgomery field elements on `device`:
    one numpy limb array (4 x 16 bits per index), one to_mont."""
    arr = np.asarray(index, dtype=np.uint64)
    limbs = np.zeros((FR.n_limbs, len(arr)), dtype=np.uint32)
    for i in range(4):
        limbs[i] = ((arr >> np.uint64(16 * i)) & np.uint64(0xFFFF)).astype(np.uint32)
    return fp.to_mont(FR, to_tensor(limbs, device))


def alg_hash(v: torch.Tensor, index: Sequence[int], chal: int) -> torch.Tensor:
    """v_i + ζ·index_i (time_prover.rs:11-21)."""
    idx_f = index_to_field(index, v.device)
    return fp.add(FR, v, fp.mont_mul(FR, idx_f, poly.scalar(FR, chal, v.device)))


def plookup_set(v: torch.Tensor, y: int, z: int) -> torch.Tensor:
    """(y(1+z) + z·v_0, {y(1+z) + v_i + z·v_{i+1}}, y(1+z) + v_{n-1})
    (time_prover.rs:23-35)."""
    n = v.shape[1]
    if n == 0:
        return v
    y1z = poly.scalar(FR, (1 + z) * y % R, v.device)
    zs = poly.scalar(FR, z, v.device)
    head = fp.add(FR, y1z, fp.mont_mul(FR, zs, v[:, :1]))
    last = fp.add(FR, y1z, v[:, -1:])
    if n == 1:
        return torch.cat([head, last], dim=1)
    trunk = fp.add(FR, fp.add(FR, y1z.expand(-1, n - 1), v[:, :-1]),
                   fp.mont_mul(FR, zs, v[:, 1:]))
    return torch.cat([head, trunk, last], dim=1)


def plookup_subset(v: torch.Tensor, y: int) -> torch.Tensor:
    ys = poly.scalar(FR, y, v.device)
    return fp.add(FR, v, ys.expand_as(v))


def compute_frequency(set_len: int, index: Sequence[int]) -> np.ndarray:
    """1 + lookup count per set position (time_prover.rs:65-70)."""
    idx = np.asarray(index, dtype=np.int64)
    return 1 + np.bincount(idx, minlength=set_len).astype(np.int64)


def extend_frequency(frequency: np.ndarray) -> np.ndarray:
    """(i repeated frequency[i] times) (time_prover.rs:72-79)."""
    return np.repeat(np.arange(len(frequency), dtype=np.int64), frequency)


def sorted_vector(set_v: torch.Tensor, frequency: np.ndarray) -> torch.Tensor:
    """Each set element repeated by its multiplicity: a gather by the
    extended-frequency addresses (time_prover.rs:81-87)."""
    return lookup(set_v, extend_frequency(frequency))


def plookup(subset: torch.Tensor, set_v: torch.Tensor,
            index: Sequence[int], y: int, z: int,
            zeta: int) -> List[torch.Tensor]:
    """The three grand-product vectors (time_prover.rs:89-113)."""
    if zeta % R != 0:
        set_h = alg_hash(set_v, range(set_v.shape[1]), zeta)
        subset_h = alg_hash(subset, index, zeta)
    else:
        set_h, subset_h = set_v, subset
    lookup_set = plookup_set(set_h, y, z)
    lookup_subset = plookup_subset(subset_h, y)
    frequency = compute_frequency(set_v.shape[1], index)
    sorted_v = sorted_vector(set_h, frequency)
    lookup_sorted = plookup_set(sorted_v, y, z)
    return [lookup_set, lookup_subset, lookup_sorted]
