"""R1CS relation frontend (port of gemini_tpu/relation/r1cs.py;
circuit.rs analogue).

An R1CS instance is (A, B, C, z, w, x) with A z o B z = C z and
z = (x, w) (circuit.rs:45-52).  Matrices live as COO triples on the
device (int64 row/col ids + Montgomery limb values) plus the host
triples for verifier-side closed forms.

Instance generators (the same `random.Random` state gives the same
instance as gemini_tpu's):
  * `dummy_r1cs` — the reference's diagonal benchmark instance
    (circuit.rs:349-365): z = (e, ..., e), A = B = C = diag(1/e).
  * `random_r1cs` — a random satisfiable instance: random sparse A, B;
    C diagonal chosen so the relation holds on a random z.
"""

from __future__ import annotations

import random as _random
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve
from ..fields.fp import FR, to_tensor
from ..ops import sparse
from ..params import R


@dataclass
class SparseMatrix:
    """COO sparse matrix over Fr.  Host triples sorted row-major."""

    n_rows: int
    n_cols: int
    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals_int: List[int]  # canonical ints, parallel to rows/cols
    device: torch.device = None
    vals: torch.Tensor = field(init=False, repr=False)  # (L, nnz) Montgomery
    rows_d: torch.Tensor = field(init=False, repr=False)
    cols_d: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.device = resolve(self.device)
        self.vals = FR.tensor(self.vals_int, self.device)
        self.rows_d = torch.from_numpy(self.rows.astype(np.int64)).to(self.device)
        self.cols_d = torch.from_numpy(self.cols.astype(np.int64)).to(self.device)

    @classmethod
    def from_rows(cls, rows_list: Sequence[Sequence[Tuple[int, int]]],
                  n_cols: int, device=None) -> "SparseMatrix":
        """rows_list[i] = [(val, col), ...] — the reference's Matrix<F>
        layout (circuit.rs:42)."""
        rr, cc, vv = [], [], []
        for i, row in enumerate(rows_list):
            for (val, col) in row:
                rr.append(i)
                cc.append(col)
                vv.append(val % R)
        return cls(
            n_rows=len(rows_list),
            n_cols=n_cols,
            rows=np.array(rr, dtype=np.int32).reshape(-1),
            cols=np.array(cc, dtype=np.int32).reshape(-1),
            vals_int=vv,
            device=device,
        )

    def to_rows(self) -> List[List[Tuple[int, int]]]:
        out: List[List[Tuple[int, int]]] = [[] for _ in range(self.n_rows)]
        for r, c, v in zip(self.rows, self.cols, self.vals_int):
            out[int(r)].append((v, int(c)))
        return out

    @property
    def nnz(self) -> int:
        return len(self.vals_int)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """M x; x (L, n_cols) Montgomery -> (L, n_rows)."""
        return sparse.spmv(FR, self.vals, self.rows_d, self.cols_d, x,
                           self.n_rows)

    def rmatvec(self, r: torch.Tensor) -> torch.Tensor:
        """M^T r (= r^T M); r (L, n_rows) Montgomery -> (L, n_cols)."""
        return sparse.rspmv(FR, self.vals, self.rows_d, self.cols_d, r,
                            self.n_cols)

    def matvec_host(self, x: Sequence[int]) -> List[int]:
        out = [0] * self.n_rows
        for r, c, v in zip(self.rows, self.cols, self.vals_int):
            out[int(r)] = (out[int(r)] + v * x[int(c)]) % R
        return out


@dataclass
class R1cs:
    """A z o B z = C z with z = (x, w)."""

    a: SparseMatrix
    b: SparseMatrix
    c: SparseMatrix
    z_int: List[int]
    x_int: List[int]  # public input prefix of z
    device: torch.device = None

    z: torch.Tensor = field(init=False, repr=False)
    w: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.device = resolve(self.device)
        self.z = FR.tensor(self.z_int, self.device)
        self.w = FR.tensor(self.w_int, self.device)

    @property
    def w_int(self) -> List[int]:
        return self.z_int[len(self.x_int):]

    @property
    def num_constraints(self) -> int:
        return self.a.n_rows

    def is_satisfied(self) -> bool:
        za = self.a.matvec_host(self.z_int)
        zb = self.b.matvec_host(self.z_int)
        zc = self.c.matvec_host(self.z_int)
        return all((p * q - r) % R == 0 for p, q, r in zip(za, zb, zc))


def dummy_r1cs(rng: _random.Random, n: int, device=None) -> R1cs:
    """Diagonal instance: z = (e,...,e), A = B = C = diag(e^-1)
    (circuit.rs:349-365).  O(n) generation, satisfiable by design."""
    device = resolve(device)
    e = rng.randrange(1, R)
    inv_e = pow(e, -1, R)
    diag = [[(inv_e, i)] for i in range(n)]
    m = lambda: SparseMatrix.from_rows(diag, n, device)
    return R1cs(a=m(), b=m(), c=m(), z_int=[e] * n, x_int=[e], device=device)


def random_r1cs(rng: _random.Random, num_constraints: int,
                num_inputs: int = 1, row_nnz: int = 3, device=None) -> R1cs:
    """Random satisfiable square instance (n constraints, n variables):
    random sparse A and B, C = diag((Az o Bz) / z) on a random z."""
    device = resolve(device)
    n = num_constraints
    z = [rng.randrange(1, R) for _ in range(n)]

    def rand_matrix():
        rows = []
        for _ in range(n):
            k = rng.randrange(1, row_nnz + 1)
            cols = rng.sample(range(n), k)
            rows.append([(rng.randrange(1, R), c) for c in cols])
        return rows

    a_rows = rand_matrix()
    b_rows = rand_matrix()
    a = SparseMatrix.from_rows(a_rows, n, device)
    b = SparseMatrix.from_rows(b_rows, n, device)
    za = a.matvec_host(z)
    zb = b.matvec_host(z)
    c_rows = [
        [((za[i] * zb[i] % R) * pow(z[i], -1, R) % R, i)] for i in range(n)
    ]
    c = SparseMatrix.from_rows(c_rows, n, device)
    out = R1cs(a=a, b=b, c=c, z_int=z, x_int=z[:num_inputs], device=device)
    assert out.is_satisfied()
    return out


# ---------------------------------------------------------------------------
# Joint sparsity pattern for the preprocessing SNARK (misc.rs:269-366).
# ---------------------------------------------------------------------------


@dataclass
class JointMatrices:
    """Union sparsity of A, B, C in column-major order: field vectors
    row/col (Montgomery, on the relation's device), index vectors (host
    numpy int64, with int64 copies on the device for gathers), and the
    per-matrix value vectors zero-filled on the union pattern."""

    row: torch.Tensor
    col: torch.Tensor
    row_index: np.ndarray
    col_index: np.ndarray
    val_a: torch.Tensor
    val_b: torch.Tensor
    val_c: torch.Tensor
    row_index_d: torch.Tensor = field(repr=False, default=None)
    col_index_d: torch.Tensor = field(repr=False, default=None)

    @property
    def num_non_zero(self) -> int:
        return len(self.row_index)


def joint_matrices(r1cs: R1cs) -> JointMatrices:
    """sum_matrices + joint_matrices (misc.rs:269-366): per column (in
    increasing order), the sorted set of rows where any of A, B, C is
    nonzero; values looked up per matrix with zero fill.

    The union pattern is a numpy unique over packed (col, row) keys; each
    matrix's values are encoded on the host (`FR.encode(vals_int)`),
    scattered onto the union positions, and moved to the device once."""
    from ..subprotocols.plookup import index_to_field

    dev = r1cs.device
    mats = (r1cs.a, r1cs.b, r1cs.c)
    n_rows = max(m.n_rows for m in mats)
    keys = [m.cols.astype(np.int64) * n_rows + m.rows.astype(np.int64)
            for m in mats]
    union = np.unique(np.concatenate(keys))  # sorted: col-major, row asc
    row_index = union % n_rows
    col_index = union // n_rows

    def vals_on_union(m: SparseMatrix, key: np.ndarray) -> torch.Tensor:
        limbs = np.zeros((FR.n_limbs, len(union)), dtype=np.uint32)
        if len(key):
            limbs[:, np.searchsorted(union, key)] = FR.encode(m.vals_int)
        return to_tensor(limbs, dev)

    return JointMatrices(
        row=index_to_field(row_index, dev),
        col=index_to_field(col_index, dev),
        row_index=row_index,
        col_index=col_index,
        val_a=vals_on_union(mats[0], keys[0]),
        val_b=vals_on_union(mats[1], keys[1]),
        val_c=vals_on_union(mats[2], keys[2]),
        row_index_d=torch.from_numpy(row_index).to(dev),
        col_index_d=torch.from_numpy(col_index).to(dev),
    )
