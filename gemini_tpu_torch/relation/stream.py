"""Streaming R1CS sources (port of gemini_tpu/relation/stream.py;
circuit.rs:26-40 `R1csStream` + iterable/dummy.rs:220-238
`dummy_r1cs_stream` analogues).

The elastic SNARK prover reads relations through this interface, so
giant synthetic instances never materialize: the dummy diagonal
instance generates every vector it needs as an O(1)-memory
`VirtualHostVector` whose blocks are made on the device, and the
challenge-tensor contraction A^T r_a + η B^T r_b + η² C^T r_c has a
closed form for diagonal matrices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..device import resolve
from ..fields import fp
from ..fields.fp import FR
from ..ops import poly
from ..ops import scan as scan_util
from ..ops.sparse import segment_sum_field
from ..params import R
from ..streaming.host import (
    HostVector, VirtualHostVector, from_device_limbs, to_device_limbs)
from .r1cs import R1cs, SparseMatrix


@dataclass
class JointStream:
    """Union-sparsity joint matrices through the stream interface (the
    JointVal/Row/ColStream family, psnark/streams/val_stream.rs:8-551):
    index vectors as host numpy int64, field-encoded row/col and
    per-matrix value vectors as (possibly virtual) HostVectors."""

    row_index: np.ndarray
    col_index: np.ndarray
    row: HostVector  # field-encoded row indices
    col: HostVector
    val_a: HostVector
    val_b: HostVector
    val_c: HostVector

    @property
    def num_non_zero(self) -> int:
        return len(self.row_index)


def _index_field_hv(idx: np.ndarray, device, block_size: int = 1 << 20
                    ) -> HostVector:
    """Host int64 indices -> field-encoded HostVector, blockwise on
    `device`."""
    from ..subprotocols.plookup import index_to_field

    out = np.zeros((FR.n_limbs, len(idx)), dtype=np.uint32)
    for off in range(0, len(idx), block_size):
        blk = idx[off: off + block_size]
        out[:, off: off + len(blk)] = from_device_limbs(index_to_field(blk, device))
    return HostVector(out, device=device)


class DenseR1csStream:
    """A dense `R1cs` through the stream interface; the challenge
    contraction uses the device's transposed spmv."""

    def __init__(self, r1cs: R1cs):
        self.r1cs = r1cs
        self.z_a = HostVector.from_device(r1cs.a.matvec(r1cs.z))
        self.z_b = HostVector.from_device(r1cs.b.matvec(r1cs.z))
        self.z_c = HostVector.from_device(r1cs.c.matvec(r1cs.z))
        self.z = HostVector.from_device(r1cs.z)
        self.w = HostVector.from_device(r1cs.w)
        self.x_int = r1cs.x_int

    def joint(self) -> JointStream:
        from .r1cs import joint_matrices

        jm = joint_matrices(self.r1cs)
        return JointStream(
            row_index=jm.row_index, col_index=jm.col_index,
            row=HostVector.from_device(jm.row), col=HostVector.from_device(jm.col),
            val_a=HostVector.from_device(jm.val_a),
            val_b=HostVector.from_device(jm.val_b),
            val_c=HostVector.from_device(jm.val_c),
        )

    def abc_tensored(self, challenges: List[int], alpha: int, eta: int,
                     block_size: int) -> HostVector:
        """A^T r_a + η B^T r_b + η² C^T r_c with r_b = ⊗(1,ρ),
        r_c = powers(α), r_a = r_b ∘ r_c (snark/time_prover.rs:63-81)."""
        r1cs = self.r1cs
        dev = r1cs.device
        b_challenges = poly.tensor_device(FR, challenges, dev)
        c_challenges = poly.powers(FR, alpha, b_challenges.shape[1], dev)
        a_challenges = fp.mont_mul(FR, b_challenges, c_challenges)
        abc = fp.add(FR, r1cs.a.rmatvec(a_challenges), fp.add(
            FR,
            fp.mont_mul(FR, r1cs.b.rmatvec(b_challenges), poly.scalar(FR, eta, dev)),
            fp.mont_mul(FR, r1cs.c.rmatvec(c_challenges),
                        poly.scalar(FR, eta * eta % R, dev))))
        return HostVector.from_device(abc)


class DummyR1csStream:
    """O(1)-memory diagonal instance: z = (e, ..., e),
    A = B = C = diag(1/e) (circuit.rs:349-365 `dummy_r1cs` as a stream,
    iterable/dummy.rs:220-238).  (Az)_i (Bz)_i = 1·1 = (Cz)_i.  Every
    vector is a `VirtualHostVector` generated on `device` (default the
    card)."""

    def __init__(self, n: int, e: int, device=None):
        assert e % R != 0
        self.n = n
        self.e = e % R
        self.device = resolve(device)
        ones = VirtualHostVector.constant(1, n, device=self.device)
        self.z_a = ones
        self.z_b = ones
        self.z_c = ones
        self.z = VirtualHostVector.constant(self.e, n, device=self.device)
        self.w = VirtualHostVector.constant(self.e, n - 1, device=self.device)
        self.x_int = [self.e]

    def joint(self) -> JointStream:
        """Diagonal union sparsity: n entries at (i, i), every value 1/e.
        The row/col field vectors are an iota made into limb planes and
        Montgomery form on the device (n < 2^32: two limbs)."""
        n, dev = self.n, self.device
        idx = np.arange(n, dtype=np.int64)

        def gen_dev(start: int, end: int):
            i = torch.arange(start, end, dtype=torch.int64, device=dev)
            limbs = FR.zeros((end - start,), dev)
            limbs[0] = (i & 0xFFFF).to(torch.int32)
            limbs[1] = ((i >> 16) & 0xFFFF).to(torch.int32)
            return fp.to_mont(FR, limbs)

        def gen(start: int, end: int) -> np.ndarray:
            return from_device_limbs(gen_dev(start, end))

        diag_field = VirtualHostVector(n, gen, device_fn=gen_dev, device=dev)
        val = VirtualHostVector.constant(pow(self.e, -1, R), n, device=dev)
        return JointStream(row_index=idx, col_index=idx, row=diag_field,
                           col=diag_field, val_a=val, val_b=val, val_c=val)

    def to_dense(self) -> R1cs:
        """The same relation as an `R1cs` on the stream's device, the
        one `dummy_r1cs` builds for this e (for verification).  A, B and
        C are one shared matrix: one host encoding of n values instead
        of three."""
        n = self.n
        diag = np.arange(n, dtype=np.int32)
        m = SparseMatrix(n, n, diag, diag, [pow(self.e, -1, R)] * n,
                         device=self.device)
        return R1cs(a=m, b=m, c=m, z_int=[self.e] * n, x_int=[self.e],
                    device=self.device)

    def abc_tensored(self, challenges: List[int], alpha: int, eta: int,
                     block_size: int) -> VirtualHostVector:
        """diag(1/e)^T r = (1/e)·r for each matrix, so the combination
        is (1/e)(r_a + η r_b + η² r_c) truncated to n, generated per
        block on the device from the tensor and power closed forms and
        made anew on each streaming pass."""
        from ..streaming.ops import powers_block_dev, tensor_block_dev

        dev = self.device
        inv_e = pow(self.e, -1, R)
        c0, c1, c2 = (poly.scalar(FR, c * inv_e % R, dev)
                      for c in (1, eta, eta * eta))

        def device_fn(start: int, end: int):
            t = tensor_block_dev(challenges, start, end, dev)
            p = powers_block_dev(alpha, start, end, dev)
            return fp.add(FR, fp.mont_mul(FR, fp.mont_mul(FR, t, p), c0),
                          fp.add(FR, fp.mont_mul(FR, t, c1),
                                 fp.mont_mul(FR, p, c2)))

        def fn(start: int, end: int):
            return from_device_limbs(device_fn(start, end))

        return VirtualHostVector(self.n, fn, device_fn=device_fn, device=dev)


class HostR1csStream:
    """Host-RAM sparse relation: COO triples and z live in host memory
    and every device interaction is a bounded block (circuit.rs:26-40,
    snark/streams.rs:11-103).  Blocks of COO triples visit the device,
    multiply against tensor/power values generated at their row indices
    (streaming/ops tensor_at/powers_at) and segment-sum into per-matrix
    host outputs.  For relations beyond device memory but within host
    RAM; blocks go to `device` (default the card)."""

    def __init__(self, a, b, c, z_limbs: np.ndarray, x_int: List[int],
                 block_size: int = 1 << 20, device=None):
        """a, b, c: (n_rows, n_cols, rows, cols, vals_limbs) host COO
        tuples, rows/cols int64 numpy, vals (L, nnz) uint32 Montgomery."""
        self._mats = [a, b, c]
        self.block_size = block_size
        self.device = resolve(device)
        self.z = HostVector(z_limbs, device=self.device)
        self.x_int = list(x_int)
        self.w = HostVector(np.ascontiguousarray(z_limbs[:, len(x_int):]),
                            device=self.device)
        self.z_a = self._matvec(a)
        self.z_b = self._matvec(b)
        self.z_c = self._matvec(c)

    @classmethod
    def from_r1cs(cls, r1cs: R1cs, block_size: int = 1 << 20) -> "HostR1csStream":
        def coo(m):
            return (m.n_rows, m.n_cols, m.rows.astype(np.int64),
                    m.cols.astype(np.int64), FR.encode(m.vals_int))

        return cls(coo(r1cs.a), coo(r1cs.b), coo(r1cs.c), FR.encode(r1cs.z_int),
                   r1cs.x_int, block_size, device=r1cs.device)

    @staticmethod
    def _row_aligned_cuts(keys: np.ndarray, block: int) -> List[int]:
        """nnz cut points about `block` apart, moved back to key
        boundaries so that no segment spans two blocks."""
        cuts = [0]
        nnz = len(keys)
        while cuts[-1] < nnz:
            t = min(cuts[-1] + block, nnz)
            if t < nnz:
                t = int(np.searchsorted(keys, keys[t], side="left"))
                if t <= cuts[-1]:  # one giant segment: take it whole
                    t = int(np.searchsorted(keys, keys[t], side="right"))
            cuts.append(t)
        return cuts

    def _segment_blocks(self, seg_keys, other, vals, block: int, out_len: int,
                        products) -> HostVector:
        """out[k] = sum over the entries with seg_keys == k of
        products(vals block, other-index block), block by block over
        row-aligned cuts of the sorted seg_keys.  Padding lanes carry
        zero values, so they add nothing."""
        dev = self.device
        out = np.zeros((FR.n_limbs, out_len), dtype=np.uint32)
        cuts = self._row_aligned_cuts(seg_keys, block)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            k_lo, k_hi = int(seg_keys[lo]), int(seg_keys[hi - 1]) + 1
            span = k_hi - k_lo
            npad = scan_util.bucket4(hi - lo, floor=256)
            spad = scan_util.bucket4(span, floor=256)
            seg = np.full((npad,), spad - 1, dtype=np.int64)
            seg[: hi - lo] = seg_keys[lo:hi] - k_lo
            v = np.zeros((FR.n_limbs, npad), dtype=np.uint32)
            v[:, : hi - lo] = vals[:, lo:hi]
            oth = np.zeros((npad,), dtype=np.int64)
            oth[: hi - lo] = other[lo:hi]
            prods = products(to_device_limbs(v, dev), oth)
            sums = segment_sum_field(FR, prods, torch.from_numpy(seg).to(dev), spad)
            out[:, k_lo:k_hi] = from_device_limbs(sums[:, :span])
        return HostVector(out, device=dev)

    def _matvec(self, m) -> HostVector:
        """M z blockwise (snark/streams.rs:11-103 `matrix_vector`): z
        gathered on the host at the block's columns, device Montgomery
        products and a segment sum per row range."""
        n_rows, _, rows, cols, vals = m
        z = self.z.limbs
        dev = self.device

        def products(v, col_idx):
            return fp.mont_mul(FR, v, to_device_limbs(z[:, col_idx], dev))

        return self._segment_blocks(rows, cols, vals, self.block_size, n_rows,
                                    products)

    def joint(self) -> JointStream:
        """Union sparsity from the host COO triples (misc.rs:269-366):
        packed (col, row) keys -> unique -> per-matrix value scatter,
        O(nnz) host RAM."""
        n_rows = max(m[0] for m in self._mats)
        keys = [m[3].astype(np.int64) * n_rows + m[2].astype(np.int64)
                for m in self._mats]
        union = np.unique(np.concatenate(keys))
        row_index = union % n_rows
        col_index = union // n_rows

        def vals_on_union(m, key) -> HostVector:
            limbs = np.zeros((FR.n_limbs, len(union)), dtype=np.uint32)
            if len(key):
                limbs[:, np.searchsorted(union, key)] = m[4]
            return HostVector(limbs, device=self.device)

        return JointStream(
            row_index=row_index, col_index=col_index,
            row=_index_field_hv(row_index, self.device, self.block_size),
            col=_index_field_hv(col_index, self.device, self.block_size),
            val_a=vals_on_union(self._mats[0], keys[0]),
            val_b=vals_on_union(self._mats[1], keys[1]),
            val_c=vals_on_union(self._mats[2], keys[2]),
        )

    def abc_tensored(self, challenges: List[int], alpha: int, eta: int,
                     block_size: int) -> HostVector:
        """A^T r_a + η B^T r_b + η² C^T r_c blockwise: per matrix, COO
        blocks sorted by column multiply against r values generated at
        their row indices and segment-sum by column; the three host
        outputs combine in one streaming lincomb."""
        from ..streaming.ops import hv_lincomb, powers_at, tensor_at

        k = max(len(challenges), 1)
        dev = self.device

        def rvals(kind, idx):
            if kind == "b":
                return tensor_at(challenges, idx, dev)
            if kind == "c":
                return powers_at(alpha, idx, k, dev)
            return fp.mont_mul(FR, tensor_at(challenges, idx, dev),
                               powers_at(alpha, idx, k, dev))

        outs = []
        for m, kind in zip(self._mats, ("a", "b", "c")):
            _, n_cols, rows, cols, vals = m
            order = np.argsort(cols, kind="stable")

            def products(v, row_idx, kind=kind):
                return fp.mont_mul(FR, v, rvals(kind, row_idx))

            outs.append(self._segment_blocks(cols[order], rows[order],
                                             vals[:, order], block_size,
                                             n_cols, products))
        return hv_lincomb(outs, [1, eta, eta * eta % R], block_size)


def as_stream(r1cs):
    """R1cs -> DenseR1csStream; stream objects pass through."""
    if isinstance(r1cs, R1cs):
        return DenseR1csStream(r1cs)
    return r1cs
