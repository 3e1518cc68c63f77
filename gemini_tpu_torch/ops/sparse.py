"""Sparse linear algebra over field limb tensors (port of
gemini_tpu/ops/sparse.py).

The reference's sparse matvec (misc.rs:100) becomes gather ->
elementwise Montgomery product -> unreduced segment sum -> one batched
modular reduction (`fp.reduce_relaxed`).  Segment sums accumulate the
16-bit limbs in int64, so a segment may hold up to 2^31 terms (the
reference's uint32 accumulators bound it at 2^16 - 2).
"""

from __future__ import annotations

import torch

from ..fields import fp

MAX_SEGMENT = (1 << 31) - 1


def segment_sum_field(spec, vals, seg_ids, num_segments: int):
    """Sum field elements into segments: vals (L, n) Montgomery,
    seg_ids (n,) int64 (need not be sorted) -> (L, num_segments)
    normalized Montgomery sums."""
    acc = torch.zeros((spec.n_limbs, num_segments), dtype=torch.int64,
                      device=vals.device)
    acc.index_add_(1, seg_ids, vals.to(torch.int64))
    return fp.reduce_relaxed(spec, acc)


def spmv(spec, vals, rows, cols, x, num_rows: int):
    """y = M x for COO (rows, cols, vals); x: (L, n_cols) Montgomery."""
    prods = fp.mont_mul(spec, vals, x[:, cols])
    return segment_sum_field(spec, prods, rows, num_rows)


def rspmv(spec, vals, rows, cols, r, num_cols: int):
    """y = M^T r (i.e. r^T M) for COO; r: (L, n_rows) Montgomery."""
    prods = fp.mont_mul(spec, vals, r[:, rows])
    return segment_sum_field(spec, prods, cols, num_cols)
