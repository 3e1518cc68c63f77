"""EC scans for the MSM pipeline (port of gemini_tpu/ops/ec_scan.py).

Points travel as (x, y, z) tuples of (L, *batch, n) limb tensors; the
level-0 operands of a reduce chain are (x, y, mask) with z in {0, 1}.
Every add is one batched call of a hand-written kernel in
curve/g1_kernels.py, through a `combiner`: by default the projective
`padd` (identity (0 : y : 0)) and `padd01` at level 0; with the
Jacobian `add_points` (identity z = 0) the MSM's Jacobian configuration
(ops/msm.py `_use_proj`).  z in {0, 1}, (0 : y : 0) and the lifted
level-0 operands mean the same point in both coordinate systems.
"""

from __future__ import annotations

import torch

from ..curve import g1, g1_kernels
from ..fields.fp import FQ

L = FQ.n_limbs


def add_points(a, b):
    """Complete Jacobian add of two (x, y, z) tuples through the add
    kernel (g1.add); canonical in, canonical out."""
    return tuple(g1.add(g1.JPoint(*a), g1.JPoint(*b)))


def padd_points(a, b):
    """Complete projective add (RCB) through the padd kernel."""
    return g1_kernels.padd(a, b)


def padd01_points(a, b):
    """Level-0 specialization: both operands (x, y, mask) with z in
    {0, 1} — 9 Montgomery products instead of 12."""
    return g1_kernels.padd01(a, b)


def _lift01(x, y, m):
    """(x, y, mask) -> projective (x, y, z) with z = mask * 1_mont."""
    one = FQ.ones_mont(x.shape[1:], x.device)
    return x, y, torch.where(m.unsqueeze(0), one, torch.zeros_like(one))


def _eo_split(x, y, z):
    def eo(a):
        t = a.reshape(*a.shape[:-1], a.shape[-1] // 2, 2)
        return t[..., 0], t[..., 1]

    (xe, xo), (ye, yo), (ze, zo) = eo(x), eo(y), eo(z)
    return (xe, ye, ze), (xo, yo, zo)


def _shift_right(p):
    """[s0..s_{m-1}] -> [junk, s0..s_{m-2}] (slot 0 discarded later)."""
    return tuple(torch.cat([a[..., :1], a[..., :-1]], dim=-1) for a in p)


def _interleave_first(evens_first, combined, scanned):
    """out[0::2] = [e0, combined[1:]]; out[1::2] = scanned."""
    out = []
    for e0, c, s in zip(evens_first, combined, scanned):
        even_out = torch.cat([e0[..., :1], c[..., 1:]], dim=-1)
        st = torch.stack([even_out, s], dim=-1)
        out.append(st.reshape(*st.shape[:-2], -1))
    return tuple(out)


def inclusive_scan_ec(elems, combiner=padd_points):
    """Inclusive scan of points (x, y, z) (L, *batch, n) along the LAST
    axis under `combiner`; n a power of two."""
    n = elems[0].shape[-1]
    assert n & (n - 1) == 0
    if n == 1:
        return elems
    evens, odds = _eo_split(*elems)
    reduced = combiner(evens, odds)  # scan values at odd positions
    scanned = inclusive_scan_ec(reduced, combiner=combiner)
    if n == 2:
        return _interleave_first(evens, evens, scanned)
    combined = combiner(_shift_right(scanned), evens)
    return _interleave_first(evens, combined, scanned)


def tree_reduce(elems, combiner=padd_points):
    """Sum (x, y, z) along the LAST axis -> size 1 under `combiner`;
    power-of-two n."""
    x, y, z = elems
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x, y, z = combiner((x[..., :h], y[..., :h], z[..., :h]),
                           (x[..., h:], y[..., h:], z[..., h:]))
    return x, y, z


def bitrev_levels(n: int, m: int) -> int:
    """Number of reduce-chain levels prefix_sums_at runs from n lanes to
    its stop level for m positions = the bit count the partial
    bit-reversed layout must reverse."""
    s_stop = 1
    while s_stop < m and s_stop < n:
        s_stop *= 2
    lv = 0
    while (n >> lv) > s_stop:
        lv += 1
    return lv


def partial_bitrev_last(a, rb: int):
    """Permute the last axis into the partial bit-reversed layout:
    logical index p = (hi, b_{rb-1}..b_0) lands at storage index
    j = (b_0..b_{rb-1}, hi), so every even/odd level split of the reduce
    chain is a contiguous halves split."""
    if rb <= 0:
        return a
    *batch, n = a.shape
    a = a.reshape(*batch, n >> rb, *([2] * rb))
    nb = len(batch)
    perm = list(range(nb)) + [nb + k for k in range(rb, 0, -1)] + [nb]
    return a.permute(perm).reshape(*batch, n)


def _stored_index(p, n_k: int, r_k: int):
    """Storage index of logical position p at a reduce-chain level of
    size n_k whose layout still has r_k reversed low bits."""
    if r_k <= 0:
        return p
    shift = n_k.bit_length() - 1 - r_k
    low = p & ((1 << r_k) - 1)
    rev = torch.zeros_like(p)
    for i in range(r_k):
        rev = rev | (((low >> i) & 1) << (r_k - 1 - i))
    return (rev << shift) | (p >> r_k)


def prefix_sums_at(x, y, mask, pos, combiner=padd_points,
                   combiner01=padd01_points, rev_bits: int = 0):
    """Inclusive PREFIX sums of points at given positions only.

    x, y: (L, *batch, n); mask: (*batch, n) bool, z in {0, 1} per lane;
    pos: (*batch, m) int64 in [-1, n-1] (-1 => identity).  Returns
    (x, y, z) of shape (L, *batch, m) with out[..., j] = sum_{i <= pos[j]}
    P_i: a reduce chain to the stop level s ~ m (level 0 on the cheaper
    z in {0, 1} kernel), a full scan there, and per-level walk-down
    fix-ups — n + m log2(n/m) adds instead of a full scan's 2n.

    Walk-down identity: with reduced[k] = P[2k] + P[2k+1],
      S(p) = S_reduced((p-1) >> 1) + (P[p] if p even else identity),
    and (p-1) >> 1 maps -1 to -1, so out-of-range stays out of range.

    `rev_bits`: when nonzero the input lanes are in the partial
    bit-reversed layout with rb = bitrev_levels(n, m), so level splits
    are contiguous halves; walk-down gathers translate positions with
    `_stored_index`.

    `combiner` adds general operands, `combiner01` two (x, y, mask)
    level-0 operands.  The empty-position identity (0 : 1_mont : 0) has
    z = 0, the identity of both coordinate systems.
    """
    n = x.shape[-1]
    assert n & (n - 1) == 0
    m = pos.shape[-1]
    s_stop = 1
    while s_stop < m and s_stop < n:
        s_stop *= 2
    if rev_bits:
        assert rev_bits == bitrev_levels(n, m), (rev_bits, n, m)

    # Reduce chain (keeping each level for the walk-down).
    levels = []  # (x, y, z-or-mask, is01)
    cx, cy, cz = x, y, mask
    is01 = True
    while cx.shape[-1] > s_stop:
        levels.append((cx, cy, cz, is01))
        if rev_bits:
            h = cx.shape[-1] // 2
            ev = (cx[..., :h], cy[..., :h], cz[..., :h])
            od = (cx[..., h:], cy[..., h:], cz[..., h:])
        else:
            ev = (cx[..., 0::2], cy[..., 0::2], cz[..., 0::2])
            od = (cx[..., 1::2], cy[..., 1::2], cz[..., 1::2])
        cx, cy, cz = (combiner01 if is01 else combiner)(ev, od)
        is01 = False

    # Full inclusive prefix scan at the stop level.
    if is01:
        cx, cy, cz = _lift01(cx, cy, cz)
    sx, sy, sz = inclusive_scan_ec((cx, cy, cz), combiner=combiner)

    poss = [pos]
    for _ in levels:
        poss.append((poss[-1] - 1) >> 1)

    batch_shape = pos.shape[:-1]
    assert len(batch_shape) <= 1
    warr = (torch.arange(batch_shape[0], device=pos.device)[:, None]
            if batch_shape else None)

    def gather_last(a, idx):
        return a[:, idx] if warr is None else a[:, warr, idx]

    def gather_mask(a, idx):
        return a[idx] if warr is None else a[warr, idx]

    one = FQ.ones_mont(pos.shape, pos.device)
    top = poss[-1]
    topc = top.clamp(min=0)
    live = (top >= 0).unsqueeze(0)
    rx = torch.where(live, gather_last(sx, topc), 0)
    ry = torch.where(live, gather_last(sy, topc), one)
    rz = torch.where(live, gather_last(sz, topc), 0)

    # Walk down: add P_level[p] where p is even and the lane is live.
    for k, ((lx, ly, lz, l01), p) in enumerate(
            zip(reversed(levels), reversed(poss[:-1]))):
        pc = p.clamp(min=0)
        even = (p >= 0) & (p % 2 == 0)
        lev_idx = len(levels) - 1 - k
        sidx = _stored_index(pc, lx.shape[-1],
                             rev_bits - lev_idx if rev_bits else 0)
        gxv = gather_last(lx, sidx)
        gyv = gather_last(ly, sidx)
        if l01:
            gzv = torch.where((gather_mask(lz, sidx) & even).unsqueeze(0),
                              one, 0)
        else:
            gzv = torch.where(even.unsqueeze(0), gather_last(lz, sidx), 0)
        opx = torch.where(even.unsqueeze(0), gxv, 0)
        rx, ry, rz = combiner((rx, ry, rz), (opx, gyv, gzv))
    return rx, ry, rz
