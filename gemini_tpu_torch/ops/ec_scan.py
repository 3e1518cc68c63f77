"""EC scans for the MSM pipeline (port of gemini_tpu/ops/ec_scan.py).

Points travel as (x, y, z) tuples of (L, *batch, n) limb tensors; the
level-0 operands of a reduce chain are (x, y, mask) with z in {0, 1}.
Every add is one batched call of a hand-written kernel in
curve/g1_kernels.py, through a `combiner`: by default the projective
`padd` (identity (0 : y : 0)) and `padd01` at level 0; with the
Jacobian `add_points` (identity z = 0) the MSM's Jacobian configuration
(ops/msm.py `_use_proj`).  z in {0, 1}, (0 : y : 0) and the lifted
level-0 operands mean the same point in both coordinate systems.  A
combiner is called as combiner(a, b, out=None): with `out`, three
(L, *batch) views, the kernel writes its sums there (the scan's even and
odd slots, the reduce chain's stacked levels), so no copy joins them.

On CUDA tensors the walk-down of `prefix_sums_at` is one launch of the
msm_walk_down kernel (ops/msm_kernels.py), which adds with the code of
padd or add; `_walk_down_plain` is its plain version, for CPU tensors.
"""

from __future__ import annotations

import torch

from ..curve import g1_kernels
from ..fields.fp import FQ
from . import msm_kernels

L = FQ.n_limbs


def add_points(a, b, out=None):
    """Complete Jacobian add of two (x, y, z) tuples through the add
    kernel (curve/g1_kernels.add); canonical in, canonical out."""
    return g1_kernels.add(a, b, out)


def padd_points(a, b, out=None):
    """Complete projective add (RCB) through the padd kernel."""
    return g1_kernels.padd(a, b, out)


def padd01_points(a, b, out=None):
    """Level-0 specialization: both operands (x, y, mask) with z in
    {0, 1} — 9 Montgomery products instead of 12."""
    return g1_kernels.padd01(a, b, out)


def _lift01(x, y, m):
    """(x, y, mask) -> projective (x, y, z) with z = mask * 1_mont."""
    one = FQ.ones_mont(x.shape[1:], x.device)
    return x, y, torch.where(m.unsqueeze(0), one, torch.zeros_like(one))


def _empty_points(like, n: int):
    """One (3, L, *batch, n) int32 buffer for the (x, y, z) of n points."""
    return torch.empty((3, *like.shape[:-1], n), dtype=like.dtype, device=like.device)


def _scan_into(s, out, combiner):
    """Inclusive scan of the points stacked in s (3, L, *batch, n) along
    the last axis, written into out (the same shape, another buffer):
    each level's adds write straight into out's odd slots (the scan of
    the pairs' sums, by recursion) and even slots 1.. (scanned[i - 1] +
    evens[i]), and slot 0 takes e0 (one copy a level).  These are
    gemini_tpu's inclusive_scan_ec's adds with their operands in the same
    order, so the relaxed limbs come out the same."""
    n = s.shape[-1]
    evens, odds = s[..., 0::2], s[..., 1::2]
    out_e, out_o = out[..., 0::2], out[..., 1::2]
    if n == 2:
        combiner(tuple(evens), tuple(odds), out=tuple(out_o))
    else:
        reduced = _empty_points(s[0], n // 2)
        combiner(tuple(evens), tuple(odds), out=tuple(reduced))
        _scan_into(reduced, out_o, combiner)
        combiner(tuple(out_o[..., :-1]), tuple(evens[..., 1:]),
                 out=tuple(out_e[..., 1:]))
    out[..., 0].copy_(s[..., 0])


def inclusive_scan_ec(s, combiner=padd_points):
    """Inclusive scan of points along the LAST axis under `combiner`, n a
    power of two: `s` holds the (x, y, z) of (L, *batch, n) stacked in one
    (3, L, *batch, n) tensor (prefix_sums_at's reduce chain writes them
    so).  Returns (x, y, z), views of one buffer."""
    n = s.shape[-1]
    assert n & (n - 1) == 0
    if n == 1:
        return tuple(s)
    out = torch.empty_like(s)
    _scan_into(s, out, combiner)
    return tuple(out)


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
    z = 0, the identity of both coordinate systems.  On CUDA tensors
    the walk-down is one msm_walk_down launch.
    """
    levels, scanned = reduce_and_scan(x, y, mask, pos.shape[-1], combiner,
                                      combiner01, rev_bits)
    if pos.is_cuda:
        return msm_kernels.walk_down(pos, scanned, levels, rev_bits,
                                     _walk_down_proj(combiner))
    return _walk_down_plain(pos, scanned, levels, rev_bits, combiner)


def reduce_and_scan(x, y, mask, m: int, combiner=padd_points,
                    combiner01=padd01_points, rev_bits: int = 0):
    """prefix_sums_at up to its walk-down, for m positions: the reduce
    chain's kept levels [(x, y, z-or-mask, is01)], the lanes first, and
    the stop level's inclusive scan (x, y, z)."""
    n = x.shape[-1]
    assert n & (n - 1) == 0
    s_stop = 1
    while s_stop < m and s_stop < n:
        s_stop *= 2
    if rev_bits:
        assert rev_bits == bitrev_levels(n, m), (rev_bits, n, m)

    # Reduce chain (keeping each level for the walk-down), each level's
    # sums written into one (3, L, *batch, n/2) buffer.
    levels = []  # (x, y, z-or-mask, is01)
    cx, cy, cz = x, y, mask
    stacked = None
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
        stacked = _empty_points(cx, cx.shape[-1] // 2)
        (combiner01 if is01 else combiner)(ev, od, out=tuple(stacked))
        cx, cy, cz = stacked
        is01 = False

    # Full inclusive prefix scan at the stop level.
    if is01:
        stacked = torch.stack(_lift01(cx, cy, cz))
    return levels, inclusive_scan_ec(stacked, combiner=combiner)


def _walk_down_proj(combiner) -> bool:
    """The walk-down kernel's add: padd for padd_points, the Jacobian add
    for add_points; it takes no other combiner."""
    if combiner is padd_points:
        return True
    if combiner is add_points:
        return False
    raise ValueError(f"the walk-down kernel adds with padd_points or add_points, "
                     f"not {combiner!r}")


def _walk_down_plain(pos, scanned, levels, rev_bits, combiner):
    """The walk-down of prefix_sums_at (the plain version of the
    msm_walk_down kernel): the scan's value at each position's top-level
    index ((0 : 1_mont : 0) where it is -1), then per level, from the stop
    level down, + (x or 0, y, z or 0) of the level's lane at the
    position's stored index, x and z kept where the position is even
    (y unmasked: the complete formulas scale their output by the
    identity operand's y)."""
    sx, sy, sz = scanned
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
