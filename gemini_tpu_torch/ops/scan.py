"""Scan utilities and shape buckets (port of gemini_tpu/ops/scan.py).

`inclusive_scan` is the work-efficient odd-even recursion with an
arbitrary associative combiner, run level by level from Python (each
level is two batched combine calls).  Elements are a tensor or a tuple
of tensors scanned along `axis`; lengths must be powers of two (pad
with the combiner's identity first — a zero tail never changes
inclusive prefixes).  Work ~2N combines, depth 2 log N.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _map(f, tree):
    return tuple(f(a) for a in tree) if isinstance(tree, tuple) else f(tree)


def _map2(f, a, b):
    if isinstance(a, tuple):
        return tuple(f(x, y) for x, y in zip(a, b))
    return f(a, b)


def _leaf(tree):
    return tree[0] if isinstance(tree, tuple) else tree


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# Shape-quantization floor for MSM padding: sizes are padded up to
# SHAPE_FLOOR * 4^k (the reference's compile-count bound; here it keeps
# every scan level a power of two and the window plans per bucket).
SHAPE_FLOOR = 1 << 10


def bucket4(n: int, floor: int = SHAPE_FLOOR) -> int:
    """Smallest floor * 4^k >= n (floor must be a power of two)."""
    if n <= floor:
        return floor
    p = next_pow2(n)
    if ((p // floor).bit_length() - 1) & 1:
        p <<= 1
    return p


def inclusive_scan(combine: Callable, elems: Any, axis: int = 1,
                   reverse: bool = False):
    """Inclusive associative scan along `axis` (power-of-two length)."""
    axis = axis % _leaf(elems).ndim
    n = _leaf(elems).shape[axis]
    assert n & (n - 1) == 0, "inclusive_scan requires power-of-two length"
    if reverse:
        elems = _map(lambda a: torch.flip(a, (axis,)), elems)
        out = _scan_rec(lambda a, b: combine(b, a), elems, axis)
        return _map(lambda a: torch.flip(a, (axis,)), out)
    return _scan_rec(combine, elems, axis)


def _eo(a, parity: int, axis: int):
    """Even (0) / odd (1) elements along `axis` via reshape."""
    shp = a.shape[:axis] + (a.shape[axis] // 2, 2) + a.shape[axis + 1:]
    return a.reshape(shp).select(axis + 1, parity)


def _scan_rec(combine, elems, axis):
    n = _leaf(elems).shape[axis]
    if n == 1:
        return elems
    evens = _map(lambda a: _eo(a, 0, axis), elems)
    odds = _map(lambda a: _eo(a, 1, axis), elems)
    reduced = combine(evens, odds)  # scan values at odd positions
    scanned = _scan_rec(combine, reduced, axis)
    # even outputs: out[0] = e0; out[2i] = scanned[i-1] . e[2i].
    if n > 2:
        shifted = _map(lambda a: torch.cat(
            [a.narrow(axis, 0, 1), a.narrow(axis, 0, n // 2 - 1)], dim=axis),
            scanned)
    else:
        shifted = scanned
    evens_combined = combine(shifted, evens)
    evens_out = _map2(lambda e, c: torch.cat(
        [e.narrow(axis, 0, 1), c.narrow(axis, 1, n // 2 - 1)], dim=axis),
        evens, evens_combined)

    def interleave(x, y):
        st = torch.stack([x, y], dim=axis + 1)
        return st.reshape(x.shape[:axis] + (n,) + x.shape[axis + 1:])

    return _map2(interleave, evens_out, scanned)
