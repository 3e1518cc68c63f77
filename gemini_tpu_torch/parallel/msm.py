"""Multi-device MSM: the lanes split across a mesh (port of
gemini_tpu/parallel/msm.py).

An MSM is a sum: partition (points, scalars) across D devices, run the
single-device window pipeline (ops/msm.py `_run_chunks`) on each
shard's lanes on its own device, move every shard's window totals to
the first device, add the D partials per window there (one padd, or
Jacobian add, launch per further shard) and combine them as one MSM
does (ops/msm.py `_combine`: one msm_combine launch for all sets on a
card).  The bucket phase needs no traffic between shards.

Every shard gets the same padded width, bucket4(ceil(lanes / D),
floor=256), with (infinity, 0) padding lanes; with GLV the lanes are
doubled to [P | phi(P)] before they are split.  The plan is
gemini_tpu's: with GLV on the whole padded width, without on one
shard's.  A shard whose device differs from the points' gets its slice
of the points and digits moved there; on one card the move is a
no-op.  `msm_multichip` never takes the host Pippenger;
`msm_batch_multichip` does below the host cutoff, as in gemini_tpu.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..curve.g1 import APoint, JPoint
from ..ops import scan as scan_util
from ..ops.msm import (
    N_BITS,
    _combine,
    _glv_double_points,
    _glv_plan,
    _glv_window_keys,
    _host_msm_max,
    _msm_host,
    _pad_points_scalars,
    _run_chunks,
    _use_glv,
    _use_proj,
    combiners,
    digit_keys,
    msm,
    msm_batch,
    plan_window,
)


def _devices(devices: Optional[Sequence]) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    from .mesh import default_mesh

    return list(default_mesh().devices)


def _shard_totals(points: APoint, keys, devs, per: int, c: int,
                  window_chunk: int, sets: int) -> JPoint:
    """Each shard's window totals, run on its own device and moved to the
    first, added there window by window in shard order, then combined
    per set (`sets` sets of W = keys.shape[0] / sets windows): a JPoint
    of batch (sets,) on devs[0]."""
    use_proj = _use_proj()
    add = combiners(use_proj)[0]
    acc = None
    for i, dev in enumerate(devs):
        sl = slice(i * per, (i + 1) * per)
        pts = APoint(points.x[:, sl].to(dev), points.y[:, sl].to(dev),
                     points.inf[sl].to(dev))
        tot = tuple(t.to(devs[0]) for t in _run_chunks(
            pts, keys[:, sl].to(dev), c, window_chunk, use_proj))
        acc = tot if acc is None else add(acc, tot)
    return _combine(acc, sets, c, use_proj)


def _pad_lanes(points: APoint, keys, npad: int):
    """(infinity, 0) padding lanes: the points at infinity, and key 1 (digit
    0, infinity), the key digit_keys gives them."""
    pad = npad - points.x.shape[1]
    if pad == 0:
        return points, keys
    points, _ = _pad_points_scalars(points, keys[:0], npad)
    return points, torch.cat([keys, keys.new_ones((keys.shape[0], pad))], 1)


def msm_multichip(points: APoint, scalars, devices: Optional[Sequence] = None,
                  c: int | None = None, n_bits: int = N_BITS) -> JPoint:
    """MSM with points and scalars split across `devices` (default: every
    CUDA device).  Returns a JPoint of batch (1,) on the points'
    device."""
    devs = _devices(devices)
    n = points.x.shape[1]
    d = max(1, min(len(devs), n))
    if d == 1:
        return msm(points, scalars, c=c, n_bits=n_bits)
    devs = devs[:d]
    use_glv = _use_glv(n_bits)
    lanes = 2 * n if use_glv else n
    per = scan_util.bucket4(-(-lanes // d), floor=256)
    npad_lanes = per * d
    c_plan, window_chunk = (_glv_plan(npad_lanes) if use_glv
                            else plan_window(per, n_bits))
    if c is None:
        c = c_plan
    if use_glv:
        from ..ops import glv as glv_mod

        keys = _glv_window_keys(*glv_mod.decompose(scalars), c, points.inf)
        points = _glv_double_points(points)
    else:
        keys = digit_keys(scalars, c, n_bits, points.inf)
    points, keys = _pad_lanes(points, keys, npad_lanes)
    res = _shard_totals(points, keys, devs, per, c, window_chunk, 1)
    return JPoint(*(t.to(points.x.device) for t in res))


def msm_batch_multichip(points: APoint, scalars_sets,
                        devices: Optional[Sequence] = None,
                        c: int | None = None, n_bits: int = N_BITS,
                        host_max: int | None = None) -> List[JPoint]:
    """Many MSMs over PREFIXES of one base array, sharded over devices:
    the multi-device twin of ops/msm.msm_batch.  Every set's windows
    stack on the window axis of the same per-shard pipeline, and one
    combine takes every set's shard-summed totals.  Scalars enter
    canonical (< R).  Returns one JPoint of batch (1,) per set."""
    sets = list(scalars_sets)
    if not sets:
        return []
    devs = _devices(devices)
    nmax = max(s.shape[1] for s in sets)
    navail = points.x.shape[1]
    assert nmax <= navail, f"scalar length {nmax} exceeds base count {navail}"
    if nmax <= _host_msm_max(points.x.device, host_max):
        return [
            _msm_host(APoint(points.x[:, :s.shape[1]], points.y[:, :s.shape[1]],
                             points.inf[:s.shape[1]]), s)
            for s in sets
        ]
    d = max(1, min(len(devs), nmax))
    if d == 1:
        return msm_batch(points, sets, c=c, n_bits=n_bits, host_max=host_max)
    devs = devs[:d]
    use_glv = _use_glv(n_bits)
    lanes = 2 * nmax if use_glv else nmax
    per = scan_util.bucket4(-(-lanes // d), floor=256)
    npad_lanes = per * d
    base_lanes = npad_lanes // 2 if use_glv else npad_lanes
    c_plan, window_chunk = (_glv_plan(npad_lanes) if use_glv
                            else plan_window(per, n_bits))
    if c is None:
        c = c_plan
    if navail >= base_lanes:
        points = APoint(points.x[:, :base_lanes], points.y[:, :base_lanes],
                        points.inf[:base_lanes])
    else:
        points, _ = _pad_points_scalars(points, sets[0][:, :0], base_lanes)
    keys_l = []
    for s in sets:
        if s.shape[1] < base_lanes:
            s = torch.cat([s, s.new_zeros((s.shape[0], base_lanes - s.shape[1]))],
                          dim=1)
        if use_glv:
            from ..ops import glv as glv_mod

            keys_l.append(_glv_window_keys(*glv_mod.decompose(s), c, points.inf))
        else:
            keys_l.append(digit_keys(s, c, n_bits, points.inf))
    keys = torch.cat(keys_l, dim=0)  # (S*W, lanes)
    if use_glv:
        points = _glv_double_points(points)
    res = _shard_totals(points, keys, devs, per, c, window_chunk, len(sets))
    res = [t.to(points.x.device) for t in res]
    return [JPoint(*(t[:, i:i + 1] for t in res)) for i in range(len(sets))]
