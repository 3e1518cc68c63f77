"""Multi-scalar multiplication (Pippenger) on the card.

Port of gemini_tpu/ops/msm.py.  Bucket accumulation uses the
threshold-suffix identity instead of data-dependent scatter-adds:

    sum_i d_i P_i = sum_{k=1}^{2^(c-1)} ( sum_{i: |d_i| >= k} ±P_i )

With points sorted by digit, each inner sum is one prefix sum of the
flipped sorted array at a bucket boundary, so per window the bucket
phase is a reduce chain + a scan at the stop level + a walk-down
(ops/ec_scan.prefix_sums_at) and a tree reduction.  Every EC add is a
batched launch of a hand-written CUDA kernel: padd01 at level 0 and
padd elsewhere (projective, the default), or the Jacobian add kernel
when GEMINI_TPU_PROJ=0 (`_use_proj`).  Digits are SIGNED (magnitude
<= 2^(c-1); negative digits negate the point during the sort).  The
final Horner combine over the O(W) window totals, sum_w 2^(c w) T_w,
runs on the card too: one msm_combine launch per MSM for all its sets
(`_combine`), and the result stays there until the caller reads it.

The glue between those launches is on the card too (ops/msm_kernels.py):
the digits of all windows and the sort keys in one msm_digits launch per
MSM, and per chunk, after torch.sort and before torch.searchsorted, one
msm_sort_gather launch and one msm_walk_down launch, and the points
packed for those gathers by one msm_pack launch per MSM.  The plain
versions (`_digits_plain`, `_pack_plain`, `_sort_gather_plain`,
ec_scan's `_walk_down_plain`, and `_horner_host` for the combine) run
on CPU tensors only.

Scalars enter in canonical (non-Montgomery) limb form, reduced (< R);
points as affine with infinity masks.  Small MSMs (n <= 4096) run on
the host Pippenger only when the tensors lie on the CPU; on CUDA every
MSM takes the kernel pipeline.  `host_max=0` forces the pipeline on
the CPU (the tests do this, as GEMINI_TPU_HOST_MSM_MAX=0 does in
gemini_tpu).

With GEMINI_TPU_GLV=1 (`_use_glv`, off by default) full-size scalars
take the GLV split (ops/glv.py): the lanes double to [P | phi(P)] and
the windows cover 128-bit components.
"""

from __future__ import annotations

import math
import os

import torch

from ..curve import g1
from ..curve.g1 import APoint, JPoint
from ..fields import fp
from ..fields.fp import FQ, FR
from ..params import R as _R_FR
from . import ec_scan, msm_kernels
from . import scan as scan_util

LIMB_BITS = fp.LIMB_BITS
HOST_MSM_MAX = 4096
CHUNK_LANES = 1 << 20
N_BITS = 255  # Fr scalars


def plan_window(n: int, n_bits: int = N_BITS, max_scalar: int | None = None):
    """Pick (window size c, windows-per-chunk Wc) minimizing the
    pipeline's add count with signed digits (the reference's cost model:
    n reduce-chain adds + 2m stop-level scan + m walk-down fix-ups per
    level + m bucket tree-reduce per window, m = 2^(c-1)); the top
    window must absorb the recode carry (checked against `max_scalar`,
    default R).  Unlike the reference (whose Wc bounded compiled
    shapes), Wc then grows to fill CHUNK_LANES."""
    if max_scalar is None:
        max_scalar = _R_FR
    if n <= 32:
        return 3, 4
    best = None
    for c in range(4, 21):
        w = -(-n_bits // c)
        if (max_scalar >> (c * (w - 1))) + 1 > (1 << (c - 1)):
            continue  # top window could overflow under recode carry
        m = 1 << (c - 1)
        levels = max(0, int(math.log2(max(n // max(m, 1), 1))))
        per_window = n + 2 * m + m * levels + m
        for wc in (1, 2, 3, 4, 5):
            if wc > 1 and wc * n > 5 << 20:
                continue
            cost = -(-w // wc) * wc * per_window
            if best is None or cost < best[0]:
                best = (cost, c, wc)
    if best is None:
        return 8, 4
    c, wc = best[1], best[2]
    # Batch more windows per chunk while a chunk stays within
    # CHUNK_LANES lanes: small MSMs then run as a few wide kernel
    # launches instead of one narrow launch chain per window.
    w = -(-n_bits // c)
    return c, max(wc, min(w, CHUNK_LANES // n))


def default_window(n: int, n_bits: int = N_BITS) -> int:
    return plan_window(n, n_bits)[0]


def extract_digits(scalars: torch.Tensor, c: int, n_bits: int = N_BITS):
    """(L, N) canonical limbs -> (W, N) int64 window digits, W windows of
    c bits, little-endian windows."""
    s = scalars.to(torch.int64)
    L = s.shape[0]
    digits = []
    mask = (1 << c) - 1
    for w in range(-(-n_bits // c)):
        limb, off = divmod(w * c, LIMB_BITS)
        d = s[limb] >> off
        got = LIMB_BITS - off
        k = limb + 1
        while got < c and k < L:  # c may span more than two limbs
            d = d | (s[k] << got)
            got += LIMB_BITS
            k += 1
        digits.append(d & mask)
    return torch.stack(digits, dim=0)


def extract_signed_digits(scalars: torch.Tensor, c: int,
                          n_bits: int = N_BITS):
    """(L, N) canonical limbs (< R) -> (mags (W, N) int64 in
    [0, 2^(c-1)], negs (W, N) bool): d' = raw + carry; if d' > 2^(c-1)
    emit d' - 2^c and carry 1.  CUDA tensors: one msm_digits launch, the
    digits read back from its keys mag << 2 | neg << 1."""
    if scalars.is_cuda:
        key = msm_kernels.digits(scalars, c, -(-n_bits // c))
        return key >> 2, (key & 2).bool()
    return _digits_plain(scalars, c, n_bits)


def _digits_plain(scalars: torch.Tensor, c: int, n_bits: int = N_BITS):
    """extract_signed_digits' plain version (the msm_digits kernel's)."""
    raw = extract_digits(scalars, c, n_bits)
    half, full = 1 << (c - 1), 1 << c
    mags, negs = [], []
    carry = torch.zeros_like(raw[0])
    for w in range(raw.shape[0]):
        d = raw[w] + carry
        neg = d > half
        mags.append(torch.where(neg, full - d, d))
        negs.append(neg)
        carry = neg.to(torch.int64)
    return torch.stack(mags, dim=0), torch.stack(negs, dim=0)


def digit_keys(scalars: torch.Tensor, c: int, n_bits: int, pinf, flip=None):
    """The window chunks' sort keys of (L, N) canonical scalars:
    (W, N) int64 mag << 2 | (neg ^ flip) << 1 | inf per window and lane
    (pinf, flip: (N,) bool; `flip`, the GLV component's sign, optional).
    The flags ride in the key's low bits, so one sort orders each window
    by magnitude.  CUDA tensors: one msm_digits launch."""
    if scalars.is_cuda:
        return msm_kernels.digits(scalars, c, -(-n_bits // c), pinf, flip)
    return _keys_plain(*_digits_plain(scalars, c, n_bits), pinf, flip)


def _keys_plain(mags, negs, pinf, flip=None):
    if flip is not None:
        negs = negs ^ flip
    return (mags << 2) | (negs.to(torch.int64) << 1) | pinf.to(torch.int64)


def _combine(totals, sets: int, c: int, use_proj: bool) -> JPoint:
    """Each set's sum_w 2^(c w) T_w from the (L, sets * W) window
    totals of `_run_chunks` (set i's windows at columns i * W ..), as a
    Jacobian JPoint of batch (sets,).  CUDA tensors: Jacobian totals
    (`use_proj` False) to projective, one msm_combine launch, then
    `_proj_to_jacobian` on the (L, sets) results, all on the card; CPU
    tensors: `_horner_host` per set."""
    if totals[0].is_cuda:
        if not use_proj:
            totals = _jacobian_to_proj(*totals)
        return JPoint(*_proj_to_jacobian(*msm_kernels.combine(totals, sets, c)))
    if use_proj:
        totals = _proj_to_jacobian(*totals)
    w = totals[0].shape[1] // sets
    parts = [_horner_host(tuple(t[:, i * w:(i + 1) * w] for t in totals), c,
                          totals[0].device) for i in range(sets)]
    return JPoint(*(torch.cat(coord, dim=1) for coord in zip(*parts)))


def _horner_host(totals_jac, c: int, device) -> JPoint:
    """result = sum_w 2^(c*w) * T_w, combined on the host over the
    O(W) window totals (the CPU tensors' combine)."""
    from ..hostcurve import g1_add, g1_double

    pts = g1.decode_jacobian(JPoint(*totals_jac))
    acc = None
    for w in reversed(range(len(pts))):
        if acc is not None:
            for _ in range(c):
                acc = g1_double(acc)
        acc = g1_add(acc, pts[w])
    return _jpoint_from_host(acc, device)


def _jpoint_from_host(acc, device) -> JPoint:
    one = FQ.ones_mont((1,), device)
    if acc is None:
        return JPoint(FQ.zeros((1,), device), one, FQ.zeros((1,), device))
    ap = g1.encode_affine([acc], device)
    return JPoint(ap.x, ap.y, one)


def pack_points(px, py):
    """(24, N) x and y -> (N, 24) int32 rows, x's 12 words then y's, word
    k = limb 2k | limb 2k+1 << 16: once per MSM, so each chunk's gather
    reads a point's 96 contiguous bytes (gemini_tpu's `_pack_xy` packs
    x and y into one array for the same reason, as limb rows).  CUDA
    tensors: one msm_pack launch."""
    if px.is_cuda:
        return msm_kernels.pack(px, py)
    return _pack_plain(px, py)


def _pack_plain(px, py):
    """pack_points' plain version (the msm_pack kernel's)."""
    words = [(t[0::2].to(torch.int64) | (t[1::2].to(torch.int64) << 16))
             for t in (px, py)]
    return torch.cat(words).T.to(torch.int32).contiguous()


def _sort_gather_proj(pp, key, rev_bits: int = 0):
    """Sort each window's points by digit magnitude, emitting FLIPPED
    (descending) (x, y, mask) for the padd01 level 0 plus the ASCENDING
    sorted digits (for the boundary positions).  pp: the packed points
    (pack_points).  One key sort (the neg/inf flags ride in the key's
    low bits, digit_keys; any order within a digit group is valid — the
    scan is a sum), then on CUDA one msm_sort_gather launch for the
    rest."""
    skey, order = torch.sort(key, dim=1)
    if key.is_cuda:
        return msm_kernels.sort_gather(pp, skey, order, rev_bits)
    return _sort_gather_plain(pp, skey, order, rev_bits)


def _sort_gather_plain(pp, skey, order, rev_bits: int = 0):
    """_sort_gather_proj after the sort (the msm_sort_gather kernel's
    plain version): the order array is flipped and bit-reversed before
    the one gather of packed rows.  Dead lanes (infinity or digit 0)
    become the identity (0 : y : 0), y nonzero; negative digits negate
    y."""
    Wc, n = skey.shape
    order_f = order.flip(1)
    skey_f = skey.flip(1)
    if rev_bits:
        order_f = ec_scan.partial_bitrev_last(order_f, rev_bits)
        skey_f = ec_scan.partial_bitrev_last(skey_f, rev_bits)
    g = pp[order_f].to(torch.int64).movedim(-1, 0)  # (24, Wc, n) words
    limbs = torch.stack([g & 0xFFFF, (g >> 16) & 0xFFFF], dim=1).reshape(48, Wc, n)
    gx, gy = limbs[:24].to(torch.int32), limbs[24:].to(torch.int32)
    sd = skey >> 2  # ascending magnitudes
    sneg = ((skey_f >> 1) & 1).bool()
    ginf = (skey_f & 1).bool()
    dead = ginf | (skey_f >> 2 == 0)
    dev = pp.device
    x = fp.select(dead, FQ.zeros((Wc, n), dev), gx)
    y = fp.select(sneg, fp.neg(FQ, gy), gy)
    y = fp.select(ginf, FQ.ones_mont((Wc, n), dev), y)
    return x, y, ~dead, sd


def _proj_to_jacobian(x, y, z):
    """(X : Y : Z) -> Jacobian (XZ, YZ^2, Z); inputs arrive relaxed
    (< 2p) from the padd pipeline: the mont_mul kernel canonicalizes the
    products, and z as its product with 1_mont (z R R^-1 = z mod p, the
    limbs of fp.add(z, 0)), so no Fq additive op runs on the card."""
    xz = fp.mont_mul(FQ, x, z)
    z2 = fp.mont_mul(FQ, z, z)
    yz2 = fp.mont_mul(FQ, y, z2)
    return xz, yz2, fp.mont_mul(FQ, z, FQ.ones_mont(z.shape[1:], z.device))


def _jacobian_to_proj(x, y, z):
    """Jacobian (X, Y, Z), canonical, -> (X Z : Y : Z^3), the same affine
    point (X / Z^2, Y / Z^3); the Jacobian identity (z = 0, y nonzero, as
    the add and dbl kernels leave it) maps to (0 : y : 0).  Two mont_mul
    launches on CUDA tensors: [X, Z] [Z, Z], then Z^2 Z."""
    n = x.shape[1]
    prod = fp.mont_mul(FQ, torch.cat([x, z], dim=1), torch.cat([z, z], dim=1))
    return prod[:, :n], y, fp.mont_mul(FQ, prod[:, n:], z)


def _use_proj() -> bool:
    """The projective padd/padd01 pipeline unless GEMINI_TPU_PROJ=0,
    which selects the Jacobian add kernel (the reference's switch, read
    on every call)."""
    return os.environ.get("GEMINI_TPU_PROJ") != "0"


def _jac_padd01(a, b, out=None):
    """z in {0, 1} level-0 combiner of the Jacobian configuration: lift
    the masks to Jacobian z and add through the add kernel."""
    return ec_scan.add_points(ec_scan._lift01(*a), ec_scan._lift01(*b), out)


def combiners(use_proj: bool):
    """(combiner, level-0 combiner) of a configuration: the projective
    padd/padd01 kernels, or the Jacobian add kernel for both."""
    if use_proj:
        return ec_scan.padd_points, ec_scan.padd01_points
    return ec_scan.add_points, _jac_padd01


def _boundary_positions(sd, c: int):
    """Flipped-prefix positions of the signed-digit bucket boundaries:
    suffix_{mag >= k} in sorted order == prefix up to
    n-1-searchsorted(k) in FLIPPED order, for k = 1..2^(c-1); -1 =
    empty (identity).  One batched searchsorted over the sorted rows."""
    Wc, n = sd.shape
    m = 1 << (c - 1)
    ks = torch.arange(1, m + 1, dtype=sd.dtype, device=sd.device)
    b = torch.searchsorted(sd.contiguous(), ks.expand(Wc, m).contiguous(),
                           side="left")
    return (n - 1) - b


def _window_chunk(pp, key, c: int, use_proj: bool):
    """One window chunk of (Wc, n) sort keys (digit_keys) over the packed
    points (pack_points): sort by
    magnitude, positional prefix sums at the 2^(c-1) bucket boundaries,
    bucket tree-reduce.  Returns the chunk's window totals, each (L, Wc):
    projective with `use_proj`, else Jacobian."""
    combiner, combiner01 = combiners(use_proj)
    n = key.shape[1]
    rb = ec_scan.bitrev_levels(n, 1 << (c - 1))
    fx, fy, fm, sd = _sort_gather_proj(pp, key, rb)
    pos = _boundary_positions(sd, c)
    bx, by, bz = ec_scan.prefix_sums_at(fx, fy, fm, pos, combiner=combiner,
                                        combiner01=combiner01, rev_bits=rb)
    x, y, z = ec_scan.tree_reduce((bx, by, bz), combiner=combiner)
    return x[..., 0], y[..., 0], z[..., 0]


def _pad_points_scalars(points: APoint, scalars, npad: int):
    n = points.x.shape[1]
    if npad == n:
        return points, scalars
    pad = npad - n
    dev = points.x.device
    points = APoint(
        torch.cat([points.x, FQ.zeros((pad,), dev)], dim=1),
        torch.cat([points.y, FQ.zeros((pad,), dev)], dim=1),
        torch.cat([points.inf, torch.ones((pad,), dtype=torch.bool, device=dev)]),
    )
    scalars = torch.cat([scalars, scalars.new_zeros((scalars.shape[0], pad))],
                        dim=1)
    return points, scalars


def _run_chunks(points: APoint, keys, c: int, window_chunk: int,
                use_proj: bool):
    """Run the window-chunk pipeline over all windows of the (W, lanes)
    sort keys (digit_keys); returns (x, y, z) totals of shape (L, W),
    projective with `use_proj`, else Jacobian."""
    W = keys.shape[0]
    pp = pack_points(points.x, points.y)
    tx, ty, tz = [], [], []
    for w0 in range(0, W, window_chunk):
        x, y, z = _window_chunk(pp, keys[w0: w0 + window_chunk], c, use_proj)
        tx.append(x)
        ty.append(y)
        tz.append(z)
    return torch.cat(tx, dim=1), torch.cat(ty, dim=1), torch.cat(tz, dim=1)


def _host_msm_max(device, host_max: int | None) -> int:
    """Size up to which an MSM runs on the host Pippenger: 4096 for CPU
    tensors, 0 (never) on CUDA, or `host_max` when given."""
    if host_max is not None:
        return host_max
    return HOST_MSM_MAX if device.type == "cpu" else 0


def _msm_host(points: APoint, scalars) -> JPoint:
    from ..hostcurve import g1_msm_pippenger

    pts = g1.decode_affine(points)
    ks = FR.decode(scalars, mont=False)
    return _jpoint_from_host(g1_msm_pippenger(pts, ks), points.x.device)


def _use_glv(n_bits: int) -> bool:
    """The GLV split for full-size Fr scalars, only with GEMINI_TPU_GLV=1
    (read on every call; default off, as in the reference), and never
    for scalars of 160 bits or fewer (the split pays only when the
    windows halve)."""
    return os.environ.get("GEMINI_TPU_GLV", "0") == "1" and n_bits > 160


def _glv_plan(n_lanes: int):
    from . import glv as glv_mod

    return plan_window(n_lanes, glv_mod.GLV_BITS,
                       max_scalar=glv_mod.COMPONENT_BOUND)


def _glv_window_keys(k1m, k1n, k2m, k2n, c: int, pinf):
    """GLV component limbs -> per-window sort keys over the doubled lane
    axis [P lanes | phi(P) lanes]; component signs fold into the keys'
    negation flags, and both halves carry the points' infinity flags."""
    from . import glv as glv_mod

    return torch.cat([digit_keys(k1m, c, glv_mod.GLV_BITS, pinf, k1n),
                      digit_keys(k2m, c, glv_mod.GLV_BITS, pinf, k2n)], dim=1)


def _glv_double_points(points: APoint) -> APoint:
    """[P | phi(P)] along the lane axis: phi scales x by beta (one
    constant Montgomery product), y and the infinity flags are shared."""
    from . import glv as glv_mod

    return APoint(torch.cat([points.x, glv_mod.endo_x(points.x)], dim=1),
                  torch.cat([points.y, points.y], dim=1),
                  torch.cat([points.inf, points.inf]))


def _msm_glv(points: APoint, scalars, c: int | None = None) -> JPoint:
    """MSM via the GLV split: 2N points (P, phi(P)) over 128-bit
    components instead of N over 255 bits."""
    from . import glv as glv_mod

    npad = scan_util.bucket4(points.x.shape[1], floor=256)
    points, scalars = _pad_points_scalars(points, scalars, npad)
    c_plan, window_chunk = _glv_plan(2 * npad)
    if c is None:
        c = c_plan
    keys = _glv_window_keys(*glv_mod.decompose(scalars), c, points.inf)
    use_proj = _use_proj()
    totals = _run_chunks(_glv_double_points(points), keys, c, window_chunk,
                         use_proj)
    return _combine(totals, 1, c, use_proj)


def msm(points: APoint, scalars, c: int | None = None, n_bits: int = N_BITS,
        glv: bool | None = None, host_max: int | None = None) -> JPoint:
    """MSM over G1: sum_i scalars[i] * points[i].

    points: APoint batch (N,); scalars: (FR_LIMBS, N) canonical
    (non-Montgomery) limbs, each < R.  `c` overrides the planned window,
    `n_bits` bounds the scalars, `glv` forces the GLV split on or off
    (default `_use_glv`).  Returns a JPoint of batch (1,)."""
    n = points.x.shape[1]
    if n <= _host_msm_max(points.x.device, host_max):
        return _msm_host(points, scalars)
    if glv is None:
        glv = _use_glv(n_bits)
    if glv:
        return _msm_glv(points, scalars, c)
    # Pad to a power-of-4 bucket with (infinity, 0) pairs: a no-op that
    # keeps every scan level a power of two.
    npad = scan_util.bucket4(n, floor=256)
    c_plan, window_chunk = plan_window(npad, n_bits)
    if c is None:
        c = c_plan
    points, scalars = _pad_points_scalars(points, scalars, npad)
    keys = digit_keys(scalars, c, n_bits, points.inf)
    use_proj = _use_proj()
    totals = _run_chunks(points, keys, c, window_chunk, use_proj)
    return _combine(totals, 1, c, use_proj)


def msm_mont_scalars(points: APoint, scalars_mont, c: int | None = None,
                     devices=None, host_max: int | None = None) -> JPoint:
    """MSM taking Montgomery-form Fr scalars (the prover's native form).
    With two or more `devices` the lanes are split across them
    (parallel/msm.py `msm_multichip`)."""
    sc = fp.from_mont(FR, scalars_mont)
    if devices is not None and len(devices) > 1:
        from ..parallel.msm import msm_multichip

        return msm_multichip(points, sc, devices=devices, c=c)
    return msm(points, sc, c, host_max=host_max)


def msm_batch(points: APoint, scalars_sets, c: int | None = None,
              n_bits: int = N_BITS, glv: bool | None = None,
              host_max: int | None = None):
    """Many MSMs over PREFIXES of the same base array, as one pipeline:
    set i (canonical (FR_LIMBS, n_i)) is multiplied against
    points[:n_i].  All sets are zero-padded to a common pow-4 bucket and
    their windows stacked on the window-chunk axis, so S small MSMs
    share each chunk's batched kernel launches, and one combine.
    Returns a list of JPoint results of batch (1,), one per set."""
    sets = list(scalars_sets)
    if not sets:
        return []
    nmax = max(s.shape[1] for s in sets)
    navail = points.x.shape[1]
    assert nmax <= navail, f"scalar length {nmax} exceeds base count {navail}"
    if nmax <= _host_msm_max(points.x.device, host_max):
        return [
            _msm_host(APoint(points.x[:, :s.shape[1]], points.y[:, :s.shape[1]],
                             points.inf[:s.shape[1]]), s)
            for s in sets
        ]
    npad = scan_util.bucket4(max(nmax, 1), floor=256)
    if navail >= npad:
        points = APoint(points.x[:, :npad], points.y[:, :npad],
                        points.inf[:npad])
    else:
        points, _ = _pad_points_scalars(points, sets[0][:, :0], npad)
    if glv is None:
        glv = _use_glv(n_bits)
    if glv:
        from . import glv as glv_mod

        c_plan, window_chunk = _glv_plan(2 * npad)
    else:
        c_plan, window_chunk = plan_window(npad, n_bits)
    if c is None:
        c = c_plan
    keys_l = []
    for s in sets:
        if s.shape[1] < npad:
            s = torch.cat([s, s.new_zeros((s.shape[0], npad - s.shape[1]))],
                          dim=1)
        if glv:
            keys_l.append(_glv_window_keys(*glv_mod.decompose(s), c, points.inf))
        else:
            keys_l.append(digit_keys(s, c, n_bits, points.inf))
    keys = torch.cat(keys_l, dim=0)  # (S*W, lanes)
    if glv:
        points = _glv_double_points(points)
    use_proj = _use_proj()
    totals = _run_chunks(points, keys, c, window_chunk, use_proj)
    res = _combine(totals, len(sets), c, use_proj)
    return [JPoint(*(t[:, i:i + 1] for t in res)) for i in range(len(sets))]
