"""The MSM window chunk's glue: the plain versions of the port's
msm_digits, msm_sort_gather and msm_walk_down kernels
(csrc/msm_kernels.cu; chip_smoke.py holds the kernels against these bit
for bit on the card) against gemini_tpu on the CPU, the copy-free
stop-level scan against the host group law, and the rule that CPU
tensors never reach ops/msm_kernels.py.

The same numpy-seeded inputs go through both packages.  gemini_tpu runs
only its jitted digit recode and sort-gather here: no prover, no Pallas
interpret mode.  Tolerance: exact limbs and points everywhere.  At most
3 collected cases (ROADMAP.md, tier-1 rule).
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemini_tpu.fields.fp import FR as JFR
from gemini_tpu.ops import msm as jmsm
from gemini_tpu_torch.curve import g1
from gemini_tpu_torch.fields import fp
from gemini_tpu_torch.fields.fp import FQ, FR
from gemini_tpu_torch.hostcurve import g1_add, g1_msm, g1_mul
from gemini_tpu_torch.ops import ec_scan, msm, msm_kernels
from gemini_tpu_torch.params import Q, R
from gemini_tpu_torch.refimpl import g1_generator

torch.set_num_threads(1)

_POINTS = [g1_mul(g1_generator(), k) for k in
           random.Random(31).sample(range(1, 1 << 30), 24)]


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _scalars(rng, c, n=96):
    """Random scalars < R, then 0, 1, R - 1, and in every window a digit
    of 2^(c-1) and of 2^(c-1) + 1 (the recode's edges)."""
    ks = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    ks[:3] = [0, 1, R - 1]
    half = 1 << (c - 1)
    for w in range(255 // c):
        for k, d in enumerate((half, half + 1)):
            i = 3 + (2 * w + k) % (n - 3)
            ks[i] = ((ks[i] & ~(((1 << c) - 1) << (c * w))) | (d << (c * w))) % R
    return ks


def _coords(rng, n, top=0x1A01):
    a = rng.integers(0, 1 << 16, size=(24, n)).astype(np.uint32)
    a[23] = rng.integers(0, top, size=n)
    return a


def test_plain_digits_and_sort_gather_match_gemini_tpu():
    """Signed digits at c = 7, 13, 16 against gemini_tpu's
    extract_signed_digits; the sort keys against the key gemini_tpu's
    _sort_gather_proj builds; the sort-gather (x, y, mask, sd) from the
    port's packed points (pack_points) against gemini_tpu's from its
    _pack_xy, at Wc = 3 windows of 256 lanes (rb = 0 and 3) and of 1024
    and 4096 lanes (rb = 7) with distinct keys (both sorts are unstable),
    y = 0 and dead lanes among them."""
    rng = np.random.default_rng(1301)
    for c in (7, 13, 16):
        ks = _scalars(rng, c)
        mj, nj = jmsm.extract_signed_digits(jnp.asarray(JFR.encode(ks, mont=False)), c)
        sc = FR.tensor(ks, "cpu", mont=False)
        mt, nt = msm.extract_signed_digits(sc, c)
        assert np.array_equal(np.asarray(mj).astype(np.int64), mt.numpy())
        assert np.array_equal(np.asarray(nj), nt.numpy())
        pinf = torch.from_numpy(rng.integers(0, 2, len(ks)).astype(bool))
        key = msm.digit_keys(sc, c, 255, pinf)
        want = (np.asarray(mj).astype(np.int64) << 2) | (np.asarray(nj) << 1) | pinf.numpy()
        assert np.array_equal(key.numpy(), want)

    wc, N = 3, 4100
    px, py = _coords(rng, N), _coords(rng, N)
    py[:, 7] = 0  # neg(0) = 0
    pinf = rng.integers(0, 2, N).astype(bool)
    pp = jmsm._pack_xy(jnp.asarray(px), jnp.asarray(py))
    # rb = 7 at n = 2^10 and 2^12: the kernel's lane mapping and, from
    # n = 2^(rb + 5), its block mapping
    for rb, n in ((0, 256), (3, 256), (7, 1024), (7, 4096)):
        mags = np.stack([rng.permutation(n) for _ in range(wc)]).astype(np.uint32)
        negs = rng.integers(0, 2, (wc, n)).astype(bool)
        key = msm._keys_plain(torch.from_numpy(mags.astype(np.int64)),
                              torch.from_numpy(negs), torch.from_numpy(pinf[:n]))
        pp_t = msm.pack_points(torch.from_numpy(px.astype(np.int32))[:, :n],
                               torch.from_numpy(py.astype(np.int32))[:, :n])
        jx, jy, jm, jsd = jmsm._sort_gather_proj(
            pp[:, :n], jnp.asarray(pinf[:n]), jnp.asarray(mags), jnp.asarray(negs), rb)
        tx, ty, tm, tsd = msm._sort_gather_proj(pp_t, key, rb)
        for j, t in ((jx, tx), (jy, ty), (jm, tm), (jsd, tsd)):
            assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))
    with pytest.raises(ValueError):  # the kernel wrappers take CUDA tensors only
        msm_kernels.digits(sc, 7, 37)


def _host_prefix(pts, p):
    acc = None
    for q in pts[:p + 1]:
        acc = g1_add(acc, q)
    return acc


def test_copy_free_scan_and_walk_down_against_host(monkeypatch):
    """inclusive_scan_ec (each level's adds written into the even and odd
    slots of one buffer) and prefix_sums_at (reduce chain into stacked
    buffers, the factored plain walk-down) at 2^8 lanes in the partial
    bit-reversed layout, positions -1, 0, n - 1 and others, a live window
    and an all-dead one, against the host group law; in the projective
    and the Jacobian configuration.  _proj_to_jacobian's z (a product
    with 1_mont) equals fp.add(z, 0) on relaxed values."""
    rng = np.random.default_rng(1302)
    for proj in (True, False):
        monkeypatch.setenv("GEMINI_TPU_PROJ", "1" if proj else "0")
        _scan_and_walk_down(rng, proj)
    z = torch.from_numpy(_coords(rng, 64, 0x3402).astype(np.int32))  # < 2p
    z[:, 0] = 0
    z[:, 1] = torch.tensor([(Q >> (16 * i)) & 0xFFFF for i in range(24)])  # p itself
    assert torch.equal(msm._proj_to_jacobian(z, z, z)[2], fp.add(FQ, z, torch.zeros_like(z)))


def _scan_and_walk_down(rng, proj):
    comb, comb01 = msm.combiners(proj)
    n, m = 256, 8
    pts = [None if rng.random() < 0.2 else _POINTS[i % len(_POINTS)] for i in range(n)]
    ap = g1.encode_affine(pts, "cpu")
    live = torch.stack([~ap.inf, torch.zeros(n, dtype=torch.bool)])  # window 1: dead
    y = torch.where(live.unsqueeze(0), ap.y.unsqueeze(1), FQ.ones_mont((2, n), "cpu"))
    x = torch.where(live.unsqueeze(0), ap.x.unsqueeze(1), 0)
    pos = torch.tensor([[-1, 0, 1, 2, 77, 128, 200, n - 1]] * 2)
    rb = ec_scan.bitrev_levels(n, m)
    assert rb == 5
    perm = ec_scan.partial_bitrev_last(torch.arange(n), rb)
    bx, by, bz = ec_scan.prefix_sums_at(x[..., perm], y[..., perm], live[:, perm], pos,
                                        combiner=comb, combiner01=comb01, rev_bits=rb)
    if proj:
        bx, by, bz = msm._proj_to_jacobian(bx, by, bz)
    got = g1.decode_jacobian(g1.JPoint(bx.reshape(24, -1), by.reshape(24, -1),
                                       bz.reshape(24, -1)))
    want = [_host_prefix(pts, p) for p in pos[0].tolist()] + [None] * m
    assert got == want

    # the stop-level scan alone: 16 points, identities among them
    sx, sy, sm_ = x[:, 0, :16], y[:, 0, :16], live[0, :16]
    lifted = ec_scan._lift01(sx, sy, sm_)
    scanned = ec_scan.inclusive_scan_ec(torch.stack(lifted), combiner=comb)
    if proj:
        scanned = msm._proj_to_jacobian(*scanned)
    assert g1.decode_jacobian(g1.JPoint(*scanned)) == [_host_prefix(pts, p)
                                                        for p in range(16)]


def test_cpu_tensors_never_reach_msm_kernels(monkeypatch):
    """With the kernel wrappers made to raise, the CPU pipeline (host_max=0:
    digits, keys, sort-gather, scan, walk-down) still gives the host
    Pippenger's MSM, in both configurations, for msm_batch and for the
    GLV split."""
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached ops/msm_kernels.py")

    for name in ("digits", "pack", "sort_gather", "walk_down"):
        monkeypatch.setattr(msm_kernels, name, boom)
    rng = np.random.default_rng(1303)
    n = 300
    pts = [_POINTS[i % len(_POINTS)] for i in range(n)]
    pts[5] = None
    ks = [int(x) % R for x in rng.integers(0, 1 << 62, size=n)]
    ks = [(k << 190 | k) % R for k in ks]
    ks[:3] = [0, R - 1, 1]
    ap, sc = g1.encode_affine(pts, "cpu"), FR.tensor(ks, "cpu", mont=False)
    want = g1_msm(pts, ks)
    for proj in ("1", "0"):
        monkeypatch.setenv("GEMINI_TPU_PROJ", proj)
        assert g1.decode_jacobian(msm.msm(ap, sc, host_max=0))[0] == want
    monkeypatch.setenv("GEMINI_TPU_PROJ", "1")
    assert g1.decode_jacobian(msm.msm(ap, sc, glv=True, host_max=0))[0] == want
    res = msm.msm_batch(ap, [sc, sc[:, :40]], host_max=0)
    assert [g1.decode_jacobian(r)[0] for r in res] == [want, g1_msm(pts[:40], ks[:40])]
