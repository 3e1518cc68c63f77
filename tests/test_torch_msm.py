"""MSM parity: the port's kernel pipeline (forced onto the CPU with
host_max=0, where every EC add runs the kernels' plain versions) against
gemini_tpu's host MSM (gemini_tpu.hostcurve).

Group elements are compared as canonical affine points: the pipeline's
internal add order changes relaxed intermediates, not results.
Tolerance: exact.  At most 3 collected cases (ROADMAP.md, tier-1 rule).
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemini_tpu import hostcurve as jhost
from gemini_tpu.fields.fp import FR as JFR
from gemini_tpu.ops import msm as jmsm
from gemini_tpu.params import R
from gemini_tpu.refimpl import g1_generator, g1_mul
from gemini_tpu_torch.curve import g1
from gemini_tpu_torch.fields import fp
from gemini_tpu_torch.fields.fp import FQ, FR
from gemini_tpu_torch.ops import ec_scan, msm
from gemini_tpu_torch.kzg.commit import fixed_base_msm

torch.set_num_threads(1)

_POINTS = [g1_mul(g1_generator(), k) for k in
           random.Random(21).sample(range(1, 1 << 30), 48)]


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _instance(n, seed):
    """n points cycling over 48 distinct ones with infinity, P and -P
    among them, and numpy-seeded scalars < R with edge values."""
    rng = np.random.default_rng(seed)
    pts = [_POINTS[i % len(_POINTS)] for i in range(n)]
    pts[1] = None
    pts[2] = (pts[0][0], (-pts[0][1]) % g1.S.modulus)
    ks = [int(x) % R for x in rng.integers(0, 1 << 62, size=n)]
    ks = [(k << 190 | k) % R for k in ks]
    ks[:4] = [0, R - 1, 1, R - 1]
    return pts, ks


def _pipeline(pts, ks):
    out = msm.msm(g1.encode_affine(pts, "cpu"), FR.tensor(ks, "cpu", mont=False),
                  host_max=0)
    return g1.decode_jacobian(out)[0]


def test_msm_kernel_pipeline_matches_host():
    """200 points (the 256-lane bucket, c = 6), 1024 points (c = 7),
    degenerate inputs, and the CPU host path for n <= 4096."""
    for n in (200, 1024):
        pts, ks = _instance(n, n)
        assert _pipeline(pts, ks) == jhost.g1_msm(pts, ks)
    pts, ks = _instance(9, 3)
    assert _pipeline(pts, ks) == jhost.g1_msm(pts, ks)
    assert _pipeline(pts, [0] * 9) is None  # all-zero scalars
    assert _pipeline([None] * 9, ks) is None  # all points at infinity
    out = msm.msm(g1.encode_affine(pts, "cpu"), FR.tensor(ks, "cpu", mont=False))
    assert g1.decode_jacobian(out)[0] == jhost.g1_msm(pts, ks)


def test_msm_batch_and_fixed_base_match_host():
    """msm_batch over prefixes of one base array, and the CUDA path's
    SRS construction (gather + padd01/padd window tree + to_affine)
    against the native host fixed-base."""
    from gemini_tpu.native import bls as jbls

    pts, ks = _instance(250, 4)
    sizes = [250, 129, 17, 2]
    sets = [FR.tensor(ks[:s], "cpu", mont=False) for s in sizes]
    res = msm.msm_batch(g1.encode_affine(pts, "cpu"), sets, host_max=0)
    got = [g1.decode_jacobian(r)[0] for r in res]
    assert got == [jhost.g1_msm(pts[:s], ks[:s]) for s in sizes]

    base = _POINTS[7]
    ks = [0, 1, R - 1] + [random.Random(6).randrange(R) for _ in range(29)]
    got = g1.decode_affine(fixed_base_msm(base, FR.tensor(ks, "cpu", mont=False)))
    want = (jbls.g1_fixed_base(base, ks) if jbls.available()
            else [jhost.g1_mul(base, k) for k in ks])
    assert got == want


def test_digits_scans_and_conversions():
    """Signed digits against gemini_tpu; ec_scan prefix sums and tree
    reduce, and the G1 conversions, against the host group law."""
    _, ks = _instance(64, 5)
    for c in (6, 16):
        mj, nj = jmsm.extract_signed_digits(
            jnp.asarray(JFR.encode(ks, mont=False)), c)
        mt, nt = msm.extract_signed_digits(FR.tensor(ks, "cpu", mont=False), c)
        assert np.array_equal(np.asarray(mj).astype(np.int64), mt.numpy())
        assert np.array_equal(np.asarray(nj), nt.numpy())
    assert msm.plan_window(1 << 20) == (16, 1)
    # c = 19 (the plan at 2^24 lanes) spans three limbs at bit offset 15;
    # the port's digits still recombine to the scalars (gemini_tpu's
    # extract_digits reads two limbs only and drops those bits).
    mags = msm.extract_digits(FR.tensor(ks, "cpu", mont=False), 19).numpy()
    assert [sum(int(d) << (19 * w) for w, d in enumerate(col))
            for col in mags.T] == ks

    # prefix sums at chosen positions of 64 affine points (in the partial
    # bit-reversed layout), and the full tree sum
    n, m = 64, 8
    pts = [_POINTS[i % len(_POINTS)] if i % 5 else None for i in range(n)]
    ap = g1.encode_affine(pts, "cpu")
    live = ~ap.inf
    y = torch.where(live.unsqueeze(0), ap.y, FQ.ones_mont((n,), "cpu"))
    x = torch.where(live.unsqueeze(0), ap.x, 0)
    pos = torch.tensor([-1, 0, 3, 10, 31, 32, 50, 63])
    rb = ec_scan.bitrev_levels(n, m)
    perm = ec_scan.partial_bitrev_last(torch.arange(n), rb)
    bx, by, bz = ec_scan.prefix_sums_at(x[:, perm], y[:, perm], live[perm],
                                        pos, rev_bits=rb)
    want = []
    for p in pos.tolist():
        acc = None
        for q in pts[:p + 1]:
            acc = jhost.g1_add(acc, q)
        want.append(acc)
    jac = msm._proj_to_jacobian(bx, by, bz)
    assert g1.decode_jacobian(g1.JPoint(*jac)) == want
    tx, ty, tz = ec_scan.tree_reduce(ec_scan._lift01(x, y, live))
    total = g1.decode_jacobian(g1.JPoint(*msm._proj_to_jacobian(tx, ty, tz)))
    assert total == [want[-1]]

    # to_affine (Fermat inversion through mont_mul), neg, from_affine
    pts = _POINTS[:6] + [None]
    ap = g1.encode_affine(pts, "cpu")
    jac = g1.from_affine(ap)
    assert g1.decode_jacobian(jac) == pts
    assert g1.decode_jacobian(g1.neg(jac)) == [jhost.g1_neg(p) for p in pts]
    # (x z^2 : y z^3 : z) with random z is the same Jacobian point
    z = FQ.tensor([random.Random(8).randrange(1, FQ.modulus) for _ in pts], "cpu")
    z2 = fp.mont_mul(FQ, z, z)
    z = torch.where(ap.inf.unsqueeze(0), 0, z)
    scaled = g1.JPoint(fp.mont_mul(FQ, ap.x, z2),
                       fp.mont_mul(FQ, ap.y, fp.mont_mul(FQ, z2, z)), z)
    assert g1.decode_affine(g1.to_affine(scaled)) == pts
