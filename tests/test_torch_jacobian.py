"""The Jacobian G1 group law of the port, its MSM configuration and the
two benchmark probes, against gemini_tpu on the CPU.

`add` and `double` (the `add`/`dbl` kernels' plain versions, which the
wrappers take for CPU tensors and chip_smoke.py holds the CUDA kernels
against) work in the canonical domain, so they must equal gemini_tpu's
CPU path (`gemini_tpu.curve.g1.add`/`double`/`add_mixed`, the tape VM,
which the JAX package's TPU gates hold equal to its Pallas `_add_kernel`
and `_dbl_kernel`) limb for limb.  Tolerance: exact, everywhere.

At most 3 collected cases (ROADMAP.md, tier-1 rule); the JAX side
compiles with XLA's optimizations off (integer results do not depend on
them).
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemini_tpu.curve import g1 as jg1
from gemini_tpu_torch.benches import probes
from gemini_tpu_torch.curve import g1, g1_kernels as gk
from gemini_tpu_torch.fields.fp import FQ, FR
from gemini_tpu_torch.hostcurve import g1_add, g1_msm, g1_mul, g1_neg
from gemini_tpu_torch.kzg.commit import fixed_base_msm
from gemini_tpu_torch.native import bls
from gemini_tpu_torch.ops import ec_scan, msm
from gemini_tpu_torch.params import Q, R
from gemini_tpu_torch.refimpl import g1_generator, g2_generator

torch.set_num_threads(1)

T = 128


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _mont(v):
    return v * FQ.mont_r % Q


def _limbs(vals):
    """Python ints (< 2^384) -> (24, n) uint32 16-bit limbs."""
    a = np.zeros((24, len(vals)), np.uint32)
    for j, v in enumerate(vals):
        a[:, j] = [(v >> (16 * i)) & 0xFFFF for i in range(24)]
    return a


def _jac(P, rnd):
    """Random Jacobian representative (x z^2, y z^3, z) of an affine host
    point, Montgomery limbs' ints; the identity is z = 0 with random x, y."""
    if P is None:
        return (_mont(rnd.randrange(Q)), _mont(rnd.randrange(Q)), 0)
    z = rnd.randrange(1, Q)
    return (_mont(P[0] * z * z % Q), _mont(P[1] * pow(z, 3, Q) % Q), _mont(z))


def _operands(seed):
    """128 lanes: P + Q, P + P (one representative), P + P (two), P - P,
    O + P, P + O, O + O on real points (small multiples of G), then
    random canonical coordinates.  Returns the (24, T) limb arrays of
    p and q, q's affine form (x, y, inf) and {lane: host p + q}."""
    rnd = random.Random(seed)
    G = g1_generator()
    pts = [g1_mul(G, k) for k in range(1, 9)]
    ps, qs, qa, want = [], [], [], {}
    for k, P in enumerate(pts):
        Qp = pts[(k + 3) % len(pts)]
        for A, B in ((P, Qp), (P, P), (P, P), (P, g1_neg(P)), (None, P),
                     (P, None), (None, None)):
            a = _jac(A, rnd)
            b = a if (A, B) == (P, P) and len(ps) % 7 == 1 else _jac(B, rnd)
            want[len(ps)] = g1_add(A, B)
            ps.append(a)
            qs.append(b)
            qa.append((0, 0, True) if B is None
                      else (_mont(B[0]), _mont(B[1]), False))
    while len(ps) < T:
        ps.append(tuple(rnd.randrange(Q) for _ in range(3)))
        qs.append(tuple(rnd.randrange(Q) for _ in range(3)))
        qa.append((rnd.randrange(Q), rnd.randrange(Q), rnd.random() < 0.25))
    p = [_limbs([t[i] for t in ps]) for i in range(3)]
    q = [_limbs([t[i] for t in qs]) for i in range(3)]
    aff = (_limbs([t[0] for t in qa]), _limbs([t[1] for t in qa]),
           np.array([t[2] for t in qa]))
    return p, q, aff, want


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _same(ref, got):
    return all(np.array_equal(np.asarray(r).astype(np.int64),
                              g.numpy().astype(np.int64))
               for r, g in zip(ref, got))


def test_group_law_matches_gemini_tpu():
    """add, double and add_mixed against gemini_tpu's CPU path, limb for
    limb, on edge lanes and random canonical coordinates; the real-point
    lanes against the host group law."""
    p, q, aff, want = _operands(3)
    jp = jg1.JPoint(*map(jnp.asarray, p))
    jq = jg1.JPoint(*map(jnp.asarray, q))
    tp = g1.JPoint(*map(_t, p))
    tq = g1.JPoint(*map(_t, q))

    got = g1.add(tp, tq)
    assert _same(jg1.add(jp, jq), got)
    host = g1.decode_jacobian(got)
    assert all(host[lane] == w for lane, w in want.items())

    dbl = g1.double(tp)
    assert _same(jg1.double(jp), dbl)
    assert g1.decode_jacobian(dbl)[:8] == [
        g1_add(P, P) for P in g1.decode_jacobian(tp)[:8]]

    ja = jg1.APoint(jnp.asarray(aff[0]), jnp.asarray(aff[1]), jnp.asarray(aff[2]))
    ta = g1.APoint(_t(aff[0]), _t(aff[1]), torch.from_numpy(aff[2]))
    mixed = g1.add_mixed(tp, ta)
    assert _same(jg1.add_mixed(jp, ja), mixed)
    host = g1.decode_jacobian(mixed)
    assert all(host[lane] == w for lane, w in want.items())

    # the wrappers are the plain versions on CPU tensors, batch shapes pass
    assert _same(gk.add_plain(*map(_t, p), *map(_t, q)), got)
    out = gk.double(tuple(_t(c).reshape(24, 2, 64) for c in p))
    assert out[0].shape == (24, 2, 64) and _same(dbl, [o.reshape(24, T) for o in out])


def test_scalar_mul_matches_gemini_tpu_and_host():
    """scalar_mul at 8 lanes: 16-bit scalars against gemini_tpu's
    scalar_mul (limbs), full 255-bit scalars against the host group law."""
    rnd = random.Random(5)
    G = g1_generator()
    pts = [g1_mul(G, rnd.randrange(1, R)) for _ in range(7)] + [None]
    jac = [_jac(P, rnd) for P in pts]
    p = [_limbs([t[i] for t in jac]) for i in range(3)]

    def bits(ks, nbits):
        return np.array([[(k >> b) & 1 for k in ks] for b in range(nbits)], bool)

    ks16 = [0, 1, 2, 3, 0xFFFF, 0x8000, 12345, 777]
    want = jg1.scalar_mul(jg1.JPoint(*map(jnp.asarray, p)),
                          jnp.asarray(bits(ks16, 16)))
    got = g1.scalar_mul(g1.JPoint(*map(_t, p)), torch.from_numpy(bits(ks16, 16)))
    assert _same(want, got)

    ks = [R - 1, 1, 0] + [rnd.randrange(R) for _ in range(5)]
    got = g1.scalar_mul(g1.JPoint(*map(_t, p)), torch.from_numpy(bits(ks, 255)))
    assert g1.decode_jacobian(got) == [g1_mul(P, k) for P, k in zip(pts, ks)]


def test_jacobian_configuration_and_probes(monkeypatch):
    """GEMINI_TPU_PROJ=0: the MSM pipeline (forced with host_max=0),
    msm_batch prefixes, the empty-bucket identity and fixed_base_msm
    through the Jacobian add, against the host; the probes' plain
    versions against numpy; the native length checks."""
    monkeypatch.setenv("GEMINI_TPU_PROJ", "0")
    assert not msm._use_proj()
    rnd = random.Random(9)
    G = g1_generator()
    base = [g1_mul(G, rnd.randrange(1, 1 << 30)) for _ in range(40)]
    n = 1 << 9
    pts = [base[i % len(base)] for i in range(n)]
    pts[1] = None
    pts[2] = g1_neg(pts[0])
    # edge scalars, and small ones that leave the upper windows' buckets empty
    ks = [0, R - 1, 1, R - 1] + [rnd.randrange(1 << 20) for _ in range(n // 2)]
    ks += [rnd.randrange(R) for _ in range(n - len(ks))]
    gk.reset_launches()
    out = msm.msm(g1.encode_affine(pts, "cpu"), FR.tensor(ks, "cpu", mont=False),
                  host_max=0)
    assert g1.decode_jacobian(out)[0] == g1_msm(pts, ks)
    assert gk.LAUNCHES["add"] == 0  # plain versions on the CPU

    sizes = [200, 17]
    res = msm.msm_batch(g1.encode_affine(pts[:200], "cpu"),
                        [FR.tensor(ks[:s], "cpu", mont=False) for s in sizes],
                        host_max=0)
    assert [g1.decode_jacobian(r)[0] for r in res] == [
        g1_msm(pts[:s], ks[:s]) for s in sizes]

    # an empty position (-1) is the identity (0 : 1 : 0) under the add
    ap = g1.encode_affine(pts[:64], "cpu")
    live = ~ap.inf
    y = torch.where(live.unsqueeze(0), ap.y, FQ.ones_mont((64,), "cpu"))
    pos = torch.tensor([-1, 0, 5, 63])
    bx, by, bz = ec_scan.prefix_sums_at(
        ap.x, y, live, pos, combiner=ec_scan.add_points,
        combiner01=msm._jac_padd01)
    want = []
    for j in pos.tolist():
        acc = None
        for P in pts[:j + 1]:
            acc = g1_add(acc, P)
        want.append(acc)
    assert g1.decode_jacobian(g1.JPoint(bx, by, bz)) == want

    fb = [0, 1, R - 1] + [rnd.randrange(R) for _ in range(9)]
    got = g1.decode_affine(fixed_base_msm(base[3], FR.tensor(fb, "cpu", mont=False)))
    assert got == [g1_mul(base[3], k) for k in fb]

    # probes: plain versions against a numpy model (uint32 wraps)
    rng = np.random.default_rng(12)
    a = rng.integers(0, 1 << 32, size=(4, 33), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=(4, 33), dtype=np.uint64).astype(np.uint32)
    acc = a.copy()
    for _ in range(7):
        acc = acc * b + a
    got = probes.vpu_chain(torch.from_numpy(a.view(np.int32)),
                           torch.from_numpy(b.view(np.int32)), 7)
    assert np.array_equal(got.numpy().view(np.uint32), acc)
    got = probes.copy_add(torch.from_numpy(a.view(np.int32)),
                          torch.from_numpy(b.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), a + b)
    fa = np.full((2, 8), 1.0000001, np.float32)
    fb32 = np.full((2, 8), 0.9999999, np.float32)
    facc = fa.copy()
    for _ in range(5):
        facc = (facc.astype(np.float64) * fb32 + fa).astype(np.float32)
    got = probes.vpu_chain(torch.from_numpy(fa), torch.from_numpy(fb32), 5)
    assert np.array_equal(got.numpy(), facc)
    assert probes.LAUNCHES == {"vpu_chain": 0, "copy_add": 0}

    # the native library refuses mismatched lengths
    if bls.available():
        with pytest.raises(ValueError):
            bls.g1_msm(base[:3], [1, 2])
        with pytest.raises(ValueError):
            bls.multi_pairing([G, G], [g2_generator()])
