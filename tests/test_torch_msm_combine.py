"""The MSM's final combine, sum_w 2^(c w) T_w over each set's window
totals: the port's CPU combine (ops/msm.py `_combine`, which runs
`_horner_host` per set; chip_smoke.py holds the msm_combine kernel
against it on the card) against gemini_tpu's `_horner_host` and the host
group law, msm_batch's results per set, and the rule that CPU tensors
never reach msm_kernels.combine.

Totals are multiples of G with random z, in both coordinate systems
(projective for the padd pipeline, Jacobian under GEMINI_TPU_PROJ=0),
the identity among them.  gemini_tpu runs only its host Horner here: no
prover, no jit.  Tolerance: exact points.  At most 3 collected cases
(ROADMAP.md, tier-1 rule).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemini_tpu.ops import msm as jmsm
from gemini_tpu_torch.curve import g1
from gemini_tpu_torch.fields.fp import FQ, FR
from gemini_tpu_torch.hostcurve import g1_msm, g1_mul
from gemini_tpu_torch.ops import msm, msm_kernels
from gemini_tpu_torch.params import Q, R
from gemini_tpu_torch.refimpl import g1_generator

torch.set_num_threads(1)

# (c, W) of the 2^20, 2^18 and 256-lane plans
PLANS = ((16, 16), (13, 20), (6, 43))


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


# points k G of known k: the host sum is one scalar multiple of G
_KS = [random.Random(1800 + j).randrange(1, R) for j in range(24)]
_POOL = [g1_mul(g1_generator(), k) for k in _KS]


def _totals(rnd, sets, windows, proj):
    """(x, y, z) of (24, sets * W) over points of the pool with random z,
    and each window's scalar k (T_w = k G, 0 for the identity): set 1
    (where there is one) has every window the identity, and a few other
    windows are, the top one of set 0 among them."""
    ks, cols = [], []
    for i in range(sets * windows):
        s, w = divmod(i, windows)
        z = rnd.randrange(1, Q)
        if s == 1 or (s == 0 and w == windows - 1) or rnd.random() < 0.1:
            ks.append(0)
            cols.append((0, 1, 0) if proj else (1, 1, 0))
            continue
        j = rnd.randrange(len(_POOL))
        x, y = _POOL[j]
        ks.append(_KS[j])
        if proj:  # (X : Y : Z) = (x z, y z, z)
            cols.append((x * z % Q, y * z % Q, z))
        else:  # (x z^2, y z^3, z)
            cols.append((x * z * z % Q, y * pow(z, 3, Q) % Q, z))
    return tuple(FQ.tensor([col[k] for col in cols], "cpu") for k in range(3)), ks


def _host_sum(ks, c):
    """sum_w 2^(c w) k_w G, as one scalar multiple of G."""
    k = sum(kw << (c * w) for w, kw in enumerate(ks)) % R
    return g1_mul(g1_generator(), k) if k else None


def test_plain_combine_matches_gemini_tpu_and_host_sum():
    """_combine on CPU tensors, projective and Jacobian totals, at the
    (c, W) of the 2^20, 2^18 and 256-lane plans with 1, 2 and 9 sets:
    each set's point against (sum_w 2^(c w) k_w) G on the host, where
    T_w = k_w G, and so the Jacobian totals turned projective
    (_jacobian_to_proj, the identity (1, 1, 0) among them); gemini_tpu's
    _horner_host on the one set's Jacobian totals (its affine result's
    limbs decoded by the port)."""
    rnd = random.Random(1801)
    for c, windows in PLANS:
        for sets in (1, 2, 9):
            for proj in (True, False):
                totals, ks = _totals(rnd, sets, windows, proj)
                want = [_host_sum(ks[s * windows:(s + 1) * windows], c)
                        for s in range(sets)]
                got = g1.decode_jacobian(msm._combine(totals, sets, c, proj))
                assert got == want, (c, windows, sets, proj)
                if not proj:  # the Jacobian totals as the card's combine takes them
                    ptot = msm._jacobian_to_proj(*totals)
                    assert g1.decode_jacobian(msm._combine(ptot, sets, c, True)) == want
                if sets == 1 and not proj:
                    jr = jmsm._horner_host(tuple(jnp.asarray(t.numpy().astype(np.uint32))
                                                 for t in totals), c)
                    jp = g1.JPoint(*(torch.from_numpy(np.asarray(t).astype(np.int32))
                                     for t in jr))
                    assert g1.decode_jacobian(jp) == want, (c, windows)


def _instance(n, seed):
    rng = np.random.default_rng(seed)
    base = [g1_mul(g1_generator(), k) for k in random.Random(seed).sample(range(1, 1 << 30), 24)]
    pts = [base[i % len(base)] for i in range(n)]
    pts[3] = None
    ks = [(int(x) << 190 | int(x)) % R for x in rng.integers(0, 1 << 62, size=n)]
    ks[:3] = [0, R - 1, 1]
    return pts, ks


def _no_combine_kernel(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached msm_kernels.combine")

    monkeypatch.setattr(msm_kernels, "combine", boom)


def test_msm_batch_results_per_set(monkeypatch):
    """msm_batch (host_max=0, one combine for every set) gives each set's
    MSM as the host Pippenger does, each a JPoint of batch (1,), with a
    set of zero scalars (the identity) and a set shorter than the base
    array; msm_kernels.combine made to raise.  (_combine's Jacobian
    branch: the first case.)"""
    _no_combine_kernel(monkeypatch)
    pts, ks = _instance(200, 1802)
    sets = [FR.tensor(ks[:s], "cpu", mont=False) for s in (200, 77)]
    sets.append(FR.tensor([0] * 50, "cpu", mont=False))
    res = msm.msm_batch(g1.encode_affine(pts, "cpu"), sets, host_max=0)
    assert all(tuple(r.x.shape) == (24, 1) for r in res)
    assert [g1.decode_jacobian(r)[0] for r in res] == [
        g1_msm(pts, ks), g1_msm(pts[:77], ks[:77]), None]


def test_cpu_tensors_never_reach_msm_combine(monkeypatch):
    """With msm_kernels.combine made to raise, the CPU pipeline's msm and
    GLV split still combine on the host and give the host Pippenger's
    point."""
    _no_combine_kernel(monkeypatch)
    pts, ks = _instance(120, 1803)
    ap, sc = g1.encode_affine(pts, "cpu"), FR.tensor(ks, "cpu", mont=False)
    want = g1_msm(pts, ks)
    assert g1.decode_jacobian(msm.msm(ap, sc, host_max=0))[0] == want
    assert g1.decode_jacobian(msm.msm(ap, sc, glv=True, host_max=0))[0] == want
