"""KZG polynomial commitment, time-efficient flavour (port of
gemini_tpu/kzg/commit.py; kzg/time.rs analogue).

Prover-side objects (SRS G1 powers, coefficient vectors, quotients)
live on the device as limb tensors; commitments and proofs are single
G1 points returned to the host.  Verification is host-side over the
native pairing, as in the reference (kzg/mod.rs:155-244).

  * SRS generation on CUDA: a host window table of generator multiples,
    one device gather per (window, scalar) and a tree of padd01/padd
    launches over the window axis (`fixed_base_msm`), or of Jacobian add
    launches under GEMINI_TPU_PROJ=0.  With CPU tensors
    the native host fixed-base builds the same points.
  * commit: one G1 MSM (ops/msm.py).
  * open: synthetic division as a suffix scan,
    q_i = alpha^-(i+1) * sum_{j>i} f_j alpha^j.
  * multi-point open: chained single-point divisions.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import torch

from ..curve import g1
from ..curve.g1 import APoint, JPoint
from ..device import resolve
from ..fields import fp
from ..fields.fp import FQ, FR
from ..hostcurve import g1_add, g1_msm, g1_mul, g1_neg, g2_add, g2_mul, pairing
from ..ops import ec_scan, poly, scan
from ..ops.msm import (
    _proj_to_jacobian,
    _use_proj,
    combiners,
    extract_digits,
    msm_batch,
    msm_mont_scalars,
)
from ..params import R
from ..refimpl import g1_generator, g2_generator

G1Host = Optional[Tuple[int, int]]


class KZGVerificationError(Exception):
    pass


def _apoint_slice(a: APoint, n: int) -> APoint:
    return APoint(a.x[:, :n], a.y[:, :n], a.inf[:n])


def _fb_tree(tx, ty, tinf, idx, use_proj: bool):
    """One gather of every window's table entry + a tree reduction over
    the WINDOW axis (log2(W) levels of complete adds per scalar; level 0
    on padd01, or on the Jacobian add kernel under GEMINI_TPU_PROJ=0).
    Returns Jacobian coordinate planes (L, n)."""
    comb, comb01 = combiners(use_proj)
    gx, gy, ginf = tx[:, idx], ty[:, idx], tinf[idx]  # (24, W, n), (W, n)
    dev = gx.device
    gy = fp.select(ginf, FQ.ones_mont(ginf.shape, dev), gy)
    gx = fp.select(ginf, torch.zeros_like(gx), gx)
    mask = ~ginf
    h = gx.shape[1] // 2  # W is a power of two (c = 8 -> W = 32)
    x, y, z = comb01((gx[:, :h], gy[:, :h], mask[:h]),
                     (gx[:, h:], gy[:, h:], mask[h:]))
    x, y, z = ec_scan.tree_reduce(
        (x.transpose(1, 2), y.transpose(1, 2), z.transpose(1, 2)),
        combiner=comb)
    x, y, z = x[..., 0], y[..., 0], z[..., 0]
    if use_proj:
        return _proj_to_jacobian(x, y, z)
    return x, y, z


def fixed_base_msm(base: G1Host, scalars_canonical, c: int = 8,
                   block: int = 1 << 15) -> APoint:
    """[s_i * base for i] as one batched device computation: the host
    precomputes the window table T[w][d] = d * 2^(c*w) * base, the
    device gathers one table entry per (window, scalar) and
    tree-reduces over the window axis, blocked over scalars to bound
    the (L, W, block) working set (kzg/time.rs:55-59)."""
    from ..utils.trace import end_timer, start_timer

    dev = scalars_canonical.device
    n = scalars_canonical.shape[1]
    n_windows = -(-255 // c)
    t = start_timer("fixed_base_msm::host table")
    table: List[G1Host] = []
    for w in range(n_windows):
        base_w = g1_mul(base, 1 << (c * w))
        row: List[G1Host] = [None]
        for _ in range((1 << c) - 1):
            row.append(g1_add(row[-1], base_w))
        table.extend(row)
    tbl = g1.encode_affine(table, dev)
    end_timer(t)
    t = start_timer("fixed_base_msm::device adds")
    digits = extract_digits(scalars_canonical, c)
    offs = torch.arange(n_windows, device=dev)[:, None] << c
    idx = digits + offs  # (W, n); digit 0 rows hit table entry None
    use_proj = _use_proj()
    outs = [_fb_tree(tbl.x, tbl.y, tbl.inf, idx[:, s:s + block], use_proj)
            for s in range(0, n, block)]
    acc = JPoint(*(torch.cat([o[k] for o in outs], dim=1) for k in range(3)))
    end_timer(t)
    t = start_timer("fixed_base_msm::to_affine")
    out = g1.to_affine(acc)
    end_timer(t)
    return out


def _suffix_sums(v):
    n = v.shape[1]
    npad = scan.next_pow2(n)
    if npad != n:  # zero tail never changes suffix sums of real slots
        v = torch.cat([v, v.new_zeros((v.shape[0], npad - n))], dim=1)
    return scan.inclusive_scan(lambda a, b: fp.add(FR, a, b), v, axis=1,
                               reverse=True)[:, :n]


def divide_linear(coeffs, alpha: int):
    """Divide f (Montgomery (L, n)) by (x - alpha): returns (f(alpha)
    canonical int, quotient (L, n-1) Montgomery).  With
    S_i = sum_{j>=i} f_j alpha^j: f(alpha) = S_0, q_i = S_{i+1} alpha^-(i+1)
    (kzg/time.rs:117-124)."""
    n = coeffs.shape[1]
    if n == 0:
        return 0, coeffs
    if n == 1:
        return FR.decode(coeffs)[0], coeffs[:, :0]
    if alpha % R == 0:
        return FR.decode(coeffs[:, :1])[0], coeffs[:, 1:]
    dev = coeffs.device
    t = fp.mont_mul(FR, coeffs, poly.powers(FR, alpha, n, dev))
    s = _suffix_sums(t)
    evaluation = FR.decode(s[:, :1])[0]
    pwinv = poly.powers(FR, pow(alpha, -1, R), n, dev)[:, 1:]
    return evaluation, fp.mont_mul(FR, s[:, 1:], pwinv)


def vanishing_polynomial_host(points: Sequence[int]) -> List[int]:
    """Coefficients (LE) of prod (x - p) over Fr (kzg/mod.rs:262)."""
    coeffs = [1]
    for p in points:
        nxt = [0] * (len(coeffs) + 1)
        for i, ci in enumerate(coeffs):
            nxt[i] = (nxt[i] - p * ci) % R
            nxt[i + 1] = (nxt[i + 1] + ci) % R
        coeffs = nxt
    return coeffs


class CommitterKey:
    """SRS: device G1 powers of tau + host G2 powers (kzg/time.rs:24).

    `devices`: with two or more, every commit MSM splits its lanes
    across them (parallel/msm.py); each shard's slice of the SRS moves
    to its device for the call."""

    def __init__(self, powers_of_g: APoint, powers_of_g2: List, tau=None,
                 devices: Optional[Sequence] = None):
        self.powers_of_g = powers_of_g
        self.powers_of_g2 = powers_of_g2
        self._tau = tau  # retained only by insecure test setups
        self.devices = devices

    def with_devices(self, devices: Sequence) -> "CommitterKey":
        """The same SRS, its commits routed across `devices`."""
        return CommitterKey(self.powers_of_g, self.powers_of_g2, tau=self._tau,
                            devices=list(devices))

    @classmethod
    def new(cls, max_degree: int, max_eval_points: int, seed: int = 0,
            tau: Optional[int] = None, device=None) -> "CommitterKey":
        """Insecure test-only setup (trapdoor from a seeded RNG), like the
        reference's `CommitterKey::new` (kzg/time.rs:49-72).  On CUDA the
        G1 powers are built on the card (`fixed_base_msm`); with
        device="cpu" by the native host fixed-base when it is built."""
        from ..native import bls as _nbls

        dev = resolve(device)
        rng = random.Random(seed)
        tau = tau if tau is not None else rng.randrange(1, R)
        g = g1_mul(g1_generator(), rng.randrange(1, R))
        g2 = g2_mul(g2_generator(), rng.randrange(1, R))
        if dev.type == "cpu" and _nbls.available():
            taus_int, t = [], 1
            for _ in range(max_degree + 1):
                taus_int.append(t)
                t = t * tau % R
            powers_of_g = g1.encode_affine(_nbls.g1_fixed_base(g, taus_int), dev)
        else:
            taus = poly.powers(FR, tau, max_degree + 1, dev)
            powers_of_g = fixed_base_msm(g, fp.from_mont(FR, taus))
        tau_pows = 1
        powers_of_g2 = []
        for _ in range(max_eval_points + 1):
            powers_of_g2.append(g2_mul(g2, tau_pows))
            tau_pows = tau_pows * tau % R
        return cls(powers_of_g, powers_of_g2, tau=tau)

    def max_eval_points(self) -> int:
        return len(self.powers_of_g2) - 1

    def commit(self, coeffs) -> G1Host:
        """One G1 MSM over the SRS prefix; coeffs Montgomery (L, n)."""
        n = coeffs.shape[1]
        assert n <= self.powers_of_g.x.shape[1], (
            f"polynomial length {n} exceeds SRS size "
            f"{self.powers_of_g.x.shape[1]}")
        result = msm_mont_scalars(_apoint_slice(self.powers_of_g, n), coeffs,
                                  devices=self.devices)
        return g1.decode_jacobian(result)[0]

    def batch_commit(self, polys: Sequence) -> List[G1Host]:
        """One batched-window MSM pipeline per power-of-4 size bucket for
        all polynomials (the fold-tree commit: log n polynomials of
        halving sizes)."""
        polys = list(polys)
        if not polys:
            return []
        nmax = max(p.shape[1] for p in polys)
        assert nmax <= self.powers_of_g.x.shape[1], (
            f"polynomial length {nmax} exceeds SRS size "
            f"{self.powers_of_g.x.shape[1]}")
        if self.devices is not None and len(self.devices) > 1:
            from ..parallel.msm import msm_batch_multichip

            run = lambda sets: msm_batch_multichip(self.powers_of_g, sets,
                                                   devices=self.devices)
        else:
            run = lambda sets: msm_batch(self.powers_of_g, sets)
        canon = [fp.from_mont(FR, p) for p in polys]
        groups: dict = {}
        for i, p in enumerate(canon):
            groups.setdefault(scan.bucket4(max(p.shape[1], 1), floor=256),
                              []).append(i)
        results: list = [None] * len(polys)
        for b in sorted(groups, reverse=True):
            idxs = groups[b]
            for i, r in zip(idxs, run([canon[i] for i in idxs])):
                results[i] = r
        # one readback for every group's results
        return g1.decode_jacobian(JPoint(*(torch.cat(coord, dim=1)
                                           for coord in zip(*results))))

    def open(self, coeffs, alpha: int):
        """-> (evaluation, proof): commitment to the quotient
        (kzg/time.rs:112-131)."""
        evaluation, quotient = divide_linear(coeffs, alpha)
        if quotient.shape[1] == 0:
            return evaluation, None
        return evaluation, self.commit(quotient)

    def open_multi_points(self, coeffs, points: Sequence[int]) -> G1Host:
        q = coeffs
        for pt in points:
            _, q = divide_linear(q, pt)
        if q.shape[1] == 0:
            return None
        return self.commit(q)

    def batch_open_multi_points(self, polys: Sequence, points: Sequence[int],
                                eval_chal: int) -> G1Host:
        """Open sum_i eta^i f_i at every point (kzg/time.rs:149-159)."""
        assert len(points) < len(self.powers_of_g2)
        etas = poly.powers_host(eval_chal, len(polys))
        batched = poly.linear_combination(FR, list(polys), etas)
        return self.open_multi_points(batched, points)


class VerifierKey:
    """Host-side verification key (kzg/mod.rs:144-149)."""

    def __init__(self, powers_of_g: List[G1Host], powers_of_g2: List):
        self.powers_of_g = powers_of_g
        self.powers_of_g2 = powers_of_g2

    @classmethod
    def from_committer_key(cls, ck: CommitterKey) -> "VerifierKey":
        m = ck.max_eval_points()
        host_g = g1.decode_affine(_apoint_slice(ck.powers_of_g, m))
        return cls(host_g, list(ck.powers_of_g2))

    def verify(self, commitment: G1Host, alpha: int, evaluation: int,
               proof: G1Host) -> None:
        """Single-point check e(C - vG, H) == e(pi, tauH - alphaH)
        (kzg/mod.rs:155-172)."""
        ep = g2_add(g2_mul(self.powers_of_g2[0], (-alpha) % R),
                    self.powers_of_g2[1])
        lhs = g1_add(commitment, g1_neg(g1_mul(self.powers_of_g[0], evaluation)))
        if pairing(lhs, self.powers_of_g2[0]) != pairing(proof, ep):
            raise KZGVerificationError("single-point KZG check failed")

    def verify_multi_points(self, commitments: Sequence[G1Host],
                            eval_points: Sequence[int],
                            evaluations: Sequence[Sequence[int]],
                            proof: G1Host, open_chal: int) -> None:
        """Batched multi-point check via Lagrange interpolation of the
        claimed evaluations (kzg/mod.rs:180-244).
        evaluations[i][j] = claimed f_i(eval_points[j])."""
        zeros_coeffs = vanishing_polynomial_host(eval_points)
        zeros = None
        for z, h in zip(zeros_coeffs, self.powers_of_g2):
            zeros = g2_add(zeros, g2_mul(h, z)) if zeros is not None else \
                g2_mul(h, z)
        etas = poly.powers_host(open_chal, len(evaluations))
        i_poly = [0] * len(eval_points)
        for evals, eta in zip(evaluations, etas):
            for k, ck_ in enumerate(_interpolate(eval_points, evals)):
                i_poly[k] = (i_poly[k] + eta * ck_) % R
        i_comm = g1_msm(list(self.powers_of_g[:len(i_poly)]), i_poly)
        f_comm = g1_msm(list(commitments), list(etas))
        lhs = g1_add(f_comm, g1_neg(i_comm) if i_comm is not None else None)
        if pairing(lhs, self.powers_of_g2[0]) != pairing(proof, zeros):
            raise KZGVerificationError("multi-point KZG check failed")


def _interpolate(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """Lagrange interpolation over Fr -> LE coefficients."""
    n = len(xs)
    coeffs = [0] * n
    for j in range(n):
        denom = 1
        for k in range(n):
            if k != j:
                denom = denom * (xs[j] - xs[k]) % R
        scale = ys[j] * pow(denom, -1, R) % R
        num = [1]
        for k in range(n):
            if k == j:
                continue
            nxt = [0] * (len(num) + 1)
            for i, ci in enumerate(num):
                nxt[i] = (nxt[i] - xs[k] * ci) % R
                nxt[i + 1] = (nxt[i + 1] + ci) % R
            num = nxt
        for i, ci in enumerate(num):
            coeffs[i] = (coeffs[i] + scale * ci) % R
    return coeffs
