#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gemini_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels and the native host library from the sources in
the checkout, then, in order:

  1. prints the card's name and power limit (nvidia-smi);
  2. holds each kernel (padd, padd01, mont_mul) against its plain
     PyTorch version on 2^16 lanes with edge lanes, bit for bit, checks
     the group law on real points, and times both at 2^20 lanes;
  3. runs the kernel MSM pipeline at 2^16 against the host Pippenger
     and times it at 2^20 on bench.py's inputs;
  4. proves the golden instance on the card and compares the proof
     bytes with gemini_tpu's (gemini_tpu_torch/testdata/snark_golden.json);
  5. proves and verifies the examples/snark.py -i 18 --time-prover
     instance (SRS built on the card), rejects a tampered proof, and
     shows that the prove went through every kernel;
  6. prints one JSON line per kernel table, the card line, and as the
     last line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero; without a CUDA device
it exits non-zero before printing a result.  Tolerance everywhere:
exact (integer arithmetic).
"""

import copy
import json
import os
import random
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM
# 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s = 128 FMA lanes
# per SM.  An SM has 64 int32 lanes, so 32-bit integer multiply-add runs
# at a quarter of the float32 FLOP rate; a 32x32->64 word product takes
# two IMADs (low and high word).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
WORD_PRODUCTS = {"padd": 21 * 144, "padd01": 15 * 144, "mont_mul": 2 * 144}
SOURCE = "gemini_tpu_torch/csrc/g1_kernels.cu"
REPLACES = {
    "padd": "gemini_tpu/curve/pallas_g1.py:616",
    "padd01": "gemini_tpu/curve/pallas_g1.py:624",
    "mont_mul": "gemini_tpu/curve/pallas_g1.py:612",
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def build_all():
    """nvcc for the kernels and g++ for the native host libraries, started
    together."""
    from gemini_tpu_torch import native
    from gemini_tpu_torch.curve import g1_kernels
    from gemini_tpu_torch.native import bls

    errs = []

    def host():
        try:
            if native.load() is None or not bls.available():
                errs.append("native host library failed to build")
        except Exception as e:  # reported below, the run fails
            errs.append(repr(e))

    t0 = time.time()
    th = threading.Thread(target=host)
    th.start()
    g1_kernels.build(verbose=True)
    th.join()
    if errs:
        raise RuntimeError("; ".join(errs))
    log(f"build: {time.time() - t0:.2f} s (nvcc + g++ in parallel)")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


EDGE_KINDS = ("P+P", "P+P'", "P-P", "O+P", "P+O", "O+O", "P+Q>p")


def kernel_inputs(n: int, seed: int):
    """Random lanes plus edge lanes: P = Q (the same and another
    projective representative), P = -Q, the identity on either or both
    sides, and coordinates in [p, 2p); padd01 also gets every mask
    combination.  Returns (padd ins, padd01 ins, mont_mul ins, edge list
    of (lane, host sum))."""
    import numpy as np
    import torch

    from gemini_tpu_torch.fields.fp import FQ
    from gemini_tpu_torch.hostcurve import g1_add, g1_mul
    from gemini_tpu_torch.params import Q, R
    from gemini_tpu_torch.refimpl import g1_generator

    rng = np.random.default_rng(seed)
    rnd = random.Random(seed)

    def below(top):  # 24 x n limbs, top limb < top (< 2p: 0x3402, < p: 0x1A01)
        a = rng.integers(0, 1 << 16, size=(24, n)).astype(np.int64)
        a[23] = rng.integers(0, top, size=n)
        return a

    def put(arr, lane, val):
        arr[:, lane] = [(val >> (16 * i)) & 0xFFFF for i in range(24)]

    def mont(v):
        return v * FQ.mont_r % Q

    def proj(P, big=False):  # random projective representative, or (0 : y : 0)
        if P is None:
            return (0, mont(rnd.randrange(1, Q)), 0)
        z = rnd.randrange(1, Q)
        rep = (mont(P[0] * z % Q), mont(P[1] * z % Q), mont(z))
        return tuple(v + Q for v in rep) if big else rep

    def affine(P, big=False):  # (x, y, live) with z in {0, 1}
        if P is None:
            return (0, mont(rnd.randrange(1, Q)), 0)
        rep = (mont(P[0]), mont(P[1]))
        return (*(v + Q for v in rep), 1) if big else (*rep, 1)

    x1, y1, z1, x2, y2, z2 = (below(0x3402) for _ in range(6))
    ax1, ay1, ax2, ay2 = (below(0x3402) for _ in range(4))
    m1 = rng.integers(0, 2, size=n)
    m2 = rng.integers(0, 2, size=n)
    edges = []
    lane = 0
    pts = [g1_mul(g1_generator(), rnd.randrange(1, R)) for _ in range(16)]
    for k, P in enumerate(pts):
        Qp = pts[(k + 1) % len(pts)]
        negP = (P[0], Q - P[1])
        for kind in EDGE_KINDS:
            A, B, big = {
                "P+P": (P, P, False), "P+P'": (P, P, False),
                "P-P": (P, negP, False), "O+P": (None, P, False),
                "P+O": (P, None, False), "O+O": (None, None, False),
                "P+Q>p": (P, Qp, True),
            }[kind]
            a = proj(A, big)
            b = a if kind == "P+P" else proj(B, big)
            for arr, v in zip((x1, y1, z1, x2, y2, z2), (*a, *b)):
                put(arr, lane, v)
            (u1, v1, l1), (u2, v2, l2) = affine(A, big), affine(B, big)
            for arr, v in zip((ax1, ay1, ax2, ay2), (u1, v1, u2, v2)):
                put(arr, lane, v)
            m1[lane], m2[lane] = l1, l2
            edges.append((lane, g1_add(A, B)))
            lane += 1
    ax1[:, m1 == 0] = 0  # dead lanes are (0 : y : 0)
    ax2[:, m2 == 0] = 0
    a, b = below(0x1A01), below(0x1A01)  # < p
    for i, v in enumerate((0, 1, Q - 1, FQ.mont_r)):
        put(a, i, v)
        put(b, i + 4, v)

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).cuda()

    return ([t(v) for v in (x1, y1, z1, x2, y2, z2)],
            [t(ax1), t(ay1), t(m1), t(ax2), t(ay2), t(m2)],
            [t(a), t(b)], edges)


def check_group_law(outs, edges, label):
    """The projective outputs of the edge lanes, normalized on the host,
    must equal the host group law (relaxed limbs < 2p decode to the
    right residue)."""
    from gemini_tpu_torch.fields.fp import FQ
    from gemini_tpu_torch.params import Q

    lanes = [lane for lane, _ in edges]
    X, Y, Z = (FQ.decode(o[:, lanes].cpu().numpy()) for o in outs)
    for (lane, want), x, y, z in zip(edges, X, Y, Z):
        got = None if z == 0 else (x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q)
        if got != want:
            raise AssertionError(f"{label}: group law wrong on lane {lane}")


def phase_kernels(results):
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk

    n = 1 << 16
    padd_in, padd01_in, mm_in, edges = kernel_inputs(n, seed=20261016)
    cases = {
        "padd": (lambda ins: gk.padd(ins[:3], ins[3:]), gk.padd_plain, padd_in),
        "padd01": (lambda ins: gk.padd01((ins[0], ins[1], ins[2]),
                                         (ins[3], ins[4], ins[5])),
                   gk.padd01_plain, padd01_in),
        "mont_mul": (lambda ins: (gk.mont_mul(*ins),),
                     lambda a, b: (gk.mont_mul_plain(a, b),), mm_in),
    }
    for name, (kern, plain, ins) in cases.items():
        got = kern(ins)
        want = plain(*ins)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        if not exact:
            raise AssertionError(f"{name}: kernel differs from plain version "
                                 f"(max abs limb error {err})")
        if name in ("padd", "padd01"):
            check_group_law(got, edges, name)
        results[name] = {"max_abs_err": err, "bit_exact": exact}
        log(f"kernel {name}: bit-exact against plain on {n} lanes "
            f"(edge lanes included), group law checked")

    # timing at 2^20 lanes
    n = 1 << 20
    reps = n // (1 << 16)
    big = {k: [t.repeat(1, reps) if t.dim() == 2 else t.repeat(reps)
               for t in v[2]] for k, v in cases.items()}
    for name, (kern, plain, _) in cases.items():
        ins = big[name]
        ms = cuda_ms(lambda: kern(ins), 20)
        plain_ms = cuda_ms(lambda: plain(*ins), 2)
        wp = WORD_PRODUCTS[name]
        coords_in = {"padd": 6, "padd01": 4, "mont_mul": 2}[name]
        coords_out = 1 if name == "mont_mul" else 3
        nbytes = n * 96 * (coords_in + coords_out) + (8 * n if name == "padd01" else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n * wp * 2 / IMAD_PER_S * 1e3
        results[name].update(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            lanes=n)
        log(f"kernel {name} at 2^20 lanes: {ms:.4f} ms (plain {plain_ms:.2f} ms, "
            f"bound {max(t_bytes, t_ops):.4f} ms)")


# ---------------------------------------------------------------------------
# Phase 3: MSM
# ---------------------------------------------------------------------------


def phase_msm():
    import numpy as np
    import torch

    from gemini_tpu_torch.curve import g1
    from gemini_tpu_torch.fields.fp import FR
    from gemini_tpu_torch.hostcurve import g1_msm, g1_mul
    from gemini_tpu_torch.ops.msm import msm
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.refimpl import g1_generator

    rnd = random.Random(0xBEEF)
    host_pts = [g1_mul(g1_generator(), rnd.randrange(1, R)) for _ in range(512)]
    ap = g1.encode_affine(host_pts, "cuda")

    def inputs(n):
        reps = -(-n // 512)
        pts = g1.APoint(ap.x.repeat(1, reps)[:, :n], ap.y.repeat(1, reps)[:, :n],
                        ap.inf.repeat(reps)[:n])
        rng = np.random.RandomState(7)
        s = np.zeros((FR.n_limbs, n), dtype=np.int64)
        for i in range(FR.n_limbs):
            s[i] = rng.randint(0, 1 << 16, size=n)
        s[FR.n_limbs - 1] &= 0x0FFF
        return pts, torch.from_numpy(s.astype(np.int32)).cuda(), s

    n = 1 << 16
    pts, sc, s_np = inputs(n)
    got = g1.decode_jacobian(msm(pts, sc))[0]
    ks = [sum(int(s_np[i, j]) << (16 * i) for i in range(FR.n_limbs)) for j in range(n)]
    t0 = time.time()
    want = g1_msm([host_pts[j % 512] for j in range(n)], ks)
    host_s = time.time() - t0
    if got != want:
        raise AssertionError("MSM 2^16: kernel pipeline differs from host Pippenger")
    log(f"msm 2^16: kernel pipeline == host Pippenger (host {host_s:.2f} s)")

    n = 1 << 20
    pts, sc, _ = inputs(n)
    t0 = time.time()
    out = msm(pts, sc)
    torch.cuda.synchronize()
    warm = time.time() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.time()
        out = msm(pts, sc)
        torch.cuda.synchronize()
        best = min(best, time.time() - t0)
    g1.decode_jacobian(out)
    log(json.dumps({"metric": "msm_g1_points_per_s_2^20", "value": n / best,
                    "best_s": best, "first_s": warm}))


# ---------------------------------------------------------------------------
# Phases 4-5: proofs
# ---------------------------------------------------------------------------


def phase_golden():
    from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
    from gemini_tpu_torch.relation import random_r1cs
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof

    with open(os.path.join(HERE, "gemini_tpu_torch", "testdata",
                           "snark_golden.json")) as f:
        golden = json.load(f)
    r1 = random_r1cs(random.Random(golden["r1cs_seed"]), golden["n"], device="cuda")
    ck = CommitterKey.new(max_degree=golden["max_degree"],
                          max_eval_points=golden["max_eval_points"],
                          seed=golden["srs_seed"], device="cuda")
    proof = Proof.new_time(r1, ck)
    if snark_proof_bytes(proof).hex() != golden["proof_hex"]:
        raise AssertionError("golden proof bytes differ from gemini_tpu's")
    proof.verify(r1, VerifierKey.from_committer_key(ck))
    log("golden instance: proof bytes equal gemini_tpu's, proof verifies")


def phase_full(results):
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.relation import dummy_r1cs
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof, SnarkVerificationError

    logn = 18
    n = 1 << logn
    t0 = time.time()
    r1cs = dummy_r1cs(random.Random(0), n, device="cuda")
    ck = CommitterKey.new(max_degree=n, max_eval_points=3, seed=0, device="cuda")
    vk = VerifierKey.from_committer_key(ck)
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    gk.reset_launches()
    os.environ["GEMINI_TPU_TRACE"] = "1"
    t0 = time.time()
    proof = Proof.new_time(r1cs, ck)
    torch.cuda.synchronize()
    prove_s = time.time() - t0
    os.environ.pop("GEMINI_TPU_TRACE")
    t0 = time.time()
    proof.verify(r1cs, vk)
    verify_s = time.time() - t0
    launches = dict(gk.LAUNCHES)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the 2^{logn} prove launched no {name} kernel")
        results[name]["launches"] = count

    bad = copy.deepcopy(proof)
    bad.zc_alpha = (bad.zc_alpha + 1) % R
    try:
        bad.verify(r1cs, vk)
    except SnarkVerificationError:
        pass
    else:
        raise AssertionError("tampered proof accepted")
    log(json.dumps({"snark_time_prover_logn": logn, "setup_s": setup_s,
                    "prove_s": prove_s, "verify_s": verify_s,
                    "proof_bytes": len(snark_proof_bytes(proof)),
                    "launches": launches, "tampered_rejected": True}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import gemini_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.time()
    build_all()
    card = card_line()
    log(card)
    results = {}
    phase_kernels(results)
    phase_msm()
    phase_golden()
    phase_full(results)
    kernels = []
    for name in ("padd", "padd01", "mont_mul"):
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "bit_exact": r["bit_exact"], "lanes": r["lanes"],
        })
    log(f"total: {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
