#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gemini_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels (one nvcc per csrc/*.cu, all at once) and the
native host library from the sources in the checkout, then, in order:

  1. prints the card's name and power limit (nvidia-smi);
  2. holds each group-law kernel (padd, padd01, mont_mul, add, dbl)
     against its plain PyTorch version, bit for bit, on 2^14 lanes (the
     prove's small launches), 2^16 lanes and fresh 2^20-lane inputs (the
     MSM launches them at up to 2^19 lanes), edge lanes and add's warp
     layouts (a warp of P = Q, P = Q only at lane 0 or 31, a warp of
     O + O, warps mixing O + P, P + O, P = -Q) included, checks the
     group law on real points, holds padd, padd01 and add on the MSM's
     strided views (halves, even/odd, transposed halves of (24, 4, n)
     tensors), shows that the guarded timer refuses a plain version,
     and times every kernel at 2^20 lanes and all but mont_mul at 2^14;
  2b. holds the probe kernels against their plain versions (vpu_chain at
     vpubench's 32 x 65536 elements, K = 128 and 512, uint32 and
     float32; copy_add at mmbench's 24 x 2^16 limbs, at 24 x 2^20, at an
     odd count, misaligned, and a non-contiguous slice the wrapper
     copies), then runs the l2bench entry point (the L2's read-write
     rate, copy_add's bound at 24 x 2^16; copy_add, torch.add and
     copy_add's other launch shapes at both shapes, by the guarded
     event timer and by torch.profiler's device time), the vpubench and
     mmbench entry points (the measured int32 multiply-add rate is the
     second denominator of every operations bound, and mmbench gives
     the cost of one launch), then addbench and coreops at their
     defaults;
  2c. drives the group API on the card: scalar_mul of 2^12 points by
     255-bit scalars and add_mixed, against the host;
  3. runs the kernel MSM pipeline at 2^16 against the host Pippenger and
     times it at 2^20 on bench.py's inputs, in the projective and in the
     Jacobian configuration (GEMINI_TPU_PROJ=0);
  4. proves the SNARK and the pSNARK golden instances on the card in
     both configurations, compares the proof bytes (and the pSNARK's
     index commitments) with gemini_tpu's
     (gemini_tpu_torch/testdata/{snark,psnark}_golden.json) and verifies
     them, then parses gemini_tpu's pSNARK bytes with the port's
     psnark_proof_from_bytes and verifies that proof on the card; the
     elastic prover (block size 8, threshold 2) gives the golden SNARK
     bytes, and the dummy stream with the constant-base τ = 1 key gives
     gemini_tpu's elastic bytes (testdata/elastic_golden.json), in both
     configurations;
  5. proves and verifies the examples/snark.py -i 18 --time-prover
     instance (SRS built on the card), rejects a tampered proof, and
     shows that the prove went through padd, padd01 and mont_mul;
  5b. does the same under GEMINI_TPU_PROJ=0 and shows that the SRS and
     the prove went through the Jacobian add kernel and not padd/padd01;
  5c. the pSNARK at 2^18 (examples/psnark.py -i 18): dummy_r1cs(Random(0),
     2^18), SRS built on the card with max_degree = 2n + nnz + 2, index,
     prove and verify each timed on the host clock ending in a
     synchronize, the bytes -> parse -> verify round trip, tampered
     zc_alpha and set_z_ep rejected; prints one JSON line with the
     times, proof bytes, psnark::* spans, launches and lanes per kernel
     (counts reset before the prove; padd, padd01 and mont_mul must
     each launch), peak device memory and the card line;
  5d. the elastic SNARK (examples/snark.py -i 24, BASELINE config 4):
     DummyR1csStream(2^24, e = Random(0).randrange(1, R)) with
     FakeCommitterKeyStream(3, seed=0, max_msm_buffer=2^20), block size
     2^20, threshold 22.  First the 2^24 prove; then at 2^20 with
     threshold 16 (four streaming rounds), whose bytes must equal the
     time prover's on the dense twin (CommitterKey.new(2^20, 3, seed=0,
     tau=1)); then the 2^24 proof verified against the dense relation,
     a tampered zc_alpha rejected; prints one {"snark_elastic_logn": 24,
     ...} JSON line (prove and verify seconds, proof bytes, peak device
     memory, host RSS before the prove (after a heap trim), its peak and
     the difference, spans, launches and lanes; padd and padd01 must
     launch, counts reset before the prove) with the card line;
  6. profiles one projective MSM at 2^20, one Jacobian MSM at 2^20, one
     projective 2^18 prove and two streamed passes of the elastic prove
     (a space-prover round over two 2^20 blocks, one 2^20 block of the
     dummy stream's abc vector) with torch.profiler and prints, as one
     JSON line, each window's device busy share, device ms per kernel
     (the port's own and the ten largest others), the PyTorch copy
     kernels' device ms, and the lanes each group-law kernel took;
  6b. counts, untimed, the add lanes and warps that need the doubling in
     one more Jacobian MSM at 2^20 and one more Jacobian 2^18 prove;
  7. prints the total seconds, the kernel table as one JSON line
     (bounds, shares of bound, ptxas registers and spills), the card
     line, and as the last line {"ok": true, "device": {...}}.  Each
     phase prints its seconds and the host RSS at its start and end.

Each kernel's launch count is read from its own path, with every count
set to 0 just before the path runs: padd, padd01, mont_mul from the
projective prove (5), add from the Jacobian prove (5b), dbl from the
group API (2c), vpu_chain from vpubench, copy_add from mmbench (2b).
The pSNARK prove's (5c) padd, padd01 and mont_mul launches are the
table's `psnark_launches`, the 2^24 elastic prove's (5d) its
`elastic_launches`.

Any failure raises and the script exits non-zero; without a CUDA device
it exits non-zero before printing a result.  Tolerance everywhere:
exact (integer arithmetic), except vpu_chain on float32, whose plain
version rounds each step from float64 (relative error stated, < 1e-6).
"""

import contextlib
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
# per SM.  An SM has 64 int32 lanes, so the data-sheet figure for 32-bit
# integer multiply-add is a quarter of the float32 FLOP rate.  Phase 2b
# measures the IMAD rate on the card (vpubench); every operations bound
# is given under both.  A 32x32->64 word product takes two IMADs (low
# and high word); a canonical product (mm) is 2 * 144 word products.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
# Word products a kernel issues per lane: a product or a reduction is
# 144.  add: 16 products and 15 reductions on a lane without the
# doubling (ADD_WORD_PRODUCTS_23MM: the 23 canonical products, 2 * 144
# each, of add-2007-bl beside dbl-2009-l, the first design's count).
WORD_PRODUCTS = {"padd": 21 * 144, "padd01": 15 * 144, "mont_mul": 2 * 144,
                 "add": 31 * 144, "dbl": 7 * 288}
ADD_WORD_PRODUCTS_23MM = 23 * 288
COORDS_IN_OUT = {"padd": (6, 3), "padd01": (4, 3), "mont_mul": (2, 1),
                 "add": (6, 3), "dbl": (3, 3)}
G1_SOURCE = "gemini_tpu_torch/csrc/g1_kernels.cu"
PROBE_SOURCE = "gemini_tpu_torch/csrc/probes.cu"
KERNELS = ("padd", "padd01", "mont_mul", "add", "dbl", "vpu_chain", "copy_add")
SOURCES = {k: G1_SOURCE for k in KERNELS[:5]}
SOURCES.update(vpu_chain=PROBE_SOURCE, copy_add=PROBE_SOURCE)
REPLACES = {
    "padd": "gemini_tpu/curve/pallas_g1.py:616",
    "padd01": "gemini_tpu/curve/pallas_g1.py:624",
    "mont_mul": "gemini_tpu/curve/pallas_g1.py:612",
    "add": "gemini_tpu/curve/pallas_g1.py:596",
    "dbl": "gemini_tpu/curve/pallas_g1.py:604",
    "vpu_chain": "benches/vpubench.py:31",
    "copy_add": "benches/mmbench.py:31",
}


def log(*a):
    print(*a, flush=True)


def trim_host_heap() -> None:
    """Collect garbage and hand freed heap pages back to the OS (glibc's
    malloc_trim), so that an RSS read afterwards counts live memory and
    not what earlier phases freed."""
    import ctypes
    import gc

    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def build_all():
    """nvcc for each kernel source and g++ for the native host libraries,
    all started together."""
    from gemini_tpu_torch import cuda_lib, native
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
    libs = cuda_lib.build()
    th.join()
    if errs:
        raise RuntimeError("; ".join(errs))
    log(f"build: {time.time() - t0:.2f} s (nvcc per source + g++ in parallel)")
    usage = {}
    for stem, (_, report) in libs.items():
        log(f"[{stem}.cu]\n{report.strip()}")
        usage.update(ptxas_usage(report))
    log(json.dumps({"sass": sass_counts(libs["g1_kernels"][0])}))
    log(json.dumps({"ptxas": usage}))
    return usage


def kernel_of(symbol: str, names: dict):
    """The port's kernel a mangled symbol names (a kernel `<sub>` in the
    anonymous namespace mangles as `<len><sub>E`, a template as
    `<len><sub>I`), or None."""
    return next((k for sub, k in names.items()
                 if f"{len(sub)}{sub}E" in symbol or f"{len(sub)}{sub}I" in symbol),
                None)


def ptxas_usage(text: str) -> dict:
    """Registers and spill bytes (stores + loads) per kernel from ptxas
    -v's report; a template kernel's instances give their largest."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = kernel_of(line, ALL_KERNELS)
            if name:
                out.setdefault(name, {"registers": 0, "spill_bytes": 0})
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[name]["spill_bytes"] = max(out[name]["spill_bytes"],
                                           int(m.group(1)) + int(m.group(2)))
        elif name and "Used" in line and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            out[name]["registers"] = max(out[name]["registers"], int(m.group(1)))
    return out


def sass_counts(lib_path: str) -> dict:
    """Instructions per group-law kernel in the built library (cuobjdump
    -sass): all of them, and the wide multiply-adds (IMAD.WIDE*), against
    the formula's word products (WORD_PRODUCTS)."""
    import re

    from gemini_tpu_torch import cuda_lib

    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_of(line, OWN_KERNELS)
            if name:
                out[name] = {"instructions": 0, "imad_wide": 0,
                             "word_products": WORD_PRODUCTS[name]}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            out[name]["instructions"] += 1
            out[name]["imad_wide"] += m.group(1).startswith("IMAD.WIDE")
    return out


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


EDGE_KINDS = ("P+P", "P+P'", "P-P", "O+P", "P+O", "O+O", "P+Q>p")


def kernel_inputs(n: int, seed: int):
    """Random lanes plus edge lanes: P = Q (the same and another
    projective representative), P = -Q, the identity on either or both
    sides, and coordinates in [p, 2p); padd01 also gets every mask
    combination.  The Jacobian add and dbl get canonical lanes (< p):
    random coordinates, and edge lanes P + Q, P = Q (one and two
    representatives), P = -Q and the identity (z = 0) on either or both
    sides, real points at random z.  Returns (padd ins, padd01 ins (bool
    masks), mont_mul ins, padd edges, add/dbl ins, add edges, dbl edges); an edge
    list holds (lane, host result)."""
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

    def jac(P):  # random Jacobian representative (x z^2, y z^3, z), or z = 0
        if P is None:
            return (mont(rnd.randrange(Q)), mont(rnd.randrange(Q)), 0)
        z = rnd.randrange(1, Q)
        return (mont(P[0] * z * z % Q), mont(P[1] * pow(z, 3, Q) % Q), mont(z))

    jin = [below(0x1A01) for _ in range(6)]  # canonical: < p
    add_edges, dbl_edges = [], []

    def put_pair(lane, A, B, one_rep=False):
        a = jac(A)
        b = a if one_rep else jac(B)
        for arr, v in zip(jin, (*a, *b)):
            put(arr, lane, v)
        add_edges.append((lane, g1_add(A, B)))
        dbl_edges.append((lane, g1_add(A, A)))

    lane = 0
    pts += [g1_mul(g1_generator(), k) for k in range(1, 9)]  # small multiples
    for k, P in enumerate(pts):
        Qp = pts[(k + 5) % len(pts)]
        negP = (P[0], Q - P[1])
        for A, B, one_rep in ((P, Qp, False), (P, P, True), (P, P, False),
                              (P, negP, False), (None, P, False),
                              (P, None, False), (None, None, False)):
            put_pair(lane, A, B, one_rep)
            lane += 1
    # Warp layouts of add's doubling branch, 32-lane warps from lane 192:
    # a warp of P = Q (one and two representatives), P = Q only at lane 0
    # and only at lane 31 of warps of random lanes, a warp of O + O, a
    # warp mixing O + P, P + O and P = -Q.
    for k in range(32):
        P = pts[k % len(pts)]
        put_pair(192 + k, P, P, one_rep=k % 2 == 0)
        put_pair(288 + k, None, None)
        put_pair(320 + k, *((None, P), (P, None), (P, (P[0], Q - P[1])))[k % 3])
    put_pair(224, pts[3], pts[3])
    put_pair(287, pts[4], pts[4])
    a, b = below(0x1A01), below(0x1A01)  # < p
    for i, v in enumerate((0, 1, Q - 1, FQ.mont_r)):
        put(a, i, v)
        put(b, i + 4, v)

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).cuda()

    return ([t(v) for v in (x1, y1, z1, x2, y2, z2)],
            [t(ax1), t(ay1), t(m1).bool(), t(ax2), t(ay2), t(m2).bool()],
            [t(a), t(b)], edges, [t(v) for v in jin], add_edges, dbl_edges)


def check_group_law(outs, edges, label, jacobian=False):
    """The projective (or Jacobian) outputs of the edge lanes, normalized
    on the host, must equal the host group law (relaxed limbs < 2p
    decode to the right residue)."""
    from gemini_tpu_torch.fields.fp import FQ
    from gemini_tpu_torch.params import Q

    lanes = [lane for lane, _ in edges]
    X, Y, Z = (FQ.decode(o[:, lanes].cpu().numpy()) for o in outs)
    for (lane, want), x, y, z in zip(edges, X, Y, Z):
        zi = pow(z, -1, Q) if z else 0
        sx, sy = (zi * zi % Q, zi * zi * zi % Q) if jacobian else (zi, zi)
        got = None if z == 0 else (x * sx % Q, y * sy % Q)
        if got != want:
            raise AssertionError(f"{label}: group law wrong on lane {lane}")


def compare(name, got, want, what):
    """Bit-for-bit equality of kernel outputs with plain outputs; returns
    the max abs limb error (0), raises on any difference."""
    import torch

    torch.cuda.synchronize()
    got = [g.reshape(w.shape) for g, w in zip(got, want)]
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel differs from plain version on "
                             f"{what} (max abs limb error {err})")
    return err


def strided_views(a, kind):
    """The MSM's operand views of a (24, 4, n) coordinate tensor (or a
    (4, n) mask): the reduce chain's halves, the scan's even/odd stride-2
    split, and the SRS tree's halves of a transposed (24, n, 4) plane."""
    if kind == "halves":
        h = a.shape[-1] // 2
        return a[..., :h], a[..., h:]
    if kind == "even/odd":
        return a[..., 0::2], a[..., 1::2]
    t = a.transpose(-1, -2).contiguous().transpose(-1, -2)  # lane stride 4
    h = t.shape[-1] // 2
    return t[..., :h], t[..., h:]


def plain_ms(fn, rounds: int = 2) -> float:
    """Host-clock ms per call of a plain version (best of `rounds` after
    a first call), ending in a synchronize.  The event timer's guard
    refuses the plain versions (phase 2 shows it on mont_mul's): they
    are chains of PyTorch launches, and `_carry` reads a flag on the host
    in every pass, so the host waits for the device inside each call."""
    import torch

    from gemini_tpu_torch.benches.timing import wall_s

    def once():
        fn()
        torch.cuda.synchronize()

    return wall_s(once, rounds)[0] * 1e3


def phase_kernels(results):
    """Each group-law kernel against its plain version, bit for bit, on
    2^14 lanes (the prove's small launches), 2^16 lanes and fresh
    2^20-lane inputs (the order of the MSM's largest launches, up to 2^19
    lanes), edge lanes and add's warp layouts included, with the group
    law checked on the edge lanes; padd, padd01 and add also on the MSM's
    strided operand views; then every kernel timed at 2^20 lanes and at
    2^14 (all but mont_mul)."""
    from gemini_tpu_torch.curve import g1_kernels as gk

    small = {}
    for n, seed in ((1 << 14, 20261015), (1 << 16, 20261016), (1 << 20, 20261017)):
        (padd_in, padd01_in, mm_in, edges, jac_in, add_edges,
         dbl_edges) = kernel_inputs(n, seed=seed)
        cases = {
            "padd": (lambda ins: gk.padd(ins[:3], ins[3:]), gk.padd_plain, padd_in),
            "padd01": (lambda ins: gk.padd01((ins[0], ins[1], ins[2]),
                                             (ins[3], ins[4], ins[5])),
                       gk.padd01_plain, padd01_in),
            "mont_mul": (lambda ins: (gk.mont_mul(*ins),),
                         lambda a, b: (gk.mont_mul_plain(a, b),), mm_in),
            "add": (lambda ins: gk.add(ins[:3], ins[3:]), gk.add_plain, jac_in),
            "dbl": (lambda ins: gk.double(ins),
                    lambda x, y, z: gk.double_plain(x, y, z), jac_in[:3]),
        }
        group_law = {"padd": (edges, False), "padd01": (edges, False),
                     "add": (add_edges, True), "dbl": (dbl_edges, True)}
        for name, (kern, plain, ins) in cases.items():
            got = kern(ins)
            want = plain(*ins)
            err = compare(name, got, want, f"{n} lanes")
            if name in group_law:
                law_edges, jacobian = group_law[name]
                check_group_law(got, law_edges, name, jacobian=jacobian)
            r = results.setdefault(name, {"max_abs_err": 0, "bit_exact": True})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"kernel {name}: bit-exact against plain on {n} lanes (edge lanes "
                f"included){', group law checked' if name in group_law else ''}")
            if name == "add" and n == 1 << 16:
                phase_strided_add(results, jac_in, want)
            del got, want
        if n == 1 << 14:
            small = {k: cases[k] for k in ("padd", "padd01", "add", "dbl")}
        if n == 1 << 16:
            phase_strided(results, padd_in, padd01_in)

    from gemini_tpu_torch.benches.timing import QueueingOutlastedSpin, event_ms

    try:
        event_ms(lambda: gk.mont_mul_plain(*cases["mont_mul"][2]), 2)
    except QueueingOutlastedSpin as e:
        log(f"the guarded timer refuses a plain version, as expected: {e}")
    else:
        raise AssertionError("the guarded timer accepted mont_mul's plain version, "
                             "which synchronizes inside")

    # timing at 2^20 lanes, on the inputs just compared, and at 2^14
    for name, (kern, plain, ins) in cases.items():
        ms = event_ms(lambda: kern(ins), 20)
        pms = plain_ms(lambda: plain(*ins))
        c_in, c_out = COORDS_IN_OUT[name]
        nbytes = n * 96 * (c_in + c_out) + (2 * n if name == "padd01" else 0)
        results[name].update(ms=ms, plain_ms=pms, library_ms=None,
                             bytes=nbytes, imads=n * WORD_PRODUCTS[name] * 2,
                             lanes=n, source=G1_SOURCE)
        line = f"kernel {name} at 2^20 lanes: {ms:.4f} ms (plain {pms:.2f} ms)"
        if name in small:
            kern14, _, ins14 = small[name]
            ms14 = event_ms(lambda: kern14(ins14), 100, spin_cycles=40_000_000)
            results[name]["ms_2^14"] = ms14
            line += f"; at 2^14 lanes: {ms14:.4f} ms"
        if name == "add":
            # 2^14 random lanes (the 2^20 inputs' last, no edge lanes): no
            # warp takes the doubling, which 9 of the 2^14 inputs' take
            last = [t[:, -(1 << 14):] for t in ins]
            ms14r = event_ms(lambda: kern(last), 100, spin_cycles=40_000_000)
            results[name]["ms_2^14_random_lanes"] = ms14r
            line += f" ({ms14r:.4f} ms on random lanes)"
        log(line)


def phase_strided_add(results, jac_in, want):
    """add on the views the Jacobian MSM hands it (halves, even/odd,
    transposed halves of (24, 4, 2m) tensors whose two views are the
    2^16 test lanes' p and q, warp layouts included), bit for bit
    against the plain result `want` on the contiguous lanes."""
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk

    n = jac_in[0].shape[1]
    m = n // 4
    p = [t.reshape(24, 4, m) for t in jac_in[:3]]
    q = [t.reshape(24, 4, m) for t in jac_in[3:]]
    for kind in ("halves", "even/odd", "transposed halves"):
        if kind == "even/odd":
            both = [torch.stack([a, b], -1).reshape(24, 4, 2 * m) for a, b in zip(p, q)]
        else:
            both = [torch.cat([a, b], -1) for a, b in zip(p, q)]
        pv, qv = zip(*(strided_views(t, kind) for t in both))
        err = compare("add", gk.add(pv, qv), want, f"{kind} views")
        results["add"]["max_abs_err"] = max(results["add"]["max_abs_err"], err)
        log(f"kernel add: bit-exact against plain on {kind} views of (24, 4, "
            f"{2 * m}) tensors (the 2^16-lane operands, warp layouts included)")


def phase_strided(results, padd_in, padd01_in):
    """padd and padd01 on the views the MSM hands them (halves, even/odd,
    transposed halves of (24, 4, n) tensors, bool masks as they are),
    bit for bit against the plain versions on contiguous copies.  The
    padd01 inputs' dead lanes are already (0 : y : 0) under their masks."""
    from gemini_tpu_torch.curve import g1_kernels as gk

    n = padd_in[0].shape[1] // 4
    coords = [t.reshape(24, 4, n) for t in padd_in[:3]]
    ax, ay = (t.reshape(24, 4, n) for t in padd01_in[:2])
    am = padd01_in[2].reshape(4, n)
    for kind in ("halves", "even/odd", "transposed halves"):
        p, q = zip(*(strided_views(t, kind) for t in coords))
        err = compare("padd", gk.padd(p, q),
                      gk.padd_plain(*(t.contiguous().reshape(24, -1)
                                      for t in (*p, *q))), f"{kind} views")
        (x1, x2), (y1, y2), (m1, m2) = (strided_views(t, kind) for t in (ax, ay, am))
        flat = [t.contiguous().reshape(24, -1) for t in (x1, y1)]
        flat2 = [t.contiguous().reshape(24, -1) for t in (x2, y2)]
        err01 = compare("padd01", gk.padd01((x1, y1, m1), (x2, y2, m2)),
                        gk.padd01_plain(*flat, m1.reshape(-1), *flat2,
                                        m2.reshape(-1)), f"{kind} views")
        for name, e in (("padd", err), ("padd01", err01)):
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)
        log(f"kernels padd, padd01: bit-exact against plain on {kind} views of "
            f"(24, 4, {n}) tensors")


def phase_probes(results):
    """2b: the probe kernels against their plain versions, then the
    l2bench, vpubench, mmbench, addbench and coreops entry points at
    their defaults.  Returns the measured rates."""
    import torch

    from gemini_tpu_torch.benches import addbench, coreops, mmbench, probes, vpubench

    # vpu_chain against its plain version at vpubench's own inputs
    # (ROWS x TILE * GRID elements, K / 4 and K), for both types
    k, rows, n = vpubench.K, vpubench.ROWS, vpubench.TILE * vpubench.GRID
    vpu_err, frel = 0, 0.0
    for dtype in ("uint32", "float32"):
        a, b = vpubench.inputs(dtype, rows, n, "cuda")
        for kk in (k // 4, k):
            got, want = probes.vpu_chain(a, b, kk), probes.vpu_chain_plain(a, b, kk)
            if dtype == "float32":
                frel = max(frel, float(((got - want).abs() / want.abs()).max()))
                continue
            vpu_err = max(vpu_err, int((got.to(torch.int64)
                                        - want.to(torch.int64)).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"vpu_chain (uint32, K = {kk}) differs from "
                                     f"its plain version (max abs error {vpu_err})")
    if not frel < 1e-6:
        raise AssertionError(f"vpu_chain (float32) off its plain version: {frel}")
    log(f"probes: vpu_chain uint32 bit-exact against plain at {rows} x {n}, "
        f"K = {k // 4} and {k}; float32 max relative error {frel:.3g}")
    copy_row = check_copy_add()

    # the entry points at their defaults, each counted on its own
    probes.reset_launches()
    vpu = vpubench.main()
    vpu_launches = probes.LAUNCHES["vpu_chain"]
    fl = vpubench.measure(dtype="float32")
    probes.reset_launches()
    mm = mmbench.main()
    copy_launches = probes.LAUNCHES["copy_add"]
    if vpu_launches == 0 or copy_launches == 0:
        raise AssertionError("the bench entry points launched no probe kernel")
    addbench.main(argv=[])
    coreops.main(argv=[])
    imad_per_s = vpu["lane_ops_per_s"] / 2
    rates = {"int32_lane_ops_per_s": vpu["lane_ops_per_s"],
             "imad_per_s": imad_per_s,
             "float32_flop_per_s": fl["lane_ops_per_s"],
             "copy_add_us_per_launch": mm["copy_add"]["us_per_launch"],
             "copy_add_ns_per_lane": mm["copy_add"]["ns_per_lane"],
             "mont_mul_us_per_launch": mm["mont_mul"]["us_per_launch"],
             "mont_mul_ns_per_lane": mm["mont_mul"]["ns_per_lane"]}
    log(json.dumps({"measured_rates": rates}))

    # table rows at the entry points' shapes
    a, b = vpubench.inputs("uint32", rows, n, "cuda")
    results["vpu_chain"] = {
        "max_abs_err": vpu_err, "bit_exact": True, "float32_max_rel_err": frel,
        "launches": vpu_launches, "ms": vpu["t_long_s"] * 1e3,
        "plain_ms": plain_ms(lambda: probes.vpu_chain_plain(a, b, k), 1),
        "library_ms": None, "bytes": 3 * 4 * rows * n, "imads": k * rows * n,
        "lanes": rows * n, "source": PROBE_SOURCE}
    copy_row.update(launches=copy_launches, source=PROBE_SOURCE)
    results["copy_add"] = copy_row
    return rates


def check_copy_add() -> dict:
    """copy_add bit for bit against its plain version at mmbench's 24 x
    2^16 limbs, at 24 x 2^20, at an odd element count, with operands 4
    or 8 bytes off 16-byte alignment, and on a non-contiguous slice
    (which the wrapper copies before the launch); then the l2bench entry
    point at its defaults.  Returns the kernel table row at mmbench's
    shape: ms and library_ms by the guarded event timer, device_ms and
    library_device_ms by the profiler, a bound of the bytes at the
    fastest L2 rate l2bench measured (the row names its source), the
    shares of that bound in device time, and the 24 x 2^20 figures under
    their own keys (bound: the bytes at 3.35 TB/s)."""
    import torch

    from gemini_tpu_torch.benches import l2bench, probes

    ca = l2bench.limbs(16, 6, "cuda")
    cb = ca.flip(1).contiguous()
    fa, fb = ca.reshape(-1), cb.reshape(-1)
    m = fa.numel() - 3  # odd
    cases = {
        "24 x 2^16": (ca, cb),
        "24 x 2^20": (l2bench.limbs(20, 7, "cuda"), l2bench.limbs(20, 8, "cuda")),
        f"{m} elements (odd)": (fa[:m], fb[:m]),
        "both operands 4 bytes off 16-byte alignment, odd count": (fa[1:1 + m],
                                                                   fb[1:1 + m]),
        "operands 4 and 8 bytes off, odd count": (fa[1:1 + m], fb[2:2 + m]),
        "ca[:, 1:], not contiguous (the wrapper's copy)": (ca[:, 1:], cb[:, 1:]),
    }
    err = 0
    for what, (a, b) in cases.items():
        got, want = probes.copy_add(a, b), probes.copy_add_plain(a, b)
        err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"copy_add differs from its plain version at {what}")
    log(f"copy_add: bit-exact against plain at {', '.join(cases)}")
    del cases

    bench = l2bench.main()
    small, big = bench["24x2^16"], bench["24x2^20"]
    l2 = small["l2"]
    bound = small["bytes"] / l2["rate"] * 1e3
    bound_big = big["bytes"] / HBM_BYTES_PER_S * 1e3
    own, lib = small["shapes"]["copy_add"], small["shapes"]["torch.add"]
    own_big, lib_big = big["shapes"]["copy_add"], big["shapes"]["torch.add"]
    return {
        "max_abs_err": err, "bit_exact": True, "ms": own["ms"],
        "device_ms": own["device_ms"],
        "plain_ms": plain_ms(lambda: probes.copy_add_plain(ca, cb), 3),
        "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
        "bytes": small["bytes"], "imads": 0, "lanes": ca.shape[1],
        "bound_ms": bound, "bound_by": "bytes", "bound_rate_bytes_per_s": l2["rate"],
        "bound_rate_from": f"the L2: fastest move of the same bytes, {l2['rate_from']}",
        "ms_24x2^20": own_big["ms"], "device_ms_24x2^20": own_big["device_ms"],
        "library_ms_24x2^20": lib_big["ms"],
        "library_device_ms_24x2^20": lib_big["device_ms"],
        "bound_ms_24x2^20": bound_big,
        "bound_share_24x2^20": bound_big / own_big["device_ms"],
        "library_bound_share_24x2^20": bound_big / lib_big["device_ms"]}


def phase_group_api(results):
    """2c: scalar_mul and add_mixed on the card against the host."""
    import numpy as np
    import torch

    from gemini_tpu_torch.curve import g1
    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.hostcurve import g1_add, g1_mul
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.refimpl import g1_generator

    rnd = random.Random(0xD0B1)
    n = 1 << 12
    base = [g1_mul(g1_generator(), rnd.randrange(1, R)) for _ in range(64)]
    pts = [base[i % 64] if i % 97 else None for i in range(n)]
    ks = [rnd.randrange(R) for _ in range(n)]
    ks[:3] = [0, 1, R - 1]
    bits = np.array([[(k >> i) & 1 for k in ks] for i in range(255)], dtype=bool)
    p = g1.from_affine(g1.encode_affine(pts, "cuda"))
    gk.reset_launches()
    t0 = time.time()
    out = g1.scalar_mul(p, torch.from_numpy(bits).cuda())
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(gk.LAUNCHES)
    if g1.decode_jacobian(out) != [g1_mul(P, k) for P, k in zip(pts, ks)]:
        raise AssertionError("scalar_mul on the card differs from host g1_mul")
    qs = [base[(i * 7) % 64] if i % 5 else None for i in range(n)]
    qs[3] = pts[3]  # P + P through the doubling select
    mixed = g1.add_mixed(out, g1.encode_affine(qs, "cuda"))
    host = [g1_mul(P, k) for P, k in zip(pts, ks)]
    if g1.decode_jacobian(mixed) != [g1_add(a, b) for a, b in zip(host, qs)]:
        raise AssertionError("add_mixed on the card differs from the host")
    if launches["dbl"] == 0 or launches["add"] == 0:
        raise AssertionError(f"scalar_mul launched no dbl/add kernel: {launches}")
    results["dbl"]["launches"] = launches["dbl"]
    log(json.dumps({"scalar_mul_2^12_x_255_bits_s": dt, "launches": launches,
                    "host_checked": True, "add_mixed_host_checked": True}))


# ---------------------------------------------------------------------------
# Phase 3: MSM
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def jacobian_config():
    """GEMINI_TPU_PROJ=0 (the MSM and SRS through the Jacobian add
    kernel) inside the block; the variable is restored after it."""
    old = os.environ.get("GEMINI_TPU_PROJ")
    os.environ["GEMINI_TPU_PROJ"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("GEMINI_TPU_PROJ")
        else:
            os.environ["GEMINI_TPU_PROJ"] = old


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
    ks = [sum(int(s_np[i, j]) << (16 * i) for i in range(FR.n_limbs)) for j in range(n)]
    t0 = time.time()
    want = g1_msm([host_pts[j % 512] for j in range(n)], ks)
    host_s = time.time() - t0
    if g1.decode_jacobian(msm(pts, sc))[0] != want:
        raise AssertionError("MSM 2^16: kernel pipeline differs from host Pippenger")
    with jacobian_config():
        if g1.decode_jacobian(msm(pts, sc))[0] != want:
            raise AssertionError("MSM 2^16, GEMINI_TPU_PROJ=0: the Jacobian "
                                 "pipeline differs from host Pippenger")
    log(f"msm 2^16: kernel pipeline == host Pippenger, projective and Jacobian "
        f"(host {host_s:.2f} s)")

    n = 1 << 20
    pts, sc, _ = inputs(n)

    def timed(config):
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
        log(json.dumps({"metric": "msm_g1_points_per_s_2^20", "config": config,
                        "value": n / best, "best_s": best, "first_s": warm}))

    timed("projective")
    with jacobian_config():
        timed("jacobian")
    return pts, sc


# ---------------------------------------------------------------------------
# Phases 4-5: proofs
# ---------------------------------------------------------------------------


def golden_file(name: str) -> dict:
    with open(os.path.join(HERE, "gemini_tpu_torch", "testdata", name)) as f:
        return json.load(f)


def psnark_golden(config):
    """The pSNARK golden instance on the card: index commitments and
    proof bytes equal gemini_tpu's, the proof verifies, and gemini_tpu's
    proof read by the port's deserializer verifies."""
    from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
    from gemini_tpu_torch.psnark import Proof, index
    from gemini_tpu_torch.relation import random_r1cs
    from gemini_tpu_torch.serialize import (g1_compressed, psnark_proof_bytes,
                                            psnark_proof_from_bytes)

    g = golden_file("psnark_golden.json")
    r1 = random_r1cs(random.Random(g["r1cs_seed"]), g["n"], row_nnz=g["row_nnz"],
                     device="cuda")
    ck = CommitterKey.new(max_degree=g["max_degree"],
                          max_eval_points=g["max_eval_points"], seed=g["srs_seed"],
                          device="cuda")
    vk = VerifierKey.from_committer_key(ck)
    idx = index(ck, r1)
    if [g1_compressed(c).hex() for c in idx] != g["index_hex"]:
        raise AssertionError(f"pSNARK golden index ({config}) differs from gemini_tpu's")
    proof = Proof.new_time(ck, r1, idx)
    if psnark_proof_bytes(proof).hex() != g["proof_hex"]:
        raise AssertionError(f"pSNARK golden proof bytes ({config}) differ from "
                             "gemini_tpu's")
    proof.verify(r1, vk, idx, g["num_non_zero"])
    psnark_proof_from_bytes(bytes.fromhex(g["proof_hex"])).verify(
        r1, vk, idx, g["num_non_zero"])
    log(f"pSNARK golden instance ({config}): index commitments and proof bytes "
        "equal gemini_tpu's, proof verifies; gemini_tpu's proof, parsed by the "
        "port, verifies")


def elastic_golden(config, r1, ck, proof_hex):
    """The elastic prover on the card: the golden SNARK instance through
    CommitterKeyStream(ck, max_msm_buffer=8), block size 8, threshold 2,
    gives gemini_tpu's time-prover bytes; the dummy stream with the
    constant-base (τ = 1) key of elastic_golden.json, where every MSM
    bucket sums copies of one point, gives gemini_tpu's elastic bytes
    and verifies."""
    from gemini_tpu_torch.relation import DummyR1csStream
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof
    from gemini_tpu_torch.streaming import CommitterKeyStream, FakeCommitterKeyStream

    proof = Proof.new_elastic(r1, CommitterKeyStream(ck, max_msm_buffer=8),
                              block_size=8, threshold=2)
    if snark_proof_bytes(proof).hex() != proof_hex:
        raise AssertionError(f"golden elastic proof bytes ({config}) differ from "
                             "gemini_tpu's")
    g = golden_file("elastic_golden.json")
    stream = DummyR1csStream(g["n"], g["e"], device="cuda")
    fake = FakeCommitterKeyStream(max_eval_points=g["max_eval_points"],
                                  seed=g["srs_seed"],
                                  max_msm_buffer=g["max_msm_buffer"], device="cuda")
    proof = Proof.new_elastic(stream, fake, block_size=g["block_size"],
                              threshold=g["threshold"])
    if snark_proof_bytes(proof).hex() != g["proof_hex"]:
        raise AssertionError(f"dummy-stream elastic proof bytes ({config}) differ "
                             "from gemini_tpu's")
    proof.verify(stream.to_dense(), fake.verifier_key())
    log(f"golden elastic proofs ({config}): the golden instance's bytes and the "
        "dummy stream's (τ = 1 key) equal gemini_tpu's, proof verifies")


def phase_golden():
    from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
    from gemini_tpu_torch.relation import random_r1cs
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof

    golden = golden_file("snark_golden.json")

    def prove(config):
        r1 = random_r1cs(random.Random(golden["r1cs_seed"]), golden["n"],
                         device="cuda")
        ck = CommitterKey.new(max_degree=golden["max_degree"],
                              max_eval_points=golden["max_eval_points"],
                              seed=golden["srs_seed"], device="cuda")
        proof = Proof.new_time(r1, ck)
        if snark_proof_bytes(proof).hex() != golden["proof_hex"]:
            raise AssertionError(f"golden proof bytes ({config}) differ from "
                                 "gemini_tpu's")
        proof.verify(r1, VerifierKey.from_committer_key(ck))
        log(f"golden instance ({config}): proof bytes equal gemini_tpu's, "
            "proof verifies")
        elastic_golden(config, r1, ck, golden["proof_hex"])
        psnark_golden(config)

    prove("projective")
    with jacobian_config():
        prove("jacobian")


def phase_full(results, jacobian: bool):
    """The 2^18 instance: SRS on the card, prove, verify, tamper.  The
    projective run must launch padd, padd01 and mont_mul; the Jacobian
    run (GEMINI_TPU_PROJ=0) must launch add, and no padd or padd01, in
    the SRS and in the prove."""
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.relation import dummy_r1cs
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof, SnarkVerificationError

    config = "jacobian" if jacobian else "projective"
    logn = 18
    n = 1 << logn
    gk.reset_launches()
    t0 = time.time()
    r1cs = dummy_r1cs(random.Random(0), n, device="cuda")
    ck = CommitterKey.new(max_degree=n, max_eval_points=3, seed=0, device="cuda")
    vk = VerifierKey.from_committer_key(ck)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    setup_launches = dict(gk.LAUNCHES)

    gk.reset_launches()
    os.environ["GEMINI_TPU_TRACE"] = "1"
    t0 = time.time()
    proof = Proof.new_time(r1cs, ck)
    torch.cuda.synchronize()
    prove_s = time.time() - t0
    os.environ.pop("GEMINI_TPU_TRACE")
    launches = dict(gk.LAUNCHES)
    lanes = dict(gk.LANES)
    t0 = time.time()
    proof.verify(r1cs, vk)
    verify_s = time.time() - t0
    if jacobian:
        for where, counts in (("SRS", setup_launches), ("prove", launches)):
            if counts["add"] == 0 or counts["padd"] or counts["padd01"]:
                raise AssertionError(f"GEMINI_TPU_PROJ=0 2^{logn} {where} did not "
                                     f"run on the add kernel alone: {counts}")
        results["add"]["launches"] = launches["add"]
    else:
        for name in ("padd", "padd01", "mont_mul"):
            if launches[name] == 0:
                raise AssertionError(f"the 2^{logn} prove launched no {name} kernel")
            results[name]["launches"] = launches[name]
            results[name]["lanes_per_prove"] = lanes[name]

    bad = copy.deepcopy(proof)
    bad.zc_alpha = (bad.zc_alpha + 1) % R
    try:
        bad.verify(r1cs, vk)
    except SnarkVerificationError:
        pass
    else:
        raise AssertionError("tampered proof accepted")
    log(json.dumps({"snark_time_prover_logn": logn, "config": config,
                    "setup_s": setup_s, "prove_s": prove_s, "verify_s": verify_s,
                    "proof_bytes": len(snark_proof_bytes(proof)),
                    "setup_launches": setup_launches, "launches": launches,
                    "lanes": lanes, "tampered_rejected": True}))
    return r1cs, ck


def phase_psnark(results, card):
    """5c: the pSNARK at 2^18 (examples/psnark.py -i 18), projective.
    Every check raises on failure."""
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.psnark import Proof, PsnarkVerificationError, index
    from gemini_tpu_torch.relation import dummy_r1cs
    from gemini_tpu_torch.relation.r1cs import joint_matrices
    from gemini_tpu_torch.serialize import psnark_proof_bytes, psnark_proof_from_bytes
    from gemini_tpu_torch.utils.trace import SpanTotals

    logn = 18
    n = 1 << logn
    t0 = time.time()
    r1cs = dummy_r1cs(random.Random(0), n, device="cuda")
    nnz = joint_matrices(r1cs).num_non_zero
    ck = CommitterKey.new(max_degree=2 * n + nnz + 2, max_eval_points=3, seed=0,
                          device="cuda")
    vk = VerifierKey.from_committer_key(ck)
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    t0 = time.time()
    idx = index(ck, r1cs)
    torch.cuda.synchronize()
    index_s = time.time() - t0

    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    with SpanTotals() as spans:
        t0 = time.time()
        proof = Proof.new_time(ck, r1cs, idx)
        torch.cuda.synchronize()
        prove_s = time.time() - t0
    launches, lanes = dict(gk.LAUNCHES), dict(gk.LANES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("padd", "padd01", "mont_mul"):
        if launches[name] == 0:
            raise AssertionError(f"the 2^{logn} pSNARK prove launched no {name} kernel")
        results[name]["psnark_launches"] = launches[name]
        results[name]["psnark_lanes"] = lanes[name]

    t0 = time.time()
    proof.verify(r1cs, vk, idx, nnz)
    torch.cuda.synchronize()
    verify_s = time.time() - t0

    raw = psnark_proof_bytes(proof)
    parsed = psnark_proof_from_bytes(raw)
    if psnark_proof_bytes(parsed) != raw:
        raise AssertionError("pSNARK proof bytes do not survive a parse")
    parsed.verify(r1cs, vk, idx, nnz)
    for field in ("zc_alpha", "set_z_ep"):
        bad = copy.deepcopy(proof)
        setattr(bad, field, (getattr(bad, field) + 1) % R)
        try:
            bad.verify(r1cs, vk, idx, nnz)
        except PsnarkVerificationError:
            pass
        else:
            raise AssertionError(f"pSNARK proof with a tampered {field} accepted")
    log(json.dumps({
        "psnark_time_prover_logn": logn, "config": "projective", "num_non_zero": nnz,
        "srs_max_degree": 2 * n + nnz + 2, "setup_s": setup_s, "index_s": index_s,
        "prove_s": prove_s, "verify_s": verify_s, "proof_bytes": len(raw),
        "round_trip_verified": True, "tampered_rejected": ["zc_alpha", "set_z_ep"],
        "spans_ms": {k: v for k, v in spans.ms.items() if k.startswith("psnark::")},
        "inner_spans_ms": {k: v for k, v in spans.ms.items()
                           if not k.startswith("psnark::")},
        "launches": launches, "lanes": lanes,
        "max_memory_allocated_bytes": peak, "card": card}))


ELASTIC_LOGN = 24  # examples/snark.py -i 24, BASELINE config 4
ELASTIC_CHECK_LOGN = 20  # elastic against time, four streaming rounds


def phase_elastic(results, card):
    """5d: the elastic SNARK (examples/snark.py -i 24), projective.
    First the 2^24 prove with counts, spans, peak device memory and the
    host RSS it adds (read after a heap trim, so that what earlier
    phases freed is not counted); then at 2^20 with threshold 16 (four
    streaming rounds) against the time prover's bytes for the dense twin
    (the dense relation and the τ = 1 key of the same generators); then
    the 2^24 proof verified against the dense relation, a tampered
    zc_alpha rejected.  Every check raises on failure."""
    import torch

    from gemini_tpu_torch import SPACE_TIME_THRESHOLD
    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.kzg.commit import CommitterKey
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.relation import DummyR1csStream
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof, SnarkVerificationError
    from gemini_tpu_torch.streaming import FakeCommitterKeyStream
    from gemini_tpu_torch.utils.trace import MemoryWatcher, SpanTotals

    e = random.Random(0).randrange(1, R)
    block = 1 << 20
    fake = FakeCommitterKeyStream(max_eval_points=3, seed=0, max_msm_buffer=block,
                                  device="cuda")
    out = {"snark_elastic_logn": ELASTIC_LOGN, "config": "projective",
           "block_size": block, "threshold": SPACE_TIME_THRESHOLD}

    stream = DummyR1csStream(1 << ELASTIC_LOGN, e, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    out["host_rss_before_trim_bytes"] = MemoryWatcher._rss()
    trim_host_heap()
    out["host_rss_before_prove_bytes"] = MemoryWatcher._rss()
    with SpanTotals() as spans, MemoryWatcher(interval=0.5, threshold_kib=1 << 22) as mem:
        t0 = time.time()
        proof = Proof.new_elastic(stream, fake, block_size=block)
        torch.cuda.synchronize()
        out["prove_s"] = time.time() - t0
    launches, lanes = dict(gk.LAUNCHES), dict(gk.LANES)
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_host_rss_bytes"] = mem.peak
    out["host_rss_added_by_prove_bytes"] = mem.peak - out["host_rss_before_prove_bytes"]
    for name in ("padd", "padd01", "mont_mul"):
        if launches[name] == 0:
            raise AssertionError(f"the 2^{ELASTIC_LOGN} elastic prove launched no "
                                 f"{name} kernel")
        results[name]["elastic_launches"] = launches[name]
        results[name]["elastic_lanes"] = lanes[name]
    out["proof_bytes"] = len(snark_proof_bytes(proof))

    n = 1 << ELASTIC_CHECK_LOGN
    check = f"check_2^{ELASTIC_CHECK_LOGN}"
    small = DummyR1csStream(n, e, device="cuda")
    t0 = time.time()
    elastic = snark_proof_bytes(Proof.new_elastic(small, fake, block_size=block,
                                                  threshold=ELASTIC_CHECK_LOGN - 4))
    torch.cuda.synchronize()
    out[f"{check}_elastic_prove_s"] = time.time() - t0
    ck = CommitterKey.new(max_degree=n, max_eval_points=3, seed=0, tau=1,
                          device="cuda")
    dense_r1cs = small.to_dense()
    t0 = time.time()
    dense = snark_proof_bytes(Proof.new_time(dense_r1cs, ck))
    torch.cuda.synchronize()
    out[f"{check}_time_prove_s"] = time.time() - t0
    if elastic != dense:
        raise AssertionError(f"elastic proof at 2^{ELASTIC_CHECK_LOGN} differs from "
                             "the time prover's on the dense twin")
    out[f"{check}_bytes_equal"] = True
    del ck, dense_r1cs

    t0 = time.time()
    dense_r1cs = stream.to_dense()
    torch.cuda.synchronize()
    out["verify_relation_build_s"] = time.time() - t0
    vk = fake.verifier_key()
    t0 = time.time()
    proof.verify(dense_r1cs, vk)
    torch.cuda.synchronize()
    out["verify_s"] = time.time() - t0
    out["verified_logn"] = ELASTIC_LOGN
    bad = copy.deepcopy(proof)
    bad.zc_alpha = (bad.zc_alpha + 1) % R
    try:
        bad.verify(dense_r1cs, vk)
    except SnarkVerificationError:
        pass
    else:
        raise AssertionError("elastic proof with a tampered zc_alpha accepted")
    out["tampered_rejected"] = ["zc_alpha"]
    out.update(spans_ms=spans.ms, span_counts=spans.count, launches=launches,
               lanes=lanes, card=card)
    log(json.dumps(out))


# ---------------------------------------------------------------------------
# Phase 6: device profile of the main path
# ---------------------------------------------------------------------------


OWN_KERNELS = {"padd01_kernel": "padd01", "padd_kernel": "padd",
               "mont_mul_kernel": "mont_mul", "add_kernel": "add",
               "dbl_kernel": "dbl"}
ALL_KERNELS = {**OWN_KERNELS, "vpu_chain_kernel": "vpu_chain",
               "copy_add_kernel": "copy_add"}


def own_kernel(name: str):
    """The port's kernel a trace name belongs to (its demangled name is
    `(anonymous namespace)::<kernel>(...)`), or None."""
    _, sep, head = name.partition("(anonymous namespace)::")
    return OWN_KERNELS.get(head.split("(")[0].split("<")[0]) if sep else None


def device_profile(fn):
    """Run `fn` (ending in a synchronize) under torch.profiler (CPU and
    CUDA activities) and read the device side of its trace: busy share
    (union of device intervals over the window from the first to the
    last event), device ms per kernel (the port's own by their names,
    the ten largest others), and the PyTorch copy kernels' and memcpys'
    device ms.  Returns None when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    evs = prof.events()
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and e.time_range.end > e.time_range.start]
    if not dev:
        return None
    t_lo = min(e.time_range.start for e in evs)
    t_hi = max(e.time_range.end for e in evs)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if cur_e is None or s0 > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    own = {k: [0.0, 0] for k in OWN_KERNELS.values()}
    others, copy_ms, copy_n, memcpy_ms, memcpy_n = {}, 0.0, 0, 0.0, 0
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        tag = own_kernel(e.name)
        if tag is not None:
            own[tag][0] += ms
            own[tag][1] += 1
            continue
        if e.name.startswith("Memcpy") or e.name.startswith("Memset"):
            memcpy_ms += ms
            memcpy_n += 1
        elif "copy" in e.name.lower():
            copy_ms += ms
            copy_n += 1
        o = others.setdefault(e.name, [0.0, 0])
        o[0] += ms
        o[1] += 1
    top = sorted(others.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_ms": (t_hi - t_lo) / 1e3, "device_busy_ms": busy / 1e3,
        "busy_share": busy / (t_hi - t_lo),
        "kernel_ms": {k: v[0] for k, v in own.items() if v[1]},
        "kernel_launches": {k: v[1] for k, v in own.items() if v[1]},
        "top_others": [{"name": name[:120], "ms": v[0], "count": v[1]}
                       for name, v in top],
        "copy_kernels_ms": copy_ms, "copy_kernels_count": copy_n,
        "memcpy_memset_ms": memcpy_ms, "memcpy_memset_count": memcpy_n,
        "device_events": len(dev)}


def phase_profile(results, msm_in, r1cs, ck):
    """6: torch.profiler over one projective MSM at 2^20, one Jacobian
    MSM at 2^20 (GEMINI_TPU_PROJ=0), one projective 2^18 prove and two
    streamed passes of the elastic prove, after the timed runs.  Without device events in the trace, says so and
    gives sum(lanes x per-lane time at 2^20) instead."""
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.ops.msm import msm
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.relation import DummyR1csStream
    from gemini_tpu_torch.snark import Proof
    from gemini_tpu_torch.streaming import SpaceProver

    def run_msm():
        msm(*msm_in)
        torch.cuda.synchronize()

    def run_msm_jacobian():
        with jacobian_config():
            run_msm()

    def run_prove():
        Proof.new_time(r1cs, ck)
        torch.cuda.synchronize()

    # Two streamed passes of the elastic prove (5d): one space-prover
    # round message over two 2^20 blocks (after one fold), and one 2^20
    # block of the dummy stream's abc vector (24 challenges).
    e = random.Random(0).randrange(1, R)
    stream = DummyR1csStream(1 << 21, e, device="cuda")
    space = SpaceProver(stream.z_a, stream.z_b, e, block_size=1 << 20)
    space.fold(e)
    chals = [random.Random(1).randrange(R) for _ in range(ELASTIC_LOGN)]
    abc = DummyR1csStream(1 << ELASTIC_LOGN, e, device="cuda").abc_tensored(
        chals, e, e, 1 << 20)

    def run_space_round():
        space._stream_round_message()
        torch.cuda.synchronize()

    def run_abc_block():
        abc.device_slice(0, 1 << 20)
        torch.cuda.synchronize()

    out = {}
    for label, fn in (("msm_2^20", run_msm), ("msm_2^20_jacobian", run_msm_jacobian),
                      ("prove_2^18", run_prove),
                      ("elastic_space_round_2x2^20", run_space_round),
                      ("elastic_abc_block_2^20", run_abc_block)):
        gk.reset_launches()
        t0 = time.time()
        prof = device_profile(fn)
        wall = time.time() - t0
        lanes = {k: v for k, v in gk.LANES.items() if v}
        if prof is None:
            prof = {"device_events": 0, "note": "the trace held no device event"}
        prof.update(wall_s_under_profiler=wall, lanes=lanes,
                    lanes_x_ms_per_lane_2p20={
                        k: v * results[k]["ms"] / results[k]["lanes"]
                        for k, v in lanes.items() if "ms" in results.get(k, {})})
        out[label] = prof
    log(json.dumps({"profile": out}))


def needs_dbl_lanes(p, q):
    """add's doubling predicate on each lane of a launch's operands, by
    the plain version's canonical field ops: h = r = 0 (u1 = u2 and
    s1 = s2) with neither operand the identity.  (n,) bool in the
    kernel's lane order."""
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk

    x1, y1, z1, x2, y2, z2 = (t.reshape(24, -1).to(torch.int64) for t in (*p, *q))
    z1z1, z2z2 = gk._mm(z1, z1), gk._mm(z2, z2)
    same_u = (gk._mm(x1, z2z2) == gk._mm(x2, z1z1)).all(0)
    same_s = (gk._mm(gk._mm(y1, z2), z2z2) == gk._mm(gk._mm(y2, z1), z1z1)).all(0)
    return same_u & same_s & (z1 != 0).any(0) & (z2 != 0).any(0)


def phase_count_dbl(msm_in, r1cs, ck):
    """Untimed: one extra Jacobian MSM at 2^20 and one extra Jacobian
    2^18 prove with every add launch's operands counted: the share of
    lanes that need the doubling, and of 32-lane warps (the kernel's
    warps: lanes 32k..32k+31 of a launch) that hold one and so run the
    doubling branch.  The operands are copied at each launch and the
    predicate runs on about 2^20 lanes at a time."""
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.ops.msm import msm
    from gemini_tpu_torch.snark import Proof

    orig = gk.add
    out = {}
    for label, fn in (("msm_2^20_jacobian", lambda: msm(*msm_in)),
                      ("prove_2^18_jacobian", lambda: Proof.new_time(r1cs, ck))):
        c = {"launches": 0, "lanes": 0, "dbl_lanes": 0, "warps": 0, "dbl_warps": 0}
        held = []

        def count():
            p = [torch.cat([h[k] for h in held], 1) for k in range(3)]
            q = [torch.cat([h[k] for h in held], 1) for k in range(3, 6)]
            nds = needs_dbl_lanes(p, q).split([h[0].shape[1] for h in held])
            for nd in nds:
                warps = torch.nn.functional.pad(nd, (0, -nd.numel() % 32)).reshape(-1, 32)
                c["lanes"] += nd.numel()
                c["dbl_lanes"] += int(nd.sum())
                c["warps"] += warps.shape[0]
                c["dbl_warps"] += int(warps.any(1).sum())
            held.clear()

        def counted(p, q):
            held.append([t.reshape(24, -1).clone() for t in (*p, *q)])
            c["launches"] += 1
            if sum(h[0].shape[1] for h in held) >= 1 << 20:
                count()
            return orig(p, q)

        gk.add = counted
        try:
            with jacobian_config():
                fn()
        finally:
            gk.add = orig
        if held:
            count()
        torch.cuda.synchronize()
        c["dbl_lane_share"] = c["dbl_lanes"] / max(c["lanes"], 1)
        c["dbl_warp_share"] = c["dbl_warps"] / max(c["warps"], 1)
        out[label] = c
    log(json.dumps({"needs_dbl": out}))


def kernel_rows(results, rates, usage):
    """The kernel table: every kernel with its bound under the data
    sheet's IMAD rate and under the rate vpubench measured (copy_add: its
    bytes at the measured L2 rate, see check_copy_add), ptxas's registers
    and spills, and its share of its bound: bound_ms / ms, or bound_ms /
    device_ms where the row has the profiler's device time (copy_add,
    whose 3-5 us launches the events time with the gaps between them);
    for the library call likewise."""
    rows = []
    for name in KERNELS:
        r = results[name]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["imads"] / IMAD_PER_S * 1e3
        t_ops_meas = r["imads"] / rates["imad_per_s"] * 1e3
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        bound_meas = max(t_bytes, t_ops_meas)
        by_meas = "bytes" if t_bytes >= t_ops_meas else "operations"
        if "bound_ms" in r:
            bound = bound_meas = r["bound_ms"]
            by = by_meas = r["bound_by"]
        rows.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": REPLACES[name], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound,
            "bound_by": by,
            "library_ms": r["library_ms"],
            "bound_ms_measured_rate": bound_meas,
            "bound_by_measured_rate": by_meas,
            "bound_share": bound / r.get("device_ms", r["ms"]),
            "library_bound_share": (bound / r.get("library_device_ms", r["library_ms"])
                                    if r["library_ms"] else None),
            "bit_exact": r["bit_exact"], "lanes": r["lanes"],
            **usage.get(name, {}),
        })
        if name == "add":
            rows[-1]["bound_ms_23_products"] = (
                r["lanes"] * ADD_WORD_PRODUCTS_23MM * 2 / IMAD_PER_S * 1e3)
        for key, v in r.items():
            if key.startswith(("ms_", "lanes_per", "psnark_", "elastic_", "float32",
                               "device_ms", "library_device", "library_ms_", "bound_ms_",
                               "bound_rate", "bound_share_", "library_bound_share_")):
                rows[-1][key] = v
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import gemini_tpu_torch  # noqa: F401  (fails outside a checkout)
    from gemini_tpu_torch.utils.trace import MemoryWatcher

    t_start = time.time()
    usage = build_all()
    card = card_line()
    log(card)
    results = {}

    def phase(label, fn, *args):
        t0, rss0 = time.time(), MemoryWatcher._rss()
        out = fn(*args)
        log(f"phase {label}: {time.time() - t0:.1f} s, host RSS "
            f"{rss0 / 2**20:.1f} -> {MemoryWatcher._rss() / 2**20:.1f} MiB")
        return out

    phase("2 kernels", phase_kernels, results)
    rates = phase("2b probes", phase_probes, results)
    phase("2c group API", phase_group_api, results)
    msm_in = phase("3 MSM", phase_msm)
    phase("4 golden", phase_golden)
    r1cs, ck = phase("5 projective 2^18", phase_full, results, False)
    with jacobian_config():
        r1cs_j, ck_j = phase("5b Jacobian 2^18", phase_full, results, True)
    phase("5c pSNARK 2^18", phase_psnark, results, card)
    phase("5d elastic SNARK 2^24", phase_elastic, results, card)
    phase("6 profile", phase_profile, results, msm_in, r1cs, ck)
    phase("6b needs_dbl count", phase_count_dbl, msm_in, r1cs_j, ck_j)
    log(f"total: {time.time() - t_start:.1f} s")
    log(json.dumps({"kernels": kernel_rows(results, rates, usage)}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
