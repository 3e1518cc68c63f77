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
  2d. prints each round kernel's registers, spills and resident blocks
     and warps per SM (one {"round_kernel_usage": ...} line), holds the
     sumcheck round kernels (sc_message, sc_fused, sc_fold:
     csrc/sumcheck_kernels.cu) against their plain versions bit for bit
     at 2^10, 2^12, 2^14, 2^16, 2^20 and 2^22 lanes with contiguous and
     strided (t[:, 0::2]) twist powers, at n = 2 and 4, on edge lanes
     (zeros, ones, r - 1, the twist at 0 and 1), on the largest sums at
     2^14 and 2^22 lanes, on the launch shapes' edges (pair counts around
     one block, the switch from split to unsplit launches and one wave
     of resident blocks), with t at lane strides 4 and 8 and with f, g
     as lane blocks at offsets 0, 1, 2 and 4 of wider tensors; times
     each at 2^10-2^22 lanes beside its plain version at 2^20, and
     sc_message there with a pair to a lane and split over two (one
     {"round_kernel_times": ...} line with the launch shapes); proves a
     2^20 sumcheck through round_arrays and holds it against the plain
     prover (messages, challenges, final foldings; 1 message launch, 19
     fused rounds, 1 fold, 20 readbacks); the plain versions run with
     fields/fp.py's Fr ops on their plain versions too (plain_fr), so the
     reference is plain PyTorch throughout;
  2e. holds the Fr field kernels (fr_mul, fr_addsub, fr_reduce,
     fr_lane_sum: csrc/fr_kernels.cu) against fields/fp.py's plain
     versions bit for bit: at 2^0, 2^4, 2^10, 2^14, 2^20 and 2^22 lanes
     (a of any 256-bit value, b canonical; mul, add, sub, neg, the lane
     sum with and without b at G = 1), on edge values (0, 1, r - 1,
     r - 2, the Montgomery one, from_mont's plain one, the largest sums
     at 2^14 and 2^22), on a (16, 1) scalar, halves, even/odd views and
     lane blocks at offsets 1 and 3, at _fold_block's (G, m) shapes of a
     2^20 block against (16, 1, m) weights, and fr_reduce at E = 16-21
     (every row at 2^47 - 1, random rows, V = 0 and V = r, int32 rows, a
     strided view) and at E = 16 on every size; times each at 2^20 and
     2^14 lanes beside its bound and its plain version (one
     {"fr_kernel_times": ...} line);
  2f. holds the MSM window chunk's glue kernels (msm_digits, msm_pack,
     msm_sort_gather, msm_walk_down: csrc/msm_kernels.cu) against their
     plain versions (ops/msm.py `_digits_plain`, `_keys_plain`,
     `_pack_plain`, `_sort_gather_plain`; ops/ec_scan.py
     `_walk_down_plain` with padd's and add's plain versions as the
     combiner) bit for bit at every (lanes, c, Wc, bits) that plan_window
     and _glv_plan return from 2^8 to 2^22 lanes, at c = 19 with Wc = 2,
     and at c = 7 and c = 2, whose 10 and 17 reduce-chain levels take two
     and three walk-down launches (random scalars with 0 and the largest, GLV signs, a tenth of
     the points at infinity, y = 0; the walk-down in both configurations),
     with every scalar small (dead windows) and every point at infinity
     at the 2^10, 2^16 and 2^20 plans, msm_sort_gather on both its
     mappings (requires plans of each), and prints the split walk-down's
     occupancy; holds padd, padd01 and add writing
     into odd-slot and transposed output views against their fresh
     outputs, and the copy-free stop-level scan against the same scan on
     the plain padd and add; times each glue kernel at the MSM 2^20,
     2^18 and 2^14 plans beside its bound and its plain version, the
     Jacobian walk-down beside the projective one, and the gather's
     attribution at the 2^20 plan (one {"msm_glue_kernel_times": ...}
     line);
  2g. holds the MSM's combine kernel (msm_combine: csrc/msm_kernels.cu)
     against its plain version (plain_combine: the chain of padd's plain
     version) bit for bit, and ops/msm.py `_combine` against
     `_horner_host` and the host sum once normalized, at the (c, W) of
     the MSM 2^20, 2^18 and 256-lane plans with 1, 2 and 9 sets and an
     all-identity set, on projective totals and on Jacobian ones (which
     `_combine` turns projective for the kernel); runs MSMs on the card
     (msm, GLV, msm_batch) with `_horner_host` and hostcurve.g1_double
     made to raise, one msm_combine launch per MSM call; times each shape
     beside the host Horner it replaced (one {"msm_combine_times": ...}
     line);
  3. runs the kernel MSM pipeline at 2^16 (and at c = 7) against the
     host Pippenger and
     times it at 2^20 on bench.py's inputs, in the projective and in the
     Jacobian configuration (GEMINI_TPU_PROJ=0), and counts the glue
     kernels' launches per MSM 2^20 (one digits and one pack launch, one
     gather and one walk-down per window chunk, one combine; a
     {"msm_glue_launches_2^20": ...} line);
  4. proves the SNARK and the pSNARK golden instances on the card in
     both configurations, compares the proof bytes (and the pSNARK's
     index commitments) with gemini_tpu's
     (gemini_tpu_torch/testdata/{snark,psnark}_golden.json) and verifies
     them, then parses gemini_tpu's pSNARK bytes with the port's
     psnark_proof_from_bytes and verifies that proof on the card; the
     elastic prover (block size 8, threshold 2) gives the golden SNARK
     bytes, and the dummy stream with the constant-base τ = 1 key gives
     gemini_tpu's elastic bytes (testdata/elastic_golden.json), in both
     configurations; the elastic pSNARK prover (block size 8, threshold
     2) gives the golden pSNARK bytes and verifies, in both
     configurations;
  5. proves and verifies the examples/snark.py -i 18 --time-prover
     instance (SRS built on the card), rejects a tampered proof, and
     shows that the prove went through padd, padd01 and mont_mul;
  5b. does the same under GEMINI_TPU_PROJ=0 and shows that the SRS and
     the prove went through the Jacobian add kernel and not padd/padd01;
     in both, the prove's sumcheck rounds run on the round kernels, and
     phase 5 proves once more with the plain round for the sumcheck
     spans beside the kernels' (the same bytes);
  5c. the pSNARK at 2^18 (examples/psnark.py -i 18): dummy_r1cs(Random(0),
     2^18), SRS built on the card with max_degree = 2n + nnz + 2, index,
     prove and verify each timed on the host clock ending in a
     synchronize, the bytes -> parse -> verify round trip, tampered
     zc_alpha and set_z_ep rejected; prints one JSON line with the
     times, proof bytes, psnark::* spans, launches and lanes per kernel
     (counts reset before the prove; padd, padd01, mont_mul and the
     round kernels must each launch), sumcheck 3's provers, rounds and
     readbacks (one per round with messages, not one per prover), peak
     device memory and the card line;
  5d. the elastic SNARK (examples/snark.py -i 24, BASELINE config 4):
     DummyR1csStream(2^24, e = Random(0).randrange(1, R)) with
     FakeCommitterKeyStream(3, seed=0, max_msm_buffer=2^20), block size
     2^20, threshold 22.  First the 2^24 prove; then at 2^18 with
     threshold 14 (four streaming rounds), whose bytes must equal the
     time prover's on the dense twin (CommitterKey.new(2^18, 3, seed=0,
     tau=1)); then the 2^24 proof verified against the dense relation,
     a tampered zc_alpha rejected; prints one {"snark_elastic_logn": 24,
     ...} JSON line (prove and verify seconds, proof bytes, peak device
     memory, host RSS before the prove (after a heap trim), its peak and
     the difference, spans, launches and lanes; padd, padd01 and the
     round kernels must launch, counts reset before the prove) with the
     card line;
  5e. the elastic pSNARK (examples/psnark.py -i 20 --giant):
     DummyR1csStream(2^20, e) with FakeCommitterKeyStream(3, seed=0,
     max_msm_buffer=2^20), block size 2^20, threshold 22: index_stream
     and the prove timed on the host clock ending in a synchronize, the
     bytes -> parse -> bytes round trip, verified against the dense
     relation, tampered zc_alpha and set_z_ep rejected; then the dense
     twin at 2^15 (block 2^12, threshold 12: the three sumchecks run
     space-prover rounds), whose elastic bytes must equal the time
     prover's on to_dense() with CommitterKey.new(2n + nnz + 2, 3,
     seed=0, tau=1), and whose index_stream must equal index there;
     prints one {"psnark_elastic_logn": 20, ...} JSON line (index,
     prove and verify seconds, proof bytes, psnark::* and
     tensorcheck::* spans, the device peak and the span it falls in,
     host RSS before the prove and what it added, launches and lanes
     per kernel; padd, padd01, mont_mul and the round kernels must
     launch, counts reset before the prove) with the card line;
  5f. the GLV MSM and the multi-device paths: glv.decompose on bench.py's
     2^20 scalars plus the edge scalars (4096 sampled lanes and the
     edges equal the CPU's, recombine mod r and stay under the bound;
     its device kernels per 2^20 MSM counted by torch.profiler); the
     GLV MSM (GEMINI_TPU_GLV=1) at 2^16 against the host Pippenger and
     at 2^20 against phase 3 in both configurations, with its padd,
     padd01 and mont_mul launches (each must launch) and three
     alternating GLV off/on pairs at 2^20 (host clock, printed, not
     claimed); then a 4-shard mesh (four cards when there are four,
     else Mesh([cuda:0] * 4), printed): msm_multichip 2^20 against
     phase 3 in both configurations, msm_batch_multichip on a fold-tree
     batch (2^18 ... 2^9) against msm_batch, one msm_combine launch a
     call and no host Horner, ShardedTimeProver 2^18 against
     TimeProver, the 2^18 SNARK with mesh= (phase 5's bytes, verified,
     timed; padd, padd01, mont_mul, sc_message, sc_fold and the MSM
     kernels, msm_combine included, must launch, no host MSM or host
     Horner may run), and with
     mesh= and GEMINI_TPU_GLV=1 in both configurations the golden
     SNARK, the golden elastic SNARKs (CommitterKeyStream and the
     τ = 1 fake key with mesh=) and the golden pSNARK against
     gemini_tpu's bytes; prints one {"mesh_glv": ...} JSON line;
  5g. runs each entry point's main in process on the card (snark -i 12
     --time-prover, snark -i 16, psnark -i 10 with and without
     --elastic, psnark -i 12 --giant, pc -d 12 -p 4 -m 3): each must name
     the card and verify (the giant pSNARK against its dense relation);
     prints their output and one {"examples": ...} JSON line;
  6. profiles one projective MSM at 2^20, one Jacobian MSM at 2^20, one
     projective 2^18 prove and two streamed passes of the elastic prove
     (a space-prover round over two 2^20 blocks, one 2^20 block of the
     dummy stream's abc vector) with torch.profiler and prints, as one
     JSON line, each window's device busy share, device ms per kernel
     (the port's own and the ten largest others), the PyTorch copy
     kernels' device ms, and the lanes each group-law kernel took; then
     the prove's sc_fused and sc_message device ms and launches beside
     the first design's (one {"round_kernels_prove_2^18": ...} line),
     and the prove's plain int64 chains by kernel name (int64 adds,
     binary ops, `or` reductions, DtoH copies), device events, busy
     share and Fr kernel ms beside the prove's with plain Fr ops (one
     {"plain_chains_prove_2^18": ...} line), and per MSM 2^20 and per
     2^18 prove the device events, copy kernels, int64 adds, binary ops,
     `or` reductions, DtoH copies and glue kernels beside the counts
     before the glue kernels (one {"msm_glue_profile": ...} line);
  6b. counts, untimed, the add lanes and warps that need the doubling in
     one more Jacobian MSM at 2^20 and one more Jacobian 2^18 prove (the
     add launches: the walk-down's adds run inside msm_walk_down and are
     not counted);
  7. prints the total seconds, the kernel table as one JSON line
     (bounds, shares of bound, ptxas registers and spills), the card
     line, and as the last line {"ok": true, "device": {...}}.  Each
     phase prints its seconds and the host RSS at its start and end.

Each kernel's launch count is read from its own path, with every count
set to 0 just before the path runs: padd, padd01, mont_mul, the round
kernels, the Fr kernels and the MSM glue kernels from the projective
prove (5; the glue kernels also from the Jacobian prove, 5b), add from
the Jacobian prove (5b), dbl from the group API (2c), vpu_chain from
vpubench, copy_add from mmbench (2b).  Every prove (5-5g) must run its
Fr ops on the Fr kernels: each of the four launches (the examples:
fr_mul) and `_carry` runs on no CUDA tensor, Fr or Fq (fields/fp.py
CUDA_CARRIES), and its MSMs on the glue kernels: each of the four
launches.
The pSNARK prove's (5c) padd, padd01 and mont_mul launches are the
table's `psnark_launches`, the 2^24 elastic prove's (5d) its
`elastic_launches`, the 2^20 elastic pSNARK prove's (5e) its
`psnark_elastic_launches` (every kernel); the GLV MSM's (5f) its
`glv_launches` and the 2^18 mesh prove's (5f) its `mesh_launches`
(padd, padd01, mont_mul and the round kernels; these also carry 5c's,
5d's and 5e's counts).

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
SC_SOURCE = "gemini_tpu_torch/csrc/sumcheck_kernels.cu"
SC_KERNELS = ("sc_message", "sc_fused", "sc_fold")
FR_SOURCE = "gemini_tpu_torch/csrc/fr_kernels.cu"
FR_KERNELS = ("fr_mul", "fr_addsub", "fr_reduce", "fr_lane_sum")
MSM_SOURCE = "gemini_tpu_torch/csrc/msm_kernels.cu"
GLUE_KERNELS = ("msm_digits", "msm_pack", "msm_sort_gather", "msm_walk_down")
MSM_KERNELS = (*GLUE_KERNELS, "msm_combine")
KERNELS = ("padd", "padd01", "mont_mul", "add", "dbl", "vpu_chain", "copy_add",
           *SC_KERNELS, *FR_KERNELS, *MSM_KERNELS)
SOURCES = {k: G1_SOURCE for k in KERNELS[:5]}
SOURCES.update(vpu_chain=PROBE_SOURCE, copy_add=PROBE_SOURCE,
               **dict.fromkeys(SC_KERNELS, SC_SOURCE),
               **dict.fromkeys(FR_KERNELS, FR_SOURCE),
               **dict.fromkeys(MSM_KERNELS, MSM_SOURCE))
# The sumcheck round kernels at n lanes of f and g (64 bytes per (16,)
# int32 element): Fr products per lane and bytes moved per lane (message:
# f, g and n/2 twist powers read; fused: f, g and n/4 powers read, f2
# and g2 written; fold: f, g read, f2, g2 written).  An 8-word CIOS
# product is 2 x 64 word products, two IMADs each.
FR_PRODUCT_IMADS = 2 * 64 * 2
SC_PRODUCTS_PER_LANE = {"sc_message": 3, "sc_fused": 2.5, "sc_fold": 1}
SC_BYTES_PER_LANE = {"sc_message": 160, "sc_fused": 208, "sc_fold": 192}
REPLACES = {
    "padd": "gemini_tpu/curve/pallas_g1.py:616",
    "padd01": "gemini_tpu/curve/pallas_g1.py:624",
    "mont_mul": "gemini_tpu/curve/pallas_g1.py:612",
    "add": "gemini_tpu/curve/pallas_g1.py:596",
    "dbl": "gemini_tpu/curve/pallas_g1.py:604",
    "vpu_chain": "benches/vpubench.py:31",
    "copy_add": "benches/mmbench.py:31",
    # XLA-fused in the reference, no Pallas kernel
    "sc_message": "gemini_tpu/subprotocols/sumcheck.py:78",
    "sc_fused": "gemini_tpu/subprotocols/sumcheck.py:117",
    "sc_fold": "gemini_tpu/subprotocols/sumcheck.py:187",
    "fr_mul": "gemini_tpu/fields/fp.py:273",
    "fr_addsub": "gemini_tpu/fields/fp.py:199, :206",
    "fr_reduce": "gemini_tpu/fields/fp.py:327",
    "fr_lane_sum": "gemini_tpu/fields/fp.py:412",
    "msm_digits": "gemini_tpu/ops/msm.py:110, :129",
    "msm_pack": "gemini_tpu/ops/msm.py:178",
    "msm_sort_gather": "gemini_tpu/ops/msm.py:199",
    "msm_walk_down": "gemini_tpu/ops/ec_scan.py:265",
    "msm_combine": "gemini_tpu/ops/msm.py:153",
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
# Phase 2d: the sumcheck round kernels against their plain versions
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_round():
    """Run the sumcheck round's plain versions on the card: the module's
    three dispatchers swapped for them, so TimeProver is otherwise the
    same code (the reference prover of phases 2d and 5)."""
    from gemini_tpu_torch.subprotocols import sumcheck as sc

    saved = sc._round_message_kernel, sc._fold_kernel, sc._fused_round
    sc._round_message_kernel = sc._round_message_plain
    sc._fold_kernel = sc._fold_plain
    sc._fused_round = sc._fused_round_plain
    try:
        yield
    finally:
        sc._round_message_kernel, sc._fold_kernel, sc._fused_round = saved


@contextlib.contextmanager
def plain_fr():
    """fields/fp.py's Fr ops on their plain versions whatever the tensor's
    device (fp._fr_kernel answers no): the plain PyTorch reference of the
    round kernels (2d), whose plain versions call fp.  Fq keeps its own
    dispatch."""
    from gemini_tpu_torch.fields import fp

    saved = fp._fr_kernel
    fp._fr_kernel = lambda spec, a: False
    try:
        yield
    finally:
        fp._fr_kernel = saved


def on_plain_fr(fn):
    with plain_fr():
        return fn()


def sc_launches():
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck

    return dict(sck.LAUNCHES)


def fr_random(gen, m):
    """(16, m) int32 random canonical Fr limbs on the card (top limb below
    0x4000, so every value is below 2^254 < r)."""
    import torch

    x = torch.randint(0, 1 << 16, (16, m), generator=gen, device="cuda",
                      dtype=torch.int32)
    x[-1] &= 0x3FFF
    return x


def check_round_kernels(results, f, g, t, twist, r, what):
    """message, fused round and fold on (f, g, t) against the plain
    versions, bit for bit (fused only for a multiple of 4 lanes)."""
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.subprotocols import sumcheck as sc
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck

    rt, tw2 = r * twist % R, twist * twist % R
    cases = [("sc_message", lambda: (sck.message(f, g, t, twist),),
              lambda: (sc._round_message_plain(f, g, t, twist),)),
             ("sc_fold", lambda: sck.fold(f, g, r, rt),
              lambda: sc._fold_plain(f, g, t, r, rt)[:2])]
    if f.shape[1] % 4 == 0:
        cases.append(("sc_fused", lambda: sck.fused_round(f, g, t, r, rt, tw2),
                      lambda: sc._fused_round_plain(f, g, t, r, rt, tw2)))
    for name, kern, plain in cases:
        want = on_plain_fr(plain)
        err = compare(name, kern(), want, what)
        res = results.setdefault(name, {"max_abs_err": 0, "bit_exact": True})
        res["max_abs_err"] = max(res["max_abs_err"], err)


SC_SIZES = (1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 20, 1 << 22)
# The first design's round kernels (a pair a thread, 256-thread blocks,
# up to 1024 of them): their device ms and launches in phase 6's 2^18
# SNARK prove (PERF.md section 5), printed beside this design's.
SC_PROVE_FIRST_DESIGN = {"sc_fused": (0.659, 34), "sc_message": (0.100, 2)}


# Each round kernel's instances: (a pair to two lanes, vector loads).
# The message has a pair-to-a-lane kernel (vector or scalar loads) and
# a split one (one lane of each operand a thread: scalar loads); the
# fused round is always split.
SC_INSTANCES = {"sc_message": ((False, True), (False, False), (True, False)),
                "sc_fused": ((True, True), (True, False))}


def round_kernel_usage(usage):
    """Each round kernel's ptxas registers and spills (the largest of its
    instances), and per instance and block size (the wrapper's two) its
    registers, local bytes and resident blocks and warps per SM (the
    occupancy API), with the card's SM count; printed as one JSON line.
    Returns it with resident[kernel][split][threads], the fewer blocks of
    the kernel's vector and scalar instances."""
    import torch

    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck

    out, resident = {}, {}
    for name, instances in SC_INSTANCES.items():
        inst = {}
        for split, vec in instances:
            for threads in (sck.SMALL_THREADS, sck.LARGE_THREADS):
                occ = sck.occupancy(name, vec, split, threads)
                occ["warps_per_sm"] = occ["blocks_per_sm"] * threads // 32
                inst[f"{'split' if split else 'pair'}_{'vector' if vec else 'scalar'}"
                     f"_{threads}"] = occ
                per = resident.setdefault(name, {}).setdefault(split, {})
                per[threads] = min(per.get(threads, 1 << 30), occ["blocks_per_sm"])
        out[name] = {**usage.get(name, {}), "instances": inst}
    out["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    log(json.dumps({"round_kernel_usage": out}))
    return out, resident


def check_launch_edges(results, gen, rnd, sms, resident):
    """The launch shapes' edges (sumcheck_kernels.launch_shape), for the
    message (2 lanes a pair) and the fused round (4 lanes a pair): one
    128-thread block plus one unit (65 and 129 pairs), the last pair
    count whose split units fit one 128-thread block per SM and one
    beyond (64 x SMs and + 1: the message's switch to a pair a lane, the
    fused round's to 256-thread blocks), Ws - 1, Ws + 1 and Ws + 128
    pairs with Ws the pairs of one wave of resident split 256-thread
    blocks, and for the message's pair-to-a-lane kernel W - 256, W - 1,
    W + 1 and W + 256 pairs with W its wave (a block fewer, a wave less
    and plus one pair, one block's pairs on a second pass).  All three
    kernels run on each lane count, against their plain versions."""
    from gemini_tpu_torch.params import R

    for name, width in (("sc_message", 2), ("sc_fused", 4)):
        small = 64 * sms
        split_wave = resident[name][True][256] * sms * 256 // 2
        cases = [65, 129, small, small + 1, split_wave - 1, split_wave + 1,
                 split_wave + 128]
        if False in resident[name]:
            wave = resident[name][False][256] * sms * 256
            cases += [wave - 256, wave - 1, wave + 1, wave + 256]
        for pairs in cases:
            n = width * pairs
            f, g, t = fr_random(gen, n), fr_random(gen, n), fr_random(gen, n // 2)
            check_round_kernels(results, f, g, t, rnd.randrange(R), rnd.randrange(R),
                                f"{name}'s edge: {pairs} pairs ({n} lanes)")
    log(f"sumcheck kernels: bit-exact on the launch shapes' edges (resident blocks "
        f"per SM by split and block size: {resident}, {sms} SMs)")


def time_message_split_and_pair(inputs):
    """sc_message at each of SC_SIZES with a pair to a lane and with a
    pair split over two lanes, each on the grid the wrapper's rule
    (sumcheck_kernels.unit_grid) gives its units (guarded events): the
    measurement behind launch_shape's choice between them.  Returns
    {"2^k": {"pair": ms, "split": ms, "chosen": "pair" | "split"}}."""
    from gemini_tpu_torch.benches.timing import event_ms
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck

    rule, out = sck.launch_shape, {}
    try:
        for n in SC_SIZES:
            f, g, t, twist, _ = inputs[n]
            sck.launch_shape = rule
            row = {"chosen": "split" if sck._shape(f.device, "sc_message", n // 2)[0]
                   else "pair"}
            for split in (False, True):
                sck.launch_shape = lambda name, pairs, sms, resident, split=split: (
                    split, *sck.unit_grid(2 * pairs if split else pairs, sms,
                                          resident[split]))
                row["split" if split else "pair"] = event_ms(
                    lambda: sck.message(f, g, t, twist), 100 if n < 1 << 20 else 20,
                    spin_cycles=40_000_000)
            out[f"2^{n.bit_length() - 1}"] = row
    finally:
        sck.launch_shape = rule
    return out


def check_views(results, gen, rnd):
    """Operand views at 2^16 lanes: t at lane strides 4 and 8 (deep
    rounds), and f, g as lane blocks of tensors of odd width at lane
    offsets 0, 1, 2 and 4 (rows not 8-byte aligned: the scalar-load
    instances), and at offset 4 of a width that keeps rows aligned (the
    vector loads on a view)."""
    from gemini_tpu_torch.params import R

    n = 1 << 16
    f, g, tbig = fr_random(gen, n), fr_random(gen, n), fr_random(gen, 4 * n)
    twist, r = rnd.randrange(R), rnd.randrange(R)
    for step in (4, 8):
        check_round_kernels(results, f, g, tbig[:, 0::step][:, : n // 2], twist, r,
                            f"2^16 lanes, t at lane stride {step}")
    t = tbig[:, 0::2][:, : n // 2]
    for width, off in ((n + 5, 1), (n + 5, 2), (n + 5, 4), (n + 5, 0), (n + 8, 4)):
        fb, gb = fr_random(gen, width), fr_random(gen, width)
        check_round_kernels(results, fb[:, off:off + n], gb[:, off:off + n], t, twist,
                            r, f"2^16 lanes, f and g at lane {off} of width {width}")
    log("sumcheck kernels: bit-exact with t at lane strides 4 and 8 and with f, g "
        "as lane blocks at offsets 0, 1, 2 and 4 of wider tensors")


def phase_sumcheck_kernels(results, usage=None):
    """2d: the sumcheck round kernels (message, fused round, fold) against
    their plain versions, bit for bit: random canonical inputs at 2^10,
    2^12, 2^14, 2^16, 2^20 and 2^22 lanes, with contiguous twist powers
    and the strided view t[:, 0::2] the folds leave; one pair (n = 2; the
    fused round at n = 4); edge lanes at 2^14 (zeros, Montgomery ones,
    r - 1 everywhere, the twist at 0 and 1) and the largest sums at 2^14
    and 2^22 (f = r - 1, g = T = 1, twist 0: every term r - 1); the
    grid's edges (check_launch_edges) and operand views (check_views).
    Prints each round kernel's registers, spills and resident blocks per
    SM (round_kernel_usage).  Then each kernel timed at 2^10-2^22 lanes
    (guarded events) beside its plain version at 2^20 (host clock), with
    the launch shape of each size, sc_message with a pair to a lane and
    split over two at each size (time_message_split_and_pair), and a
    full 2^20 sumcheck through
    round_arrays against the plain prover: messages, challenges and final
    foldings, one message launch, 19 fused rounds, one terminal fold and
    20 readbacks."""
    import torch

    from gemini_tpu_torch.benches.timing import event_ms
    from gemini_tpu_torch.fields.fp import FR
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.subprotocols import sumcheck as sc
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck
    from gemini_tpu_torch.transcript import GeminiTranscript

    occ, resident = round_kernel_usage(usage or {})
    sms = occ["sms"]
    gen = torch.Generator(device="cuda").manual_seed(20261017)
    rnd = random.Random(20261017)
    inputs = {}
    for n in (2, 4, *SC_SIZES):
        f, g, tfull = fr_random(gen, n), fr_random(gen, n), fr_random(gen, n)
        twist, r = rnd.randrange(R), rnd.randrange(R)
        for t, kind in ((tfull[:, : n // 2].contiguous(), "contiguous"),
                        (tfull[:, 0::2], "strided (lane stride 2)")):
            check_round_kernels(results, f, g, t, twist, r, f"{n} lanes, {kind} t")
        inputs[n] = (f, g, tfull[:, 0::2], twist, r)
        log(f"sumcheck kernels: bit-exact against plain on {n} lanes (contiguous "
            "and strided twist powers)")

    def const(v, n, mont=True):
        return FR.tensor([v], "cuda", mont=mont).expand(16, n).contiguous()

    n = 1 << 14
    f, g, t, twist, r = inputs[n]
    zero, one = const(0, n), const(1, n)
    rmax = const(R - 1, n, mont=False)  # limbs of r - 1
    edges = [("zeros", zero, zero, zero[:, : n // 2], twist, r),
             ("ones", one, one, one[:, : n // 2], 1, 1),
             ("r - 1 everywhere", rmax, rmax, rmax[:, : n // 2], R - 1, R - 1),
             ("largest sums", rmax, one, one[:, : n // 2], 0, R - 1),
             ("twist 0", f, g, t, 0, r), ("twist 1", f, g, t, 1, r)]
    for label, *args in edges:
        check_round_kernels(results, *args, f"2^14 lanes, {label}")
    big = 1 << 22
    check_round_kernels(results, const(R - 1, big, mont=False), const(1, big),
                        const(1, big // 2), 0, R - 1, "2^22 lanes, largest sums")
    want = (big // 2) * (R - 1)
    got = sck.message(const(R - 1, big, mont=False), const(1, big),
                      const(1, big // 2), 0).cpu().numpy().astype(object)
    if [sum(int(x) << (16 * i) for i, x in enumerate(row)) for row in got] != [want] * 2:
        raise AssertionError("sc_message: the 2^22-lane largest sum is not "
                             "2^21 (r - 1)")
    log("sumcheck kernels: bit-exact on n = 2 and 4, on edge lanes at 2^14 "
        "(zeros, ones, r - 1, twist 0 and 1) and on the largest sums at 2^14 "
        "and 2^22 lanes")
    check_launch_edges(results, gen, rnd, sms, resident)
    check_views(results, gen, rnd)
    for name, split in (("sc_message", False), ("sc_fused", True)):
        blocks = resident[name][split][256]  # the large rounds' instance
        results[name].update(resident_blocks_per_sm_256=blocks,
                             resident_warps_per_sm=blocks * 256 // 32)

    shapes = {}
    for name in SC_KERNELS:
        res = results[name]
        for n in SC_SIZES:
            f, g, t, twist, r = inputs[n]
            rt, tw2 = r * twist % R, twist * twist % R
            kern = {"sc_message": lambda: sck.message(f, g, t, twist),
                    "sc_fused": lambda: sck.fused_round(f, g, t, r, rt, tw2),
                    "sc_fold": lambda: sck.fold(f, g, r, rt)}[name]
            ms = event_ms(kern, 100 if n < 1 << 20 else 20,
                          spin_cycles=40_000_000)
            if name != "sc_fold":
                pairs = n // (2 if name == "sc_message" else 4)
                shapes.setdefault(name, {})[f"2^{n.bit_length() - 1}"] = \
                    sck._shape(f.device, name, pairs)
            if n == 1 << 20:
                plain = {"sc_message": lambda: sc._round_message_plain(f, g, t, twist),
                         "sc_fused": lambda: sc._fused_round_plain(f, g, t, r, rt, tw2),
                         "sc_fold": lambda: sc._fold_plain(f, g, t, r, rt)}[name]
                res.update(ms=ms, plain_ms=plain_ms(lambda: on_plain_fr(plain)),
                           library_ms=None,
                           bytes=n * SC_BYTES_PER_LANE[name],
                           imads=int(n * SC_PRODUCTS_PER_LANE[name] * FR_PRODUCT_IMADS),
                           lanes=n, source=SC_SOURCE)
            else:
                res[f"ms_2^{n.bit_length() - 1}"] = ms
                res[f"bound_ms_2^{n.bit_length() - 1}"] = bound_n = max(
                    n * SC_BYTES_PER_LANE[name] / HBM_BYTES_PER_S,
                    n * SC_PRODUCTS_PER_LANE[name] * FR_PRODUCT_IMADS / IMAD_PER_S) * 1e3
                res[f"bound_share_2^{n.bit_length() - 1}"] = bound_n / ms
        bound = max(res["bytes"] / HBM_BYTES_PER_S, res["imads"] / IMAD_PER_S) * 1e3
        log(f"kernel {name}: {res['ms_2^14']:.4f} ms at 2^14 lanes, "
            f"{res['ms']:.4f} ms at 2^20 (bound {bound:.4f} ms, "
            f"{bound / res['ms']:.1%} of it; plain {res['plain_ms']:.2f} ms), "
            f"{res['ms_2^22']:.4f} ms at 2^22 (bound {res['bound_ms_2^22']:.4f} ms, "
            f"{res['bound_ms_2^22'] / res['ms_2^22']:.1%} of it)")
    split_or_pair = time_message_split_and_pair(inputs)
    log(json.dumps({"round_kernel_times": {
        name: {"ms": {k[3:]: v for k, v in results[name].items()
                      if k.startswith("ms_2^")} | {"2^20": results[name]["ms"]},
               "launch_shapes": shapes.get(name)} for name in SC_KERNELS},
        "sc_message_pair_vs_split_ms": split_or_pair}))

    # A full 2^20 sumcheck through round_arrays against the plain prover.
    n = 1 << 20
    f, g, _, twist, _ = inputs[n]
    sck.reset_launches()
    sc.reset_readbacks()
    t0 = time.time()
    kern = sc.Sumcheck.prove(GeminiTranscript(b"S"), sc.TimeProver(f, g, twist))
    torch.cuda.synchronize()
    kern_s = time.time() - t0
    launches, readbacks = sc_launches(), sc.READBACKS["round_messages"]
    with plain_round(), plain_fr():
        t0 = time.time()
        plain = sc.Sumcheck.prove(GeminiTranscript(b"S"), sc.TimeProver(f, g, twist))
        torch.cuda.synchronize()
        plain_s = time.time() - t0
    if (kern.messages, kern.challenges, kern.final_foldings) != \
            (plain.messages, plain.challenges, plain.final_foldings):
        raise AssertionError("the 2^20 sumcheck through round_arrays differs from "
                             "the plain prover")
    if launches != {"sc_message": 1, "sc_fused": 19, "sc_fold": 1} or readbacks != 20:
        raise AssertionError(f"the 2^20 sumcheck: launches {launches}, readbacks "
                             f"{readbacks}; want 1 message, 19 fused, 1 fold, 20")
    log(json.dumps({"sumcheck_2^20": {
        "equal_to_plain": True, "kernel_s": kern_s, "plain_s": plain_s,
        "launches": launches, "readbacks": readbacks}}))


# ---------------------------------------------------------------------------
# Phase 2e: the Fr field kernels against their plain versions
# ---------------------------------------------------------------------------


FR_SIZES = (1, 1 << 4, 1 << 10, 1 << 14, 1 << 20, 1 << 22)
# _fold_block's (groups, m) at a 2^20 block: round j of a streamed
# sumcheck folds m = 2^j base lanes a group.
FOLD_SHAPES = ((1 << 20, 1), (1 << 19, 2), (1 << 16, 16), (1 << 14, 64),
               (1 << 10, 1 << 10), (1 << 4, 1 << 16), (2, 1 << 19), (1, 1 << 20))
REDUCE_ROWS = (16, 17, 18, 19, 20, 21)
# Bytes and 32-bit IMADs per lane of each Fr kernel as phase 2e times it at
# n lanes (64 bytes per (16,) int32 element; a row of int64 8 bytes): mul
# reads a and b and writes the product, one 8-word CIOS product (2 x 64
# word products, two IMADs each); addsub the same bytes; reduce reads 18
# int64 rows and writes one element, a CIOS over reduce_words(18) = 10
# words (2 x 8 word products a word); lane_sum reads one element a term
# (with b: two and a product) and writes 18 limbs a group.
FR_REDUCE_TIMED_ROWS = 18


def fr_bytes_imads(name, n, groups=1, with_b=False):
    from gemini_tpu_torch.fields import fr_kernels as frk

    if name in ("fr_mul", "fr_addsub"):
        return 192 * n, FR_PRODUCT_IMADS * n if name == "fr_mul" else 0
    if name == "fr_reduce":
        rows = FR_REDUCE_TIMED_ROWS
        return (8 * rows + 64) * n, 2 * 2 * 8 * frk.reduce_words(rows) * n
    return ((128 if with_b else 64) * n + 72 * groups,
            FR_PRODUCT_IMADS * n if with_b else 0)


def fr_bound_ms(name, n, groups=1, with_b=False):
    nbytes, imads = fr_bytes_imads(name, n, groups, with_b)
    return max(nbytes / HBM_BYTES_PER_S, imads / IMAD_PER_S) * 1e3


def any_256(gen, m, *batch):
    """(16, *batch, m) int32 16-bit limbs of any 256-bit values."""
    import torch

    return torch.randint(0, 1 << 16, (16, *batch, m), generator=gen, device="cuda",
                         dtype=torch.int32)


def check_fr(results, name, kern, plain, what):
    """One Fr kernel call against its plain version (fp's `_*_plain`),
    bit for bit."""
    err = compare(name, (kern(),), (plain(),), what)
    res = results.setdefault(name, {"max_abs_err": 0, "bit_exact": True})
    res["max_abs_err"] = max(res["max_abs_err"], err)


def check_fr_pair(results, a, b, what):
    """mul, add, sub and neg (sub from a broadcast zero) of a and b, and the
    lane sum of a and of a * b over the last axis, against the plain
    versions."""
    from gemini_tpu_torch.fields import fp
    from gemini_tpu_torch.fields import fr_kernels as frk
    from gemini_tpu_torch.fields.fp import FR

    axis = a.ndim - 1 if a.ndim >= b.ndim else b.ndim - 1
    check_fr(results, "fr_mul", lambda: frk.mul(a, b),
             lambda: fp._mont_mul_plain(FR, a, b), what)
    check_fr(results, "fr_addsub", lambda: frk.addsub(a, b, False),
             lambda: fp._add_plain(FR, a, b), f"{what} (add)")
    check_fr(results, "fr_addsub", lambda: frk.addsub(a, b, True),
             lambda: fp._sub_plain(FR, a, b), f"{what} (sub)")
    check_fr(results, "fr_addsub", lambda: fp.neg(FR, b),
             lambda: fp._sub_plain(FR, b.new_zeros(b.shape), b), f"{what} (neg)")
    check_fr(results, "fr_lane_sum", lambda: frk.lane_sum(a, axis),
             lambda: fp._lane_sum_plain(FR, a, axis), f"{what} (sum of a)")
    check_fr(results, "fr_lane_sum", lambda: frk.lane_sum(a, axis, b),
             lambda: fp._lane_sum_plain(FR, fp._mont_mul_plain(FR, a, b), axis),
             f"{what} (sum of a * b)")


def reduce_rows(gen, rows, n, top=1 << 47):
    import torch

    return torch.randint(0, top, (rows, n), generator=gen, device="cuda",
                         dtype=torch.int64)


def phase_fr_kernels(results):
    """2e: the Fr kernels (fr_mul, fr_addsub, fr_reduce, fr_lane_sum:
    csrc/fr_kernels.cu) against fields/fp.py's plain versions, bit for
    bit: a of any 256-bit value and canonical b at 2^0, 2^4, 2^10, 2^14,
    2^20 and 2^22 lanes (the lane sums at G = 1, with and without b);
    edge values (0, 1, r - 1, r - 2, the Montgomery one and from_mont's
    plain one, the largest sums) at 2^10 lanes; a (16, 1) scalar, halves,
    even/odd views and lane blocks at offsets 1 and 3 of a wider tensor;
    _fold_block's grouped shapes (a 2^20 block as G x m, m = 1 ... 2^20,
    against (16, 1, m) weights) with and without b; fr_reduce at E =
    16-21 with every row at 2^47 - 1, with random rows below 2^47, V = 0
    and V = r, on int64 and int32 rows and a strided view.  Then each
    kernel timed at 2^20 and 2^14 lanes (guarded events) beside its bound
    and its plain version (host clock, at 2^20), fr_lane_sum also with b
    and at the grouped shapes; prints one {"fr_kernel_times": ...} line."""
    import torch

    from gemini_tpu_torch.benches.timing import event_ms
    from gemini_tpu_torch.fields import fp
    from gemini_tpu_torch.fields import fr_kernels as frk
    from gemini_tpu_torch.fields.fp import FR
    from gemini_tpu_torch.params import R

    gen = torch.Generator(device="cuda").manual_seed(20261018)
    inputs = {}
    for n in FR_SIZES:
        a, b = any_256(gen, n), fr_random(gen, n)
        check_fr_pair(results, a, b, f"{n} lanes")
        inputs[n] = (a, b)
    log("Fr kernels: bit-exact against plain at 2^0, 2^4, 2^10, 2^14, 2^20 and "
        "2^22 lanes (mul, add, sub, neg, lane sums with and without b)")

    def const(v, n, mont=True):
        return FR.tensor([v], "cuda", mont=mont).expand(16, n).contiguous()

    n = 1 << 10
    edge_vals = [(0, True), (1, True), (R - 1, False), (R - 2, False), (1, False),
                 (R - 1, True)]
    edges = torch.cat([const(v, n // 8, m) for v, m in edge_vals]
                      + [fr_random(gen, n - 6 * (n // 8))], dim=1)
    rolled = edges.roll(n // 8, dims=1)
    for label, a, b in (("edge values", edges, edges), ("edges x rolled", edges, rolled),
                        ("r - 1 x edges", const(R - 1, n, False), edges)):
        check_fr_pair(results, a, b, f"2^10 lanes, {label}")
    one = torch.zeros((16, 1), dtype=torch.int32, device="cuda")
    one[0] = 1  # from_mont's plain one, broadcast
    check_fr(results, "fr_mul", lambda: fp.from_mont(FR, inputs[n][0]),
             lambda: fp._mont_mul_plain(FR, inputs[n][0], one), "from_mont at 2^10")
    for big in (1 << 14, 1 << 22):
        rmax = const(R - 1, big, False)
        check_fr(results, "fr_lane_sum", lambda: frk.lane_sum(rmax),
                 lambda: fp._lane_sum_plain(FR, rmax, 1), f"largest sums, {big} lanes")
    got = frk.lane_sum(const(R - 1, 1 << 22, False)).cpu().numpy().astype(object)
    if sum(int(x) << (16 * i) for i, x in enumerate(got)) != (1 << 22) * (R - 1):
        raise AssertionError("fr_lane_sum: the 2^22-lane largest sum is not 2^22 (r - 1)")

    n = 1 << 14
    a, b = inputs[n]
    wide, canon = any_256(gen, 2 * n + 5), fr_random(gen, 2 * n + 5)
    scalar = fr_random(gen, 1)
    views = [("a (16, 1) scalar", a, scalar), ("scalar first", scalar.expand(16, n), b),
             ("halves", wide[:, :n], canon[:, n:2 * n]),
             ("even/odd", wide[:, 0:2 * n:2], canon[:, 1:2 * n:2]),
             ("offsets 1 and 3", wide[:, 1:n + 1], canon[:, 3:n + 3])]
    for label, x, y in views:
        check_fr_pair(results, x, y, f"2^14 lanes, {label}")
    log("Fr kernels: bit-exact on edge values, from_mont, the largest sums and "
        "broadcast, half, even/odd and offset views")

    block = any_256(gen, 1 << 20)
    for groups, m in FOLD_SHAPES:
        grouped = block.reshape(16, groups, m)
        w = fr_random(gen, m).reshape(16, 1, m)
        check_fr(results, "fr_lane_sum", lambda: frk.lane_sum(grouped, 2),
                 lambda: fp._lane_sum_plain(FR, grouped, 2), f"({groups}, {m})")
        check_fr(results, "fr_lane_sum", lambda: frk.lane_sum(grouped, 2, w),
                 lambda: fp._lane_sum_plain(FR, fp._mont_mul_plain(FR, grouped, w), 2),
                 f"({groups}, {m}) with (16, 1, {m}) weights")
        check_fr(results, "fr_mul", lambda: frk.mul(grouped, w),
                 lambda: fp._mont_mul_plain(FR, grouped, w), f"({groups}, {m}) weights")
    log(f"Fr kernels: bit-exact at _fold_block's shapes {FOLD_SHAPES}")

    for rows in REDUCE_ROWS:
        n = 1 << 10
        top = torch.full((rows, n // 4), (1 << 47) - 1, dtype=torch.int64, device="cuda")
        zero = torch.zeros((rows, 4), dtype=torch.int64, device="cuda")
        r_rows = zero.clone()
        r_rows[:16] = torch.tensor([(R >> (16 * k)) & 0xFFFF for k in range(16)],
                                   device="cuda")[:, None]
        v = torch.cat([top, zero, r_rows, reduce_rows(gen, rows, n)], dim=1)
        check_fr(results, "fr_reduce", lambda: frk.reduce(v),
                 lambda: fp._reduce_relaxed_plain(FR, v), f"E = {rows}, edge rows")
        want = [sum(int(x) << (16 * k) for k, x in enumerate(col)) % R
                for col in v[:, n // 4 - 1:n // 4 + 8].T.cpu().tolist()]
        if FR.decode(frk.reduce(v)[:, n // 4 - 1:n // 4 + 8], mont=False) != want:
            raise AssertionError(f"fr_reduce at E = {rows}: not V mod r")
        v32 = reduce_rows(gen, rows, n, 1 << 16).to(torch.int32)
        check_fr(results, "fr_reduce", lambda: frk.reduce(v32),
                 lambda: fp._reduce_relaxed_plain(FR, v32), f"E = {rows}, int32 rows")
    for n in FR_SIZES:
        v = reduce_rows(gen, 16, n)
        check_fr(results, "fr_reduce", lambda: frk.reduce(v),
                 lambda: fp._reduce_relaxed_plain(FR, v), f"E = 16, {n} lanes")
    vs = reduce_rows(gen, 18, 3 * (1 << 14))[:, 1::3]
    check_fr(results, "fr_reduce", lambda: frk.reduce(vs),
             lambda: fp._reduce_relaxed_plain(FR, vs), "E = 18, lane stride 3")
    log(f"Fr kernels: fr_reduce bit-exact at E = {REDUCE_ROWS} (rows at 2^47 - 1, "
        "V = 0, V = r, int32 rows) and at E = 16 on every size")

    times = {}
    for name in FR_KERNELS:
        res = results[name]
        for n in (1 << 14, 1 << 20):
            a, b = inputs[n] if n in inputs else (any_256(gen, n), fr_random(gen, n))
            v = reduce_rows(gen, FR_REDUCE_TIMED_ROWS, n)
            kern, plain = {
                "fr_mul": (lambda: frk.mul(a, b), lambda: fp._mont_mul_plain(FR, a, b)),
                "fr_addsub": (lambda: frk.addsub(a, b, False),
                              lambda: fp._add_plain(FR, a, b)),
                "fr_reduce": (lambda: frk.reduce(v),
                              lambda: fp._reduce_relaxed_plain(FR, v)),
                "fr_lane_sum": (lambda: frk.lane_sum(a),
                                lambda: fp._lane_sum_plain(FR, a, 1))}[name]
            ms = event_ms(kern, 100 if n < 1 << 20 else 20, spin_cycles=40_000_000)
            if n == 1 << 20:
                nbytes, imads = fr_bytes_imads(name, n)
                res.update(ms=ms, plain_ms=plain_ms(plain), library_ms=None,
                           bytes=nbytes, imads=imads, lanes=n, source=FR_SOURCE,
                           bound_ms=fr_bound_ms(name, n))
                res["bound_by"] = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                    imads / IMAD_PER_S else "operations"
            else:
                res["ms_2^14"] = ms
                res["bound_ms_2^14"] = fr_bound_ms(name, n)
                res["bound_share_2^14"] = res["bound_ms_2^14"] / ms
        times[name] = {"ms_2^20": res["ms"], "bound_ms_2^20": res["bound_ms"],
                       "ms_2^14": res["ms_2^14"], "plain_ms_2^20": res["plain_ms"]}
    res = results["fr_lane_sum"]
    for n in (1 << 14, 1 << 20):
        a, b = inputs[n]
        key = f"2^{n.bit_length() - 1}"
        res[f"ms_with_b_{key}"] = ms = event_ms(lambda: frk.lane_sum(a, 1, b),
                                                100 if n < 1 << 20 else 20,
                                                spin_cycles=40_000_000)
        res[f"bound_ms_with_b_{key}"] = bound = fr_bound_ms("fr_lane_sum", n,
                                                            with_b=True)
        res[f"bound_share_with_b_{key}"] = bound / ms
    fold = {}
    for groups, m in FOLD_SHAPES:
        grouped = block.reshape(16, groups, m)
        w = fr_random(gen, m).reshape(16, 1, m)
        ms = event_ms(lambda: frk.lane_sum(grouped, 2, w), 20, spin_cycles=40_000_000)
        nbytes = 64 * (1 << 20) + 64 * m + 72 * groups  # weights read once
        bound = max(nbytes / HBM_BYTES_PER_S,
                    (1 << 20) * FR_PRODUCT_IMADS / IMAD_PER_S) * 1e3
        fold[f"{groups}x{m}"] = {"ms": ms, "bound_ms": bound,
                                 "shape": frk.lane_sum_shape(groups, m,
                                                             frk._sm_count(block.device))}
    res["ms_fold_2^20"] = {k: v["ms"] for k, v in fold.items()}
    times["fr_lane_sum"].update({"with_b": {k: v for k, v in res.items()
                                            if "with_b" in k}, "fold_2^20": fold})
    for name in FR_KERNELS:
        log(f"kernel {name}: {results[name]['ms_2^14']:.4f} ms at 2^14 lanes, "
            f"{results[name]['ms']:.4f} ms at 2^20 (bound "
            f"{results[name]['bound_ms']:.4f} ms, "
            f"{results[name]['bound_ms'] / results[name]['ms']:.1%} of it; plain "
            f"{results[name]['plain_ms']:.2f} ms)")
    log(json.dumps({"fr_kernel_times": times}))


# ---------------------------------------------------------------------------
# Phase 2f: the MSM window chunk's glue kernels
# ---------------------------------------------------------------------------


SECTOR = 32
# The glue's bounds count what each launch must move: every input sector
# it reads, once (the distinct 32-byte sectors of its gathers), and every
# byte it writes.  msm_sort_gather: the packed rows its order reads (96
# bytes, 3 sectors each), all of the sorted keys and the order (8 bytes
# each a lane: the gather reads a permutation of them, and sd reads the
# keys in order), and its outputs x and y (192 bytes a lane), mask (1)
# and sd (8).  msm_pack's bytes a point: 192 read, 96 written.
SG_OUT_BYTES = 8 + 192 + 1 + 8
PACK_BYTES = 192 + 96
GLUE_LOGS = range(8, 23)  # lanes 2^8 .. 2^22
# the MSM 2^20 plan (the table's row), the 2^18 plan (the 2^18 SNARK's
# largest MSM: c = 13, Wc = 4) and the 2^14 plan
GLUE_TIMED = (1 << 20, 1 << 18, 1 << 14)
GATHER_L2_ROWS = 1 << 15  # the gather's variant with rows from an L2-held table


def glue_plans():
    """Every (lanes, c, Wc, bits) that plan_window and _glv_plan return
    from 2^8 to 2^22 lanes, c = 19 at 2^16 lanes with Wc = 2 (windows
    over three limbs, a chunk of two windows), and two plans of more
    reduce-chain levels than one walk-down launch takes: c = 7 at 2^16
    lanes with Wc = 2 (10 levels, two launches) and c = 2 at 2^18 (17
    levels, three)."""
    from gemini_tpu_torch.ops import glv, msm

    plans = set()
    for k in GLUE_LOGS:
        plans.add((1 << k, *msm.plan_window(1 << k), msm.N_BITS))
        plans.add((1 << k, *msm._glv_plan(1 << k), glv.GLV_BITS))
    plans.add((1 << 16, 19, 2, msm.N_BITS))
    plans.add((1 << 16, 7, 2, msm.N_BITS))
    plans.add((1 << 18, 2, 1, msm.N_BITS))
    return sorted(plans)


def glue_inputs(gen, n, bits, kind):
    """Scalars and points of n lanes on the card: (limbs, n) int32 scalars
    (16 limbs below R, or 8 limbs of a GLV component), 0 and the largest
    (R - 1, or the component bound - 1) at lanes 0 and 1, or with kind
    "small" every scalar below 2^8 (every window above the first dead);
    points (24, n) canonical x and y with a random tenth at infinity, or
    every point at infinity with kind "inf"; the GLV component signs."""
    import torch

    from gemini_tpu_torch.ops import glv
    from gemini_tpu_torch.params import R

    limbs, top = (16, 0x73ED) if bits > 128 else (8, 0x2000)
    big = R - 1 if bits > 128 else glv.COMPONENT_BOUND - 1

    def rand(rows, hi):
        t = torch.randint(0, 1 << 16, (rows, n), generator=gen, device="cuda",
                          dtype=torch.int32)
        t[-1] = torch.randint(0, hi, (n,), generator=gen, device="cuda",
                              dtype=torch.int32)
        return t

    sc = rand(limbs, top)
    sc[:, 0] = 0
    sc[:, 1] = torch.tensor([(big >> (16 * i)) & 0xFFFF for i in range(limbs)])
    if kind == "small":
        sc[1:] = 0
        sc[0] &= 0xFF
    px, py = rand(24, 0x1A01), rand(24, 0x1A01)
    py[:, 2] = 0  # -0 = 0
    pinf = torch.rand((n,), generator=gen, device="cuda") < 0.1
    if kind == "inf":
        pinf[:] = True
    flip = torch.rand((n,), generator=gen, device="cuda") < 0.5
    return sc, px, py, pinf, flip


def plain_combiner(proj):
    """padd's (or add's) plain version as a combiner on CUDA tensors: the
    walk-down's and the scan's plain reference with no kernel in it."""
    from gemini_tpu_torch.curve import g1_kernels as gk

    fn = gk.padd_plain if proj else gk.add_plain

    def comb(a, b, out=None):
        shape = a[0].shape
        res = [r.reshape(shape) for r in fn(*(t.reshape(24, -1) for t in (*a, *b)))]
        if out is not None:
            for o, r in zip(out, res):
                o.copy_(r)
        return tuple(res)

    return comb


def gathered_sectors(t, rows, w, idx):
    """Ids of the 32-byte sectors that reading operand t (a (rows, *batch)
    view, or with rows = 0 a (*batch) mask) at lanes (w, idx) touches, as
    the walk-down's loads address it (curve/g1_kernels.lane_strides)."""
    import torch

    from gemini_tpu_torch.curve.g1_kernels import lane_strides

    ls, bs, es = lane_strides(t, rows)
    off = w * bs + idx * es
    if rows:
        off = off.reshape(1, -1) + torch.arange(rows, device=off.device)[:, None] * ls
    return ((t.data_ptr() + off * t.element_size()) // SECTOR).reshape(-1)


def walk_down_work(pos, scanned, levels, rev_bits):
    """(bytes, IMADs) one walk-down launch over these positions needs:
    per lane its position (8) and output (288 bytes), and the distinct
    32-byte sectors that its loads touch: the top gather (x, y, z) where
    the top position is live, and per level y at the stored index, x and
    z (or the mask) where the position is even; one padd (21 x 144 word
    products, two IMADs each) per lane and level."""
    import torch

    from gemini_tpu_torch.ops import ec_scan

    w = (torch.arange(pos.shape[0], device=pos.device)[:, None].expand_as(pos)
         if pos.ndim == 2 else torch.zeros_like(pos))
    top = pos
    for _ in levels:
        top = (top - 1) >> 1
    live = top >= 0
    ids = [gathered_sectors(t, 24, w[live], top[live]) for t in scanned]
    pk = pos
    for k, (lx, ly, lz, is01) in enumerate(levels):
        even = (pk >= 0) & (pk % 2 == 0)
        sidx = ec_scan._stored_index(pk.clamp(min=0), lx.shape[-1],
                                     rev_bits - k if rev_bits else 0)
        ids += [gathered_sectors(ly, 24, w, sidx),
                gathered_sectors(lx, 24, w[even], sidx[even]),
                gathered_sectors(lz, 0 if is01 else 24, w[even], sidx[even])]
        pk = (pk - 1) >> 1
    sectors = torch.unique(torch.cat(ids)).numel()
    lanes = pos.numel()
    return (lanes * (8 + 288) + sectors * SECTOR,
            lanes * len(levels) * WORD_PRODUCTS["padd"] * 2)


def sort_gather_bytes(pp, skey, order):
    """The bytes msm_sort_gather must move: the packed rows `order`
    reads (3 sectors each, once), the keys and the order (8 bytes each a
    lane), and SG_OUT_BYTES a lane."""
    import torch

    rows = torch.unique(order).numel()
    return rows * 3 * SECTOR + skey.numel() * (8 + 8 + SG_OUT_BYTES)


def check_glue_plan(results, gen, plan, kind, configs, keep=None):
    """One plan's glue against the plain versions, bit for bit: the
    digits (mags and negs; the sort keys, with the GLV signs where bits
    = 128), the packed points, one window chunk's sort-gather (the first chunk, or with
    kind "small" the last, all of whose windows are dead) and its
    walk-down after the kernels' reduce chain and scan, in each of
    `configs` (True: projective, False: Jacobian).  `keep` collects the
    inputs for the timings."""
    import torch

    from gemini_tpu_torch.ops import ec_scan, msm
    from gemini_tpu_torch.ops import msm_kernels as mk

    n, c, wc, bits = plan
    what = f"{n} lanes, c = {c}, Wc = {wc}, {bits}-bit scalars, {kind}"
    sc, px, py, pinf, flip = glue_inputs(gen, n, bits, kind)
    flip = flip if bits == 128 else None
    W = -(-bits // c)
    mags, negs = msm._digits_plain(sc, c, bits)
    keys = mk.digits(sc, c, W, pinf, flip)
    errs = {"msm_digits": compare("msm_digits", (keys,),
                                  (msm._keys_plain(mags, negs, pinf, flip),), what)}
    compare("msm_digits", msm.extract_signed_digits(sc, c, bits), (mags, negs),
            f"{what} (the digits read from the keys, no flags)")
    pp = mk.pack(px, py)
    errs["msm_pack"] = compare("msm_pack", (pp,), (msm._pack_plain(px, py),), what)
    w0 = W - wc if kind == "small" else 0
    key = keys[w0:w0 + wc]
    rb = ec_scan.bitrev_levels(n, 1 << (c - 1))
    skey, order = torch.sort(key, dim=1)
    got = mk.sort_gather(pp, skey, order, rb)
    errs["msm_sort_gather"] = compare(
        "msm_sort_gather", got, msm._sort_gather_plain(pp, skey, order, rb), what)
    fx, fy, fm, sd = got
    pos = msm._boundary_positions(sd, c)
    errs["msm_walk_down"] = 0
    for proj in configs:
        comb, comb01 = msm.combiners(proj)
        levels, scanned = ec_scan.reduce_and_scan(fx, fy, fm, pos.shape[-1], comb,
                                                  comb01, rb)
        before = mk.LAUNCHES["msm_walk_down"]
        got = mk.walk_down(pos, scanned, levels, rb, proj)
        launches = mk.LAUNCHES["msm_walk_down"] - before
        if launches != max(1, -(-len(levels) // mk.MAX_LEVELS)):
            raise AssertionError(f"msm_walk_down: {launches} launches for "
                                 f"{len(levels)} levels at {what}")
        err = compare("msm_walk_down", got,
                      ec_scan._walk_down_plain(pos, scanned, levels, rb,
                                               plain_combiner(proj)),
                      f"{what}, {'projective' if proj else 'Jacobian'}")
        errs["msm_walk_down"] = max(errs["msm_walk_down"], err)
        if keep is not None and proj:
            keep.update(sc=sc, c=c, W=W, pinf=pinf, px=px, py=py, pp=pp, skey=skey,
                        order=order, rb=rb, pos=pos, scanned=scanned, levels=levels)
        elif keep is not None:
            keep.update(jacobian=(scanned, levels))
    for name, err in errs.items():
        res = results.setdefault(name, {"max_abs_err": 0, "bit_exact": True})
        res["max_abs_err"] = max(res["max_abs_err"], err)


def glue_split_ms(k, variants):
    """Device ms (guarded events) of msm_sort_gather and of msm_walk_down
    in both configurations on one plan's inputs `k` (check_glue_plan's
    `keep`, the walk-down in both configurations); with `variants`, the
    gather's attribution: the same kernel with the order the identity
    (rows read in sequence), with rb = 0 (keys and order read
    coalesced), both, with every row taken from the first GATHER_L2_ROWS
    points (a table the L2 holds), and pp.index_select of the order's
    rows (a yardstick of random 96-byte row gathers, not the function).
    It calls only wrappers and helpers that checkouts from before the
    redesigned glue kernels also have, so benches/pairs.py times a parent
    checkout with it too."""
    import torch

    from gemini_tpu_torch.benches.timing import event_ms
    from gemini_tpu_torch.ops import msm_kernels as mk

    iters = 20 if k["skey"].numel() >= 1 << 20 else 100

    def ms(fn):
        return event_ms(fn, iters, spin_cycles=40_000_000)

    pp, skey, order, rb = k["pp"], k["skey"], k["order"], k["rb"]
    scanned_j, levels_j = k["jacobian"]
    out = {"msm_sort_gather": ms(lambda: mk.sort_gather(pp, skey, order, rb)),
           "msm_walk_down": ms(lambda: mk.walk_down(k["pos"], k["scanned"], k["levels"],
                                                    rb, True)),
           "msm_walk_down_jacobian": ms(lambda: mk.walk_down(k["pos"], scanned_j, levels_j,
                                                             rb, False))}
    if variants:
        ident = torch.arange(skey.shape[-1], device=skey.device).expand_as(order)
        ident = ident.contiguous()
        in_l2 = order % GATHER_L2_ROWS
        rows = order.flatten()
        out["msm_sort_gather_variants"] = {
            "order_identity": ms(lambda: mk.sort_gather(pp, skey, ident, rb)),
            "rb_0": ms(lambda: mk.sort_gather(pp, skey, order, 0)),
            "order_identity_rb_0": ms(lambda: mk.sort_gather(pp, skey, ident, 0)),
            "rows_in_l2": ms(lambda: mk.sort_gather(pp, skey, in_l2, rb)),
            "index_select": ms(lambda: pp.index_select(0, rows)),
            "index_select_rows": rows.numel()}
    return out


def check_strided_outputs(results):
    """padd, padd01 and add writing into views, bit for bit against their
    fresh outputs: the odd slots of a (3, 24, 4, 2m) buffer (the others
    left as they were) and a transposed (24, m, 4) plane, on phase 2's
    2^14-lane inputs as (24, 4, m); then the copy-free stop-level scan
    with the kernels against the same scan with padd's and add's plain
    versions, on (24, 4, 2^12) points."""
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.ops import ec_scan

    n = 1 << 14
    m = n // 4
    padd_in, padd01_in, _, _, jac_in, _, _ = kernel_inputs(n, seed=20261019)

    def shaped(t):
        return t.reshape(24, 4, m) if t.ndim == 2 else t.reshape(4, m)

    for name, fn, ins in (("padd", gk.padd, padd_in), ("padd01", gk.padd01, padd01_in),
                          ("add", gk.add, jac_in)):
        p = [shaped(t) for t in ins]
        fresh = fn(p[:3], p[3:])
        buf = torch.full((3, 24, 4, 2 * m), -1, dtype=torch.int32, device="cuda")
        err = compare(name, fn(p[:3], p[3:], out=tuple(buf[..., 1::2])), fresh,
                      "output in odd slots")
        if not bool((buf[..., 0::2] == -1).all()):
            raise AssertionError(f"{name}: wrote outside its output views")
        plane = torch.empty((3, 24, m, 4), dtype=torch.int32, device="cuda")
        err = max(err, compare(name, fn(p[:3], p[3:], out=tuple(plane.transpose(-1, -2))),
                               fresh, "output in a transposed plane"))
        res = results.setdefault(name, {"max_abs_err": 0, "bit_exact": True})
        res["max_abs_err"] = max(res.get("max_abs_err", 0), err)
    for proj, ins in ((True, padd_in), (False, jac_in)):
        s = torch.stack([t.reshape(24, 4, m)[..., :1 << 12] for t in ins[:3]])
        comb = ec_scan.padd_points if proj else ec_scan.add_points
        name = "padd" if proj else "add"
        err = compare(name, ec_scan.inclusive_scan_ec(s, combiner=comb),
                      ec_scan.inclusive_scan_ec(s, combiner=plain_combiner(proj)),
                      "the copy-free scan of (24, 4, 2^12)")
        res = results.setdefault(name, {"max_abs_err": 0, "bit_exact": True})
        res["max_abs_err"] = max(res.get("max_abs_err", 0), err)
    log("kernels padd, padd01, add: bit-exact into odd-slot and transposed output "
        "views; the copy-free scan bit-exact against the plain padd and add")


def phase_msm_glue(results):
    """2f: the MSM window chunk's glue kernels (msm_digits, msm_pack,
    msm_sort_gather, msm_walk_down: csrc/msm_kernels.cu) against their
    plain versions, bit
    for bit, at every plan of glue_plans() (random scalars with 0 and the
    largest; the walk-down in both configurations), and with every scalar
    small (dead windows) and every point at infinity at the 2^10, 2^16 and
    2^20 plans, the gather at plans of both its mappings; the strided
    outputs of padd, padd01 and add; then each kernel timed at the MSM
    2^20, 2^18 and 2^14 plans (guarded events) beside its bound (bytes at
    the HBM rate, or at the 2^14 plan, whose operands stay in the L2, at
    phase 2b's measured L2 rate) and its plain version (host clock,
    2^20), the Jacobian walk-down beside the projective one, and the
    gather's attribution at the 2^20 plan (glue_split_ms); prints the
    projective walk-down's occupancy and one {"msm_glue_kernel_times":
    ...} line."""
    import torch

    from gemini_tpu_torch.benches.timing import event_ms
    from gemini_tpu_torch.ops import ec_scan, msm
    from gemini_tpu_torch.ops import msm_kernels as mk

    gen = torch.Generator(device="cuda").manual_seed(20261020)
    l2_rate = results["copy_add"]["bound_rate_bytes_per_s"]
    kept = {}
    plans = glue_plans()
    for plan in plans:
        n, c, wc, bits = plan
        timed = (n in GLUE_TIMED and (c, wc) == tuple(msm.plan_window(n))
                 and bits == msm.N_BITS)
        keep = kept.setdefault(n, {}) if timed else None
        check_glue_plan(results, gen, plan, "random", (True, False), keep)
        if n in (1 << 10, 1 << 16, 1 << 20) and bits == msm.N_BITS and c != 19:
            for kind in ("small", "inf"):
                check_glue_plan(results, gen, plan, kind, (True, False))
    log(f"MSM glue kernels: bit-exact at {len(plans)} plans {plans} (the walk-down "
        "projective and Jacobian), with dead windows and all points at infinity")
    lane_plans = [p for p in plans if not mk.sort_gather_blocked(
        p[0], ec_scan.bitrev_levels(p[0], 1 << (p[1] - 1)))]
    if not 0 < len(lane_plans) < len(plans):
        raise AssertionError(f"msm_sort_gather: {len(lane_plans)} of {len(plans)} plans "
                             "on the lane mapping; 2f must check both mappings")
    log(f"msm_sort_gather: block mapping at {len(plans) - len(lane_plans)} plans, a "
        f"thread on its own lane at {lane_plans}")
    occ = mk.walk_down_occupancy()
    results["msm_walk_down"].update(
        resident_blocks_per_sm=occ["blocks_per_sm"],
        resident_warps_per_sm=occ["blocks_per_sm"] * 3,
        resident_shared_bytes_per_block=occ["shared_bytes"])
    log(json.dumps({"msm_walk_down_occupancy": occ}))
    check_strided_outputs(results)

    times = {}
    for name in GLUE_KERNELS:
        res = results[name]
        for n in GLUE_TIMED:
            k = kept[n]
            kern, plain, work = {
                "msm_digits": (
                    lambda: mk.digits(k["sc"], k["c"], k["W"], k["pinf"]),
                    lambda: msm._keys_plain(*msm._digits_plain(k["sc"], k["c"]),
                                            k["pinf"]),
                    lambda: (n * (4 * 16 + 1 + 8 * k["W"]), 0)),
                "msm_pack": (
                    lambda: mk.pack(k["px"], k["py"]),
                    lambda: msm._pack_plain(k["px"], k["py"]),
                    lambda: (n * PACK_BYTES, 0)),
                "msm_sort_gather": (
                    lambda: mk.sort_gather(k["pp"], k["skey"], k["order"], k["rb"]),
                    lambda: msm._sort_gather_plain(k["pp"], k["skey"], k["order"],
                                                   k["rb"]),
                    lambda: (sort_gather_bytes(k["pp"], k["skey"], k["order"]), 0)),
                "msm_walk_down": (
                    lambda: mk.walk_down(k["pos"], k["scanned"], k["levels"], k["rb"],
                                         True),
                    lambda: ec_scan._walk_down_plain(k["pos"], k["scanned"], k["levels"],
                                                     k["rb"], plain_combiner(True)),
                    lambda: walk_down_work(k["pos"], k["scanned"], k["levels"],
                                           k["rb"]))}[name]
            ms = event_ms(kern, 100 if n < 1 << 18 else 20, spin_cycles=40_000_000)
            nbytes, imads = work()
            # at the 2^14 plan every operand stays in the L2 between the
            # timed launches: its bytes move at most at the L2 rate
            # l2bench measured (phase 2b's copy_add row), as copy_add's are
            rate = l2_rate if n == 1 << 14 else HBM_BYTES_PER_S
            bound = max(nbytes / rate, imads / IMAD_PER_S) * 1e3
            by = "bytes" if nbytes / rate >= imads / IMAD_PER_S else "operations"
            key = f"2^{n.bit_length() - 1}"
            times.setdefault(name, {})[key] = {
                "ms": ms, "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                "bound_rate_bytes_per_s": rate,
                "imads": imads, "lanes": {"msm_digits": n, "msm_pack": n,
                                          "msm_sort_gather": k["skey"].numel(),
                                          "msm_walk_down": k["pos"].numel()}[name]}
            if n == GLUE_TIMED[0]:
                res.update(ms=ms, plain_ms=plain_ms(plain), library_ms=None,
                           bytes=nbytes, imads=imads, lanes=times[name][key]["lanes"],
                           source=MSM_SOURCE, bound_ms=bound, bound_by=by)
                times[name][key]["plain_ms"] = res["plain_ms"]
            else:
                res.update({f"ms_{key}": ms, f"bound_ms_{key}": bound,
                            f"bound_by_{key}": by, f"bound_share_{key}": bound / ms})
        log(f"kernel {name}: {res['ms_2^14']:.4f} ms at the 2^14 plan, "
            f"{res['ms_2^18']:.4f} ms at the 2^18 plan, {res['ms']:.4f} "
            f"ms at the 2^20 plan (bound {res['bound_ms']:.4f} ms, "
            f"{res['bound_ms'] / res['ms']:.1%} of it, {res['bound_by']}; plain "
            f"{res['plain_ms']:.2f} ms)")
    for n in GLUE_TIMED:
        key = f"2^{n.bit_length() - 1}"
        split = glue_split_ms(kept[n], n == GLUE_TIMED[0])
        times["msm_walk_down"][key]["jacobian_ms"] = split["msm_walk_down_jacobian"]
        times["msm_sort_gather"][key]["block_mapping"] = mk.sort_gather_blocked(
            n, kept[n]["rb"])
        if "msm_sort_gather_variants" in split:
            var = split["msm_sort_gather_variants"]
            times["msm_sort_gather"][key]["variants"] = var
            # the yardstick's bytes: each of its rows read and written once
            var["index_select_bound_ms"] = (var["index_select_rows"] * 2 * 96
                                            / HBM_BYTES_PER_S * 1e3)
            log(f"msm_sort_gather at the 2^20 plan: {json.dumps(var)}")
        if n == GLUE_TIMED[0]:
            results["msm_walk_down"]["jacobian_ms"] = split["msm_walk_down_jacobian"]
    log(json.dumps({"msm_glue_kernel_times": times}))


# (c, W) of the MSM 2^20, 2^18 and 256-lane plans, and the sets a combine
# takes: one MSM, a batch of two, the 2^18 SNARK's batch of nine
COMBINE_PLANS = ((16, 16), (13, 20), (6, 43))
COMBINE_SETS = (1, 2, 9)


def combine_totals(rnd, sets, windows, proj, identity=False):
    """Window totals on the card for msm_combine, (x, y, z) of
    (24, sets * W), set s's window w at column s * W + w: k G (G the
    generator) with a random z, projective (x z, y z, z) or Jacobian
    (x z^2, y z^3, z); the identity in every window of set 1 (where there
    is one), in set 0's top window and in about a tenth of the others, or
    in every window with `identity`.  Returns the totals and each
    window's k (0 for the identity)."""
    from gemini_tpu_torch.fields.fp import FQ
    from gemini_tpu_torch.hostcurve import g1_mul
    from gemini_tpu_torch.params import Q, R
    from gemini_tpu_torch.refimpl import g1_generator

    ks, cols = [], []
    for i in range(sets * windows):
        s, w = divmod(i, windows)
        z = rnd.randrange(1, Q)
        if identity or s == 1 or (s == 0 and w == windows - 1) or rnd.random() < 0.1:
            ks.append(0)
            cols.append((0, 1, 0) if proj else (1, 1, 0))
            continue
        ks.append(rnd.randrange(1, R))
        x, y = g1_mul(g1_generator(), ks[-1])
        cols.append((x * z % Q, y * z % Q, z) if proj else
                    (x * z * z % Q, y * pow(z, 3, Q) % Q, z))
    return tuple(FQ.tensor([col[k] for col in cols], "cuda") for k in range(3)), ks


def plain_combine(totals, sets, c):
    """msm_combine's plain version on the card: every set's chain at once
    on projective totals, c padd_plain(acc, acc) and one
    padd_plain(acc, T_w) a window, the highest window first."""
    from gemini_tpu_torch.curve import g1_kernels as gk

    windows = totals[0].shape[1] // sets
    acc = tuple(t[:, windows - 1::windows] for t in totals)
    for w in reversed(range(windows - 1)):
        for _ in range(c):
            acc = gk.padd_plain(*acc, *acc)
        acc = gk.padd_plain(*acc, *(t[:, w::windows] for t in totals))
    return acc


@contextlib.contextmanager
def no_host_horner():
    """ops/msm.py `_horner_host` and hostcurve.g1_double made to raise
    inside the block."""
    from gemini_tpu_torch import hostcurve
    from gemini_tpu_torch.ops import msm

    def boom(*a, **k):
        raise AssertionError("an MSM on CUDA tensors combined on the host")

    saved = msm._horner_host, hostcurve.g1_double
    msm._horner_host = hostcurve.g1_double = boom
    try:
        yield
    finally:
        msm._horner_host, hostcurve.g1_double = saved


def phase_msm_combine(results):
    """2g: msm_combine (csrc/msm_kernels.cu) against its plain version
    (plain_combine), bit for bit, with 9 sets and with one set all
    identity, on projective totals and on Jacobian ones turned projective
    (`_jacobian_to_proj`); `_combine` against `_horner_host` (the CPU
    tensors' combine, on the same totals read back) and the host sum
    (sum_w 2^(c w) k_w) G, normalized, with 1, 2 and 9 sets, at the MSM
    2^20, 2^18 and 256-lane plans, projective and Jacobian; MSMs on the
    card (msm in both configurations, the GLV split, msm_batch) against
    the host Pippenger with `_horner_host` and hostcurve.g1_double made
    to raise, one msm_combine launch per MSM call; then each shape timed
    (guarded events: the kernel, and `_combine` whole with one set)
    beside the host Horner it replaces (host clock, from and to the
    card), and one {"msm_combine_times": ...} line."""
    import torch

    from gemini_tpu_torch.benches.timing import event_ms
    from gemini_tpu_torch.curve import g1
    from gemini_tpu_torch.hostcurve import g1_msm, g1_mul
    from gemini_tpu_torch.ops import msm
    from gemini_tpu_torch.ops import msm_kernels as mk
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.refimpl import g1_generator

    rnd = random.Random(20261018)
    res = results.setdefault("msm_combine", {"max_abs_err": 0, "bit_exact": True})
    times, kept = {}, {}
    for c, windows in COMBINE_PLANS:
        for proj in (True, False):
            config = "projective" if proj else "jacobian"
            for sets, identity in [(s, False) for s in COMBINE_SETS] + [(1, True)]:
                what = (f"c = {c}, W = {windows}, {sets} sets, {config}"
                        + (", every total the identity" if identity else ""))
                totals, ks = combine_totals(rnd, sets, windows, proj, identity)
                ptotals = totals if proj else msm._jacobian_to_proj(*totals)
                if sets == 9 or identity:
                    res["max_abs_err"] = max(res["max_abs_err"], compare(
                        "msm_combine", mk.combine(ptotals, sets, c),
                        plain_combine(ptotals, sets, c), what))
                jac = msm._proj_to_jacobian(*totals) if proj else totals
                jac = tuple(t.cpu() for t in jac)
                host = [g1.decode_jacobian(msm._horner_host(
                    tuple(t[:, s * windows:(s + 1) * windows] for t in jac), c, "cpu"))[0]
                    for s in range(sets)]
                want = []
                for s in range(sets):
                    k = sum(kw << (c * w) for w, kw in
                            enumerate(ks[s * windows:(s + 1) * windows])) % R
                    want.append(g1_mul(g1_generator(), k) if k else None)
                with no_host_horner():
                    out = msm._combine(totals, sets, c, proj)
                if not (g1.decode_jacobian(out) == host == want):
                    raise AssertionError(f"msm_combine differs from _horner_host or the "
                                         f"host sum at {what}")
                if identity or (not proj and sets > 1):
                    continue
                key = f"c{c}_W{windows}_{config}_sets{sets}"
                steps = (c + 1) * (windows - 1)
                times[key] = {"chain_steps": steps}
                if proj:
                    ms = event_ms(lambda: mk.combine(totals, sets, c), 10,
                                  spin_cycles=40_000_000)
                    times[key].update(ms=ms, us_per_step=ms * 1e3 / steps)
                    kept[key] = (totals, sets, c)
                if sets == 1:
                    times[key]["combine_ms"] = event_ms(
                        lambda: msm._combine(totals, sets, c, proj), 10,
                        spin_cycles=40_000_000)
                    cuda_jac = msm._proj_to_jacobian(*totals) if proj else totals
                    times[key]["host_horner_ms"] = plain_ms(
                        lambda: msm._horner_host(cuda_jac, c, totals[0].device))
    log(f"msm_combine: bit-exact against plain_combine and _combine equal to "
        f"_horner_host and the host sum at {COMBINE_PLANS} with {COMBINE_SETS} sets "
        "and all-identity sets, projective and Jacobian totals")

    pts, sc, s_np, host_pts = bench_msm_inputs(1 << 14)
    n = pts.x.shape[1]
    ks = [sum(int(s_np[i, j]) << (16 * i) for i in range(s_np.shape[0])) for j in range(n)]
    hp = [host_pts[j % 512] for j in range(n)]
    want = g1_msm(hp, ks)
    calls = 0
    mk.reset_launches()
    with no_host_horner():
        for config, ctx in (("projective", contextlib.nullcontext),
                            ("jacobian", jacobian_config)):
            with ctx():
                if g1.decode_jacobian(msm.msm(pts, sc))[0] != want:
                    raise AssertionError(f"MSM 2^14 ({config}) differs from the host")
                calls += 1
        if g1.decode_jacobian(msm.msm(pts, sc, glv=True))[0] != want:
            raise AssertionError("GLV MSM 2^14 differs from the host")
        batch = msm.msm_batch(pts, [sc, sc[:, :1000], torch.zeros_like(sc[:, :300])])
        calls += 2  # the GLV MSM and the batch
        got = [g1.decode_jacobian(r)[0] for r in batch]
        if got != [want, g1_msm(hp[:1000], ks[:1000]), None]:
            raise AssertionError("msm_batch 2^14 differs from the host")
    torch.cuda.synchronize()
    if mk.LAUNCHES["msm_combine"] != calls or mk.LANES["msm_combine"] != calls + 2:
        raise AssertionError(f"msm_combine: {mk.LAUNCHES['msm_combine']} launches, "
                             f"{mk.LANES['msm_combine']} sets for {calls} MSM calls")
    log(f"msm_combine: {calls} MSMs on the card (projective, Jacobian, GLV, a batch "
        "of 3) equal the host Pippenger, one launch each, no host Horner")

    top = "c16_W16_projective_sets1"
    totals, sets, c = kept[top]
    windows = totals[0].shape[1] // sets
    steps = (c + 1) * (windows - 1)
    # one serial chain of padds a set: neither bytes nor IMADs bound it,
    # and no latency bound is measured apart from the kernel itself
    res.update(ms=times[top]["ms"], plain_ms=times[top]["host_horner_ms"], library_ms=None,
               lanes=sets, source=MSM_SOURCE,
               bytes=sets * (windows * 3 * 48 + 3 * 48),
               imads=sets * steps * WORD_PRODUCTS["padd"] * 2, bound_ms=None,
               bound_by=f"none: latency, a serial chain of (c + 1)(W - 1) = {steps} padds")
    for key in ("c13_W20_projective_sets1", "c6_W43_projective_sets1",
                "c16_W16_projective_sets9"):
        res[f"ms_{key}"] = times[key]["ms"]
    for key in ("c16_W16_projective_sets1", "c16_W16_jacobian_sets1"):
        res[f"combine_ms_{key}"] = times[key]["combine_ms"]
    log(json.dumps({"msm_combine_times": times}))


# ---------------------------------------------------------------------------
# Phase 3: MSM
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def env_config(name: str, value: str):
    """os.environ[name] = value inside the block; restored after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def jacobian_config():
    """GEMINI_TPU_PROJ=0 (the MSM and SRS through the Jacobian add
    kernel) inside the block."""
    return env_config("GEMINI_TPU_PROJ", "0")


def bench_msm_inputs(n):
    """bench.py's MSM inputs at n lanes on the card: 512 host points
    (Random(0xBEEF)) tiled, RandomState(7) scalars with the top limb
    masked.  Returns (points, scalars, scalar limbs as numpy, the 512
    host points)."""
    import numpy as np
    import torch

    from gemini_tpu_torch.curve import g1
    from gemini_tpu_torch.fields.fp import FR
    from gemini_tpu_torch.hostcurve import g1_mul
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.refimpl import g1_generator

    rnd = random.Random(0xBEEF)
    host_pts = [g1_mul(g1_generator(), rnd.randrange(1, R)) for _ in range(512)]
    ap = g1.encode_affine(host_pts, "cuda")
    reps = -(-n // 512)
    pts = g1.APoint(ap.x.repeat(1, reps)[:, :n], ap.y.repeat(1, reps)[:, :n],
                    ap.inf.repeat(reps)[:n])
    rng = np.random.RandomState(7)
    s = np.zeros((FR.n_limbs, n), dtype=np.int64)
    for i in range(FR.n_limbs):
        s[i] = rng.randint(0, 1 << 16, size=n)
    s[FR.n_limbs - 1] &= 0x0FFF
    return pts, torch.from_numpy(s.astype(np.int32)).cuda(), s, host_pts


def phase_msm():
    """3: the MSM at 2^16 against the host Pippenger and timed at 2^20,
    in both configurations.  Returns the 2^20 inputs and each
    configuration's 2^20 result (a host point)."""
    import torch

    from gemini_tpu_torch.curve import g1
    from gemini_tpu_torch.fields.fp import FR
    from gemini_tpu_torch.hostcurve import g1_msm
    from gemini_tpu_torch.ops import msm_kernels as mk
    from gemini_tpu_torch.ops.msm import N_BITS, msm, plan_window

    n = 1 << 16
    pts, sc, s_np, host_pts = bench_msm_inputs(n)
    ks = [sum(int(s_np[i, j]) << (16 * i) for i in range(FR.n_limbs)) for j in range(n)]
    t0 = time.time()
    want = g1_msm([host_pts[j % 512] for j in range(n)], ks)
    host_s = time.time() - t0
    if g1.decode_jacobian(msm(pts, sc))[0] != want:
        raise AssertionError("MSM 2^16: kernel pipeline differs from host Pippenger")
    if g1.decode_jacobian(msm(pts, sc, c=7))[0] != want:  # 10 levels: 2 walk-downs
        raise AssertionError("MSM 2^16, c = 7: kernel pipeline differs from host "
                             "Pippenger")
    with jacobian_config():
        if g1.decode_jacobian(msm(pts, sc))[0] != want:
            raise AssertionError("MSM 2^16, GEMINI_TPU_PROJ=0: the Jacobian "
                                 "pipeline differs from host Pippenger")
    log(f"msm 2^16: kernel pipeline == host Pippenger, projective and Jacobian, "
        f"and with c = 7 (host {host_s:.2f} s)")

    n = 1 << 20
    pts, sc, _, _ = bench_msm_inputs(n)

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
        log(json.dumps({"metric": "msm_g1_points_per_s_2^20", "config": config,
                        "value": n / best, "best_s": best, "first_s": warm}))
        return g1.decode_jacobian(out)[0]

    out = {"projective": timed("projective")}
    with jacobian_config():
        out["jacobian"] = timed("jacobian")
    if out["projective"] != out["jacobian"]:
        raise AssertionError("MSM 2^20: the projective and Jacobian results differ")
    # the glue's launches per MSM: one digits and one pack launch, one
    # gather and one walk-down per window chunk, in both configurations
    c, wc = plan_window(n)
    chunks = -(-(-(-N_BITS // c)) // wc)
    want = {"msm_digits": 1, "msm_pack": 1, "msm_sort_gather": chunks,
            "msm_walk_down": chunks, "msm_combine": 1}
    glue = {}
    for config, ctx in (("projective", contextlib.nullcontext), ("jacobian",
                                                                 jacobian_config)):
        mk.reset_launches()
        with ctx():
            msm(pts, sc)
        torch.cuda.synchronize()
        glue[config] = dict(mk.LAUNCHES)
        if glue[config] != want:
            raise AssertionError(f"MSM 2^20 ({config}): glue launches {glue[config]}, "
                                 f"want {want}")
    log(json.dumps({"msm_glue_launches_2^20": {**glue, "c": c, "window_chunk": wc}}))
    return (pts, sc), out


# ---------------------------------------------------------------------------
# Phases 4-5: proofs
# ---------------------------------------------------------------------------


def golden_file(name: str) -> dict:
    with open(os.path.join(HERE, "gemini_tpu_torch", "testdata", name)) as f:
        return json.load(f)


def psnark_golden(config):
    """The pSNARK golden instance on the card: index commitments and
    proof bytes equal gemini_tpu's, the proof verifies, and gemini_tpu's
    proof read by the port's deserializer verifies; the elastic prover
    (CommitterKeyStream(ck, max_msm_buffer=16), block 8, threshold 2)
    gives the same bytes, which gemini_tpu's tests pin its own elastic
    proof to, and its proof verifies."""
    from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
    from gemini_tpu_torch.psnark import Proof, index
    from gemini_tpu_torch.relation import random_r1cs
    from gemini_tpu_torch.serialize import (g1_compressed, psnark_proof_bytes,
                                            psnark_proof_from_bytes)
    from gemini_tpu_torch.streaming import CommitterKeyStream

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
    proof = Proof.new_elastic(CommitterKeyStream(ck, max_msm_buffer=16), r1, idx,
                              block_size=8, threshold=2)
    if psnark_proof_bytes(proof).hex() != g["proof_hex"]:
        raise AssertionError(f"pSNARK golden elastic proof bytes ({config}) differ "
                             "from gemini_tpu's")
    proof.verify(r1, vk, idx, g["num_non_zero"])
    log(f"pSNARK golden instance ({config}): index commitments and proof bytes "
        "equal gemini_tpu's, proof verifies; gemini_tpu's proof, parsed by the "
        "port, verifies; the elastic proof (block 8, threshold 2) has the same "
        "bytes and verifies")


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


def require_round_kernels(counts, what, fused=True):
    """The sumcheck rounds of a prove ran on the round kernels: message
    and terminal fold launches, and fused rounds where the path fuses."""
    need = ("sc_message", "sc_fold") + (("sc_fused",) if fused else ())
    if not all(counts[k] for k in need):
        raise AssertionError(f"{what} did not run its sumcheck rounds on the "
                             f"round kernels: {counts}")


def reset_fr() -> None:
    """Fr kernel launches, the MSM glue kernels' launches and the `_carry`
    calls on CUDA tensors set to 0."""
    from gemini_tpu_torch.fields import fp
    from gemini_tpu_torch.fields import fr_kernels as frk
    from gemini_tpu_torch.ops import msm_kernels as mk

    frk.reset_launches()
    mk.reset_launches()
    for k in fp.CUDA_CARRIES:
        fp.CUDA_CARRIES[k] = 0


def require_fr_kernels(what, need=FR_KERNELS, need_msm=MSM_KERNELS):
    """The Fr ops and the MSMs of a run since reset_fr() went to the
    kernels: each Fr kernel of `need` and each MSM glue kernel of
    `need_msm` launched, and `_carry` ran on no CUDA tensor, Fr or Fq.
    Returns {"fr_launches": ..., "fr_lanes": ..., "msm_launches": ...,
    "msm_lanes": ..., "cuda_carries": ...}."""
    from gemini_tpu_torch.fields import fp
    from gemini_tpu_torch.fields import fr_kernels as frk
    from gemini_tpu_torch.ops import msm_kernels as mk

    launches, carries = dict(frk.LAUNCHES), dict(fp.CUDA_CARRIES)
    glue = dict(mk.LAUNCHES)
    if (carries["Fr"] or carries["Fq"] or not all(launches[k] for k in need)
            or not all(glue[k] for k in need_msm)):
        raise AssertionError(f"{what} ran field ops or MSM glue off the kernels: "
                             f"Fr launches {launches}, MSM glue launches {glue}, "
                             f"_carry calls on CUDA tensors {carries}")
    return {"fr_launches": launches, "fr_lanes": dict(frk.LANES),
            "msm_launches": glue, "msm_lanes": dict(mk.LANES), "cuda_carries": carries}


@contextlib.contextmanager
def counted_batches():
    """Records each Sumcheck.prove_batch inside the block: provers, rounds
    and round-message readbacks."""
    from gemini_tpu_torch.subprotocols import sumcheck as sc

    saved = sc.Sumcheck.__dict__["prove_batch"]
    batches = []

    def counted(transcript, provers):
        before = sc.READBACKS["round_messages"]
        out = saved.__func__(transcript, provers)
        batches.append({"provers": len(provers), "rounds": out.rounds,
                        "readbacks": sc.READBACKS["round_messages"] - before})
        return out

    sc.Sumcheck.prove_batch = staticmethod(counted)
    try:
        yield batches
    finally:
        sc.Sumcheck.prove_batch = saved


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
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck
    from gemini_tpu_torch.utils.trace import SpanTotals

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
    sck.reset_launches()
    reset_fr()
    os.environ["GEMINI_TPU_TRACE"] = "1"
    with SpanTotals() as spans:
        t0 = time.time()
        proof = Proof.new_time(r1cs, ck)
        torch.cuda.synchronize()
        prove_s = time.time() - t0
    os.environ.pop("GEMINI_TPU_TRACE")
    launches = dict(gk.LAUNCHES)
    lanes = dict(gk.LANES)
    sc_l = sc_launches()
    require_round_kernels(sc_l, f"the 2^{logn} {config} prove")
    fr = require_fr_kernels(f"the 2^{logn} {config} prove")
    sumcheck_ms = {"kernels": {k: v for k, v in spans.ms.items() if "sumcheck" in k}}
    if not jacobian:
        # The same prove with the plain round, then with the kernels again
        # (host clock, in turns), for the sumcheck spans before and after.
        for label, ctx in (("plain", plain_round), ("kernels_again",
                                                    contextlib.nullcontext)):
            with ctx(), SpanTotals() as again:
                t0 = time.time()
                other = Proof.new_time(r1cs, ck)
                torch.cuda.synchronize()
                sumcheck_ms[f"{label}_prove_s"] = time.time() - t0
            if snark_proof_bytes(other) != snark_proof_bytes(proof):
                raise AssertionError(f"the 2^18 proof ({label}) differs")
            sumcheck_ms[label] = {k: v for k, v in again.ms.items()
                                  if "sumcheck" in k}
    t0 = time.time()
    proof.verify(r1cs, vk)
    verify_s = time.time() - t0
    if jacobian:
        for where, counts in (("SRS", setup_launches), ("prove", launches)):
            if counts["add"] == 0 or counts["padd"] or counts["padd01"]:
                raise AssertionError(f"GEMINI_TPU_PROJ=0 2^{logn} {where} did not "
                                     f"run on the add kernel alone: {counts}")
        results["add"]["launches"] = launches["add"]
        for name in MSM_KERNELS:
            results[name]["jacobian_launches"] = fr["msm_launches"][name]
    else:
        for name in ("padd", "padd01", "mont_mul"):
            if launches[name] == 0:
                raise AssertionError(f"the 2^{logn} prove launched no {name} kernel")
            results[name]["launches"] = launches[name]
            results[name]["lanes_per_prove"] = lanes[name]
        for name in SC_KERNELS:
            results[name]["launches"] = sc_l[name]
        for name in FR_KERNELS:
            results[name]["launches"] = fr["fr_launches"][name]
            results[name]["lanes_per_prove"] = fr["fr_lanes"][name]
        for name in MSM_KERNELS:
            results[name]["launches"] = fr["msm_launches"][name]
            results[name]["lanes_per_prove"] = fr["msm_lanes"][name]

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
                    "lanes": lanes, "sc_launches": sc_l, **fr,
                    "sumcheck_spans_ms": sumcheck_ms, "tampered_rejected": True}))
    return r1cs, ck, snark_proof_bytes(proof)


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
    from gemini_tpu_torch.subprotocols import sumcheck as sc
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck
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
    sck.reset_launches()
    reset_fr()
    with SpanTotals() as spans, counted_batches() as batches:
        t0 = time.time()
        proof = Proof.new_time(ck, r1cs, idx)
        torch.cuda.synchronize()
        prove_s = time.time() - t0
    launches, lanes = dict(gk.LAUNCHES), dict(gk.LANES)
    sc_l = sc_launches()
    peak = torch.cuda.max_memory_allocated()
    for name in ("padd", "padd01", "mont_mul"):
        if launches[name] == 0:
            raise AssertionError(f"the 2^{logn} pSNARK prove launched no {name} kernel")
        results[name]["psnark_launches"] = launches[name]
        results[name]["psnark_lanes"] = lanes[name]
    require_round_kernels(sc_l, f"the 2^{logn} pSNARK prove")
    fr = require_fr_kernels(f"the 2^{logn} pSNARK prove")
    for name in SC_KERNELS:
        results[name]["psnark_launches"] = sc_l[name]
    for name in FR_KERNELS:
        results[name]["psnark_launches"] = fr["fr_launches"][name]
    for name in MSM_KERNELS:
        results[name]["psnark_launches"] = fr["msm_launches"][name]
    # sumcheck 3: 13 TimeProvers, one readback per round that has messages
    third = batches[-1]
    if third["provers"] != 13 or third["readbacks"] != third["rounds"] - 1:
        raise AssertionError(f"pSNARK sumcheck 3 batch: {third}; want 13 provers "
                             "and one readback per round with messages")

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
        "launches": launches, "lanes": lanes, "sc_launches": sc_l, **fr,
        "sumcheck_3": third,
        "max_memory_allocated_bytes": peak, "card": card}))


ELASTIC_LOGN = 24  # examples/snark.py -i 24, BASELINE config 4
ELASTIC_CHECK_LOGN = 18  # elastic against time, four streaming rounds


def phase_elastic(results, card):
    """5d: the elastic SNARK (examples/snark.py -i 24), projective.
    First the 2^24 prove with counts, spans, peak device memory and the
    host RSS it adds (read after a heap trim, so that what earlier
    phases freed is not counted); then at 2^18 with threshold 14 (four
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
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck
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
    sck.reset_launches()
    reset_fr()
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
    out["sc_launches"] = sc_launches()
    require_round_kernels(out["sc_launches"], f"the 2^{ELASTIC_LOGN} elastic prove")
    out.update(require_fr_kernels(f"the 2^{ELASTIC_LOGN} elastic prove"))
    for name in SC_KERNELS:
        results[name]["elastic_launches"] = out["sc_launches"][name]
    for name in FR_KERNELS:
        results[name]["elastic_launches"] = out["fr_launches"][name]
    for name in MSM_KERNELS:
        results[name]["elastic_launches"] = out["msm_launches"][name]
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


PSNARK_ELASTIC_LOGN = 20  # examples/psnark.py -i 20 --giant
PSNARK_TWIN_LOGN = 15  # the space prover's rounds against the time prover
PSNARK_TWIN_BLOCK_LOG = 12  # also the threshold: three to five space rounds


def span_totals_with_peaks():
    """A SpanTotals that also reads the device's peak allocation at every
    span end and resets it: `peak[label]` is the largest allocation
    reached while `label` was the next span to end."""
    import torch

    from gemini_tpu_torch.utils.trace import SpanTotals

    class WithPeaks(SpanTotals):
        def __init__(self):
            super().__init__()
            self.peak = {}

        def add(self, label: str, dt: float) -> None:
            super().add(label, dt)
            self.peak[label] = max(self.peak.get(label, 0),
                                   torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

    return WithPeaks()


def phase_psnark_elastic(results, card):
    """5e: the elastic pSNARK (examples/psnark.py -i 20 --giant),
    projective: DummyR1csStream(2^20, e = Random(0).randrange(1, R)),
    FakeCommitterKeyStream(3, seed=0, max_msm_buffer=2^20), block 2^20,
    the default threshold.  index_stream and the prove timed; the bytes
    round-trip; verified against the dense relation; tampered zc_alpha
    and set_z_ep rejected.  Then the dense twin at 2^15 (block 2^12,
    threshold 12, so the three sumchecks run space-prover rounds): the
    elastic bytes equal the time prover's on to_dense() with the τ = 1
    key of the same generators, and index_stream equals index there.
    Every check raises on failure."""
    import torch

    from gemini_tpu_torch import SPACE_TIME_THRESHOLD
    from gemini_tpu_torch.benches import probes
    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.kzg.commit import CommitterKey
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.psnark import (Proof, PsnarkVerificationError, index,
                                         index_stream)
    from gemini_tpu_torch.relation import DummyR1csStream
    from gemini_tpu_torch.relation.r1cs import joint_matrices
    from gemini_tpu_torch.serialize import psnark_proof_bytes, psnark_proof_from_bytes
    from gemini_tpu_torch.streaming import FakeCommitterKeyStream
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck
    from gemini_tpu_torch.utils.trace import MemoryWatcher

    e = random.Random(0).randrange(1, R)
    n = 1 << PSNARK_ELASTIC_LOGN
    block = 1 << 20
    fake = FakeCommitterKeyStream(max_eval_points=3, seed=0, max_msm_buffer=block,
                                  device="cuda")
    stream = DummyR1csStream(n, e, device="cuda")
    out = {"psnark_elastic_logn": PSNARK_ELASTIC_LOGN, "config": "projective",
           "block_size": block, "threshold": SPACE_TIME_THRESHOLD}
    t0 = time.time()
    idx = index_stream(fake, stream)
    torch.cuda.synchronize()
    out["index_s"] = time.time() - t0

    trim_host_heap()
    out["host_rss_before_prove_bytes"] = MemoryWatcher._rss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    probes.reset_launches()
    sck.reset_launches()
    reset_fr()
    with span_totals_with_peaks() as spans, \
            MemoryWatcher(interval=0.5, threshold_kib=1 << 22) as mem:
        t0 = time.time()
        proof = Proof.new_elastic(fake, stream, idx, block_size=block)
        torch.cuda.synchronize()
        out["prove_s"] = time.time() - t0
    require_round_kernels(sc_launches(), f"the 2^{PSNARK_ELASTIC_LOGN} elastic "
                          "pSNARK prove")
    fr = require_fr_kernels(f"the 2^{PSNARK_ELASTIC_LOGN} elastic pSNARK prove")
    launches = {**gk.LAUNCHES, **probes.LAUNCHES, **sck.LAUNCHES, **fr["fr_launches"],
                **fr["msm_launches"]}
    lanes = {**gk.LANES, **sck.LANES, **fr["fr_lanes"], **fr["msm_lanes"]}
    out["cuda_carries"] = fr["cuda_carries"]
    spans.peak["after the last span"] = torch.cuda.max_memory_allocated()
    stage = max(spans.peak, key=spans.peak.get)
    out.update(max_memory_allocated_bytes=spans.peak[stage],
               max_memory_allocated_stage=stage,
               max_memory_allocated_by_span_bytes=spans.peak,
               peak_host_rss_bytes=mem.peak,
               host_rss_added_by_prove_bytes=mem.peak
               - out["host_rss_before_prove_bytes"])
    for name in ("padd", "padd01", "mont_mul"):
        if launches[name] == 0:
            raise AssertionError(f"the 2^{PSNARK_ELASTIC_LOGN} elastic pSNARK prove "
                                 f"launched no {name} kernel")
    for name in KERNELS:
        results[name]["psnark_elastic_launches"] = launches[name]
        results[name]["psnark_elastic_lanes"] = lanes.get(name, 0)

    raw = psnark_proof_bytes(proof)
    out["proof_bytes"] = len(raw)
    if psnark_proof_bytes(psnark_proof_from_bytes(raw)) != raw:
        raise AssertionError("elastic pSNARK proof bytes do not survive a parse")
    t0 = time.time()
    dense_r1cs = stream.to_dense()
    torch.cuda.synchronize()
    out["verify_relation_build_s"] = time.time() - t0
    vk = fake.verifier_key()
    t0 = time.time()
    proof.verify(dense_r1cs, vk, idx, n)
    torch.cuda.synchronize()
    out["verify_s"] = time.time() - t0
    for field in ("zc_alpha", "set_z_ep"):
        bad = copy.deepcopy(proof)
        setattr(bad, field, (getattr(bad, field) + 1) % R)
        try:
            bad.verify(dense_r1cs, vk, idx, n)
        except PsnarkVerificationError:
            pass
        else:
            raise AssertionError(f"elastic pSNARK proof with a tampered {field} "
                                 "accepted")
    out["tampered_rejected"] = ["zc_alpha", "set_z_ep"]
    del dense_r1cs

    m = 1 << PSNARK_TWIN_LOGN
    twin = f"twin_2^{PSNARK_TWIN_LOGN}"
    small = DummyR1csStream(m, e, device="cuda")
    small_idx = index_stream(fake, small)
    t0 = time.time()
    elastic = psnark_proof_bytes(Proof.new_elastic(
        fake, small, small_idx, block_size=1 << PSNARK_TWIN_BLOCK_LOG,
        threshold=PSNARK_TWIN_BLOCK_LOG))
    torch.cuda.synchronize()
    out[f"{twin}_elastic_s"] = time.time() - t0
    dense_r1cs = small.to_dense()
    nnz = joint_matrices(dense_r1cs).num_non_zero
    ck = CommitterKey.new(max_degree=2 * m + nnz + 2, max_eval_points=3, seed=0,
                          tau=1, device="cuda")
    if index(ck, dense_r1cs) != small_idx:
        raise AssertionError(f"index_stream at 2^{PSNARK_TWIN_LOGN} differs from index "
                             "on the dense twin")
    t0 = time.time()
    dense = psnark_proof_bytes(Proof.new_time(ck, dense_r1cs, small_idx))
    torch.cuda.synchronize()
    out[f"{twin}_time_s"] = time.time() - t0
    if elastic != dense:
        raise AssertionError(f"elastic pSNARK proof at 2^{PSNARK_TWIN_LOGN} differs "
                             "from the time prover's on the dense twin")
    out[f"{twin}_bytes_equal"] = True
    out[f"{twin}_block_size_and_threshold"] = [1 << PSNARK_TWIN_BLOCK_LOG,
                                               PSNARK_TWIN_BLOCK_LOG]
    out.update(spans_ms={k: v for k, v in spans.ms.items()
                         if k.startswith(("psnark::", "tensorcheck::"))},
               span_counts=spans.count, launches=launches, lanes=lanes, card=card)
    log(json.dumps(out))


# ---------------------------------------------------------------------------
# Phase 5f: the multi-device paths and GLV
# ---------------------------------------------------------------------------

MESH_SIZE = 4
GLV_PAIRS = 3  # alternating GLV off/on MSMs at 2^20, printed, not claimed


def glv_config(flag: str):
    """GEMINI_TPU_GLV=flag inside the block."""
    return env_config("GEMINI_TPU_GLV", flag)


def glv_edge_scalars():
    """0, 1, LAMBDA, R - 1 and the scalars whose rounded quotient q is
    Z2 // 2 and Z2 // 2 + 1 (the two sides of decompose's balance)."""
    from gemini_tpu_torch.ops import glv
    from gemini_tpu_torch.params import R

    def k_with_q(target):
        k0 = target * R // glv.Z2
        return next(k for k in range(k0 - 4, k0 + 5)
                    if (k * glv.Z2 + R // 2) // R == target)

    return [0, 1, glv.LAMBDA, R - 1, k_with_q(glv.Z2 // 2),
            k_with_q(glv.Z2 // 2 + 1)]


def check_glv_decompose(sc):
    """decompose on the card over bench.py's 2^20 scalars plus the edge
    scalars; on a sample of 4096 lanes plus the edges, the card's limbs
    and flags equal the CPU's, k1 + k2 lambda == k (mod r) and both
    magnitudes are below COMPONENT_BOUND.  Returns the device profile
    of one decompose at 2^20 (its launches per 2^20 MSM)."""
    import torch

    from gemini_tpu_torch.fields.fp import FR
    from gemini_tpu_torch.ops import glv
    from gemini_tpu_torch.params import R

    n = sc.shape[1]
    edge = glv_edge_scalars()
    full = torch.cat([sc, FR.tensor(edge, "cuda", mont=False)], dim=1)
    parts = glv.decompose(full)
    lanes = random.Random(5).sample(range(n), 4096) + list(range(n, n + len(edge)))
    idx = torch.tensor(lanes, device="cuda")
    got = [t[..., idx].cpu() for t in parts]
    cols = full[:, idx].cpu()
    for a, b in zip(glv.decompose(cols), got):
        if not torch.equal(a, b):
            raise AssertionError("glv.decompose: the card's limbs differ from the CPU's")
    if not (got[3][-2:].tolist() == [False, True]):
        raise AssertionError("glv.decompose: the balance edge scalars took the "
                             "wrong branch")
    to_int = lambda t, j: sum(int(v) << (16 * i) for i, v in enumerate(t[:, j].tolist()))
    for j in range(len(lanes)):
        k1 = -to_int(got[0], j) if got[1][j] else to_int(got[0], j)
        k2 = -to_int(got[2], j) if got[3][j] else to_int(got[2], j)
        if (k1 + k2 * glv.LAMBDA - to_int(cols, j)) % R or \
                max(abs(k1), abs(k2)) >= glv.COMPONENT_BOUND:
            raise AssertionError(f"glv.decompose: lane {lanes[j]} does not recombine")
    log(f"glv.decompose 2^20 + {len(edge)} edge scalars on the card: 4096 sampled "
        "lanes and the edges equal the CPU's and recombine, within the bound")

    def one():
        glv.decompose(sc)
        torch.cuda.synchronize()

    one()
    return device_profile(one)


def phase_mesh_glv(results, card, msm_in, msm_out, r1cs, ck, proof_18):
    """5f: the GLV MSM (GEMINI_TPU_GLV=1) and the multi-device paths on
    a 4-shard mesh.  Every check raises on failure."""
    import torch

    from gemini_tpu_torch import hostcurve
    from gemini_tpu_torch.curve import g1
    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.fields.fp import FR
    from gemini_tpu_torch.hostcurve import g1_msm
    from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
    from gemini_tpu_torch.ops import msm_kernels as mk
    from gemini_tpu_torch.ops.msm import msm, msm_batch
    from gemini_tpu_torch.params import R
    from gemini_tpu_torch.parallel import (Mesh, ShardedTimeProver,
                                           msm_batch_multichip, msm_multichip)
    from gemini_tpu_torch.psnark import Proof as PProof
    from gemini_tpu_torch.psnark import index
    from gemini_tpu_torch.relation import DummyR1csStream, random_r1cs
    from gemini_tpu_torch.serialize import psnark_proof_bytes, snark_proof_bytes
    from gemini_tpu_torch.snark import Proof
    from gemini_tpu_torch.streaming import CommitterKeyStream, FakeCommitterKeyStream
    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck
    from gemini_tpu_torch.subprotocols.sumcheck import Sumcheck, TimeProver
    from gemini_tpu_torch.transcript import GeminiTranscript

    out = {"card": card}
    pts, sc = msm_in
    decode = lambda p: g1.decode_jacobian(p)[0]
    timed_s = {}

    def timed(label, fn):
        t0 = time.time()
        r = fn()
        torch.cuda.synchronize()
        timed_s[label] = time.time() - t0
        return r

    # GLV on the card
    prof = check_glv_decompose(sc)
    if prof is None:
        raise AssertionError("decompose: the profiler recorded no device event")
    out["decompose_2^20"] = {
        "device_events": prof["device_events"],
        "kernels": prof["device_events"] - prof["memcpy_memset_count"],
        "memcpy_memset": prof["memcpy_memset_count"],
        "device_busy_ms": prof["device_busy_ms"], "window_ms": prof["window_ms"]}
    p16, s16, s16_np, host_pts = bench_msm_inputs(1 << 16)
    ks = [sum(int(s16_np[i, j]) << (16 * i) for i in range(FR.n_limbs))
          for j in range(1 << 16)]
    want16 = g1_msm([host_pts[j % 512] for j in range(1 << 16)], ks)
    with glv_config("1"):
        if decode(msm(p16, s16)) != want16:
            raise AssertionError("GLV MSM 2^16 differs from host Pippenger")
        gk.reset_launches()
        mk.reset_launches()
        got = timed("glv_msm_2^20_first", lambda: decode(msm(pts, sc)))
        glv_launches = {**gk.LAUNCHES, **mk.LAUNCHES}
        glv_lanes = {**gk.LANES, **mk.LANES}
        if got != msm_out["projective"]:
            raise AssertionError("GLV MSM 2^20 differs from phase 3's MSM")
        with jacobian_config():
            if decode(msm(pts, sc)) != msm_out["jacobian"]:
                raise AssertionError("GLV MSM 2^20, GEMINI_TPU_PROJ=0, differs "
                                     "from phase 3's MSM")
    for name in ("padd", "padd01", "mont_mul", *MSM_KERNELS):
        if glv_launches[name] == 0:
            raise AssertionError(f"the GLV MSM launched no {name} kernel")
        results[name]["glv_launches"] = glv_launches[name]
        results[name]["glv_lanes"] = glv_lanes[name]
    pairs = []
    for _ in range(GLV_PAIRS):
        row = {}
        for flag in ("0", "1"):
            with glv_config(flag):
                t0 = time.time()
                msm(pts, sc)
                torch.cuda.synchronize()
                row["glv_on_s" if flag == "1" else "glv_off_s"] = time.time() - t0
        pairs.append(row)
    log("GLV MSM: 2^16 == host Pippenger; 2^20 == phase 3's MSM, projective and "
        f"Jacobian; off/on pairs at 2^20 (host clock): {pairs}")

    # The mesh
    if torch.cuda.device_count() >= MESH_SIZE:
        mesh = Mesh([torch.device("cuda", i) for i in range(MESH_SIZE)])
        out["mesh_kind"] = f"{MESH_SIZE} cards"
    else:
        mesh = Mesh([torch.device("cuda", 0)] * MESH_SIZE)
        out["mesh_kind"] = f"{MESH_SIZE} shards on one card"
    out["mesh"] = [str(d) for d in mesh.devices]
    log(f"mesh: {out['mesh_kind']}, {out['mesh']}")
    # the shards' totals are added and combined on the card: one
    # msm_combine launch a call, no host Horner
    mk.reset_launches()
    with no_host_horner():
        got = timed("msm_multichip_2^20", lambda: decode(msm_multichip(
            pts, sc, devices=mesh.devices)))
        if got != msm_out["projective"]:
            raise AssertionError("msm_multichip 2^20 differs from msm")
        with jacobian_config():
            if decode(msm_multichip(pts, sc, devices=mesh.devices)) != msm_out["jacobian"]:
                raise AssertionError("msm_multichip 2^20, GEMINI_TPU_PROJ=0, differs "
                                     "from msm")
        sets = [sc[:, :1 << k] for k in range(18, 8, -1)]
        single = timed("msm_batch_fold_tree",
                       lambda: [decode(r) for r in msm_batch(pts, sets)])
        multi = timed("msm_batch_multichip_fold_tree", lambda: [
            decode(r) for r in msm_batch_multichip(pts, sets, devices=mesh.devices)])
        if single != multi:
            raise AssertionError("msm_batch_multichip (2^18 ... 2^9) differs from msm_batch")
    if (mk.LAUNCHES["msm_combine"], mk.LANES["msm_combine"]) != (4, 2 + 2 * len(sets)):
        raise AssertionError(f"the mesh MSMs: {mk.LAUNCHES['msm_combine']} msm_combine "
                             f"launches, {mk.LANES['msm_combine']} sets; want 4 and "
                             f"{2 + 2 * len(sets)}")

    n = 1 << 18
    gen = torch.Generator(device="cuda").manual_seed(18)
    f, g = (torch.randint(0, 1 << 16, (FR.n_limbs, n), generator=gen, device="cuda",
                          dtype=torch.int32) for _ in range(2))
    f[-1] &= 0x0FFF
    g[-1] &= 0x0FFF
    twist = random.Random(18).randrange(R)
    dense = timed("sumcheck_2^18_dense", lambda: Sumcheck.prove(
        GeminiTranscript(b"M"), TimeProver(f, g, twist)))
    sharded = timed("sumcheck_2^18_sharded", lambda: Sumcheck.prove(
        GeminiTranscript(b"M"), ShardedTimeProver(mesh, f, g, twist)))
    if (dense.messages, dense.challenges, dense.final_foldings) != \
            (sharded.messages, sharded.challenges, sharded.final_foldings):
        raise AssertionError("ShardedTimeProver 2^18 differs from TimeProver")

    host_calls = [0]
    pippenger = hostcurve.g1_msm_pippenger

    def counted(*a):
        host_calls[0] += 1
        return pippenger(*a)

    gk.reset_launches()
    sck.reset_launches()
    reset_fr()
    hostcurve.g1_msm_pippenger = counted
    try:
        with no_host_horner():
            proof = timed("snark_2^18_mesh_prove", lambda: Proof.new_time(r1cs, ck,
                                                                        mesh=mesh))
    finally:
        hostcurve.g1_msm_pippenger = pippenger
    mesh_launches, mesh_lanes = dict(gk.LAUNCHES), dict(gk.LANES)
    mesh_sc = sc_launches()
    # the sharded prover folds and sums each shard apart (no fused round)
    require_round_kernels(mesh_sc, "the 2^18 mesh prove", fused=False)
    mesh_fr = require_fr_kernels("the 2^18 mesh prove")
    for name in SC_KERNELS:
        results[name]["mesh_launches"] = mesh_sc[name]
    for name in FR_KERNELS:
        results[name]["mesh_launches"] = mesh_fr["fr_launches"][name]
    for name in MSM_KERNELS:
        results[name]["mesh_launches"] = mesh_fr["msm_launches"][name]
    if snark_proof_bytes(proof) != proof_18:
        raise AssertionError("the 2^18 SNARK with mesh= differs from phase 5's proof")
    proof.verify(r1cs, VerifierKey.from_committer_key(ck))
    if host_calls[0]:
        raise AssertionError(f"the mesh prove ran {host_calls[0]} host MSMs")
    for name in ("padd", "padd01", "mont_mul"):
        if mesh_launches[name] == 0:
            raise AssertionError(f"the 2^18 mesh prove launched no {name} kernel")
        results[name]["mesh_launches"] = mesh_launches[name]
        results[name]["mesh_lanes"] = mesh_lanes[name]
    log("mesh: msm_multichip 2^20 == msm, msm_batch_multichip == msm_batch, "
        "ShardedTimeProver 2^18 == TimeProver, the 2^18 SNARK with mesh= has "
        "phase 5's bytes and verifies, no host MSM")

    gs, gp, ge = (golden_file(f"{k}_golden.json") for k in ("snark", "psnark",
                                                            "elastic"))
    for config in ("projective", "jacobian"):
        ctx = jacobian_config() if config == "jacobian" else contextlib.nullcontext()
        with ctx, glv_config("1"):
            r1 = random_r1cs(random.Random(gs["r1cs_seed"]), gs["n"], device="cuda")
            ck1 = CommitterKey.new(max_degree=gs["max_degree"],
                                   max_eval_points=gs["max_eval_points"],
                                   seed=gs["srs_seed"], device="cuda")
            p = Proof.new_time(r1, ck1, mesh=mesh)
            if snark_proof_bytes(p).hex() != gs["proof_hex"]:
                raise AssertionError(f"golden SNARK, mesh= and GLV ({config}), "
                                     "differs from gemini_tpu's bytes")
            p.verify(r1, VerifierKey.from_committer_key(ck1))
            p = Proof.new_elastic(r1, CommitterKeyStream(ck1, max_msm_buffer=8,
                                                         mesh=mesh),
                                  block_size=8, threshold=2)
            if snark_proof_bytes(p).hex() != gs["proof_hex"]:
                raise AssertionError(f"golden elastic SNARK, mesh= and GLV ({config}), "
                                     "differs from gemini_tpu's bytes")
            stream = DummyR1csStream(ge["n"], ge["e"], device="cuda")
            fake = FakeCommitterKeyStream(max_eval_points=ge["max_eval_points"],
                                          seed=ge["srs_seed"],
                                          max_msm_buffer=ge["max_msm_buffer"],
                                          device="cuda", mesh=mesh)
            p = Proof.new_elastic(stream, fake, block_size=ge["block_size"],
                                  threshold=ge["threshold"])
            if snark_proof_bytes(p).hex() != ge["proof_hex"]:
                raise AssertionError(f"dummy-stream elastic SNARK, mesh= and GLV "
                                     f"({config}), differs from gemini_tpu's bytes")
            p.verify(stream.to_dense(), fake.verifier_key())
            r1 = random_r1cs(random.Random(gp["r1cs_seed"]), gp["n"],
                             row_nnz=gp["row_nnz"], device="cuda")
            ck1 = CommitterKey.new(max_degree=gp["max_degree"],
                                   max_eval_points=gp["max_eval_points"],
                                   seed=gp["srs_seed"], device="cuda")
            idx = index(ck1, r1)
            p = PProof.new_time(ck1, r1, idx, mesh=mesh)
            if psnark_proof_bytes(p).hex() != gp["proof_hex"]:
                raise AssertionError(f"golden pSNARK, mesh= and GLV ({config}), "
                                     "differs from gemini_tpu's bytes")
            p.verify(r1, VerifierKey.from_committer_key(ck1), idx, gp["num_non_zero"])
        log(f"golden SNARK, elastic SNARKs (CommitterKeyStream and the τ = 1 fake "
            f"key with mesh=) and pSNARK with mesh= and GEMINI_TPU_GLV=1 ({config}): "
            "gemini_tpu's bytes, verified")
    out.update({"times_s": timed_s, "glv_pairs_2^20_s": pairs,
                "glv_launches": glv_launches, "glv_lanes": glv_lanes,
                "mesh_launches": mesh_launches, "mesh_lanes": mesh_lanes,
                "mesh_sc_launches": mesh_sc, "mesh_fr": mesh_fr,
                "golden_bytes_equal": ["snark", "snark_elastic", "elastic_dummy",
                                       "psnark"]})
    log(json.dumps({"mesh_glv": out}))


# ---------------------------------------------------------------------------
# Phase 5g: the command-line entry points
# ---------------------------------------------------------------------------


EXAMPLES = (("snark", ("-i", "12", "--time-prover")), ("snark", ("-i", "16")),
            ("psnark", ("-i", "10")), ("psnark", ("-i", "10", "--elastic")),
            ("psnark", ("-i", "12", "--giant")),
            ("pc", ("-d", "12", "-p", "4", "-m", "3")))


def phase_examples(card):
    """5g: each example's main (python -m gemini_tpu_torch.examples.<name>)
    in process on the card at a small size: it must name the card, and
    its proof must verify (inside the example; the --giant pSNARK here,
    against its dense relation).  Prints each run's output and one
    {"examples": ...} JSON line (wall time, proof size, round-kernel
    launches)."""
    import importlib
    import io

    import torch

    from gemini_tpu_torch.subprotocols import sumcheck_kernels as sck

    runs = []
    for name, argv in EXAMPLES:
        mod = importlib.import_module(f"gemini_tpu_torch.examples.{name}")
        command = f"python -m gemini_tpu_torch.examples.{name} {' '.join(argv)}"
        sck.reset_launches()
        reset_fr()
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            res = mod.main(list(argv))
        torch.cuda.synchronize()
        wall = time.time() - t0
        text = buf.getvalue()
        log(f"$ {command}\n{text.rstrip()}")
        if not text.startswith(f"device: {torch.cuda.get_device_name(0)}\n"):
            raise AssertionError(f"{command}: did not run on the card")
        if "--giant" in argv:
            dense = res["stream"].to_dense()
            res["proof"].verify(dense, res["ck_stream"].verifier_key(), res["index"],
                                res["stream"].n)
        elif not res["verified"]:
            raise AssertionError(f"{command}: not verified")
        runs.append({"command": command, "wall_s": wall,
                     "prove_s": res.get("prove_s"),
                     "proof_size": res.get("proof_size"), "verified": True,
                     "sc_launches": sc_launches(),
                     **require_fr_kernels(command, need=("fr_mul",))})
    log(json.dumps({"examples": runs, "card": card}))


# ---------------------------------------------------------------------------
# Phase 6: device profile of the main path
# ---------------------------------------------------------------------------


OWN_KERNELS = {"padd01_kernel": "padd01", "padd_kernel": "padd",
               "mont_mul_kernel": "mont_mul", "add_kernel": "add",
               "dbl_kernel": "dbl", "sc_message_kernel": "sc_message",
               "sc_message_split_kernel": "sc_message",
               "sc_fused_split_kernel": "sc_fused", "sc_fold_kernel": "sc_fold",
               "fr_mul_kernel": "fr_mul", "fr_addsub_kernel": "fr_addsub",
               "fr_reduce_kernel": "fr_reduce", "fr_lane_sum_kernel": "fr_lane_sum",
               "msm_digits_kernel": "msm_digits", "msm_pack_kernel": "msm_pack",
               "msm_sort_gather_kernel": "msm_sort_gather",
               "msm_walk_down_kernel": "msm_walk_down",
               "msm_walk_down_split_kernel": "msm_walk_down",
               "msm_combine_kernel": "msm_combine"}
# ptxas's lines per kernel: the Jacobian walk-down (a thread a lane) apart
# from the projective one (split), which is the table's row.
ALL_KERNELS = {**OWN_KERNELS, "msm_walk_down_kernel": "msm_walk_down_jacobian",
               "vpu_chain_kernel": "vpu_chain", "copy_add_kernel": "copy_add"}


# The plain int64 chains' PyTorch kernels by name (phase 6): what the Fr
# kernels take off the prove.  PROVE_CLASSES_PLAIN_FR: ms and launches
# per class in the same 2^18 prove with every Fr op on the plain int64
# chain (NVIDIA H100 80GB HBM3, 700 W; PERF.md), summed over the names
# of its ten largest other kernels, so a lower bound where a class had
# names below the ten; PROVE_EVENTS_PLAIN_FR, PROVE_BUSY_PLAIN_FR: its
# device events and busy share.
PROFILE_CLASSES = {"int64_add": ("CUDAFunctor_add<long>",),
                   "binary_op": ("BinaryFunctor<long", "UnaryFunctor<long"),
                   "or_reduction": ("or_kernel",),
                   "dtoh_copy": ("Memcpy DtoH",)}
PROVE_CLASSES_PLAIN_FR = {"int64_add": (177.88, 68765),
                          "binary_op": (199.86, 102057),
                          "or_reduction": (36.64, 7481), "dtoh_copy": (17.27, 7481)}
PROVE_EVENTS_PLAIN_FR, PROVE_BUSY_PLAIN_FR = 223402, 0.07474
# The same counts before the MSM glue kernels (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md section 5): device events, copy kernels and each class
# as (ms, launches), per MSM 2^20 and per 2^18 SNARK prove.
GLUE_PROFILE_PR12 = {
    "msm_2^20": {"device_events": 7462, "copy_kernels": (11.87, 2634),
                 "int64_add": (11.80, 116), "binary_op": (15.54, 1795),
                 "or_reduction": (4.97, 67), "dtoh_copy": (0.17, 70)},
    "prove_2^18": {"device_events": 20672, "copy_kernels": (18.12, 5196),
                   "int64_add": (22.62, 956), "binary_op": (32.65, 5462),
                   "or_reduction": (9.26, 197), "dtoh_copy": (0.85, 357)}}


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
    classes = {k: [0.0, 0] for k in PROFILE_CLASSES}
    others, copy_ms, copy_n, memcpy_ms, memcpy_n = {}, 0.0, 0, 0.0, 0
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        for cls, subs in PROFILE_CLASSES.items():
            if any(sub in e.name for sub in subs):
                classes[cls][0] += ms
                classes[cls][1] += 1
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
        "plain_chain_classes": {k: {"ms": v[0], "launches": v[1]}
                                for k, v in classes.items()},
        "device_events": len(dev),
        "first_device_events": [e.name[:80] for e in sorted(
            dev, key=lambda e: e.time_range.start)[:3]]}


def phase_profile(results, msm_in, r1cs, ck):
    """6: torch.profiler over one projective MSM at 2^20, one Jacobian
    MSM at 2^20 (GEMINI_TPU_PROJ=0), one projective 2^18 prove and two
    streamed passes of the elastic prove, after the timed runs.  Without device events in the trace, says so and
    gives sum(lanes x per-lane time at 2^20) instead."""
    import torch

    from gemini_tpu_torch.curve import g1_kernels as gk
    from gemini_tpu_torch.ops import msm_kernels as mk
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
        mk.reset_launches()
        t0 = time.time()
        prof = device_profile(fn)
        wall = time.time() - t0
        lanes = {k: v for k, v in gk.LANES.items() if v}
        if prof is None:
            prof = {"device_events": 0, "note": "the trace held no device event"}
        prof.update(wall_s_under_profiler=wall, lanes=lanes,
                    glue_launches_counted={k: v for k, v in mk.LAUNCHES.items() if v},
                    lanes_x_ms_per_lane_2p20={
                        k: v * results[k]["ms"] / results[k]["lanes"]
                        for k, v in lanes.items() if "ms" in results.get(k, {})})
        out[label] = prof
    log(json.dumps({"profile": out}))
    prove = out["prove_2^18"]
    classes = prove.get("plain_chain_classes", {})
    log(json.dumps({"plain_chains_prove_2^18": {
        "classes": {cls: {**classes.get(cls, {}), "plain_fr_ms": ms0,
                          "plain_fr_launches": n0}
                    for cls, (ms0, n0) in PROVE_CLASSES_PLAIN_FR.items()},
        "device_events": prove.get("device_events"),
        "plain_fr_device_events": PROVE_EVENTS_PLAIN_FR,
        "busy_share": prove.get("busy_share"),
        "plain_fr_busy_share": PROVE_BUSY_PLAIN_FR,
        "fr_kernel_ms": {k: prove.get("kernel_ms", {}).get(k) for k in FR_KERNELS},
        "fr_kernel_launches": {k: prove.get("kernel_launches", {}).get(k)
                               for k in FR_KERNELS}}}))
    log(json.dumps({"msm_glue_profile": {
        label: {"device_events": out[label].get("device_events"),
                "copy_kernels": {"ms": out[label].get("copy_kernels_ms"),
                                 "launches": out[label].get("copy_kernels_count")},
                **{cls: out[label].get("plain_chain_classes", {}).get(cls)
                   for cls in PROFILE_CLASSES},
                "glue_kernels": {k: {"ms": out[label].get("kernel_ms", {}).get(k),
                                     "launches": out[label].get(
                                         "kernel_launches", {}).get(k),
                                     "launches_counted": out[label].get(
                                         "glue_launches_counted", {}).get(k)}
                                 for k in MSM_KERNELS},
                "first_device_events": out[label].get("first_device_events"),
                "pr12": before}
        for label, before in GLUE_PROFILE_PR12.items()}}))
    log(json.dumps({"round_kernels_prove_2^18": {
        name: {"device_ms": prove.get("kernel_ms", {}).get(name),
               "launches": prove.get("kernel_launches", {}).get(name),
               "first_design_device_ms": ms0, "first_design_launches": n0}
        for name, (ms0, n0) in SC_PROVE_FIRST_DESIGN.items()}}))


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

        def counted(p, q, out=None):
            held.append([t.reshape(24, -1).clone() for t in (*p, *q)])
            c["launches"] += 1
            if sum(h[0].shape[1] for h in held) >= 1 << 20:
                count()
            return orig(p, q, out)

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
            "bound_share": (bound / r.get("device_ms", r["ms"])
                            if bound is not None else None),
            "library_bound_share": (bound / r.get("library_device_ms", r["library_ms"])
                                    if r["library_ms"] and bound is not None else None),
            "bit_exact": r["bit_exact"], "lanes": r["lanes"],
            **usage.get(name, {}),
            **{f"{k}_jacobian": v for k, v in usage.get(f"{name}_jacobian", {}).items()},
        })
        if name == "add":
            rows[-1]["bound_ms_23_products"] = (
                r["lanes"] * ADD_WORD_PRODUCTS_23MM * 2 / IMAD_PER_S * 1e3)
        for key, v in r.items():
            if key.startswith(("ms_", "lanes_per", "psnark_", "elastic_", "float32",
                               "glv_", "mesh_", "resident_", "jacobian_", "combine_ms_",
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
    phase("2d sumcheck kernels", phase_sumcheck_kernels, results, usage)
    phase("2e Fr kernels", phase_fr_kernels, results)
    phase("2f MSM glue kernels", phase_msm_glue, results)
    phase("2g MSM combine", phase_msm_combine, results)
    msm_in, msm_out = phase("3 MSM", phase_msm)
    phase("4 golden", phase_golden)
    r1cs, ck, proof_18 = phase("5 projective 2^18", phase_full, results, False)
    with jacobian_config():
        r1cs_j, ck_j, _ = phase("5b Jacobian 2^18", phase_full, results, True)
    phase("5c pSNARK 2^18", phase_psnark, results, card)
    phase("5d elastic SNARK 2^24", phase_elastic, results, card)
    phase("5e elastic pSNARK 2^20", phase_psnark_elastic, results, card)
    phase("5f mesh and GLV", phase_mesh_glv, results, card, msm_in, msm_out,
          r1cs, ck, proof_18)
    phase("5g examples", phase_examples, card)
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
