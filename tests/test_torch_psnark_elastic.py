"""Elastic pSNARK parity: the port's streaming ops of the elastic pSNARK
(gemini_tpu/streaming/ops.py), the `gather` methods of its host
vectors, `EntryProduct.new_elastic_batch`, `index_stream` and
`Proof.new_elastic`, against gemini_tpu and the port's time prover on
the CPU.

The ops take the same numpy-seeded limbs in both packages, at n = 37
and 64 with block 8, so that blocks end inside the vectors and the last
block is short.  The proofs are the golden pSNARK instance
(tests/test_psnark.py's smallest, whose gemini_tpu bytes are in
gemini_tpu_torch/testdata/psnark_golden.json) and the giant-instance
path at test scale (DummyR1csStream(32, e), tests/test_psnark.py's
test_psnark_elastic_from_dummy_stream shape).  Tolerance: exact,
everywhere.  At most 3 collected cases (ROADMAP.md, tier-1 rule); the
JAX side compiles with XLA's optimizations off (integer results do not
depend on them).
"""

import copy
import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemini_tpu.fields.fp import FR as JFR
from gemini_tpu.streaming import host as jhost
from gemini_tpu.streaming import ops as jops
from gemini_tpu_torch.fields.fp import FR
from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
from gemini_tpu_torch.params import R
from gemini_tpu_torch.psnark import Proof, PsnarkVerificationError, index, index_stream
from gemini_tpu_torch.relation import DummyR1csStream, random_r1cs
from gemini_tpu_torch.relation.r1cs import joint_matrices
from gemini_tpu_torch.serialize import psnark_proof_bytes
from gemini_tpu_torch.streaming import CommitterKeyStream, host
from gemini_tpu_torch.streaming import ops as sops

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "gemini_tpu_torch", "testdata")
BLOCK = 8


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _limbs(hv) -> np.ndarray:
    return np.asarray(hv.limbs).astype(np.int64)


def _same(a, b) -> bool:
    """Two host vectors (one of each package, or two of the port) hold
    the same limbs."""
    la, lb = _limbs(a), _limbs(b)
    return la.shape == lb.shape and np.array_equal(la, lb)


def _pair(values):
    """The same canonical values as a port and a gemini_tpu HostVector."""
    limbs = FR.encode(values)
    return host.HostVector(limbs, device="cpu"), jhost.HostVector(limbs.copy())


def test_streaming_ops_match_gemini_tpu():
    """Every elastic-pSNARK op and the three gather methods, against
    gemini_tpu on the same limbs: n = 37 and 64, block 8 (five blocks
    and a 5-element tail at 37, so the suffix-product stitch crosses
    four block boundaries), hv_plookup with ζ ≠ 0 and ζ = 0, hv_tensor
    with 6 challenges (blocks of 4)."""
    rng = np.random.default_rng(81)
    rand = lambda n: [int(x) % R for x in rng.integers(0, 1 << 62, size=n)]
    for n in (37, 64):
        a, ja = _pair(rand(n))
        b, jb = _pair(rand(n + 5))
        x, y, z, zeta = rand(4)
        checks = {
            "hadamard": (sops.hv_hadamard(a, b, BLOCK), jops.hv_hadamard(ja, jb, BLOCK)),
            "accumulated_product": (sops.hv_accumulated_product(a, BLOCK),
                                    jops.hv_accumulated_product(ja, BLOCK)),
            "powers": (sops.hv_powers(x, n, BLOCK, "cpu"), jops.hv_powers(x, n, BLOCK)),
            "slice": (sops.hv_slice(b, n - 3), jops.hv_slice(jb, n - 3)),
            "alg_hash positions": (sops.hv_alg_hash(a, None, zeta, BLOCK),
                                   jops.hv_alg_hash(ja, None, zeta, BLOCK)),
            "plookup_set": (sops.hv_plookup_set(a, y, z, BLOCK),
                            jops.hv_plookup_set(ja, y, z, BLOCK)),
            "plookup_subset": (sops.hv_plookup_subset(a, y, BLOCK),
                               jops.hv_plookup_subset(ja, y, BLOCK)),
            "monic": (sops.hv_monic(a), jops.hv_monic(ja)),
            "right_rotation": (sops.hv_right_rotation(a), jops.hv_right_rotation(ja)),
        }
        idx = rng.integers(0, n, size=n + 9)
        checks["gather"] = (sops.hv_gather(a, idx), jops.hv_gather(ja, idx))
        checks["alg_hash indices"] = (sops.hv_alg_hash(a, idx[:n], zeta, BLOCK),
                                      jops.hv_alg_hash(ja, idx[:n], zeta, BLOCK))
        # plookup: r* = set[idx] looked up, frequencies as the prover's
        freq = 1 + np.bincount(idx, minlength=n)
        sub, jsub = sops.hv_gather(a, idx), jops.hv_gather(ja, idx)
        for zt in (zeta, 0):
            set_h = sops.hv_alg_hash(a, None, zt, BLOCK) if zt else a
            jset_h = jops.hv_alg_hash(ja, None, zt, BLOCK) if zt else ja
            got = sops.hv_plookup(sub, set_h, idx, y, z, zt, freq, BLOCK)
            want = jops.hv_plookup(jsub, jset_h, idx, y, z, zt, freq, BLOCK)
            for k, (g, w) in enumerate(zip(got, want)):
                checks[f"plookup {k}, zeta {'0' if zt == 0 else 'random'}"] = (g, w)
            assert len(got[0]) == n + 1 and len(got[2]) == n + len(idx) + 1
        for name, (got, want) in checks.items():
            assert _same(got, want), (n, name)
            assert got.device.type == "cpu", (n, name)

        assert sops.hv_prod(a, BLOCK) == jops.hv_prod(ja, BLOCK)
        assert sops.hv_ip(a, b, BLOCK) == jops.hv_ip(ja, jb, BLOCK)
        assert sops.hv_evaluate(b, x, BLOCK) == jops.hv_evaluate(jb, x, BLOCK)

        # the device-resident vector reads back, then gathers
        dv = host.DeviceVector(torch.from_numpy(FR.encode(rand(n)).astype(np.int32)))
        jdv = jhost.DeviceVector(jnp.asarray(dv.limbs))
        assert _same(dv.gather(idx), jdv.gather(idx))

    # ⊗(1, rho_j) with 6 challenges: 2^6 elements in blocks of 4
    ch = rand(6)
    t, jt = sops.hv_tensor(ch, BLOCK, "cpu"), jops.hv_tensor(ch, BLOCK)
    assert len(t) == 64 and _same(t, jt)
    assert _same(sops.hv_tensor([], BLOCK, "cpu"), jops.hv_tensor([], BLOCK))

    # gather on a constant is O(1) and stays a constant; on any other
    # generated vector it raises, as in gemini_tpu
    c = host.VirtualHostVector.constant(12345, 40, device="cpu")
    jc = jhost.VirtualHostVector.constant(12345, 40)
    gc = c.gather(np.arange(70) % 40)
    assert isinstance(gc, host.VirtualHostVector) and len(gc) == 70
    assert gc.device.type == "cpu"
    assert _same(gc, jc.gather(np.arange(70) % 40))
    gen = host.VirtualHostVector(16, lambda s, e: FR.encode(list(range(s, e))),
                                 device="cpu")
    jgen = jhost.VirtualHostVector(16, lambda s, e: JFR.encode(list(range(s, e))))
    with pytest.raises(NotImplementedError):
        gen.gather([0, 1])
    with pytest.raises(NotImplementedError):
        jgen.gather([0, 1])


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(TESTDATA, "psnark_golden.json")) as f:
        return json.load(f)


def test_golden_elastic_psnark(golden):
    """The port's Proof.new_elastic on the golden pSNARK instance
    (CommitterKeyStream(ck, max_msm_buffer=16), block 8, threshold 2):
    its bytes are gemini_tpu's time-prover bytes, which gemini_tpu's own
    tests/test_psnark.py::test_psnark_elastic_equals_time pins its
    elastic proof to at these parameters; every field equals the port's
    Proof.new_time; the proof verifies and tampered zc_alpha and
    set_z_ep are rejected.

    This stands in for running gemini_tpu's elastic pSNARK prover here:
    two of its proves at n = 32 took about 108 s of wall time and 258 s
    of CPU time (XLA's compile threads) beside tests/test_psnark.py in
    the tier-1 run, while the golden file is checked against gemini_tpu's
    prover by tests/test_torch_psnark.py."""
    r1 = random_r1cs(random.Random(golden["r1cs_seed"]), golden["n"],
                     row_nnz=golden["row_nnz"], device="cpu")
    ck = CommitterKey.new(max_degree=golden["max_degree"],
                          max_eval_points=golden["max_eval_points"],
                          seed=golden["srs_seed"], device="cpu")
    vk = VerifierKey.from_committer_key(ck)
    idx = index(ck, r1)
    pe = Proof.new_elastic(CommitterKeyStream(ck, max_msm_buffer=16), r1, idx,
                           block_size=8, threshold=2)
    assert psnark_proof_bytes(pe).hex() == golden["proof_hex"]
    pt = Proof.new_time(ck, r1, idx)
    for f in dataclasses.fields(Proof):
        assert getattr(pt, f.name) == getattr(pe, f.name), f.name
    pe.verify(r1, vk, idx, golden["num_non_zero"])
    for field in ("zc_alpha", "set_z_ep"):
        bad = copy.deepcopy(pe)
        setattr(bad, field, (getattr(bad, field) + 1) % R)
        with pytest.raises(PsnarkVerificationError):
            bad.verify(r1, vk, idx, golden["num_non_zero"])


def test_dummy_stream_elastic_psnark():
    """The giant-instance path at test scale: DummyR1csStream(32, e) with
    CommitterKeyStream(ck, max_msm_buffer=64), block 24, threshold 3.
    index_stream equals index on the dense relation; the elastic proof
    from the stream equals the elastic proof from the dense relation and
    the time proof on it; the proof verifies."""
    n = 32
    stream = DummyR1csStream(n, e=random.Random(83).randrange(1, R), device="cpu")
    r1 = stream.to_dense()
    nnz = joint_matrices(r1).num_non_zero
    ck = CommitterKey.new(max_degree=n + nnz + n, max_eval_points=3, seed=23,
                          device="cpu")
    cks = CommitterKeyStream(ck, max_msm_buffer=64)
    idx = index_stream(cks, stream)
    assert idx == index(ck, r1)
    pe = Proof.new_elastic(cks, stream, idx, block_size=24, threshold=3)
    pd = Proof.new_elastic(cks, r1, idx, block_size=24, threshold=3)
    pt = Proof.new_time(ck, r1, idx)
    for f in dataclasses.fields(Proof):
        assert getattr(pe, f.name) == getattr(pd, f.name), f.name
        assert getattr(pe, f.name) == getattr(pt, f.name), f.name
    pe.verify(r1, VerifierKey.from_committer_key(ck), idx, nnz)
