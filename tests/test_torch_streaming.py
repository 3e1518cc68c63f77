"""Elastic slice parity: the port's streaming modules (host vectors,
space/elastic sumcheck, streaming KZG and tensorcheck, relation
streams, the constraint builder) and its elastic SNARK prover against
gemini_tpu on the CPU.

Two instances:
  * the golden SNARK instance (random_r1cs(random.Random(11), 16),
    CommitterKey.new(31, 3, seed=11)), whose gemini_tpu proof bytes are
    in gemini_tpu_torch/testdata/snark_golden.json;
  * DummyR1csStream(32, e=0xABCDE) with
    FakeCommitterKeyStream(3, seed=7, max_msm_buffer=16), block size 8,
    threshold 2 (tests/test_streaming.py's giant-instance machinery at
    test scale), whose gemini_tpu proof bytes are in
    gemini_tpu_torch/testdata/elastic_golden.json; the module fixture
    runs gemini_tpu's elastic prover once and checks the file.
Block size 8 makes every block boundary (the space prover's twist
offsets, the divide stage's carried suffix, the row-aligned COO cuts)
fall inside the vectors.  Tolerance: exact, everywhere.  At most 3
collected cases (ROADMAP.md, tier-1 rule); the JAX side compiles with
XLA's optimizations off (integer results do not depend on them).
"""

import copy
import json
import os
import random

import numpy as np
import pytest
import torch

import jax

from gemini_tpu.kzg import commit as jkzg
from gemini_tpu.relation import ConstraintBuilder as JBuilder
from gemini_tpu.relation import LinComb as JLinComb
from gemini_tpu.relation.stream import DummyR1csStream as JDummyStream
from gemini_tpu.serialize import snark_proof_bytes as j_bytes
from gemini_tpu.snark import Proof as JProof
from gemini_tpu.streaming import host as jhost
from gemini_tpu.streaming import kzg as jskzg
from gemini_tpu.streaming import ops as jops
from gemini_tpu.streaming import sumcheck as jssc
from gemini_tpu.subprotocols import sumcheck as jsc
from gemini_tpu.transcript import GeminiTranscript as JTranscript
from gemini_tpu_torch.kzg import commit as tkzg
from gemini_tpu_torch.params import R
from gemini_tpu_torch.relation import (
    ConstraintBuilder, DummyR1csStream, HostR1csStream, LinComb, random_r1cs)
from gemini_tpu_torch.relation.r1cs import joint_matrices
from gemini_tpu_torch.serialize import snark_proof_bytes
from gemini_tpu_torch.snark import Proof, SnarkVerificationError
from gemini_tpu_torch.streaming import host
from gemini_tpu_torch.streaming import kzg as skzg
from gemini_tpu_torch.streaming import ops as sops
from gemini_tpu_torch.streaming import sumcheck as ssc
from gemini_tpu_torch.subprotocols import sumcheck as tsc
from gemini_tpu_torch.transcript import GeminiTranscript

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "gemini_tpu_torch", "testdata")


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _golden(name):
    with open(os.path.join(TESTDATA, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def elastic_golden():
    """gemini_tpu's elastic proof of the dummy stream: the one run of
    its elastic prover in this file, checked against the golden file."""
    g = _golden("elastic_golden.json")
    stream = JDummyStream(g["n"], e=g["e"])
    fake = jskzg.FakeCommitterKeyStream(
        max_eval_points=g["max_eval_points"], seed=g["srs_seed"],
        max_msm_buffer=g["max_msm_buffer"])
    proof = JProof.new_elastic(stream, fake, block_size=g["block_size"],
                               threshold=g["threshold"])
    assert j_bytes(proof).hex() == g["proof_hex"]
    return g


def test_golden_elastic_proof_bytes():
    """The port's elastic prover on the golden SNARK instance gives
    gemini_tpu's time-prover bytes with every round streaming
    (threshold 0), mixed (2) and all dense (100), and through a
    host-RAM relation stream; the proof verifies, and the host stream's
    joint sparsity is the dense relation's (joint_matrices, held to
    gemini_tpu by tests/test_torch_psnark.py)."""
    g = _golden("snark_golden.json")
    r1 = random_r1cs(random.Random(g["r1cs_seed"]), g["n"], device="cpu")
    ck = tkzg.CommitterKey.new(max_degree=g["max_degree"],
                               max_eval_points=g["max_eval_points"],
                               seed=g["srs_seed"], device="cpu")
    cks = skzg.CommitterKeyStream(ck, max_msm_buffer=8)
    for threshold in (0, 2, 100):
        proof = Proof.new_elastic(r1, cks, block_size=8, threshold=threshold)
        assert snark_proof_bytes(proof).hex() == g["proof_hex"], threshold
    hs = HostR1csStream.from_r1cs(r1, block_size=8)
    proof = Proof.new_elastic(hs, cks, block_size=8, threshold=2)
    assert snark_proof_bytes(proof).hex() == g["proof_hex"]
    proof.verify(r1, tkzg.VerifierKey.from_committer_key(ck))
    jm, js = joint_matrices(r1), hs.joint()
    assert (js.row_index.tolist(), js.col_index.tolist()) == \
        (jm.row_index.tolist(), jm.col_index.tolist())
    for a in ("row", "col", "val_a", "val_b", "val_c"):
        assert _same_limbs(getattr(js, a).limbs, getattr(jm, a))


def test_dummy_stream_fake_key_matches_gemini_tpu(elastic_golden):
    """DummyR1csStream + FakeCommitterKeyStream: the port's bytes equal
    gemini_tpu's and the port's time prover's on the dense twin (the
    dense relation with the τ = 1 key of the same generators); the
    proof verifies under fake.verifier_key() and a tampered zc_alpha is
    rejected."""
    g = elastic_golden
    stream = DummyR1csStream(g["n"], e=g["e"], device="cpu")
    fake = skzg.FakeCommitterKeyStream(
        max_eval_points=g["max_eval_points"], seed=g["srs_seed"],
        max_msm_buffer=g["max_msm_buffer"], device="cpu")
    proof = Proof.new_elastic(stream, fake, block_size=g["block_size"],
                              threshold=g["threshold"])
    assert snark_proof_bytes(proof).hex() == g["proof_hex"]

    dense = stream.to_dense()
    ck1 = tkzg.CommitterKey.new(max_degree=g["n"],
                                max_eval_points=g["max_eval_points"],
                                seed=g["srs_seed"], tau=1, device="cpu")
    assert snark_proof_bytes(Proof.new_time(dense, ck1)).hex() == g["proof_hex"]

    vk = fake.verifier_key()
    proof.verify(dense, vk)
    bad = copy.deepcopy(proof)
    bad.zc_alpha = (bad.zc_alpha + 1) % R
    with pytest.raises(SnarkVerificationError):
        bad.verify(dense, vk)


def _same_limbs(a, b):
    return np.array_equal(np.asarray(a).astype(np.int64),
                          np.asarray(b).astype(np.int64))


def test_streaming_modules_match_gemini_tpu():
    """The same seeded inputs through both packages: pack/unpack, the
    space and elastic sumcheck messages at lengths 33 and 27, the
    streaming commit, commit_folding, batch_open_multi_points (with and
    without a point at 0), divide_linear_stream and open, the tensor and
    power windows, the dummy stream's joint vectors, limb for limb and
    point for point; and the constraint builder's x^3 + x + 5 = 35."""
    rng = np.random.default_rng(7)
    limbs = rng.integers(0, 1 << 16, size=(16, 37)).astype(np.uint32)
    packed = host.pack_rows_host(limbs)
    assert _same_limbs(packed, jhost.pack_rows_host(limbs))
    assert _same_limbs(host.unpack_rows_host(packed), limbs)
    assert _same_limbs(host.from_device_limbs(host.to_device_limbs(limbs, "cpu")),
                       jhost.from_device_limbs(jhost.to_device_limbs(limbs)))

    ints = lambda n: [int(x) % R for x in rng.integers(0, 1 << 62, size=n)]
    f, g = ints(33), ints(27)
    twist = int(rng.integers(1, 1 << 62))
    for th in (None, 2):  # space prover; elastic prover switching at 2
        jt, tt = JTranscript(b"GEMINI-v0"), GeminiTranscript(b"GEMINI-v0")
        jhv = [jhost.HostVector.from_ints(v) for v in (f, g)]
        thv = [host.HostVector.from_ints(v, device="cpu") for v in (f, g)]
        if th is None:
            jp = jssc.SpaceProver(*jhv, twist, block_size=8)
            tp = ssc.SpaceProver(*thv, twist, block_size=8)
        else:
            jp = jsc.ElasticProver(*jhv, twist, block_size=8, threshold=th)
            tp = tsc.ElasticProver(*thv, twist, block_size=8, threshold=th)
        js, ts = jsc.Sumcheck.prove(jt, jp), tsc.Sumcheck.prove(tt, tp)
        assert (ts.messages, ts.final_foldings) == (js.messages, js.final_foldings)
    assert isinstance(tsc.ElasticProver(thv[0].device_slice(0, 33),
                                        thv[1].device_slice(0, 27), twist),
                      tsc.TimeProver)  # device tensors: the dense prover

    gk = _golden("snark_golden.json")
    jck = jkzg.CommitterKey.new(max_degree=gk["max_degree"],
                                max_eval_points=gk["max_eval_points"],
                                seed=gk["srs_seed"])
    tck = tkzg.CommitterKey.new(max_degree=gk["max_degree"],
                                max_eval_points=gk["max_eval_points"],
                                seed=gk["srs_seed"], device="cpu")
    jcks = jskzg.CommitterKeyStream(jck, max_msm_buffer=8)
    tcks = skzg.CommitterKeyStream(tck, max_msm_buffer=8)
    polys = [ints(n) for n in (29, 21, 6)]
    jp = [jhost.HostVector.from_ints(p) for p in polys]
    tp = [host.HostVector.from_ints(p, device="cpu") for p in polys]
    assert tcks.commit(tp[0]) == jcks.commit(jp[0])
    chals = ints(5)
    jcm, jfolds = jcks.commit_folding(jp[0], chals)
    tcm, tfolds = tcks.commit_folding(tp[0], chals)
    assert tcm == jcm
    assert all(_same_limbs(a.limbs, b.limbs) for a, b in zip(tfolds, jfolds))
    for pts in (ints(3), [0] + ints(2)):
        assert tcks.batch_open_multi_points(tp, pts, chals[0]) == \
            jcks.batch_open_multi_points(jp, pts, chals[0])
    for x in (chals[1], 0):
        jev, jq = jskzg.divide_linear_stream(jp[1], x, block_size=8)
        tev, tq = skzg.divide_linear_stream(tp[1], x, block_size=8)
        assert tev == jev and _same_limbs(tq.limbs, jq.limbs)
        assert tcks.open(tp[1], x) == jcks.open(jp[1], x)

    # the closed forms the dummy stream's abc vector is made of, on
    # windows that cut the tensor's bits (8 lanes: one JAX compile)
    for start in (0, 5, 24):
        assert _same_limbs(sops.tensor_block(chals, start, start + 8, "cpu"),
                           jops.tensor_block(chals, start, start + 8))
        assert _same_limbs(sops.powers_block(chals[2], start, start + 8, "cpu"),
                           jops.powers_block(chals[2], start, start + 8))
    idx = rng.integers(0, 32, size=8)
    assert _same_limbs(sops.tensor_at(chals, idx, "cpu"), jops.tensor_at(chals, idx))
    assert _same_limbs(sops.powers_at(chals[3], idx, 5, "cpu"),
                       jops.powers_at(chals[3], idx, 5))
    jj, tj = JDummyStream(8, e=3).joint(), DummyR1csStream(8, e=3, device="cpu").joint()
    for a in ("row", "col", "val_a"):
        assert _same_limbs(getattr(tj, a).limbs, getattr(jj, a).limbs)

    def build(builder, lincomb, **kw):
        cs = builder()
        out = cs.public_input(35)
        x = cs.witness(3)
        x3 = cs.mul(cs.mul(x, x), x)
        cs.enforce(x3 + x + 5, lincomb.one(), out)
        return cs.build(**kw)

    jr, tr = build(JBuilder, JLinComb), build(ConstraintBuilder, LinComb,
                                              device="cpu")
    assert (tr.z_int, tr.x_int) == (jr.z_int, jr.x_int)
    assert _same_limbs(tr.z, jr.z) and _same_limbs(tr.w, jr.w)
    for tm, jm in ((tr.a, jr.a), (tr.b, jr.b), (tr.c, jr.c)):
        assert (tm.n_rows, tm.n_cols, tm.vals_int) == (jm.n_rows, jm.n_cols, jm.vals_int)
        assert _same_limbs(tm.rows, jm.rows) and _same_limbs(tm.cols, jm.cols)
        assert _same_limbs(tm.vals, jm.vals)
