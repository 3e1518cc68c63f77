"""SNARK slice parity: the port's KZG, sumcheck and time-efficient SNARK
against gemini_tpu on the CPU.

The golden instance is random_r1cs(random.Random(11), 16) with
CommitterKey.new(max_degree=31, max_eval_points=3, seed=11); its
gemini_tpu proof bytes are stored in
gemini_tpu_torch/testdata/snark_golden.json (chip_smoke.py compares the
card's proof with them).  Tolerance: exact, everywhere.  At most 3
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
import jax.numpy as jnp

from gemini_tpu.fields.fp import FR as JFR
from gemini_tpu.kzg import commit as jkzg
from gemini_tpu.relation import random_r1cs as j_random_r1cs
from gemini_tpu.serialize import g2_uncompressed as j_g2
from gemini_tpu.serialize import snark_proof_bytes as j_bytes
from gemini_tpu.serialize import snark_proof_from_bytes
from gemini_tpu.snark import Proof as JProof
from gemini_tpu.subprotocols import sumcheck as jsc
from gemini_tpu.transcript import GeminiTranscript as JTranscript
from gemini_tpu_torch import interop
from gemini_tpu_torch.fields.fp import FR
from gemini_tpu_torch.kzg import commit as tkzg
from gemini_tpu_torch.params import R
from gemini_tpu_torch.relation import random_r1cs
from gemini_tpu_torch.serialize import g2_uncompressed, snark_proof_bytes
from gemini_tpu_torch.snark import Proof, SnarkVerificationError
from gemini_tpu_torch.subprotocols import sumcheck as tsc
from gemini_tpu_torch.transcript import GeminiTranscript

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "gemini_tpu_torch", "testdata", "snark_golden.json")


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _port_instance(g):
    r1 = random_r1cs(random.Random(g["r1cs_seed"]), g["n"], device="cpu")
    ck = tkzg.CommitterKey.new(max_degree=g["max_degree"],
                               max_eval_points=g["max_eval_points"],
                               seed=g["srs_seed"], device="cpu")
    return r1, ck


@pytest.fixture(scope="module")
def jax_instance(golden):
    r1 = j_random_r1cs(random.Random(golden["r1cs_seed"]), golden["n"])
    ck = jkzg.CommitterKey.new(max_degree=golden["max_degree"],
                               max_eval_points=golden["max_eval_points"],
                               seed=golden["srs_seed"])
    return r1, ck


def test_golden_proof_bytes_match_gemini_tpu(golden, jax_instance):
    """gemini_tpu's proof regenerates the golden file; the port's proof
    has the same bytes and verifies; gemini_tpu's verifier accepts the
    port's proof read back from bytes; tampered proofs are rejected."""
    r1j, ckj = jax_instance
    assert j_bytes(JProof.new_time(r1j, ckj)).hex() == golden["proof_hex"]

    r1, ck = _port_instance(golden)
    proof = Proof.new_time(r1, ck)
    assert snark_proof_bytes(proof).hex() == golden["proof_hex"]
    vk = tkzg.VerifierKey.from_committer_key(ck)
    proof.verify(r1, vk)
    read = snark_proof_from_bytes(snark_proof_bytes(proof))
    read.verify(r1j, jkzg.VerifierKey.from_committer_key(ckj))

    bad = copy.deepcopy(proof)
    bad.zc_alpha = (bad.zc_alpha + 1) % R
    bad2 = copy.deepcopy(proof)
    m0 = bad2.second_sumcheck_msgs[0]
    m0[0] = ((m0[0][0] + 1) % R, m0[0][1])
    bad3 = copy.deepcopy(proof)
    tc = bad3.tensorcheck_proof
    tc.folded_polynomials_evaluations[0] = (
        (tc.folded_polynomials_evaluations[0][0] + 1) % R,
        tc.folded_polynomials_evaluations[0][1])
    other = random_r1cs(random.Random(golden["r1cs_seed"] + 1), golden["n"],
                        device="cpu")
    for p, rel in ((bad, r1), (bad2, r1), (bad3, r1), (proof, other)):
        with pytest.raises(SnarkVerificationError):
            p.verify(rel, vk)


def test_interop_and_kzg_match_gemini_tpu(golden, jax_instance):
    """gemini_tpu's SRS limbs equal the port's from the same seed; the
    state carried across by interop proves to the golden bytes; KZG
    commit / open / batch commit / multi-point open equal gemini_tpu's,
    and the port's verifier rejects a wrong evaluation."""
    r1, ck = jax_instance
    _, ck_port = _port_instance(golden)
    for a, b in ((ck.powers_of_g.x, ck_port.powers_of_g.x),
                 (ck.powers_of_g.y, ck_port.powers_of_g.y),
                 (ck.powers_of_g.inf, ck_port.powers_of_g.inf)):
        assert np.array_equal(np.asarray(a).astype(np.int64),
                              b.numpy().astype(np.int64))
    assert [j_g2(q) for q in ck.powers_of_g2] == \
        [g2_uncompressed(q) for q in ck_port.powers_of_g2]
    ck_x = interop.committer_key(np.asarray(ck.powers_of_g.x),
                                 np.asarray(ck.powers_of_g.y),
                                 np.asarray(ck.powers_of_g.inf),
                                 ck.powers_of_g2, device="cpu")
    coo = lambda m: (m.n_rows, m.n_cols, m.rows, m.cols, m.vals_int)
    r1_x = interop.r1cs(coo(r1.a), coo(r1.b), coo(r1.c), r1.z_int, r1.x_int,
                        device="cpu")
    proof = Proof.new_time(r1_x, ck_x)
    assert snark_proof_bytes(proof).hex() == golden["proof_hex"]

    ck_t = ck_x
    rng = np.random.default_rng(31)
    coeffs = [int(x) % R for x in rng.integers(0, 1 << 62, size=29)]
    fj = jnp.asarray(JFR.encode(coeffs))
    ft = FR.tensor(coeffs, "cpu")
    assert ck_t.commit(ft) == ck.commit(fj)
    for alpha in (0, R - 1):
        ev_t, pi_t = ck_t.open(ft, alpha)
        ev_j, pi_j = ck.open(fj, alpha)
        assert (ev_t, pi_t) == (ev_j, pi_j)
    vk = tkzg.VerifierKey.from_committer_key(ck_t)
    com = ck_t.commit(ft)
    ev, pi = ck_t.open(ft, 5)
    vk.verify(com, 5, ev, pi)
    with pytest.raises(tkzg.KZGVerificationError):
        vk.verify(com, 5, (ev + 1) % R, pi)
    polys = [ft, ft[:, :7], ft[:, :2]]
    assert ck_t.batch_commit(polys) == [ck.commit(fj[:, :n]) for n in (29, 7, 2)]
    pts = [3, 7, 11]
    assert ck_t.batch_open_multi_points(polys, pts, 9) == \
        ck.batch_open_multi_points([fj, fj[:, :7], fj[:, :2]], pts, 9)


def test_sumchecks_match_gemini_tpu():
    """Single and batched sumcheck messages, challenges and final
    foldings equal gemini_tpu's; the subclaims verify and a wrong sum is
    rejected."""
    rng = np.random.default_rng(41)
    n = 1 << 6
    f = [int(x) % R for x in rng.integers(0, 1 << 62, size=n)]
    g = [int(x) % R for x in rng.integers(0, 1 << 62, size=n - 3)]
    twist = 0x1234567
    pj = jsc.Sumcheck.prove(JTranscript(b"T"), jsc.TimeProver(
        jnp.asarray(JFR.encode(f)), jnp.asarray(JFR.encode(g)), twist))
    pt = tsc.Sumcheck.prove(GeminiTranscript(b"T"), tsc.TimeProver(
        FR.tensor(f, "cpu"), FR.tensor(g, "cpu"), twist))
    assert pt.messages == pj.messages
    assert pt.challenges == pj.challenges
    assert pt.final_foldings == pj.final_foldings
    claim = sum(a * b * pow(twist, i, R) for i, (a, b) in
                enumerate(zip(f, g + [0] * 3))) % R
    tsc.Subclaim.new(GeminiTranscript(b"T"), pt.messages, pt.final_foldings,
                     claim)
    with pytest.raises(tsc.VerificationError):
        tsc.Subclaim.new(GeminiTranscript(b"T"), pt.messages,
                         pt.final_foldings, (claim + 1) % R)

    rng = np.random.default_rng(43)
    sizes, twists = (64, 16, 1), (7, 1, 3)
    vecs = [[[int(x) % R for x in rng.integers(0, 1 << 62, size=n)]
             for _ in range(2)] for n in sizes]
    pj = jsc.Sumcheck.prove_batch(JTranscript(b"B"), [
        jsc.TimeProver(jnp.asarray(JFR.encode(f)), jnp.asarray(JFR.encode(g)), t)
        for (f, g), t in zip(vecs, twists)])
    pt = tsc.Sumcheck.prove_batch(GeminiTranscript(b"B"), [
        tsc.TimeProver(FR.tensor(f, "cpu"), FR.tensor(g, "cpu"), t)
        for (f, g), t in zip(vecs, twists)])
    assert (pt.messages, pt.challenges, pt.final_foldings) == \
        (pj.messages, pj.challenges, pj.final_foldings)
    sums = [sum(a * b * pow(t, i, R) for i, (a, b) in enumerate(zip(f, g))) % R
            for (f, g), t in zip(vecs, twists)]
    tsc.Subclaim.new_batch(GeminiTranscript(b"B"), pt.messages,
                           pt.final_foldings, sums)
