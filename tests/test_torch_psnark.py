"""pSNARK slice parity: the port's preprocessing SNARK (index, time
prover, verifier), its pieces and proof deserialization against
gemini_tpu on the CPU.

The golden instance is tests/test_psnark.py's:
random_r1cs(random.Random(41), 8, row_nnz=2) (27 joint non-zeros) with
CommitterKey.new(max_degree=8 + 27 + 8, max_eval_points=3, seed=13).
gemini_tpu's proof bytes and index commitments are stored in
gemini_tpu_torch/testdata/psnark_golden.json (chip_smoke.py compares
the card's proofs with them); the module fixture runs gemini_tpu's
pSNARK prover once and checks the file.  Tolerance: exact, everywhere.
At most 3 collected cases (ROADMAP.md, tier-1 rule); the JAX side
compiles with XLA's optimizations off (integer results do not depend on
them).
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
from gemini_tpu.kzg import commit as jkzg
from gemini_tpu.ops import poly as jpoly
from gemini_tpu.psnark import Proof as JProof
from gemini_tpu.psnark import index as j_index
from gemini_tpu.relation import random_r1cs as j_random_r1cs
from gemini_tpu.relation.r1cs import joint_matrices as j_joint_matrices
from gemini_tpu.serialize import g1_compressed as j_g1_compressed
from gemini_tpu.serialize import psnark_proof_bytes as j_psnark_bytes
from gemini_tpu.serialize import snark_proof_from_bytes as j_snark_from_bytes
from gemini_tpu.subprotocols import entry_product as jep
from gemini_tpu.subprotocols import plookup as jpl
from gemini_tpu.transcript import GeminiTranscript as JTranscript
from gemini_tpu_torch.fields.fp import FR
from gemini_tpu_torch.kzg import commit as tkzg
from gemini_tpu_torch.ops import poly
from gemini_tpu_torch.params import Q, R
from gemini_tpu_torch.psnark import Proof, PsnarkVerificationError, index
from gemini_tpu_torch.relation import random_r1cs
from gemini_tpu_torch.relation.r1cs import joint_matrices
from gemini_tpu_torch.serialize import (
    DeserializationError, g1_compressed, g1_from_compressed,
    psnark_proof_bytes, psnark_proof_from_bytes, snark_proof_from_bytes)
from gemini_tpu_torch.subprotocols import entry_product as tep
from gemini_tpu_torch.subprotocols import plookup as tpl
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


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(TESTDATA, "psnark_golden.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_run(golden):
    """gemini_tpu's instance, SRS, index and proof: the one run of its
    pSNARK prover in this file, checked against the golden file."""
    r1 = j_random_r1cs(random.Random(golden["r1cs_seed"]), golden["n"],
                       row_nnz=golden["row_nnz"])
    jm = j_joint_matrices(r1)
    assert jm.num_non_zero == golden["num_non_zero"]
    ck = jkzg.CommitterKey.new(max_degree=golden["max_degree"],
                               max_eval_points=golden["max_eval_points"],
                               seed=golden["srs_seed"])
    idx = j_index(ck, r1)
    assert [j_g1_compressed(c).hex() for c in idx] == golden["index_hex"]
    proof = JProof.new_time(ck, r1, idx)
    assert j_psnark_bytes(proof).hex() == golden["proof_hex"]
    return r1, jm, ck, idx


@pytest.fixture(scope="module")
def port_run(golden):
    r1 = random_r1cs(random.Random(golden["r1cs_seed"]), golden["n"],
                     row_nnz=golden["row_nnz"], device="cpu")
    ck = tkzg.CommitterKey.new(max_degree=golden["max_degree"],
                               max_eval_points=golden["max_eval_points"],
                               seed=golden["srs_seed"], device="cpu")
    return r1, ck, tkzg.VerifierKey.from_committer_key(ck)


def _limbs(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.numpy().astype(np.int64)
    return np.asarray(t).astype(np.int64)


def _same(a, b) -> bool:
    return a.shape == b.shape and np.array_equal(_limbs(a), _limbs(b))


def test_golden_psnark_matches_gemini_tpu(golden, jax_run, port_run):
    """The port's CPU index and time prover give gemini_tpu's index
    commitments and proof bytes; the port verifies its proof; with no
    card, the entry points refuse device=None."""
    r1, ck, vk = port_run
    idx = index(ck, r1)
    assert [g1_compressed(c).hex() for c in idx] == golden["index_hex"]
    proof = Proof.new_time(ck, r1, idx)
    assert psnark_proof_bytes(proof).hex() == golden["proof_hex"]
    proof.verify(r1, vk, idx, golden["num_non_zero"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            random_r1cs(random.Random(golden["r1cs_seed"]), golden["n"],
                        row_nnz=golden["row_nnz"])
        with pytest.raises(RuntimeError):
            tkzg.CommitterKey.new(max_degree=7, max_eval_points=1, seed=1)


def test_psnark_pieces_match_gemini_tpu(golden, jax_run, port_run):
    """Piece by piece on the golden instance, against gemini_tpu: the
    joint matrices, the nine plookup vectors, the accumulated products
    and lane products, the entry product's messages; and the host
    evaluations on seeded inputs."""
    _, jmj, ckj, _ = jax_run
    r1, ck, _ = port_run
    jm = joint_matrices(r1)
    assert np.array_equal(jm.row_index, jmj.row_index)
    assert np.array_equal(jm.col_index, jmj.col_index)
    assert np.array_equal(jm.row_index_d.numpy(), jmj.row_index)
    assert np.array_equal(jm.col_index_d.numpy(), jmj.col_index)
    for name in ("row", "col", "val_a", "val_b", "val_c"):
        assert _same(getattr(jm, name), getattr(jmj, name)), name

    # plookup on (r*, alpha*, z*)-shaped lookups: set vectors of the
    # first sumcheck's length (8) and z, subsets gathered by the joint
    # indices, seeded challenges.
    rng = np.random.default_rng(61)
    rand = lambda n: [int(x) % R for x in rng.integers(0, 1 << 62, size=n)]
    y, z, zeta = rand(3)
    sets = [rand(8), rand(8), list(r1.z_int)]
    idxs = [jm.row_index, jm.row_index, jm.col_index]
    vecs_t, vecs_j = [], []
    for s, ix in zip(sets, idxs):
        st, sj = FR.tensor(s, "cpu"), jnp.asarray(JFR.encode(s))
        out_t = tpl.plookup(tpl.lookup(st, ix), st, ix, y, z, zeta)
        out_j = jpl.plookup(jpl.lookup(sj, ix), sj, ix, y, z, zeta)
        vecs_t += out_t
        vecs_j += out_j
    assert len(vecs_t) == 9
    for k, (a, b) in enumerate(zip(vecs_t, vecs_j)):
        assert _same(a, b), f"plookup vector {k}"
        assert poly.lane_prod(FR, a) == jpoly.lane_prod(JFR, b), k
        m_t, m_j = tep.monic(a), jep.monic(b)
        assert _same(tep.accumulated_product(m_t), jep.accumulated_product(m_j)), k
    # the grand-product identity the plookup argument rests on
    for k in range(0, 9, 3):
        n_sub = vecs_t[k + 1].shape[1]
        lhs = poly.lane_prod(FR, vecs_t[k + 2])
        rhs = (poly.lane_prod(FR, vecs_t[k]) * poly.lane_prod(FR, vecs_t[k + 1])
               * pow(1 + z, n_sub, R)) % R
        assert lhs == rhs, k

    prods = [poly.lane_prod(FR, v) for v in vecs_t]
    ep_t = tep.EntryProduct.new_time_batch(GeminiTranscript(b"EP"), ck, vecs_t, prods)
    ep_j = jep.EntryProduct.new_time_batch(JTranscript(b"EP"), ckj, vecs_j, prods)
    assert ep_t.msgs.acc_v_commitments == ep_j.msgs.acc_v_commitments
    assert ep_t.msgs.claimed_sumchecks == ep_j.msgs.claimed_sumchecks
    assert ep_t.chal == ep_j.chal
    for a, b in zip(ep_t.acc_vs, ep_j.acc_vs):
        assert _same(a, b)

    coeffs = rand(37)
    ct, cj = FR.tensor(coeffs, "cpu"), jnp.asarray(JFR.encode(coeffs))
    for x in rand(2) + [0, 1, R - 1]:
        assert poly.evaluate_be(FR, ct, x) == jpoly.evaluate_be(JFR, cj, x)
        assert poly.powers2_host(x, 9) == jpoly.powers2_host(x, 9)
        for n in (1, 2, 27, 1 << 18):
            assert poly.evaluate_geometric_poly(x, n) == \
                jpoly.evaluate_geometric_poly(x, n)
            if x != 1:
                assert poly.evaluate_index_poly(x, n) == \
                    jpoly.evaluate_index_poly(x, n)
        for k in (0, 1, 5, 18):
            ch = rand(k)
            assert poly.evaluate_tensor_poly(ch, x) == \
                jpoly.evaluate_tensor_poly(ch, x)
    with pytest.raises(ValueError):
        poly.evaluate_index_poly(1, 5)


def _off_subgroup_point():
    """(x, y) on y^2 = x^3 + 4 outside the order-r subgroup: the smallest
    x >= 1 with x^3 + 4 a square (the cofactor makes almost every curve
    point such a point; checked by r·P != O on the refimpl)."""
    from gemini_tpu_torch.refimpl import curve as ric

    x = 1
    while True:
        a = (x ** 3 + 4) % Q
        y = pow(a, (Q + 1) // 4, Q)
        if y * y % Q == a:
            p = (x, y)
            assert ric.g1_is_on_curve(p) and ric.g1_mul(p, R) is not None
            return p
        x += 1


def test_psnark_deserialization(golden, port_run):
    """gemini_tpu's pSNARK bytes parse into the port's Proof, which the
    port verifies and writes back to the same bytes; the SNARK golden
    bytes parse to gemini_tpu's parse; truncated, trailing and
    off-subgroup inputs raise DeserializationError; tampered zc_alpha and
    set_z_ep are rejected."""
    r1, _, vk = port_run
    idx = [g1_from_compressed(bytes.fromhex(h)) for h in golden["index_hex"]]
    raw = bytes.fromhex(golden["proof_hex"])
    proof = psnark_proof_from_bytes(raw)
    proof.verify(r1, vk, idx, golden["num_non_zero"])
    assert psnark_proof_bytes(proof) == raw

    with open(os.path.join(TESTDATA, "snark_golden.json")) as f:
        snark_raw = bytes.fromhex(json.load(f)["proof_hex"])
    got, want = snark_proof_from_bytes(snark_raw), j_snark_from_bytes(snark_raw)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "tensorcheck_proof":
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name

    for parse, data in ((psnark_proof_from_bytes, raw),
                        (snark_proof_from_bytes, snark_raw)):
        for cut in (data[:-1], data[:100], data + b"\x00"):
            with pytest.raises(DeserializationError):
                parse(cut)

    # Points on the curve outside the order-r subgroup: (0, 2), of order
    # 3, and the smallest x >= 1 on the curve, in the first commitment.
    for p in ((0, 2), _off_subgroup_point()):
        with pytest.raises(DeserializationError):
            g1_from_compressed(g1_compressed(p))
        with pytest.raises(DeserializationError):
            psnark_proof_from_bytes(g1_compressed(p) + raw[48:])
    assert g1_from_compressed(g1_compressed(idx[0])) == idx[0]

    bad = copy.deepcopy(proof)
    bad.zc_alpha = (bad.zc_alpha + 1) % R
    bad2 = copy.deepcopy(proof)
    bad2.set_z_ep = (bad2.set_z_ep + 1) % R
    for p in (bad, bad2):
        with pytest.raises(PsnarkVerificationError):
            p.verify(r1, vk, idx, golden["num_non_zero"])
