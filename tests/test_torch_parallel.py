"""Multi-device and GLV parity: the port's parallel/ (Mesh, sharded
sumcheck, lane-split MSMs, mesh= on the provers) and ops/glv.py against
gemini_tpu on the CPU.

The port's mesh is Mesh([cpu] * 4): four shards in one process, the
role that gemini_tpu's 8-virtual-device CPU mesh plays for JAX.  The
MSM paths run with the kernel pipeline forced (host_max=0 where the
entry point has a host cutoff) and with GLV off and on
(GEMINI_TPU_GLV).  None of gemini_tpu's provers runs here: the golden
proofs are held to gemini_tpu_torch/testdata/*_golden.json, which
tests/test_torch_snark.py and tests/test_torch_psnark.py regenerate
from gemini_tpu.  Tolerance: exact, everywhere.  At most 3 collected
cases (ROADMAP.md, tier-1 rule); the JAX side compiles with XLA's
optimizations off (integer results do not depend on them).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemini_tpu import hostcurve as jhost
from gemini_tpu.fields.fp import FQ as JFQ
from gemini_tpu.fields.fp import FR as JFR
from gemini_tpu.ops import glv as jglv
from gemini_tpu.ops import msm as jmsm
from gemini_tpu.parallel import ShardedTimeProver as JShardedTimeProver
from gemini_tpu.parallel import default_mesh as j_default_mesh
from gemini_tpu.relation import random_r1cs as j_random_r1cs
from gemini_tpu.subprotocols import sumcheck as jsc
from gemini_tpu.transcript import GeminiTranscript as JTranscript
from gemini_tpu_torch.curve import g1
from gemini_tpu_torch.fields.fp import FQ, FR
from gemini_tpu_torch.kzg.commit import CommitterKey, VerifierKey
from gemini_tpu_torch.ops import glv, msm
from gemini_tpu_torch.parallel import (Mesh, ShardedTimeProver, default_mesh,
                                       msm_batch_multichip, msm_multichip)
from gemini_tpu_torch.params import R
from gemini_tpu_torch.psnark import Proof as PProof
from gemini_tpu_torch.psnark import index
from gemini_tpu_torch.refimpl import g1_generator, g1_mul
from gemini_tpu_torch.relation import random_r1cs
from gemini_tpu_torch.serialize import psnark_proof_bytes, snark_proof_bytes
from gemini_tpu_torch.snark import Proof
from gemini_tpu_torch.streaming import CommitterKeyStream
from gemini_tpu_torch.streaming.host import HostVector
from gemini_tpu_torch.subprotocols import sumcheck as tsc
from gemini_tpu_torch.transcript import GeminiTranscript

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "gemini_tpu_torch", "testdata")
CPU4 = Mesh([torch.device("cpu")] * 4)


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _golden(name):
    with open(os.path.join(TESTDATA, name)) as f:
        return json.load(f)


def _k_with_q(target):
    """A scalar whose rounded quotient round(k z^2 / r) is `target`."""
    k0 = target * R // jglv.Z2
    for k in range(k0 - 4, k0 + 5):
        if (k * jglv.Z2 + R // 2) // R == target:
            return k
    raise AssertionError(target)


def test_glv_and_plans_match_gemini_tpu():
    """decompose's limbs and sign flags and endo_x's limbs equal
    gemini_tpu's on 64 seeded scalars plus the edge scalars (0, 1,
    LAMBDA, R - 1, and q at Z2 // 2 and Z2 // 2 + 1, the balance
    branch's edge); the window plans (plain and GLV) pick gemini_tpu's
    c; SparseMatrix.nnz and to_rows equal gemini_tpu's."""
    rng = np.random.default_rng(53)
    ks = [sum(int(v) << (62 * i) for i, v in enumerate(row)) % R
          for row in rng.integers(0, 1 << 62, size=(64, 5))]
    ks += [0, 1, glv.LAMBDA, R - 1, _k_with_q(glv.Z2 // 2),
           _k_with_q(glv.Z2 // 2 + 1)]
    want = [np.asarray(a) for a in
            jglv.decompose(jnp.asarray(JFR.encode(ks, mont=False)))]
    got = glv.decompose(FR.tensor(ks, "cpu", mont=False))
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(np.int64), g.numpy().astype(np.int64))
    assert got[3][-2:].tolist() == [False, True]  # both sides of the balance
    for j, k in enumerate(ks):
        k1 = sum(int(v) << (16 * i) for i, v in enumerate(got[0][:, j].tolist()))
        k2 = sum(int(v) << (16 * i) for i, v in enumerate(got[2][:, j].tolist()))
        k1, k2 = -k1 if got[1][j] else k1, -k2 if got[3][j] else k2
        assert (k1 + k2 * glv.LAMBDA - k) % R == 0
        assert max(abs(k1), abs(k2)) < glv.COMPONENT_BOUND

    xs = [int(x) for x in rng.integers(0, 1 << 62, size=16)]
    xs = [(x << 320 | x << 100 | x) % JFQ.modulus for x in xs]
    want = np.asarray(jglv.endo_x(jnp.asarray(JFQ.encode(xs))))
    got = glv.endo_x(FQ.tensor(xs, "cpu"))
    assert np.array_equal(want.astype(np.int64), got.numpy().astype(np.int64))

    for n in (256, 1 << 12, 1 << 16, 1 << 20, 1 << 21):
        for n_bits in (255, 128, 64):
            assert msm.plan_window(n, n_bits)[0] == \
                jmsm.plan_window(n, n_bits)[0] == msm.default_window(n, n_bits)
        assert msm._glv_plan(n)[0] == jmsm._glv_plan(n)[0]

    r1 = random_r1cs(random.Random(11), 16, device="cpu")
    r1j = j_random_r1cs(random.Random(11), 16)
    for m, mj in ((r1.a, r1j.a), (r1.b, r1j.b), (r1.c, r1j.c)):
        assert (m.nnz, m.to_rows()) == (mj.nnz, mj.to_rows())


def test_sharded_sumcheck_and_multichip_msms(monkeypatch):
    """ShardedTimeProver on Mesh([cpu] * 4) gives gemini_tpu's
    ShardedTimeProver's (default_mesh(4)) messages, challenges and final
    foldings at n = 64, and so do Sumcheck.new_time and a batch with a
    1-element prover; msm_multichip and msm_batch_multichip (the
    pipeline forced) equal gemini_tpu's host MSM with GLV off and on, as
    do msm and msm_batch with glv=True; a streaming commit with mesh=
    equals the plain one (and HostVector.to_device the encoded vector);
    default_mesh raises without enough cards."""
    rng = np.random.default_rng(59)
    n = 64
    f = [int(x) % R for x in rng.integers(0, 1 << 62, size=n)]
    g = [int(x) % R for x in rng.integers(0, 1 << 62, size=n - 5)]
    twist = int(rng.integers(1, 1 << 62))
    fj, gj = jnp.asarray(JFR.encode(f)), jnp.asarray(JFR.encode(g))
    want = jsc.Sumcheck.prove(JTranscript(b"S"), JShardedTimeProver(
        j_default_mesh(4), fj, gj, twist))
    ft, gt = FR.tensor(f, "cpu"), FR.tensor(g, "cpu")
    got = tsc.Sumcheck.prove(GeminiTranscript(b"S"),
                             ShardedTimeProver(CPU4, ft, gt, twist))
    assert (got.messages, got.challenges, got.final_foldings) == \
        (want.messages, want.challenges, want.final_foldings)
    dense = tsc.Sumcheck.new_time(GeminiTranscript(b"S"), ft, gt, twist)
    assert (dense.messages, dense.final_foldings) == \
        (want.messages, want.final_foldings)
    batch = [(ft, gt, twist), (ft[:, :16], gt[:, :16], 3), (ft[:, :1], gt[:, :1], 5)]
    bt = tsc.Sumcheck.prove_batch(GeminiTranscript(b"B"), [
        ShardedTimeProver(CPU4, *a) for a in batch])
    bd = tsc.Sumcheck.prove_batch(GeminiTranscript(b"B"), [
        tsc.TimeProver(*a) for a in batch])
    assert (bt.messages, bt.final_foldings) == (bd.messages, bd.final_foldings)

    rnd = random.Random(61)
    pts = [g1_mul(g1_generator(), rnd.randrange(1, R)) for _ in range(50)]
    pts[3] = None
    ks = [int(x) % R for x in rng.integers(0, 1 << 62, size=50)]
    ks = [(k << 190 | k) % R for k in ks]
    ks[:3] = [0, 1, R - 1]
    ap = g1.encode_affine(pts, "cpu")
    sizes = (50, 13)
    want = [jhost.g1_msm([p for p in pts[:m] if p is not None],
                         [k for p, k in zip(pts[:m], ks[:m]) if p is not None])
            for m in sizes]
    sets = [FR.tensor(ks[:m], "cpu", mont=False) for m in sizes]
    for flag in ("0", "1"):
        monkeypatch.setenv("GEMINI_TPU_GLV", flag)
        one = msm_multichip(ap, sets[0], devices=CPU4.devices)
        assert g1.decode_jacobian(one)[0] == want[0]
        res = msm_batch_multichip(ap, sets, devices=CPU4.devices, host_max=0)
        assert [g1.decode_jacobian(r)[0] for r in res] == want
    monkeypatch.delenv("GEMINI_TPU_GLV")
    assert g1.decode_jacobian(msm.msm(ap, sets[0], glv=True, host_max=0))[0] \
        == want[0]
    res = msm.msm_batch(ap, sets, glv=True, host_max=0)
    assert [g1.decode_jacobian(r)[0] for r in res] == want

    ck = CommitterKey.new(max_degree=31, max_eval_points=3, seed=3, device="cpu")
    hv = HostVector(np.asarray(FR.encode(ks[:32])), FR, "cpu")
    assert torch.equal(hv.to_device(), FR.tensor(ks[:32], "cpu"))
    assert CommitterKeyStream(ck, 32, mesh=CPU4).commit(hv) == \
        CommitterKeyStream(ck, 32).commit(hv)

    with pytest.raises(RuntimeError):
        default_mesh(torch.cuda.device_count() + 1)


def test_golden_proofs_with_mesh(monkeypatch):
    """The golden SNARK proved with mesh=Mesh([cpu] * 4), with GLV off
    and on, and the golden pSNARK with GLV off (the default), have
    gemini_tpu's bytes and verify (the pSNARK with GLV on runs in
    chip_smoke.py)."""
    g = _golden("snark_golden.json")
    r1 = random_r1cs(random.Random(g["r1cs_seed"]), g["n"], device="cpu")
    ck = CommitterKey.new(max_degree=g["max_degree"],
                          max_eval_points=g["max_eval_points"],
                          seed=g["srs_seed"], device="cpu")
    vk = VerifierKey.from_committer_key(ck)
    gp = _golden("psnark_golden.json")
    r1p = random_r1cs(random.Random(gp["r1cs_seed"]), gp["n"],
                      row_nnz=gp["row_nnz"], device="cpu")
    ckp = CommitterKey.new(max_degree=gp["max_degree"],
                           max_eval_points=gp["max_eval_points"],
                           seed=gp["srs_seed"], device="cpu")
    vkp = VerifierKey.from_committer_key(ckp)
    idx = index(ckp, r1p)
    for flag in ("0", "1"):
        monkeypatch.setenv("GEMINI_TPU_GLV", flag)
        proof = Proof.new_time(r1, ck, mesh=CPU4)
        assert snark_proof_bytes(proof).hex() == g["proof_hex"]
        proof.verify(r1, vk)
    monkeypatch.delenv("GEMINI_TPU_GLV")
    proof = PProof.new_time(ckp, r1p, idx, mesh=CPU4)
    assert psnark_proof_bytes(proof).hex() == gp["proof_hex"]
    proof.verify(r1p, vkp, idx, gp["num_non_zero"])
