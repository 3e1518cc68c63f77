"""The plain reference against the port at toy sizes on the CPU, the
random diagonal instance, the control, and the reference's imports."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from proofbench import control, correct, instances
from proofbench.reference import fr, snark as ref

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "reference")
SEED = 2 ** 31 + 4242


def test_diagonal_instance_is_satisfiable():
    inst = instances.DiagonalInstance(SEED, 0, 64)
    assert inst.is_satisfied()
    assert all(0 < v < fr.R for v in inst.a + inst.b + inst.z)
    other = instances.DiagonalInstance(SEED, 1, 64)
    assert other.z != inst.z
    assert instances.DiagonalInstance(SEED, 0, 64).z == inst.z


def test_fr_vectors_by_python_ints():
    rng = np.random.default_rng(5)
    xs = [int.from_bytes(rng.bytes(32), "little") % fr.R for _ in range(37)]
    ys = [int.from_bytes(rng.bytes(32), "little") % fr.R for _ in range(37)]
    xs[0], ys[1] = fr.R - 1, 0
    a, b = (fr.from_canonical(instances._limbs(v, "cpu")) for v in (xs, ys))
    assert fr.to_ints(fr.mont_mul(a, b)) == [x * y % fr.R for x, y in zip(xs, ys)]
    assert fr.to_ints(fr.add(a, b)) == [(x + y) % fr.R for x, y in zip(xs, ys)]
    assert fr.total(a) == sum(xs) % fr.R
    assert fr.evaluate(a, 7) == sum(x * pow(7, i, fr.R) for i, x in enumerate(xs)) % fr.R


def _port_time_proof(inst, seed):
    from gemini_tpu_torch.kzg.commit import CommitterKey
    from gemini_tpu_torch.relation.r1cs import R1cs, SparseMatrix
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof

    n = inst.n
    idx = np.arange(n, dtype=np.int32)
    mk = lambda v: SparseMatrix(n, n, idx, idx, v, device="cpu")  # noqa: E731
    r1 = R1cs(mk(inst.a), mk(inst.b), mk(inst.c), z_int=inst.z, x_int=inst.z[:1],
              device="cpu")
    ck = CommitterKey.new(max_degree=n, max_eval_points=3,
                          seed=instances.key_seed(seed), device="cpu")
    p = Proof.new_time(r1, ck)
    return p, snark_proof_bytes(p)


def _port_elastic_proof(inst, seed):
    from gemini_tpu_torch.relation.stream import DummyR1csStream
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof
    from gemini_tpu_torch.streaming import FakeCommitterKeyStream

    fake = FakeCommitterKeyStream(3, seed=instances.key_seed(seed),
                                  max_msm_buffer=16, device="cpu")
    p = Proof.new_elastic(DummyR1csStream(inst.n, inst.e, device="cpu"), fake,
                          block_size=8, threshold=2)
    return p, snark_proof_bytes(p)


@pytest.mark.parametrize("kind, log2", [("time", 4), ("elastic", 6)])
def test_reference_equals_port_and_control_fails(kind, log2):
    from proofbench.drivers import common

    n = 1 << log2
    if kind == "time":
        inst, key = instances.DiagonalInstance(SEED, 0, n), instances.time_key(SEED)
        proof, pbytes = _port_time_proof(inst, SEED)
    else:
        inst, key = instances.DummyInstance(SEED, 0, n), instances.fake_key(SEED)
        proof, pbytes = _port_elastic_proof(inst, SEED)
    st = inst.statement("cpu")
    good = correct.reference_proof(ref, st, key)
    counts = correct.mismatches(common.parts(proof), good[0], pbytes, good[1])
    assert counts == {"commitments": 0, "sumchecks": 0, "evaluations": 0, "bytes": 0}
    bad = control.control_proof(ref, st, key)
    fails = correct.mismatches(bad[0], good[0], bad[1], good[1])
    assert fails["commitments"] > 0 and fails["bytes"] > 0


def test_perturbed_arithmetic_fails(monkeypatch):
    """A reference whose Fr sum drops one unit (an off-by-one in a lane
    reduction) no longer gives the port's proof."""
    n = 16
    inst, key = instances.DiagonalInstance(SEED, 1, n), instances.time_key(SEED)
    proof, pbytes = _port_time_proof(inst, SEED)
    total = fr.total
    monkeypatch.setattr(fr, "total", lambda a: (total(a) - 1) % fr.R)
    bad = correct.reference_proof(ref, inst.statement("cpu"), key)
    from proofbench.drivers import common

    counts = correct.mismatches(common.parts(proof), bad[0], pbytes, bad[1])
    assert counts["sumchecks"] > 0 and counts["bytes"] > 0


def test_reference_imports_nothing_of_the_port():
    for name in sorted(os.listdir(REF_DIR)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF_DIR, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("gemini_tpu_torch", "gemini_tpu", "jax"), \
                    f"{name} imports {m}"
    code = ("import sys; sys.path.insert(0, %r); import proofbench.reference.snark; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gemini_tpu_torch', 'gemini_tpu', 'jax', 'jaxlib'}))"
            % os.path.dirname(os.path.dirname(REF_DIR)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
