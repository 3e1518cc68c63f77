"""The port's entry points (gemini_tpu_torch/examples: snark, psnark,
pc) run in process with `--cpu`: each exits cleanly, verifies, and
prints the proof size of the same proof built directly through the
port's API; without `--cpu` and with no card each raises RuntimeError
before it runs anything.

Sizes: 2^2 constraints, the smallest at which gemini_tpu's examples
verify too (at -i 1 the tensorcheck has no fold round and both
packages' verifiers fail), and 2^2 coefficients for pc.  Tolerance:
exact.  At most 3 collected cases (ROADMAP.md, tier-1 rule).
"""

import contextlib
import io
import random
import re

import pytest
import torch

from gemini_tpu_torch.examples import pc, psnark, snark
from gemini_tpu_torch.fields.fp import FR
from gemini_tpu_torch.kzg.commit import CommitterKey
from gemini_tpu_torch.params import R
from gemini_tpu_torch.psnark import Proof as PProof
from gemini_tpu_torch.psnark import index, index_stream
from gemini_tpu_torch.relation import DummyR1csStream, dummy_r1cs
from gemini_tpu_torch.relation.r1cs import joint_matrices
from gemini_tpu_torch.serialize import psnark_proof_bytes, snark_proof_bytes
from gemini_tpu_torch.snark import Proof
from gemini_tpu_torch.streaming import CommitterKeyStream, FakeCommitterKeyStream

torch.set_num_threads(1)

LOG = 2
N = 1 << LOG
BUF = 1 << 20  # the examples' default --msm-buffer-log


def _main(mod, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = mod.main([*argv, "--cpu"])
    text = out.getvalue()
    assert text.startswith("device: cpu\n")
    return res, text


def _size(text):
    return int(re.search(r"^proof size:\s+(\d+) B", text, re.M).group(1))


def _refuses_without_card(monkeypatch, mod, *argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(RuntimeError):
        mod.main(list(argv))
    assert out.getvalue() == ""
    monkeypatch.undo()


def test_snark_example(monkeypatch):
    """`snark -i 2 --time-prover` and `snark -i 2` (elastic) verify and
    print the size of the API's proof, byte for byte the same proof."""
    res, text = _main(snark, "-i", str(LOG), "--time-prover")
    assert "verifier time:" in text and res["verified"]
    r1 = dummy_r1cs(random.Random(0), N, device="cpu")
    ck = CommitterKey.new(max_degree=N, max_eval_points=3, seed=0, device="cpu")
    raw = snark_proof_bytes(Proof.new_time(r1, ck))
    assert snark_proof_bytes(res["proof"]) == raw and _size(text) == len(raw)

    res, text = _main(snark, "-i", str(LOG))
    assert "(elastic prover)" in text and "verifier time:" in text
    e = random.Random(0).randrange(1, R)
    fake = FakeCommitterKeyStream(max_eval_points=3, seed=0, max_msm_buffer=BUF,
                                  device="cpu")
    raw = snark_proof_bytes(Proof.new_elastic(
        DummyR1csStream(N, e, device="cpu"), fake, block_size=BUF))
    assert snark_proof_bytes(res["proof"]) == raw and _size(text) == len(raw)
    _refuses_without_card(monkeypatch, snark, "-i", str(LOG), "--time-prover")


def test_psnark_example(monkeypatch):
    """`psnark -i 2` with the time prover, `--elastic` and `--giant`:
    the first two verify inside the example, the giant proof verifies
    against its dense relation here; each prints the API proof's size."""
    r1 = dummy_r1cs(random.Random(0), N, device="cpu")
    nnz = joint_matrices(r1).num_non_zero
    ck = CommitterKey.new(max_degree=2 * N + nnz + 2, max_eval_points=3, seed=0,
                          device="cpu")
    idx = index(ck, r1)
    for flags, prove in (((), lambda: PProof.new_time(ck, r1, idx)),
                         (("--elastic",), lambda: PProof.new_elastic(
                             CommitterKeyStream(ck, BUF), r1, idx, block_size=BUF))):
        res, text = _main(psnark, "-i", str(LOG), *flags)
        assert "verifier time:" in text and res["verified"]
        raw = psnark_proof_bytes(prove())
        assert psnark_proof_bytes(res["proof"]) == raw and _size(text) == len(raw)

    res, text = _main(psnark, "-i", str(LOG), "--giant")
    stream = DummyR1csStream(N, random.Random(0).randrange(1, R), device="cpu")
    cks = FakeCommitterKeyStream(max_eval_points=3, seed=0, max_msm_buffer=BUF,
                                 device="cpu")
    gidx = index_stream(cks, stream)
    raw = psnark_proof_bytes(PProof.new_elastic(cks, stream, gidx, block_size=BUF))
    assert psnark_proof_bytes(res["proof"]) == raw and _size(text) == len(raw)
    dense = stream.to_dense()
    res["proof"].verify(dense, cks.verifier_key(), res["index"],
                        joint_matrices(dense).num_non_zero)
    _refuses_without_card(monkeypatch, psnark, "-i", str(LOG), "--giant")


def test_pc_example(monkeypatch):
    """`pc -d 2 -p 2 -m 2` commits, opens at two points and verifies;
    its commitments and opening equal the API's on the same inputs."""
    res, text = _main(pc, "-d", str(LOG), "-p", "2", "-m", "2")
    assert re.search(r"^verify: .*\(OK\)$", text, re.M) and res["verified"]
    rng = random.Random(0)
    ck = CommitterKey.new(max_degree=N, max_eval_points=2, seed=0, device="cpu")
    polys = [FR.tensor([rng.randrange(R) for _ in range(N)], "cpu") for _ in range(2)]
    pts = [rng.randrange(R) for _ in range(2)]
    assert res["commitments"] == ck.batch_commit(polys)
    assert res["proof"] == ck.batch_open_multi_points(polys, pts, rng.randrange(R))
    _refuses_without_card(monkeypatch, pc, "-d", str(LOG))
