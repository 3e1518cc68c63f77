"""herring parity: the port's host-only copy of gemini_tpu/herring (module
sumchecks, the pairing-based inner-product argument, the CRS streams)
against gemini_tpu on the same seeded inputs.

herring runs on the host in both packages (no device path, no JAX), so
every comparison is of Python integers and curve points, made exact by
`_plain`, which reduces field elements, points and GT elements to
nested tuples of integers.  Sizes are tests/test_herring.py's: the
pairing work of the IPA at d = 8 costs about 10 s per package here.  At
most 3 collected cases (ROADMAP.md, tier-1 rule).
"""

import copy
import random

import pytest
import torch

from gemini_tpu import herring as jh
from gemini_tpu.herring import space as jspace
from gemini_tpu.transcript import GeminiTranscript as JTranscript
from gemini_tpu_torch import herring as th
from gemini_tpu_torch.herring import space as tspace
from gemini_tpu_torch.herring.ipa import HerringVerificationError
from gemini_tpu_torch.params import R
from gemini_tpu_torch.refimpl import g1_generator, g1_mul, g2_generator, g2_mul
from gemini_tpu_torch.transcript import GeminiTranscript

torch.set_num_threads(1)


def _plain(x):
    """Field elements, points, GT and containers -> nested int tuples."""
    if x is None or isinstance(x, int):
        return x
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if hasattr(x, "v"):  # GT
        return ("gt", _plain(x.v))
    if hasattr(x, "n"):  # Fq / Fr
        return x.n
    if hasattr(x, "c2"):
        return (_plain(x.c0), _plain(x.c1), _plain(x.c2))
    if hasattr(x, "c0"):
        return (_plain(x.c0), _plain(x.c1))
    raise TypeError(type(x))


def _run(prover, rng):
    """All messages and the final foldings, with challenges from rng."""
    msgs, r = [], None
    while (m := prover.next_message(r)) is not None:
        msgs.append(_plain(m))
        r = rng.randrange(R)
    return msgs, _plain(prover.final_foldings())


def _transcripts(pkg_time, pkg_space, pkg_elastic, witness, seed):
    out = []
    for make in (pkg_time, pkg_space, pkg_elastic):
        out.append(_run(make(witness), random.Random(seed)))
    return out


def test_module_sumchecks_match_gemini_tpu():
    """FModule (twisted, ragged and odd lengths) and G1Module/G2Module
    witnesses through the time, space and elastic provers: every message
    and final folding equals gemini_tpu's, and the three provers agree."""
    rnd = random.Random(71)
    G, H = g1_generator(), g2_generator()
    cases = []
    for nf, ng, twist in ((8, 8, 1), (8, 8, 5), (7, 5, 9), (16, 16, 7)):
        f = [rnd.randrange(R) for _ in range(nf)]
        g = [rnd.randrange(R) for _ in range(ng)]
        cases.append(("FModule", f, g, twist))
    pts1 = [g1_mul(G, rnd.randrange(1, R)) for _ in range(4)]
    pts2 = [g2_mul(H, rnd.randrange(1, R)) for _ in range(4)]
    sc = [rnd.randrange(R) for _ in range(4)]
    cases += [("G1Module", pts1, sc, 1), ("G2Module", sc, pts2, 1)]
    for k, (mod, f, g, twist) in enumerate(cases):
        runs = []
        for pkg, sp in ((th, tspace), (jh, jspace)):
            module = getattr(pkg, mod)
            runs.append(_transcripts(
                pkg.ModuleTimeProver, sp.ModuleSpaceProver,
                lambda w, sp=sp: sp.ModuleElasticProver(w, threshold=2),
                pkg.ModuleWitness(module, f, g, twist), seed=100 + k))
        port, ref = runs
        assert port == ref, (mod, k)
        assert port[0] == port[1] == port[2], (mod, k)
        assert len(port[0][0]) > 0


def test_ipa_matches_gemini_tpu():
    """InnerProductProof.new on the same CRS and transcript: every proof
    field equals gemini_tpu's; the port verifies its proof; a wrong
    claimed product and a tampered folding raise
    HerringVerificationError."""
    d, n = 8, 4
    rnd = random.Random(72)
    a = [rnd.randrange(R) for _ in range(n)]
    b = [rnd.randrange(R) for _ in range(n)]
    y = sum(x * z for x, z in zip(a, b)) % R

    crs = th.Crs.new(random.Random(73), d)
    jcrs = jh.Crs.new(random.Random(73), d)
    assert _plain(crs.g1s) == _plain(jcrs.g1s)
    assert _plain(crs.g2s) == _plain(jcrs.g2s)
    proof = th.InnerProductProof.new(GeminiTranscript(b"GEMINI-v0"), crs, a, b)
    jproof = jh.InnerProductProof.new(JTranscript(b"GEMINI-v0"), jcrs, a, b)
    for field in ("batch_challenges", "foldings_ff", "foldings_fg1",
                  "foldings_fg2"):
        assert _plain(getattr(proof, field)) == _plain(getattr(jproof, field)), field
    for field in ("messages", "challenges", "rounds", "final_foldings"):
        assert _plain(getattr(proof.sumcheck, field)) == \
            _plain(getattr(jproof.sumcheck, field)), field

    vrs = th.Vrs.from_crs(crs)
    comm_a, comm_b = crs.commit_g1(a), crs.commit_g2(b)
    proof.verify_transcript(vrs, comm_a, comm_b, y)
    with pytest.raises(HerringVerificationError):
        proof.verify_transcript(vrs, comm_a, comm_b, (y + 1) % R)
    bad = copy.deepcopy(proof)
    ff0, ff1 = bad.foldings_ff[0]
    bad.foldings_ff[0] = ((ff0 + 1) % R, ff1)
    with pytest.raises(HerringVerificationError):
        bad.verify_transcript(vrs, comm_a, comm_b, y)


def test_crs_stream_and_folded_stream_match():
    """CrsStream commits, truncations and halvings equal the dense Crs
    and gemini_tpu's; folded_stream equals gemini_tpu's on ragged
    lengths and depths, and a dense fold of the same vector."""
    rnd = random.Random(74)
    crs = th.Crs.new(random.Random(5), 9)
    jcrs = jh.Crs.new(random.Random(5), 9)
    stream = th.CrsStream(crs.g1s, crs.g2s)
    jstream = jh.CrsStream(jcrs.g1s, jcrs.g2s)
    sc = [rnd.randrange(R) for _ in range(8)]
    assert stream.commit_g1(sc) == crs.commit_g1(sc)
    assert stream.commit_g2(sc) == crs.commit_g2(sc)
    assert _plain(stream.commit_g1(sc)) == _plain(jstream.commit_g1(sc))
    assert _plain(stream.commit_g2(sc)) == _plain(jstream.commit_g2(sc))
    t = stream.truncate(2)
    assert t.materialize().g1s == crs.truncate(2).g1s
    h = t.halve()
    assert h.materialize().g2s == crs.truncate(2).halve().g2s
    assert _plain(h.materialize().g2s) == \
        _plain(jstream.truncate(2).halve().materialize().g2s)

    add = lambda u, v: (u + v) % R
    smul = lambda u, s: u * s % R
    for n in (1, 5, 8, 13, 16):
        v = [rnd.randrange(R) for _ in range(n)]
        for depth in range(4):
            ch = [rnd.randrange(R) for _ in range(depth)]
            got = list(th.folded_stream(iter(v), ch, add, smul))
            assert got == list(jh.folded_stream(iter(v), ch, add, smul)), (n, depth)
            dense = list(v)
            for r in ch:
                dense = [(dense[i] + r * (dense[i + 1] if i + 1 < len(dense) else 0))
                         % R for i in range(0, len(dense), 2)]
            assert got == dense, (n, depth)
