"""Sumcheck round parity: the port's `TimeProver.round_arrays`,
`decode_msg`, fused round and one-readback `Sumcheck.prove_batch`
against gemini_tpu's on the CPU, and the limb contract that the CUDA
round kernels (csrc/sumcheck_kernels.cu) are held to on the card.

On CPU tensors the round runs the kernels' plain versions
(`_round_message_plain`, `_fused_round_plain`, `_fold_plain`);
chip_smoke.py holds the kernels against them bit for bit.  The sizes
are tests/test_torch_snark.py's (f of 64, g of 61; a batch of 64, 16
and 1), so gemini_tpu's compiled round shapes are shared with it.
Tolerance: exact, everywhere.  At most 3 collected cases (ROADMAP.md,
tier-1 rule).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemini_tpu.fields.fp import FR as JFR
from gemini_tpu.ops import poly as jpoly
from gemini_tpu.ops import scan as jscan
from gemini_tpu.subprotocols import sumcheck as jsc
from gemini_tpu.transcript import GeminiTranscript as JTranscript
from gemini_tpu_torch.fields.fp import FR
from gemini_tpu_torch.params import R
from gemini_tpu_torch.streaming.host import HostVector
from gemini_tpu_torch.streaming.sumcheck import ElasticProver as StreamElastic
from gemini_tpu_torch.subprotocols import sumcheck as tsc
from gemini_tpu_torch.transcript import GeminiTranscript

torch.set_num_threads(1)

MONT = FR.mont_r
TWIST = 0x1234567


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _vec(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


def _both(f, g, twist):
    return (jsc.TimeProver(jnp.asarray(JFR.encode(f)), jnp.asarray(JFR.encode(g)),
                           twist),
            tsc.TimeProver(FR.tensor(f, "cpu"), FR.tensor(g, "cpu"), twist))


def _run(prover, challenges):
    """Messages through round_arrays + decode_msg, one challenge after
    each message (the terminal fold included)."""
    msgs, c = [], None
    for nxt in challenges:
        ab = prover.round_arrays(c)
        if ab is None:
            break
        msgs.append(type(prover).decode_msg(ab))
        c = nxt
    assert prover.round_arrays(c) is None
    return msgs, prover.final_foldings()


def test_round_arrays_match_gemini_tpu():
    """round_arrays/decode_msg messages and final foldings equal
    gemini_tpu's under fixed challenges; one fused round equals
    gemini_tpu's `_fused_round_body` (f2, g2 and T' on the logical
    prefix, the message after decoding); a prover started mid-protocol
    (the elastic tail's tot_rounds/round override) gives the fresh
    prover's remaining messages."""
    rng = np.random.default_rng(101)
    f, g = _vec(rng, 64), _vec(rng, 61)
    chals = _vec(rng, 7)
    jp, tp = _both(f, g, TWIST)
    want = _run(jp, chals)
    assert _run(tp, chals) == want
    assert len(want[0]) == 6

    jp, tp = _both(f, g, TWIST)
    assert tsc.TimeProver.decode_msg(tp.round_arrays(None)) == \
        jsc.TimeProver.decode_msg(jp.round_arrays(None))
    r = chals[0]
    tw2 = TWIST * TWIST % R
    jf2, jg2, jt2, jab = jsc._fused_round_cached(
        jp.f, jp.g, jp.t_pow, jpoly.scalar(JFR, r),
        jpoly.scalar(JFR, r * TWIST % R), jpoly.scalar(JFR, tw2),
        jscan.bucket4(32))
    f2, g2, t2, ab = tsc._fused_round_plain(tp.f, tp.g, tp.t_pow, r,
                                            r * TWIST % R, tw2)
    assert f2.shape == g2.shape == (16, 32) and t2.shape == (16, 16)
    for got, ref, n in ((f2, jf2, 32), (g2, jg2, 32), (t2, jt2, 16)):
        assert np.array_equal(got.numpy(), np.asarray(ref)[:, :n].astype(np.int32))
    assert tsc.TimeProver.decode_msg(ab) == jsc.TimeProver.decode_msg(jab)

    # Mid-protocol start: f, g folded once by chals[0] (an integer model
    # of the fold), twist squared, the round counter carried over.
    c0 = chals[0]
    gp = g + [0] * 3
    f1 = [(f[2 * k] + c0 * TWIST * f[2 * k + 1]) % R for k in range(32)]
    g1 = [(gp[2 * k] + c0 * gp[2 * k + 1]) % R for k in range(32)]
    mid = tsc.TimeProver(FR.tensor(f1, "cpu"), FR.tensor(g1, "cpu"), tw2)
    mid.tot_rounds, mid.round = 6, 1
    assert _run(mid, chals[1:]) == (want[0][1:], want[1])


class _NextMessageOnly:
    """A prover seen through next_message alone (no round_arrays)."""

    def __init__(self, p):
        self.p = p

    def rounds(self):
        return self.p.rounds()

    def next_message(self, c):
        return self.p.next_message(c)

    def final_foldings(self):
        return self.p.final_foldings()


def _proof(sc):
    return sc.messages, sc.challenges, sc.rounds, sc.final_foldings


def test_prove_batch_one_readback_per_round():
    """prove_batch over three TimeProvers gives gemini_tpu's messages,
    challenges, final foldings and transcript, reading the round
    messages back once per round that has them (every round but the
    batch's extra last one, where all provers are done); a batch mixing
    TimeProvers with a streaming ElasticProver (HostVector, block 8,
    threshold 2) equals the same batch proved through next_message."""
    rng = np.random.default_rng(103)
    sizes, twists = (64, 16, 1), (7, 1, 3)
    vecs = [(_vec(rng, n), _vec(rng, n)) for n in sizes]
    jt, tt = JTranscript(b"B"), GeminiTranscript(b"B")
    pj = jsc.Sumcheck.prove_batch(jt, [
        jsc.TimeProver(jnp.asarray(JFR.encode(f)), jnp.asarray(JFR.encode(g)), t)
        for (f, g), t in zip(vecs, twists)])
    tsc.reset_readbacks()
    pt = tsc.Sumcheck.prove_batch(tt, [
        tsc.TimeProver(FR.tensor(f, "cpu"), FR.tensor(g, "cpu"), t)
        for (f, g), t in zip(vecs, twists)])
    assert _proof(pt) == _proof(pj)
    assert tt.get_challenge(b"after") == jt.get_challenge(b"after")
    assert pt.rounds == 7
    assert tsc.READBACKS["round_messages"] == pt.rounds - 1

    fs, gs = _vec(rng, 32), _vec(rng, 29)

    def mixed():
        return [tsc.TimeProver(FR.tensor(f, "cpu"), FR.tensor(g, "cpu"), t)
                for (f, g), t in zip(vecs, twists)] + [
            StreamElastic(HostVector.from_ints(fs, device="cpu"),
                          HostVector.from_ints(gs, device="cpu"), 5,
                          block_size=8, threshold=2)]

    ta, tb = GeminiTranscript(b"M"), GeminiTranscript(b"M")
    got = tsc.Sumcheck.prove_batch(ta, mixed())
    want = tsc.Sumcheck.prove_batch(tb, [_NextMessageOnly(p) for p in mixed()])
    assert _proof(got) == _proof(want)
    assert ta.get_challenge(b"after") == tb.get_challenge(b"after")


def _limbs(x, n):
    return [(x >> (16 * i)) & 0xFFFF for i in range(n)]


def test_round_plain_limb_contract():
    """The contract the CUDA round kernels are held to bit for bit on
    the card, on random inputs, on r - 1 everywhere (the largest sums)
    and on one pair: `_round_message_plain` returns (2, 18) limbs below
    2^16 equal to the exact integer sums of the canonical Montgomery
    values of a_k = f[2k] g[2k] T_k and b_k = (f[2k] g[2k+1] + g[2k]
    f[2k+1] twist) T_k; `_fold_plain` returns the canonical limbs of
    f[2k] + r twist f[2k+1] and g[2k] + r g[2k+1]; the fused round is
    the fold, then the message with twist^2 over T_2k."""
    for kind in ("random", "r-1", "n=2"):
        _limb_contract(kind)


def _limb_contract(kind):
    rng = np.random.default_rng(107)
    n = 2 if kind == "n=2" else 64
    if kind == "r-1":
        f = g = t = [R - 1] * n
        twist, r = R - 1, R - 1
    else:
        f, g, t = _vec(rng, n), _vec(rng, n), _vec(rng, n)
        twist, r = _vec(rng, 2)
    T = t[: n // 2]
    ab = tsc._round_message_plain(FR.tensor(f, "cpu"), FR.tensor(g, "cpu"),
                                  FR.tensor(T, "cpu"), twist)
    a = sum(f[2 * k] * g[2 * k] * T[k] % R * MONT % R for k in range(n // 2))
    b = sum((f[2 * k] * g[2 * k + 1] + g[2 * k] * f[2 * k + 1] * twist) * T[k]
            % R * MONT % R for k in range(n // 2))
    assert ab.dtype == torch.int32 and ab.shape == (2, 18)
    assert ab.tolist() == [_limbs(a, 18), _limbs(b, 18)]
    assert tsc.TimeProver.decode_msg(ab) == (a * pow(MONT, -1, R) % R,
                                             b * pow(MONT, -1, R) % R)

    rt = r * twist % R
    f2, g2, t2 = tsc._fold_plain(FR.tensor(f, "cpu"), FR.tensor(g, "cpu"),
                                 FR.tensor(T, "cpu"), r, rt)
    wf = [(f[2 * k] + rt * f[2 * k + 1]) % R for k in range(n // 2)]
    wg = [(g[2 * k] + r * g[2 * k + 1]) % R for k in range(n // 2)]
    assert np.array_equal(f2.numpy(), FR.encode(wf).astype(np.int32))
    assert np.array_equal(g2.numpy(), FR.encode(wg).astype(np.int32))
    assert torch.equal(t2, FR.tensor(T[0::2], "cpu"))
    if n >= 4:
        fused = tsc._fused_round_plain(FR.tensor(f, "cpu"), FR.tensor(g, "cpu"),
                                       FR.tensor(T, "cpu"), r, rt, twist * twist % R)
        want = tsc._round_message_plain(f2, g2, t2, twist * twist % R)
        assert all(torch.equal(x, y) for x, y in zip(fused, (f2, g2, t2, want)))
