"""The Gemini non-preprocessing SNARK proof, worked out in plain PyTorch
from the statement and the key's trapdoor.

What the proof is follows arkworks-rs/gemini (`snark/time_prover.rs`,
`subprotocols/sumcheck`, `subprotocols/tensorcheck`, `kzg/time.rs`) and
its transcript order.  Every O(n) step is an Fr vector operation of
`fr.py`.  A KZG commitment to p is p(tau) * g, and the batched opening
at three points is q(tau) * g with q = (F - I) / Z, where F is the
batched polynomial, Z the vanishing polynomial of the points and I the
interpolant of F's values there: the quotient of the prover's chained
synthetic divisions, without a multi-scalar multiplication.  The key is
a test key with a known trapdoor (`Key`), so each group element of the
proof is one scalar multiplication of g on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from . import fr, g1
from .fr import R
from .transcript import GeminiTranscript


@dataclass
class Key:
    """A KZG key's trapdoor tau and its base point g (powers_of_g[i] =
    tau^i g)."""

    tau: int
    g: g1.Point

    def commit_value(self, value: int) -> g1.Point:
        return g1.mul(self.g, value % R)


@dataclass
class Matrix:
    """COO matrix over Fr: rows, cols int64 (nnz,), vals (16, nnz)
    Montgomery."""

    n_rows: int
    n_cols: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor


@dataclass
class Statement:
    """A z o B z = C z with z = (x, w); z (16, n) Montgomery."""

    a: Matrix
    b: Matrix
    c: Matrix
    z: torch.Tensor
    num_inputs: int


@dataclass
class Proof:
    """The fields of snark::Proof (snark/mod.rs:76-82) and of its
    TensorcheckProof, as ints and affine points."""

    witness_commitment: g1.Point
    zc_alpha: int
    first_msgs: List[Tuple[int, int]]
    first_final: Tuple[int, int]
    second_msgs: List[Tuple[int, int]]
    second_final: Tuple[int, int]
    folded_commitments: List[g1.Point]
    folded_evaluations: List[Tuple[int, int]]
    evaluation_proof: g1.Point
    base_evaluations: List[Tuple[int, int, int]]


def diagonal(vals: torch.Tensor) -> Matrix:
    n = vals.shape[1]
    idx = torch.arange(n, dtype=torch.int64, device=vals.device)
    return Matrix(n, n, idx, idx, vals)


def _segment_sum(v: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Sums of the elements of v by segment id: exact limb sums, carried,
    then reduced by as many subtractions of r as a segment has terms."""
    dev = v.device
    acc = torch.zeros((fr.LIMBS + 1, n), dtype=torch.int64, device=dev)
    acc[:fr.LIMBS].index_add_(1, seg, v.to(torch.int64))
    terms = int(torch.bincount(seg, minlength=n).max().item()) if seg.numel() else 0
    for k in range(fr.LIMBS):
        acc[k + 1] += acc[k] >> 16
        acc[k] &= fr.MASK
    limbs, top = acc[:fr.LIMBS], acc[fr.LIMBS]
    p = fr.limbs_of(R)
    for _ in range(max(terms - 1, 0)):
        d = torch.empty_like(limbs)
        borrow = torch.zeros_like(top)
        for k in range(fr.LIMBS):
            t = limbs[k] - p[k] - borrow
            borrow = (t < 0).to(torch.int64)
            d[k] = t + (borrow << 16)
        keep = (top - borrow) < 0
        limbs = torch.where(keep.unsqueeze(0), limbs, d)
        top = torch.where(keep, top, top - borrow)
    return limbs.to(torch.int32)


def matvec(m: Matrix, x: torch.Tensor) -> torch.Tensor:
    return _segment_sum(fr.mont_mul(m.vals, x[:, m.cols]), m.rows, m.n_rows)


def rmatvec(m: Matrix, r: torch.Tensor) -> torch.Tensor:
    return _segment_sum(fr.mont_mul(m.vals, r[:, m.rows]), m.cols, m.n_cols)


def _fr_bytes(x: int) -> bytes:
    return (x % R).to_bytes(32, "little")


def _rounds(n: int) -> int:
    return 0 if n <= 1 else (n - 1).bit_length()


def sumcheck(tr: GeminiTranscript, f: torch.Tensor, g: torch.Tensor,
             twist: int):
    """Twisted scalar-product sumcheck <f o (1, t, t^2, ...), g>
    (subprotocols/sumcheck/time_prover.rs): per round the two low
    coefficients (a, b) of the partial-sum polynomial, then the fold
    f' = f_e + r t f_o, g' = g_e + r g_o, t' = t^2.  Returns (messages,
    challenges, (f0, g0))."""
    rounds = _rounds(max(f.shape[1], g.shape[1]))
    n = max(1 << rounds, 2)
    f, g = fr.pad(f, n), fr.pad(g, n)
    twist %= R
    tpow = fr.powers(twist * twist % R, max(n // 2, 1), f.device)
    msgs, chs = [], []
    for _ in range(rounds):
        fe, fo = fr.even_odd(f)
        ge, go = fr.even_odd(g)
        a = fr.dot(fr.mont_mul(fe, ge), tpow)
        cross = fr.add(fr.mont_mul(fe, go),
                       fr.mul_scalar(fr.mont_mul(ge, fo), twist))
        b = fr.dot(cross, tpow)
        tr.append_message(b"evaluations", _fr_bytes(a) + _fr_bytes(b))
        r = tr.get_challenge(b"challenge")
        msgs.append((a, b))
        chs.append(r)
        f = fr.add(fe, fr.mul_scalar(fo, r * twist % R))
        g = fr.add(ge, fr.mul_scalar(go, r))
        tpow = tpow[:, 0::2]
        twist = twist * twist % R
    final = (fr.to_ints(f[:, :1])[0], fr.to_ints(g[:, :1])[0])
    tr.append_message(b"final-folding", _fr_bytes(final[0]))
    tr.append_message(b"final-folding", _fr_bytes(final[1]))
    return msgs, chs, final


def _interpolate_at(xs: Sequence[int], ys: Sequence[int], t: int) -> int:
    """The value at t of the polynomial of degree < len(xs) through
    (xs, ys) (Lagrange)."""
    out = 0
    for j, (xj, yj) in enumerate(zip(xs, ys)):
        num, den = 1, 1
        for k, xk in enumerate(xs):
            if k != j:
                num = num * (t - xk) % R
                den = den * (xj - xk) % R
        out = (out + yj * num * pow(den, -1, R)) % R
    return out


def _ip_prefix(p: torch.Tensor, pw: torch.Tensor) -> int:
    return fr.dot(p, pw[:, :p.shape[1]])


def _same(v: torch.Tensor) -> torch.Tensor:
    return v


def tensorcheck(tr: GeminiTranscript, key: Key, w: torch.Tensor,
                body: Sequence[torch.Tensor], challenges: Sequence[int],
                commit_filter=_same):
    """Tensorcheck of one instance (subprotocols/tensorcheck/mod.rs:190-
    275) with base polynomial w: commitments to the foldings of the
    batched body polynomial, evaluations at beta^2, beta, -beta, and the
    batched three-point opening of w and the foldings."""
    dev = w.device
    bc = tr.get_challenge(b"batch_challenge")
    coeffs = [pow(bc, i, R) for i in range(len(body))]
    n = max(p.shape[1] for p in body)
    batched = None
    for p, c in zip(body, coeffs):
        term = fr.mul_scalar(fr.pad(p, n), c)
        batched = term if batched is None else fr.add(batched, term)
    foldings = []
    cur = batched
    for ch in challenges[:-1]:
        if cur.shape[1] % 2:
            cur = fr.pad(cur, cur.shape[1] + 1)
        cur = fr.fold(cur, ch)
        foldings.append(cur)
    top = max([w.shape[1]] + [f.shape[1] for f in foldings])
    tau_pw = fr.powers(key.tau, top, dev)
    at_tau = [_ip_prefix(commit_filter(f), tau_pw) for f in foldings]
    commitments = [key.commit_value(v) for v in at_tau]
    for c in commitments:
        tr.append_message(b"commitment", g1.uncompressed(c))
    beta = tr.get_challenge(b"evaluation-chal")
    points = [beta * beta % R, beta, (-beta) % R]
    pws = [fr.powers(x, top, dev) for x in points]
    base_evals = [tuple(_ip_prefix(w, pw) for pw in pws)]
    fold_vals = [[_ip_prefix(f, pw) for pw in pws] for f in foldings]
    folded_evals = [(v[1], v[2]) for v in fold_vals]
    for evs in base_evals:
        for e in evs:
            tr.append_message(b"eval", _fr_bytes(e))
    for evs in folded_evals:
        for e in evs:
            tr.append_message(b"eval", _fr_bytes(e))
    eta = tr.get_challenge(b"open-chal")
    # F = sum eta^i p_i over (w, foldings...): its values at the points
    # and at tau, then q(tau) = (F(tau) - I(tau)) / Z(tau).
    all_vals = [list(base_evals[0]) + [_ip_prefix(w, tau_pw)]]
    all_vals += [v + [t] for v, t in zip(fold_vals, at_tau)]
    f_at = [0, 0, 0, 0]
    for i, vals in enumerate(all_vals):
        e = pow(eta, i, R)
        f_at = [(acc + e * v) % R for acc, v in zip(f_at, vals)]
    z_tau = 1
    for x in points:
        z_tau = z_tau * (key.tau - x) % R
    i_tau = _interpolate_at(points, f_at[:3], key.tau)
    q_tau = (f_at[3] - i_tau) * pow(z_tau, -1, R) % R
    proof = key.commit_value(q_tau)
    return commitments, folded_evals, proof, base_evals


def prove(st: Statement, key: Key, commit_filter=_same) -> Proof:
    """snark::Proof::new_time (snark/time_prover.rs:19-118).
    `commit_filter` maps a polynomial's coefficients before its
    commitment is worked out: the identity, or a control's fault."""
    dev = st.z.device
    w = st.z[:, st.num_inputs:]
    z_a, z_b, z_c = (matvec(m, st.z) for m in (st.a, st.b, st.c))
    tr = GeminiTranscript()
    wc = key.commit_value(fr.evaluate(commit_filter(w), key.tau))
    tr.append_message(b"witness", g1.uncompressed(wc))
    alpha = tr.get_challenge(b"alpha")
    zc_alpha = fr.evaluate(z_c, alpha)
    tr.append_message(b"zc(alpha)", _fr_bytes(zc_alpha))
    del z_c
    msgs1, chs1, final1 = sumcheck(tr, z_a, z_b, alpha)
    del z_a, z_b
    b_ch = fr.tensor(chs1, dev)
    c_ch = fr.powers(alpha, b_ch.shape[1], dev)
    a_ch = fr.mont_mul(b_ch, c_ch)
    eta = tr.get_challenge(b"eta")
    abc = fr.add(rmatvec(st.a, a_ch), fr.add(
        fr.mul_scalar(rmatvec(st.b, b_ch), eta),
        fr.mul_scalar(rmatvec(st.c, c_ch), eta * eta % R)))
    del a_ch, b_ch, c_ch
    msgs2, chs2, final2 = sumcheck(tr, abc, st.z, 1)
    comms, fevals, eproof, bevals = tensorcheck(tr, key, w, [abc, st.z], chs2,
                                                commit_filter)
    return Proof(wc, zc_alpha, msgs1, final1, msgs2, final2, comms, fevals,
                 eproof, bevals)


def proof_bytes(p: Proof) -> bytes:
    """CanonicalSerialize of snark::Proof: compressed points, 32-byte
    scalars, u64 length prefixes for vectors (Vec<[F; 3]> has one
    prefix and no per-entry prefix)."""
    def u64(k):
        return k.to_bytes(8, "little")

    def sc(msgs, final):
        out = u64(len(msgs)) + b"".join(_fr_bytes(a) + _fr_bytes(b) for a, b in msgs)
        return out + u64(1) + _fr_bytes(final[0]) + _fr_bytes(final[1])

    out = g1.compressed(p.witness_commitment) + _fr_bytes(p.zc_alpha)
    out += sc(p.first_msgs, p.first_final) + sc(p.second_msgs, p.second_final)
    out += u64(len(p.folded_commitments))
    out += b"".join(g1.compressed(c) for c in p.folded_commitments)
    out += u64(len(p.folded_evaluations))
    out += b"".join(_fr_bytes(a) + _fr_bytes(b) for a, b in p.folded_evaluations)
    out += g1.compressed(p.evaluation_proof)
    out += u64(len(p.base_evaluations))
    out += b"".join(_fr_bytes(e) for evs in p.base_evaluations for e in evs)
    return out


def parts(p: Proof) -> dict:
    """The proof's values by the layer that makes them: commitments and
    openings (MSM pipeline), sumcheck messages and final foldings, and
    evaluations, each a flat list compared item by item."""
    return {
        "commitments": [p.witness_commitment, *p.folded_commitments,
                        p.evaluation_proof],
        "sumchecks": [*p.first_msgs, p.first_final, *p.second_msgs,
                      p.second_final],
        "evaluations": [p.zc_alpha, *p.folded_evaluations,
                        *p.base_evaluations],
    }

