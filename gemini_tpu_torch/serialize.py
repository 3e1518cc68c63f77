"""ark-serialize-compatible byte encodings (uncompressed + compressed).

Encodings follow arkworks-0.4 `CanonicalSerialize`:
  * Fp (Fr/Fq): little-endian bytes of the canonical integer
    (32 bytes for Fr, 48 for Fq).
  * Fq2: c0 then c1.
  * Short-Weierstrass affine, uncompressed: x || y, with the flags byte
    OR'd into the most-significant (= last LE) byte of y.
    Infinity flag = 1 << 6; infinity serializes as x = y = 0 + flag.
  * Compressed: x only, flags in the last byte: infinity = 1 << 6,
    "y is negative" (y > (q-1)/2) = 1 << 7.

These are what the reference feeds the transcript via
`serialize_uncompressed` (reference src/transcript.rs:21-23).

Proof (de)serialization for both SNARKs is at the end.  Unlike
gemini_tpu's copy, `g1_from_compressed` refuses a point that is on the
curve but outside the order-r subgroup, and `g1_from_uncompressed`
refuses a malformed encoding, a point off the curve and one outside the
subgroup.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .hostcurve import g1_mul, g1_neg
from .params import B_G1, Q, R
from .refimpl.fields import Fq2

_INF_FLAG = 1 << 6
_NEG_FLAG = 1 << 7


def fr_to_bytes(x: int) -> bytes:
    return (x % R).to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= R:
        raise ValueError("non-canonical Fr encoding")
    return v


def fq_to_bytes(x: int) -> bytes:
    return (x % Q).to_bytes(48, "little")


def fq_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= Q:
        raise ValueError("non-canonical Fq encoding")
    return v


def g1_uncompressed(p: Optional[Tuple[int, int]]) -> bytes:
    if p is None:
        y = bytearray(48)
        y[-1] |= _INF_FLAG
        return bytes(48) + bytes(y)
    x, y = p
    return fq_to_bytes(x) + fq_to_bytes(y)


def g1_from_uncompressed(b: bytes) -> Optional[Tuple[int, int]]:
    """The point g1_uncompressed encodes.  Raises DeserializationError
    on a length other than 96, the sign flag (which only the compressed
    encoding carries), a nonzero coordinate under the infinity flag, a
    coordinate >= q, a point off y^2 = x^3 + 4, or one outside the
    order-r subgroup."""
    if len(b) != 96:
        raise DeserializationError("uncompressed G1 must be 96 bytes")
    xb, yb = b[:48], bytearray(b[48:])
    flags = yb[-1] & 0xC0
    yb[-1] &= 0x3F
    if flags & _NEG_FLAG:
        raise DeserializationError("sign flag on an uncompressed G1 point")
    if flags & _INF_FLAG:
        if any(xb) or any(yb):
            raise DeserializationError("nonzero coordinates with infinity flag")
        return None
    try:
        x, y = fq_from_bytes(xb), fq_from_bytes(bytes(yb))
    except ValueError as e:
        raise DeserializationError(str(e))
    if (y * y - x * x * x - B_G1) % Q:
        raise DeserializationError("point not on the curve")
    if not _in_subgroup((x, y)):
        raise DeserializationError("point not in the order-r subgroup")
    return (x, y)


def g1_compressed(p: Optional[Tuple[int, int]]) -> bytes:
    if p is None:
        x = bytearray(48)
        x[-1] |= _INF_FLAG
        return bytes(x)
    x, y = p
    out = bytearray(fq_to_bytes(x))
    if y > (Q - 1) // 2:
        out[-1] |= _NEG_FLAG
    return bytes(out)


def g2_uncompressed(p) -> bytes:
    if p is None:
        y = bytearray(96)
        y[-1] |= _INF_FLAG
        return bytes(96) + bytes(y)
    x, y = p
    xb = fq_to_bytes(x.c0.n) + fq_to_bytes(x.c1.n)
    yb = fq_to_bytes(y.c0.n) + fq_to_bytes(y.c1.n)
    return xb + yb


def usize_to_bytes(n: int) -> bytes:
    return n.to_bytes(8, "little")


# ---------------------------------------------------------------------------
# Typed wrappers so heterogeneous protocol messages can go through one
# `append_serializable` entry point (transcript.py).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScalarMsg:
    value: int  # Fr


@dataclass(frozen=True)
class G1Msg:
    point: Optional[Tuple[int, int]]


@dataclass(frozen=True)
class G2Msg:
    point: object


@dataclass(frozen=True)
class UsizeMsg:
    value: int


def serialize_uncompressed(obj) -> bytes:
    if isinstance(obj, ScalarMsg):
        return fr_to_bytes(obj.value)
    if isinstance(obj, G1Msg):
        return g1_uncompressed(obj.point)
    if isinstance(obj, G2Msg):
        return g2_uncompressed(obj.point)
    if isinstance(obj, UsizeMsg):
        return usize_to_bytes(obj.value)
    if isinstance(obj, (list, tuple)):
        # ark-serialize Vec<T>: u64 length prefix then elements.
        body = b"".join(serialize_uncompressed(o) for o in obj)
        return usize_to_bytes(len(obj)) + body
    raise TypeError(f"cannot ark-serialize {type(obj)!r}")


# ---------------------------------------------------------------------------
# Proof serialization (ark CanonicalSerialize layout: compressed points
# are 48 bytes, scalars 32, Vec<T> gets a u64 length prefix).  Used for
# the `compressed_size()` reporting of examples/snark.rs:96.
# ---------------------------------------------------------------------------


def _sumcheck_msgs_bytes(msgs) -> bytes:
    rounds, finals = msgs
    out = usize_to_bytes(len(rounds))
    for (a, b) in rounds:
        out += fr_to_bytes(a) + fr_to_bytes(b)
    out += usize_to_bytes(len(finals))
    for (a, b) in finals:
        out += fr_to_bytes(a) + fr_to_bytes(b)
    return out


def _tensorcheck_bytes(tc) -> bytes:
    out = usize_to_bytes(len(tc.folded_polynomials_commitments))
    for c in tc.folded_polynomials_commitments:
        out += g1_compressed(c)
    out += usize_to_bytes(len(tc.folded_polynomials_evaluations))
    for (a, b) in tc.folded_polynomials_evaluations:
        out += fr_to_bytes(a) + fr_to_bytes(b)
    out += g1_compressed(tc.evaluation_proof)
    # Vec<[F; 3]> — u64 length prefix then 3 scalars per entry
    # (tensorcheck/mod.rs:119-120; fixed-size arrays have no prefix).
    out += usize_to_bytes(len(tc.base_polynomials_evaluations))
    for evs in tc.base_polynomials_evaluations:
        assert len(evs) == 3
        for e in evs:
            out += fr_to_bytes(e)
    return out


def snark_proof_bytes(proof) -> bytes:
    """snark::Proof CanonicalSerialize (snark/mod.rs:76-82)."""
    return (
        g1_compressed(proof.witness_commitment)
        + fr_to_bytes(proof.zc_alpha)
        + _sumcheck_msgs_bytes(proof.first_sumcheck_msgs)
        + _sumcheck_msgs_bytes(proof.second_sumcheck_msgs)
        + _tensorcheck_bytes(proof.tensorcheck_proof)
    )


def psnark_proof_bytes(proof) -> bytes:
    """psnark::Proof CanonicalSerialize (psnark/mod.rs:29-51)."""
    out = g1_compressed(proof.witness_commitment)
    out += fr_to_bytes(proof.zc_alpha)
    out += _sumcheck_msgs_bytes(proof.first_sumcheck_msgs)
    for c in proof.r_star_commitments:
        out += g1_compressed(c)
    out += g1_compressed(proof.z_star_commitment)
    out += _sumcheck_msgs_bytes(proof.second_sumcheck_msgs)
    for s in (proof.set_r_ep, proof.subset_r_ep):
        out += fr_to_bytes(s)
    out += g1_compressed(proof.sorted_r_commitment)
    for s in (proof.set_alpha_ep, proof.subset_alpha_ep):
        out += fr_to_bytes(s)
    out += g1_compressed(proof.sorted_alpha_commitment)
    for s in (proof.set_z_ep, proof.subset_z_ep):
        out += fr_to_bytes(s)
    out += g1_compressed(proof.sorted_z_commitment)
    out += usize_to_bytes(len(proof.ep_msgs.acc_v_commitments))
    for c in proof.ep_msgs.acc_v_commitments:
        out += g1_compressed(c)
    out += usize_to_bytes(len(proof.ep_msgs.claimed_sumchecks))
    for s in proof.ep_msgs.claimed_sumchecks:
        out += fr_to_bytes(s)
    out += usize_to_bytes(len(proof.ralpha_star_acc_mu_evals))
    for s in proof.ralpha_star_acc_mu_evals:
        out += fr_to_bytes(s)
    out += g1_compressed(proof.ralpha_star_acc_mu_proof)
    for s in proof.rstars_vals:
        out += fr_to_bytes(s)
    out += _sumcheck_msgs_bytes(proof.third_sumcheck_msgs)
    out += _tensorcheck_bytes(proof.tensorcheck_proof)
    return out


# ---------------------------------------------------------------------------
# Proof deserialization (bytes -> Proof), the CanonicalDeserialize analog
# (snark/mod.rs:75, psnark/mod.rs:28).  Compressed G1 points are
# decompressed: y = sqrt(x^3 + 4) with the sign picked by the 1<<7 flag
# (q = 3 mod 4, so sqrt = a^((q+1)/4)), then checked to lie in the
# order-r subgroup.
# ---------------------------------------------------------------------------


class DeserializationError(ValueError):
    pass


def _fq_sqrt(a: int):
    r = pow(a, (Q + 1) // 4, Q)
    if r * r % Q != a % Q:
        return None
    return r


def _in_subgroup(p: Tuple[int, int]) -> bool:
    """r·P = O, tested as (r-1)·P = -P (the native backend reduces
    scalars mod r, so it cannot be handed r itself)."""
    return g1_mul(p, R - 1) == g1_neg(p)


def g1_from_compressed(b: bytes) -> Optional[Tuple[int, int]]:
    if len(b) != 48:
        raise DeserializationError("compressed G1 must be 48 bytes")
    xb = bytearray(b)
    flags = xb[-1] & 0xC0
    xb[-1] &= 0x3F
    if flags & _INF_FLAG:
        if any(xb):
            raise DeserializationError("nonzero x with infinity flag")
        return None
    try:
        x = fq_from_bytes(bytes(xb))
    except ValueError as e:
        raise DeserializationError(str(e))
    y = _fq_sqrt((x * x % Q * x + 4) % Q)
    if y is None:
        raise DeserializationError("x not on curve")
    y_neg = y > (Q - 1) // 2
    if bool(flags & _NEG_FLAG) != y_neg:
        y = Q - y
    if not _in_subgroup((x, y)):
        raise DeserializationError("point not in the order-r subgroup")
    return (x, y)


class _Reader:
    def __init__(self, b: bytes):
        self.b = b
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.b):
            raise DeserializationError("truncated proof")
        out = self.b[self.off:self.off + n]
        self.off += n
        return out

    def fr(self) -> int:
        try:
            return fr_from_bytes(self.take(32))
        except ValueError as e:
            raise DeserializationError(str(e))

    def g1c(self):
        return g1_from_compressed(self.take(48))

    def usize(self) -> int:
        n = int.from_bytes(self.take(8), "little")
        # Sanity bound: no real proof carries 2^32 elements.
        if n > 1 << 32:
            raise DeserializationError("implausible vector length")
        return n

    def done(self):
        if self.off != len(self.b):
            raise DeserializationError(f"{len(self.b) - self.off} trailing bytes")


def _sumcheck_msgs_read(r: _Reader):
    rounds = [(r.fr(), r.fr()) for _ in range(r.usize())]
    finals = [(r.fr(), r.fr()) for _ in range(r.usize())]
    return (rounds, finals)


def _tensorcheck_read(r: _Reader):
    from .subprotocols.tensorcheck import TensorcheckProof

    fpc = [r.g1c() for _ in range(r.usize())]
    fpe = [(r.fr(), r.fr()) for _ in range(r.usize())]
    ep = r.g1c()
    bpe = [(r.fr(), r.fr(), r.fr()) for _ in range(r.usize())]
    return TensorcheckProof(
        folded_polynomials_commitments=fpc,
        folded_polynomials_evaluations=fpe,
        evaluation_proof=ep,
        base_polynomials_evaluations=bpe,
    )


def snark_proof_from_bytes(b: bytes):
    """bytes -> snark.Proof (inverse of snark_proof_bytes)."""
    from .snark.proof import Proof

    r = _Reader(b)
    proof = Proof(
        witness_commitment=r.g1c(),
        zc_alpha=r.fr(),
        first_sumcheck_msgs=_sumcheck_msgs_read(r),
        second_sumcheck_msgs=_sumcheck_msgs_read(r),
        tensorcheck_proof=_tensorcheck_read(r),
    )
    r.done()
    return proof


def psnark_proof_from_bytes(b: bytes):
    """bytes -> psnark.Proof (inverse of psnark_proof_bytes)."""
    from .psnark.proof import Proof
    from .subprotocols.entry_product import ProverMsgs as EpMsgs

    r = _Reader(b)
    witness_commitment = r.g1c()
    zc_alpha = r.fr()
    first = _sumcheck_msgs_read(r)
    r_star_commitments = [r.g1c() for _ in range(3)]
    z_star_commitment = r.g1c()
    second = _sumcheck_msgs_read(r)
    set_r_ep, subset_r_ep = r.fr(), r.fr()
    sorted_r_commitment = r.g1c()
    set_alpha_ep, subset_alpha_ep = r.fr(), r.fr()
    sorted_alpha_commitment = r.g1c()
    set_z_ep, subset_z_ep = r.fr(), r.fr()
    sorted_z_commitment = r.g1c()
    acc_v_commitments = [r.g1c() for _ in range(r.usize())]
    claimed_sumchecks = [r.fr() for _ in range(r.usize())]
    ralpha_star_acc_mu_evals = [r.fr() for _ in range(r.usize())]
    ralpha_star_acc_mu_proof = r.g1c()
    rstars_vals = [r.fr(), r.fr()]
    third = _sumcheck_msgs_read(r)
    tc = _tensorcheck_read(r)
    r.done()
    return Proof(
        witness_commitment=witness_commitment,
        zc_alpha=zc_alpha,
        first_sumcheck_msgs=first,
        r_star_commitments=r_star_commitments,
        z_star_commitment=z_star_commitment,
        second_sumcheck_msgs=second,
        set_r_ep=set_r_ep,
        subset_r_ep=subset_r_ep,
        sorted_r_commitment=sorted_r_commitment,
        set_alpha_ep=set_alpha_ep,
        subset_alpha_ep=subset_alpha_ep,
        sorted_alpha_commitment=sorted_alpha_commitment,
        set_z_ep=set_z_ep,
        subset_z_ep=subset_z_ep,
        sorted_z_commitment=sorted_z_commitment,
        ep_msgs=EpMsgs(acc_v_commitments, claimed_sumchecks),
        ralpha_star_acc_mu_evals=ralpha_star_acc_mu_evals,
        ralpha_star_acc_mu_proof=ralpha_star_acc_mu_proof,
        rstars_vals=rstars_vals,
        third_sumcheck_msgs=third,
        tensorcheck_proof=tc,
    )
