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

This module holds the SNARK encoders; the pSNARK proof layout and
proof deserialization belong to later parts of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .params import Q, R
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
    assert len(b) == 96
    ybytes = bytearray(b[48:])
    flags = ybytes[-1] & 0xC0
    ybytes[-1] &= 0x3F
    if flags & _INF_FLAG:
        return None
    return (fq_from_bytes(b[:48]), fq_from_bytes(bytes(ybytes)))


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
