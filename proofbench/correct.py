"""Deciding `correct`: the proofs the window produced against those of
the configuration's plain reference (`reference/<reference>.py`, named by
its key `reference`), on the same statement and key, which the driver's
`inputs` makes from the seed.

Proofs are compared part by part (commitments and openings from the MSM
pipeline; sumcheck messages and final foldings; evaluations) and byte by
byte.  Each number is a count of things that differ, and each limit is
0: the proof of a statement under a key is one exact byte string.
"""

from __future__ import annotations

import random
from types import ModuleType
from typing import Dict, List


def mismatches(port_parts: dict, ref_parts: dict, port_bytes: bytes,
               ref_bytes: bytes) -> Dict[str, int]:
    out = {}
    for part in ("commitments", "sumchecks", "evaluations"):
        a, b = port_parts[part], ref_parts[part]
        out[part] = sum(1 for x, y in zip(a, b) if x != y) + abs(len(a) - len(b))
    out["bytes"] = sum(1 for x, y in zip(port_bytes, ref_bytes) if x != y) + \
        abs(len(port_bytes) - len(ref_bytes))
    return out


def sample(done: List[int], k: int, seed: int) -> List[int]:
    """Up to k job indices of `done`, drawn from the seed."""
    if len(done) <= k:
        return sorted(done)
    return sorted(random.Random(seed).sample(sorted(done), k))


def reference_proof(reference: ModuleType, statement, key):
    """The parts and bytes of `reference`'s proof of the statement."""
    p = reference.prove(statement, key)
    return reference.parts(p), reference.proof_bytes(p)


def tally(rows: List[Dict[str, int]]) -> Dict[str, int]:
    keys = ("commitments", "sumchecks", "evaluations", "bytes")
    return {k: sum(r[k] for r in rows) for k in keys}
