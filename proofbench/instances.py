"""The benchmark's inputs, made from the run's seed.

Every input of a run comes from `derive(seed, purpose, ...)`, a SHA-256
of the seed and a label, so the same seed gives the same inputs and any
whole number is a seed.  Instances are made here and handed alike to the
program (as the ints its constructors take) and to the reference (as
limb tensors it builds itself).
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch

from .reference import fr, g1
from .reference.fr import R
from .reference.snark import Key, Statement, diagonal


def derive(seed: int, *labels) -> int:
    """A 64-bit sub-seed of `seed` for one purpose."""
    text = "/".join([str(int(seed))] + [str(x) for x in labels])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")


def nonzero_scalars(sub_seed: int, n: int) -> list:
    """n uniform elements of Fr \\ {0}: 255-bit draws, the ones at or
    above r (or zero) drawn again, in order."""
    gen = np.random.Generator(np.random.PCG64(sub_seed))
    r_words = [(R >> (64 * k)) & (2 ** 64 - 1) for k in range(4)]
    out: list = []
    while len(out) < n:
        need = n - len(out)
        w = gen.integers(0, 2 ** 64, size=(need + need // 8 + 16, 4), dtype=np.uint64,
                         endpoint=False)
        w[:, 3] &= np.uint64(2 ** 63 - 1)
        below = np.zeros(len(w), dtype=bool)  # w < r, compared from the top word
        equal = np.ones(len(w), dtype=bool)
        for k in (3, 2, 1, 0):
            rk = np.uint64(r_words[k])
            below |= equal & (w[:, k] < rk)
            equal &= w[:, k] == rk
        keep = below & w.any(axis=1)
        obj = w[keep].astype(object)
        vals = (obj[:, 3] << 192) | (obj[:, 2] << 128) | (obj[:, 1] << 64) | obj[:, 0]
        out.extend(vals[:need].tolist())
    return out


class DiagonalInstance:
    """A z o B z = C z with A = diag(a), B = diag(b), C = diag(c), a, b, z
    uniform nonzero and c = a o b o z, so that (a z)(b z) = c z; one
    public input (x = z_0), the reference's diagonal sparsity (one entry
    a row in each matrix, circuit.rs:349-365)."""

    def __init__(self, seed: int, index: int, n: int):
        self.n = n
        self.a = nonzero_scalars(derive(seed, "instance", index, "a"), n)
        self.b = nonzero_scalars(derive(seed, "instance", index, "b"), n)
        self.z = nonzero_scalars(derive(seed, "instance", index, "z"), n)
        a, b, z = (np.array(v, dtype=object) for v in (self.a, self.b, self.z))
        self.c = (a * b % R * z % R).tolist()

    def is_satisfied(self) -> bool:
        return all((a * z % R) * (b * z % R) % R == c * z % R
                   for a, b, c, z in zip(self.a, self.b, self.c, self.z))

    def statement(self, device) -> Statement:
        a, b, c, z = (fr.from_canonical(_limbs(v, device))
                      for v in (self.a, self.b, self.c, self.z))
        return Statement(diagonal(a), diagonal(b), diagonal(c), z, 1)


class DummyInstance:
    """The reference's giant-instance relation (circuit.rs:349-365,
    iterable/dummy.rs:220-238): z = (e, ..., e), A = B = C = diag(1/e)."""

    def __init__(self, seed: int, index: int, n: int):
        self.n = n
        self.e = random.Random(derive(seed, "instance", index, "e")).randrange(1, R)

    def statement(self, device) -> Statement:
        inv = fr.scalar(pow(self.e, -1, R), device).expand(fr.LIMBS, self.n)
        m = diagonal(inv)
        z = fr.scalar(self.e, device).expand(fr.LIMBS, self.n)
        return Statement(m, m, m, z, 1)


def _limbs(values: list, device) -> torch.Tensor:
    buf = b"".join(v.to_bytes(32, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), 16).T
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def key_seed(seed: int) -> int:
    return derive(seed, "key")


def time_key(seed: int) -> Key:
    """The trapdoor of `CommitterKey.new(..., seed=key_seed(seed))`: the
    test setup draws tau and then g's scalar from random.Random(seed)
    (kzg/time.rs:49-72)."""
    rng = random.Random(key_seed(seed))
    tau = rng.randrange(1, R)
    return Key(tau, g1.mul(g1.G1, rng.randrange(1, R)))


def fake_key(seed: int) -> Key:
    """The constant-base key of the reference's giant instances
    (examples/snark.rs:55-67): every power is g, a trapdoor tau = 1,
    with g's scalar drawn first from random.Random(seed)."""
    rng = random.Random(key_seed(seed))
    return Key(1, g1.mul(g1.G1, rng.randrange(1, R)))
