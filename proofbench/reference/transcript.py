"""Merlin transcript (STROBE-128 over Keccak-f[1600]) in pure Python.

A frozen copy of the pure-Python engine of the port's
`gemini_tpu_torch/transcript.py` (Keccak-f, STROBE-128 and the Merlin
framing, which that file writes from the public specifications), taken
when the benchmark was written; only the shorthands at the end are the
benchmark's own.  The port may run a native engine instead; this copy
never does.
"""

from __future__ import annotations

from .fr import R

# ---------------------------------------------------------------------------
# Keccak-f[1600]
# ---------------------------------------------------------------------------

_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(lanes):
    """In-place Keccak-f permutation on a 5x5 list of 64-bit lanes [x][y]."""
    a = lanes
    for rnd in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & _M64 & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= _RC[rnd]
    return a


def _keccak_f_bytes(state: bytearray) -> None:
    """Keccak-f on a 200-byte little-endian state, in place."""
    lanes = [[0] * 5 for _ in range(5)]
    for y in range(5):
        for x in range(5):
            off = 8 * (5 * y + x)
            lanes[x][y] = int.from_bytes(state[off:off + 8], "little")
    keccak_f1600(lanes)
    for y in range(5):
        for x in range(5):
            off = 8 * (5 * y + x)
            state[off:off + 8] = lanes[x][y].to_bytes(8, "little")


# ---------------------------------------------------------------------------
# STROBE-128 (the subset merlin uses: meta-AD, AD, PRF)
# ---------------------------------------------------------------------------

_STROBE_R = 166
_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_M = 1 << 4


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        _keccak_f_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        _keccak_f_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags, "continuation must use same flags"
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = (flags & _FLAG_C) != 0
        if force_f and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)


# ---------------------------------------------------------------------------
# Merlin transcript + Gemini shorthands
# ---------------------------------------------------------------------------


class Transcript:
    """Byte-compatible reimplementation of `merlin::Transcript`."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        data_len = len(message).to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        data_len = n.to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        return self.strobe.prf(n, False)


# Modulus-bit mask used by `Field::from_random_bytes`: the top
# (8*32 - 255) bits of the 32-byte LE value are shaved off before the
# rejection test (ark-ff from_random_bytes_with_flags semantics).
_FR_SHAVE_MASK = (1 << 255) - 1

PROTOCOL_NAME = b"GEMINI-v0"  # lib.rs:74


class GeminiTranscript:
    """Gemini's shorthands (reference src/transcript.rs:15-35): messages
    are appended as ark-serialize uncompressed bytes, challenges are Fr
    elements rejection-sampled from 64-byte PRF outputs (the first 32
    bytes, masked to 255 bits)."""

    def __init__(self, label: bytes = PROTOCOL_NAME):
        self.t = Transcript(label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.t.append_message(label, message)

    def get_challenge(self, label: bytes) -> int:
        while True:
            raw = self.t.challenge_bytes(label, 64)
            candidate = int.from_bytes(raw[:32], "little") & _FR_SHAVE_MASK
            if candidate < R:
                return candidate
