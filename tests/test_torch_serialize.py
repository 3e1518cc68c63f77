"""The port's uncompressed G1 decoder (gemini_tpu_torch/serialize.py
`g1_from_uncompressed`): valid points, the identity among them, decode
as gemini_tpu's decoder decodes them; malformed encodings, points off
the curve and points outside the order-r subgroup raise
`DeserializationError`.  gemini_tpu's decoder validates nothing, so no
invalid input is compared with it.  Host-only, no prover; at most 3
collected cases (ROADMAP.md, tier-1 rule).
"""

import random

import pytest
import torch

from gemini_tpu import serialize as jser
from gemini_tpu_torch import serialize as ser
from gemini_tpu_torch.params import Q, R
from gemini_tpu_torch.refimpl.curve import (g1_generator, g1_is_on_curve, g1_mul,
                                            g1_neg)

torch.set_num_threads(1)

G = g1_generator()


def _enc(x: int, y: int, flags: int = 0) -> bytes:
    """x || y as 48 little-endian bytes each, `flags` OR'd into y's last
    byte (the layout g1_uncompressed writes)."""
    yb = bytearray(y.to_bytes(48, "little"))
    yb[-1] |= flags
    return x.to_bytes(48, "little") + bytes(yb)


def test_valid_points_decode_as_gemini_tpu():
    rnd = random.Random(1117)
    points = [None, G, g1_neg(G)] + [g1_mul(G, rnd.randrange(1, R)) for _ in range(3)]
    for p in points:
        b = ser.g1_uncompressed(p)
        assert b == jser.g1_uncompressed(p)
        assert ser.g1_from_uncompressed(b) == jser.g1_from_uncompressed(b) == p


def test_malformed_encodings_raise():
    x, y = G
    good = _enc(x, y)
    bad = [good[:95], good + b"\0",  # lengths
           _enc(x, y, 0x80),  # the sign flag belongs to the compressed encoding
           _enc(0, 0, 0xC0),
           _enc(1, 0, 0x40), _enc(0, 1, 0x40),  # infinity with a coordinate
           _enc(x + Q, y), _enc(Q, y),  # x >= q
           _enc(x, y + Q)]  # y >= q
    assert ser.g1_from_uncompressed(good) == G
    assert ser.g1_from_uncompressed(_enc(0, 0, 0x40)) is None
    for b in bad:
        with pytest.raises(ser.DeserializationError):
            ser.g1_from_uncompressed(b)


def test_points_off_curve_or_subgroup_raise():
    x, y = G
    assert not g1_is_on_curve((x, y + 1))
    # The first x >= 1 with x^3 + 4 a square mod q: on the curve, and
    # (cofactor about 2^126) outside the order-r subgroup, r P != O.
    px = 1
    while pow((px ** 3 + 4) % Q, (Q - 1) // 2, Q) != 1:
        px += 1
    py = pow((px ** 3 + 4) % Q, (Q + 1) // 4, Q)
    off_group = (px, py)
    assert g1_is_on_curve(off_group) and g1_mul(off_group, R) is not None
    for p in ((x, y + 1), (x, 0), off_group, g1_neg(off_group)):
        with pytest.raises(ser.DeserializationError):
            ser.g1_from_uncompressed(_enc(*p))
