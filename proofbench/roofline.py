"""The work a kernel's lanes need, counted from the algorithm, and the
chip's published peaks: the yardstick of the `<kernel>_roofline`
metrics.  Nothing here reads how a kernel is implemented.

Operations are 32-bit integer multiply-adds.  A CIOS Montgomery product
of s 32-bit words needs 2 s^2 + s word products (Koc, Acar and Kaliski,
"Analyzing and comparing Montgomery multiplication algorithms", IEEE
Micro 1996), and each word product (32 x 32 bits plus a 64-bit addend)
is one multiply-add instruction: 300 for an Fq product (s = 12, 381
bits), 136 for an Fr product (s = 8, 255 bits).  Additions, carries
and selects are not counted, so the count is a floor.

Bytes: each input lane read once and each output lane written once, in
the pipeline's layout of 16-bit limbs held in int32 words: an Fq
coordinate is 24 x 4 = 96 bytes, an Fr element 16 x 4 = 64 bytes.

Peaks: NVIDIA H100 SXM5 (the data sheet's 3.35 TB/s of HBM3; 132 SMs
at the 1,980 MHz boost clock, and 64 32-bit integer multiply-adds per
clock per SM for compute capability 9.0 in the CUDA C Programming
Guide's table of arithmetic instruction throughput), at the full 700 W
power limit.  The run prints the card's own limit beside them.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_PER_S = 132 * 1.98e9 * 64

FQ_WORDS, FR_WORDS = 12, 8
FQ_BYTES, FR_BYTES = 24 * 4, 16 * 4


def cios_products(words: int) -> int:
    return 2 * words * words + words


@dataclass(frozen=True)
class LaneWork:
    """One lane of a kernel: its multiply-adds and its bytes."""

    imad: int
    bytes: int

    def least_seconds(self, lanes: int) -> float:
        return max(lanes * self.imad / PEAK_IMAD_PER_S,
                   lanes * self.bytes / PEAK_BYTES_PER_S)


# padd: the complete projective addition of Renes, Costello and Batina
# 2015, algorithm 7 (a = 0): 12 general Fq products (its two products by
# 3b are by a small constant and count as additions); reads two points
# (x, y, z), writes one.
PADD = LaneWork(imad=12 * cios_products(FQ_WORDS), bytes=9 * FQ_BYTES)

# fr_mul: one Fr Montgomery product; reads a, writes the product.  The
# second operand is not counted, since a launch may broadcast it (one
# lane for all) and the lane counter does not say which launches do; the
# least time is then a floor for launches where it is a full vector.
FR_MUL = LaneWork(imad=cios_products(FR_WORDS), bytes=2 * FR_BYTES)

WORK = {"padd": PADD, "fr_mul": FR_MUL}
