"""Pure-Python ground-truth implementation of BLS12-381 arithmetic.

This package is the *oracle* for every TPU kernel in gemini_tpu: field
ops, curve ops, MSM, pairings.  It is deliberately slow and obviously
correct.  TPU kernels are tested bit-exact against it (the analogue of
the reference's time/space transcript-equality idiom,
reference src/kzg/tests.rs:16-59).

It is also used directly on the verifier's pairing path, where inputs
are a handful of points and speed is irrelevant.
"""

from .fields import Fq, Fr, Fq2, Fq6, Fq12
from .curve import (
    G1Affine,
    G2Affine,
    g1_generator,
    g2_generator,
    g1_add,
    g1_double,
    g1_mul,
    g2_add,
    g2_mul,
    g1_neg,
    g2_neg,
    g1_is_on_curve,
    g2_is_on_curve,
    g1_msm,
    g1_msm_pippenger,
)
from .pairing import pairing, miller_loop, final_exponentiation, gt_pow
