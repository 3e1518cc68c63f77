from .g1 import (
    JPoint,
    APoint,
    is_infinity,
    neg,
    to_affine,
    from_affine,
    encode_affine,
    decode_affine,
    decode_jacobian,
)
