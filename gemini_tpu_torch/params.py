"""BLS12-381 curve parameters (public constants).

Parity note: mirrors the curve configuration used by the reference
(arkworks `ark-bls12-381`; reference tests fix this curve, e.g.
reference src/snark/tests.rs). All values are standard published
BLS12-381 constants.
"""

# Base field modulus (Fq), 381 bits.
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Scalar field modulus (Fr), 255 bits.
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative).
BLS_X = -0xD201000000010000
BLS_X_ABS = 0xD201000000010000

# G1 generator (affine, Fq).
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# G2 generator (affine, Fq2 = Fq[u]/(u^2+1), coordinates (c0, c1)).
G2_X0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_X1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_Y0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_Y1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

# Curve equations: E/Fq: y^2 = x^3 + 4;  E'/Fq2: y^2 = x^3 + 4(1+u).
B_G1 = 4
B_G2 = (4, 4)  # 4*(1+u)

# Non-residue used for the sextic twist: xi = 1 + u in Fq2.
XI = (1, 1)

# ---------------------------------------------------------------------------
# Limb decomposition parameters for the TPU engine.
#
# Field elements are stored as vectors of W-bit limbs held in uint32 lanes,
# little-endian limb order, Montgomery form.  16-bit limbs make 16x16->32-bit
# products exact in uint32 and leave ~9 bits of headroom for deferred-carry
# accumulation across a full CIOS pass (see fields/fp.py).
# ---------------------------------------------------------------------------
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

FQ_LIMBS = 24  # 24 * 16 = 384 >= 381
FR_LIMBS = 16  # 16 * 16 = 256 >= 255

# Montgomery radix per field: R_mont = 2^(LIMB_BITS * n_limbs) mod modulus.
FQ_MONT_R = pow(2, LIMB_BITS * FQ_LIMBS, Q)
FQ_MONT_R2 = pow(FQ_MONT_R, 2, Q)
FR_MONT_R = pow(2, LIMB_BITS * FR_LIMBS, R)
FR_MONT_R2 = pow(FR_MONT_R, 2, R)

# -modulus^{-1} mod 2^LIMB_BITS (the per-limb Montgomery factor).
FQ_N0INV = (-pow(Q, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
FR_N0INV = (-pow(R, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
