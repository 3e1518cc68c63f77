"""Polynomial/vector helpers on limb tensors (port of
gemini_tpu/ops/poly.py; misc.rs analogues).

Coefficient vectors are (L, N) Montgomery limb tensors; scalars are
host Python ints (canonical).  Anything O(log N) stays on the host;
anything O(N) is a device op on the vector's device.
"""

from __future__ import annotations

import torch

from ..fields import fp
from ..fields.fp import FR, FieldSpec


def scalar(spec: FieldSpec, x: int, device) -> torch.Tensor:
    """Host int -> (L, 1) Montgomery scalar on device."""
    return spec.tensor([x % spec.modulus], device)


def powers_device(spec: FieldSpec, base, n: int):
    """(L, 1) Montgomery base -> (L, n) [1, b, b^2, ..., b^(n-1)] by
    doubling: p_{2m} = [p_m, b^m * p_m] (log2(n) batched products)."""
    p = spec.ones_mont((1,), base.device)
    cur = base  # b^(len(p))
    while p.shape[1] < n:
        p = torch.cat([p, fp.mont_mul(spec, p, cur)], dim=1)
        cur = fp.mont_mul(spec, cur, cur)
    return p[:, :n]


def powers(spec: FieldSpec, x: int, n: int, device) -> torch.Tensor:
    return powers_device(spec, scalar(spec, x, device), n)


def powers_host(x: int, n: int, modulus: int | None = None) -> list[int]:
    m = modulus or FR.modulus
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * x % m
    return out


def powers2_host(x: int, n: int, modulus: int | None = None) -> list[int]:
    """[x, x^2, x^4, ..., x^(2^(n-1))] (misc.rs:68 powers2)."""
    m = modulus or FR.modulus
    out = []
    cur = x % m
    for _ in range(n):
        out.append(cur)
        cur = cur * cur % m
    return out


def tensor_device(spec: FieldSpec, challenges: list[int], device) -> torch.Tensor:
    """Expansion of the tensor product of (1, rho_j): length 2^n,
    t[bits] = prod rho_j^bit_j, by doubling t_{j+1} = [t_j, rho_j t_j]."""
    t = spec.ones_mont((1,), device)
    for rho in challenges:
        t = torch.cat([t, fp.mont_mul(spec, t, scalar(spec, rho, device))],
                      dim=1)
    return t


def hadamard(spec: FieldSpec, a, b):
    return fp.mont_mul(spec, a, b)


def lane_prod(spec: FieldSpec, v) -> int:
    """Product of all lane elements of a (L, N) Montgomery vector ->
    canonical int: a log-depth tree of halving Montgomery products over
    the vector padded with ones to a power of two, then one readback."""
    n = v.shape[1]
    npad = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if npad != n:
        v = torch.cat([v, spec.ones_mont((npad - n,), v.device)], dim=1)
    while v.shape[1] > 1:
        half = v.shape[1] // 2
        v = fp.mont_mul(spec, v[:, :half], v[:, half:])
    return spec.decode(v.cpu())[0]


def ip(spec: FieldSpec, a, b) -> int:
    """Inner product of two (L, N) Montgomery vectors -> canonical int:
    one fused product-and-sum pass (on the card, one fr_lane_sum launch),
    then one 18-limb readback."""
    s = fp.mul_lane_sum(spec, a, b, axis=1)
    return spec.decode_relaxed(s[:, None])[0]


def evaluate_le(spec: FieldSpec, coeffs, x: int) -> int:
    """Evaluate sum_i coeffs[i] x^i (little-endian) at host scalar x."""
    return ip(spec, coeffs, powers(spec, x, coeffs.shape[1], coeffs.device))


def evaluate_be(spec: FieldSpec, coeffs, x: int) -> int:
    """Big-endian evaluation (highest-degree coefficient first), the
    reference's stream convention (misc.rs:180)."""
    pw = powers(spec, x, coeffs.shape[1], coeffs.device)
    return ip(spec, coeffs, pw.flip(1))


def eo_split(a):
    """Even/odd columns of (..., n) via reshape."""
    t = a.reshape(*a.shape[:-1], a.shape[-1] // 2, 2)
    return t[..., 0], t[..., 1]


def fold_polynomial(spec: FieldSpec, f, r):
    """out[k] = f[2k] + r * f[2k+1]; f must have even length (pad
    upstream).  r is an (L, 1) Montgomery scalar."""
    f_e, f_o = eo_split(f)
    return fp.add(spec, f_e, fp.mont_mul(spec, f_o, r))


def pad_to(spec: FieldSpec, f, n: int):
    """Zero-pad (L, m) to (L, n)."""
    m = f.shape[1]
    if m == n:
        return f
    assert m < n
    return torch.cat([f, f.new_zeros((spec.n_limbs, n - m))], dim=1)


def linear_combination(spec: FieldSpec, polys, coeffs: list[int]):
    """sum_i coeffs[i] * polys[i], aligning lengths to the max
    (misc.rs:37 linear_combination)."""
    n = max(p.shape[1] for p in polys)
    acc = None
    for p, c in zip(polys, coeffs):
        term = fp.mont_mul(spec, pad_to(spec, p, n), scalar(spec, c, p.device))
        acc = term if acc is None else fp.add(spec, acc, term)
    return acc


# ---------------------------------------------------------------------------
# Closed-form structured-polynomial evaluations (misc.rs:373-399), used
# by the pSNARK verifier's oracle computations.  Host arithmetic mod R.
# ---------------------------------------------------------------------------


def evaluate_tensor_poly(challenges: list[int], x: int,
                         modulus: int | None = None) -> int:
    """prod_j (1 + rho_j * x^(2^j)) (misc.rs:373-383)."""
    m = modulus or FR.modulus
    res, s = 1, x % m
    for rho in challenges:
        res = res * (1 + rho * s) % m
        s = s * s % m
    return res


def evaluate_geometric_poly(rx: int, n: int,
                            modulus: int | None = None) -> int:
    """1 + rx + rx^2 + ... + rx^(n-1) (misc.rs:387-390)."""
    m = modulus or FR.modulus
    rx %= m
    if rx == 1:
        return n % m
    return (pow(rx, n, m) - 1) * pow(rx - 1, -1, m) % m


def evaluate_index_poly(x: int, n: int, modulus: int | None = None) -> int:
    """x + 2x^2 + ... + (n-1)x^(n-1) (misc.rs:394-399); x != 1."""
    m = modulus or FR.modulus
    x %= m
    if x == 1:
        raise ValueError("evaluate_index_poly: x = 1")
    x1 = (1 - x) % m
    x_n = pow(x, n - 1, m)
    return (x * (1 - x_n) % m * pow(x1 * x1 % m, -1, m)
            - (n - 1) * x_n % m * x % m * pow(x1, -1, m)) % m
