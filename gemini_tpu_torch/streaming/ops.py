"""Blockwise device pipelines over host-resident vectors (port of the
SNARK path's part of gemini_tpu/streaming/ops.py; the reference's
stream combinators, sumcheck/streams.rs, tensorcheck/streams.rs).

Each op streams `HostVector` blocks through the device and writes the
result back to host RAM, or generates it lazily on the device.  Device
memory stays bounded by the block size.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..fields import fp
from ..fields.fp import FR
from ..ops import poly
from ..params import R
from .host import HostVector, VirtualHostVector, device_block, from_device_limbs


def hv_lincomb(hvs: Sequence[HostVector], coeffs: Sequence[int],
               block_size: int = 1 << 20) -> HostVector:
    """Streaming sum_i coeffs[i] * hvs[i], aligned at index 0 to the max
    length (the `lincomb!` stream, tensorcheck/streams.rs:15-134)."""
    n = max(len(hv) for hv in hvs)
    dev = hvs[0].device
    out = np.zeros((FR.n_limbs, n), dtype=np.uint32)
    cs = [poly.scalar(FR, c, dev) for c in coeffs]
    for off in range(0, n, block_size):
        m = min(block_size, n - off)
        acc = _lincomb_device_block(hvs, cs, off, m)
        if acc is not None:
            out[:, off: off + m] = from_device_limbs(acc)
    return HostVector(out, hvs[0].spec, dev)


def _lincomb_device_block(hvs, cs, off: int, m: int):
    """One device block of sum_i cs[i]*hvs[i][off:off+m), zero-padded;
    None when every source is exhausted."""
    acc = None
    for hv, c in zip(hvs, cs):
        end = min(off + m, len(hv))
        if end <= off:
            continue
        term = fp.mont_mul(FR, device_block(hv, off, end, pad_to=m), c)
        acc = term if acc is None else fp.add(FR, acc, term)
    return acc


def hv_lincomb_lazy(hvs: Sequence[HostVector], coeffs: Sequence[int]
                    ) -> VirtualHostVector:
    """The lincomb as a lazy device-generating stream: a consumer that
    reads it once (the fold tree's first level) never materializes the
    n-length combination."""
    n = max(len(hv) for hv in hvs)
    dev = hvs[0].device
    cs = [poly.scalar(FR, c, dev) for c in coeffs]

    def device_fn(start: int, end: int):
        acc = _lincomb_device_block(hvs, cs, start, end - start)
        return acc if acc is not None else FR.zeros((end - start,), dev)

    def fn(start: int, end: int):
        return from_device_limbs(device_fn(start, end))

    return VirtualHostVector(n, fn, hvs[0].spec, device_fn=device_fn,
                             device=dev)


def _masked_bit_products(bits, idx: torch.Tensor, const: int = 1
                         ) -> torch.Tensor:
    """const * prod_{(l, s) in bits} s^{bit_l(idx)} on idx's device: one
    masked Montgomery product per (l, s)."""
    dev = idx.device
    out = poly.scalar(FR, const, dev).expand(FR.n_limbs, idx.shape[0])
    for l, s in bits:
        bit = ((idx >> l) & 1).bool()
        out = fp.select(bit, fp.mont_mul(FR, out, poly.scalar(FR, s, dev)), out)
    return out.contiguous()


def tensor_block_dev(challenges: Sequence[int], start: int, end: int,
                     device) -> torch.Tensor:
    """Window [start, end) of the ⊗_j (1, rho_j) expansion on `device`:
    t[i] = prod_l rho_l^{bit_l(i)} (the `advance_by` of
    tensor_stream.rs:49-90).  Bits that are the same across the whole
    window fold into one host scalar; the others are masked device
    products over an on-device iota."""
    idx = torch.arange(start, end, dtype=torch.int64, device=device)
    const, varying = 1, []
    for l, ch in enumerate(challenges):
        if start >> l != (end - 1) >> l:
            varying.append((l, ch))
        elif (start >> l) & 1:  # bit l set across the whole window
            const = const * ch % R
    return _masked_bit_products(varying, idx, const)


def tensor_block(challenges: Sequence[int], start: int, end: int,
                 device) -> np.ndarray:
    return from_device_limbs(tensor_block_dev(challenges, start, end, device))


def tensor_at(challenges: Sequence[int], idx: np.ndarray, device) -> torch.Tensor:
    """⊗-expansion values at arbitrary indices, t[idx] =
    prod_l rho_l^{bit_l(idx)}: (L, len(idx)) Montgomery on `device`."""
    idx = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(device)
    return _masked_bit_products(list(enumerate(challenges)), idx)


def powers_at(x: int, idx: np.ndarray, n_bits: int, device) -> torch.Tensor:
    """x^idx at arbitrary indices from the bit decomposition of idx and
    the host's x^(2^l): (L, len(idx)) Montgomery on `device`."""
    idx = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(device)
    return _masked_bit_products(list(enumerate(poly.powers2_host(x, n_bits))),
                                idx)


def powers_block_dev(x: int, start: int, end: int, device) -> torch.Tensor:
    """Window [start, end) of [1, x, x^2, ...] on `device`."""
    return fp.mont_mul(FR, poly.powers(FR, x, end - start, device),
                       poly.scalar(FR, pow(x, start, R), device))


def powers_block(x: int, start: int, end: int, device) -> np.ndarray:
    return from_device_limbs(powers_block_dev(x, start, end, device))
