"""Blockwise device pipelines over host-resident vectors (port of
gemini_tpu/streaming/ops.py without `hv_fold`, which nothing calls; the
reference's stream combinators, sumcheck/streams.rs,
tensorcheck/streams.rs, and the elastic pSNARK's lookup, plookup and
product streams, psnark/streams/, entryproduct/streams/).

Each op streams `HostVector` blocks through the device and writes the
result back to host RAM, or generates it lazily on the device.  Device
memory stays bounded by the block size.  Every vector an op returns
lives on its input's device, or on the `device` the caller passes
(default the card).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve
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


def hv_hadamard(a: HostVector, b: HostVector,
                block_size: int = 1 << 20) -> HostVector:
    """Streaming elementwise product (hadamard_stream.rs); lengths align
    to the shorter vector, like the reference's zip."""
    n = min(len(a), len(b))
    out = np.zeros((FR.n_limbs, n), dtype=np.uint32)
    for off in range(0, n, block_size):
        m = min(block_size, n - off)
        out[:, off: off + m] = from_device_limbs(fp.mont_mul(
            FR, a.device_slice(off, off + m), b.device_slice(off, off + m)))
    return HostVector(out, a.spec, a.device)


def hv_accumulated_product(hv: HostVector,
                           block_size: int = 1 << 20) -> HostVector:
    """Streaming suffix products acc[i] = prod_{j>=i} v[j]
    (entryproduct/streams/product_stream.rs): blocks from right to left,
    each block's own suffix scan times the carry, the suffix product of
    everything to its right, kept on the device as one (L, 1) column."""
    from ..subprotocols.entry_product import accumulated_product

    n = len(hv)
    out = np.zeros((FR.n_limbs, n), dtype=np.uint32)
    carry = poly.scalar(FR, 1, hv.device)
    for off in reversed(range(0, n, block_size)):
        m = min(block_size, n - off)
        acc = fp.mont_mul(FR, accumulated_product(hv.device_slice(off, off + m)),
                          carry)
        out[:, off: off + m] = from_device_limbs(acc)
        carry = acc[:, :1]
    return HostVector(out, hv.spec, hv.device)


def hv_prod(hv: HostVector, block_size: int = 1 << 20) -> int:
    """Streaming grand product -> canonical int."""
    acc = 1
    for _, block in hv.blocks(block_size):
        acc = acc * poly.lane_prod(FR, block) % R
    return acc


def hv_ip(a: HostVector, b: HostVector, block_size: int = 1 << 20) -> int:
    """Streaming inner product over the shorter length -> canonical int
    (misc.rs ip over streams)."""
    n = min(len(a), len(b))
    acc = 0
    for off in range(0, n, block_size):
        m = min(block_size, n - off)
        acc = (acc + poly.ip(FR, a.device_slice(off, off + m),
                             b.device_slice(off, off + m))) % R
    return acc


def hv_evaluate(hv: HostVector, x: int, block_size: int = 1 << 20) -> int:
    """Streaming little-endian evaluation f(x) -> canonical int."""
    acc = 0
    for off, block in hv.blocks(block_size):
        acc = (acc + pow(x, off, R) * poly.evaluate_le(FR, block, x)) % R
    return acc


def hv_tensor(challenges: Sequence[int], block_size: int = 1 << 20,
              device=None) -> HostVector:
    """⊗_j (1, rho_j), of length 2^k, as a HostVector made block by block
    on `device` (the `TensorIter` stream, psnark/streams/tensor_stream.rs:
    12-90): a block is the low challenges' expansion times the product of
    the challenges that the block offset's high bits select.  Blocks are
    the largest power of two below `block_size`, as in gemini_tpu."""
    dev = resolve(device)
    k = len(challenges)
    out = np.zeros((FR.n_limbs, 1 << k), dtype=np.uint32)
    low = min(k, max(0, (block_size - 1).bit_length() - 1))
    blk = 1 << low
    wlow = poly.tensor_device(FR, list(challenges[:low]), dev)
    for off in range(0, 1 << k, blk):
        s = 1
        for j in range(low, k):
            if (off >> j) & 1:
                s = s * challenges[j] % R
        out[:, off: off + blk] = from_device_limbs(
            fp.mont_mul(FR, wlow, poly.scalar(FR, s, dev)))
    return HostVector(out, FR, dev)


def hv_powers(x: int, n: int, block_size: int = 1 << 20,
              device=None) -> HostVector:
    """[1, x, ..., x^(n-1)] as a HostVector made block by block on
    `device`."""
    dev = resolve(device)
    out = np.zeros((FR.n_limbs, n), dtype=np.uint32)
    for off in range(0, n, block_size):
        m = min(block_size, n - off)
        out[:, off: off + m] = powers_block(x, off, off + m, dev)
    return HostVector(out, FR, dev)


def hv_gather(hv: HostVector, idx: np.ndarray) -> HostVector:
    """items[idx] (the LookupStreamer, psnark/streams/lookup_stream.rs:
    numpy fancy indexing on the host replaces the sorted single-pass
    iterator; a constant stays a constant)."""
    return hv.gather(idx)


def hv_slice(hv: HostVector, n: int) -> HostVector:
    return HostVector(np.asarray(hv.slice(0, n)), hv.spec, hv.device)


def hv_alg_hash(hv: HostVector, indices, zeta: int,
                block_size: int = 1 << 20) -> HostVector:
    """v_i + ζ·index_i block by block (algebraic_hash.rs); indices=None
    means the positions 0..n-1."""
    from ..subprotocols.plookup import index_to_field

    n = len(hv)
    dev = hv.device
    out = np.zeros((FR.n_limbs, n), dtype=np.uint32)
    zs = poly.scalar(FR, zeta, dev)
    for off in range(0, n, block_size):
        m = min(block_size, n - off)
        if indices is None:
            idx = np.arange(off, off + m, dtype=np.int64)
        else:
            idx = np.asarray(indices[off: off + m], dtype=np.int64)
        out[:, off: off + m] = from_device_limbs(fp.add(
            FR, hv.device_slice(off, off + m),
            fp.mont_mul(FR, index_to_field(idx, dev), zs)))
    return HostVector(out, hv.spec, dev)


def hv_plookup_set(hv: HostVector, y: int, z: int,
                   block_size: int = 1 << 20) -> HostVector:
    """plookup's randomized set vector, y(1+z) + v_i + z·v_{i+1} with the
    head y(1+z) + z·v_0 and the tail y(1+z) + v_{n-1}
    (subprotocols/plookup.py plookup_set), streamed with a one-element
    overlap between blocks: n + 1 elements."""
    n = len(hv)
    dev = hv.device
    out = np.zeros((FR.n_limbs, n + 1), dtype=np.uint32)
    if n == 0:
        return HostVector(out[:, :0], hv.spec, dev)
    y1z = poly.scalar(FR, (1 + z) * y % R, dev)
    zs = poly.scalar(FR, z, dev)
    out[:, :1] = from_device_limbs(
        fp.add(FR, y1z, fp.mont_mul(FR, zs, hv.device_slice(0, 1))))
    for off in range(0, n - 1, block_size):  # slot i+1 for i in [0, n-1)
        m = min(block_size, n - 1 - off)
        v = hv.device_slice(off, off + m)
        t = fp.add(FR, fp.add(FR, y1z.expand_as(v), v),
                   fp.mont_mul(FR, zs, hv.device_slice(off + 1, off + 1 + m)))
        out[:, off + 1: off + 1 + m] = from_device_limbs(t)
    out[:, n:] = from_device_limbs(fp.add(FR, y1z, hv.device_slice(n - 1, n)))
    return HostVector(out, hv.spec, dev)


def hv_plookup_subset(hv: HostVector, y: int,
                      block_size: int = 1 << 20) -> HostVector:
    """f*_i + y block by block."""
    n = len(hv)
    out = np.zeros((FR.n_limbs, n), dtype=np.uint32)
    ys = poly.scalar(FR, y, hv.device)
    for off in range(0, n, block_size):
        m = min(block_size, n - off)
        v = hv.device_slice(off, off + m)
        out[:, off: off + m] = from_device_limbs(fp.add(FR, v, ys.expand_as(v)))
    return HostVector(out, hv.spec, hv.device)


def _one_col() -> np.ndarray:
    """Montgomery 1 as one (L, 1) host limb column."""
    return FR.encode([1])


def hv_monic(hv: HostVector) -> HostVector:
    """f(x) + x^N: a trailing Montgomery 1, concatenated on the host."""
    return HostVector(np.concatenate([hv.slice(0, len(hv)), _one_col()], axis=1),
                      hv.spec, hv.device)


def hv_right_rotation(hv: HostVector) -> HostVector:
    """(f_{n-1}, f_0, ..., f_{n-2}) (rrot_stream.rs)."""
    n = len(hv)
    return HostVector(
        np.concatenate([hv.slice(n - 1, n), hv.slice(0, n - 1)], axis=1),
        hv.spec, hv.device)


def hv_plookup(subset: HostVector, set_hashed: HostVector,
               index: np.ndarray, y: int, z: int, zeta: int,
               frequency: np.ndarray,
               block_size: int = 1 << 20) -> List[HostVector]:
    """The three grand-product vectors of plookup
    (plookup/streams/{set,subset,sorted}_stream.rs): `set_hashed` is
    already position-hashed by ζ; `subset` is the raw looked-up vector,
    hashed here against its lookup indices."""
    if zeta % R != 0:
        subset_h = hv_alg_hash(subset, index, zeta, block_size)
    else:
        subset_h = subset
    lookup_set = hv_plookup_set(set_hashed, y, z, block_size)
    lookup_subset = hv_plookup_subset(subset_h, y, block_size)
    addr = np.repeat(np.arange(len(frequency), dtype=np.int64), frequency)
    lookup_sorted = hv_plookup_set(hv_gather(set_hashed, addr), y, z, block_size)
    return [lookup_set, lookup_subset, lookup_sorted]
