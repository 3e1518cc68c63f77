"""Host-RAM vector sources (port of gemini_tpu/streaming/host.py; the
reference's `Iterable` streaming substrate, src/iterable/).

Instances too large for the card live in host RAM as numpy limb
arrays and visit the device block by block.  A `HostVector` is
restartable (`blocks()` may be called once per sumcheck round, like
`Iterable::iter`) and cheap to slice; blocks arrive on the vector's
device as (L, B) int32 Montgomery tensors (16-bit limb values, the
layout of fields/fp.py).

`VirtualHostVector` is the O(1)-memory flavour (iterable/dummy.rs):
blocks are generated by a function instead of read from RAM, and with
`device_fn` they are generated on the device, so streaming passes over
synthetic giant vectors move no bytes between host and device.

Blocks are little-endian (coefficient order), as in gemini_tpu.
"""

from __future__ import annotations

from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from ..device import resolve
from ..fields.fp import FR, FieldSpec, to_tensor


# ---------------------------------------------------------------------------
# Packed transfers.  Normalized Montgomery rows hold 16-bit values in
# 32-bit planes, so half of a plain transfer is zeros.  Every transfer
# packs row pairs (j, j + L/2) into one 32-bit row: 32 B per Fr element
# on the wire, both ways (gemini_tpu's wire format).
# ---------------------------------------------------------------------------


def pack_rows_host(limbs: np.ndarray) -> np.ndarray:
    """Host (L, B) 16-bit-valued uint32 rows -> (L/2, B) packed."""
    h = limbs.shape[0] // 2
    return limbs[:h] | (limbs[h:] << np.uint32(16))


def unpack_rows_host(packed: np.ndarray) -> np.ndarray:
    """(L/2, B) packed -> (L, B) 16-bit rows."""
    return np.concatenate([packed & np.uint32(0xFFFF), packed >> np.uint32(16)],
                          axis=0)


def _pack_rows_dev(a: torch.Tensor) -> torch.Tensor:
    h = a.shape[0] // 2
    return a[:h] | (a[h:] << 16)


def _unpack_rows_dev(p: torch.Tensor) -> torch.Tensor:
    # `>>` on int32 is arithmetic: mask the high half after the shift.
    return torch.cat([p & 0xFFFF, (p >> 16) & 0xFFFF], dim=0)


def to_device_limbs(limbs: np.ndarray, device) -> torch.Tensor:
    """Host (L, B) normalized limb rows -> int32 tensor on `device`,
    packed on the wire.  To a card the packed rows are written into a
    pinned buffer and copied without blocking the host (PyTorch's
    pinned-memory cache keeps the buffer until the copy has run)."""
    device = torch.device(device)
    h = limbs.shape[0] // 2
    if device.type == "cuda":
        stage = torch.empty((h, limbs.shape[1]), dtype=torch.int32,
                            pin_memory=True)
        np.bitwise_or(limbs[:h], limbs[h:] << np.uint32(16),
                      out=stage.numpy().view(np.uint32))
        return _unpack_rows_dev(stage.to(device, non_blocking=True))
    packed = np.ascontiguousarray(pack_rows_host(limbs), dtype=np.uint32)
    return _unpack_rows_dev(torch.from_numpy(packed.view(np.int32)))


def from_device_limbs(arr: torch.Tensor) -> np.ndarray:
    """(L, B) normalized limb tensor -> host uint32 numpy, packed on the
    wire (the pack runs on the tensor's device; half the bytes come
    back)."""
    packed = _pack_rows_dev(arr.to(torch.int32)).cpu().numpy()
    return unpack_rows_host(packed.view(np.uint32))


class HostVector:
    """A field vector resident in host RAM as (L, N) uint32 Montgomery
    limbs; a restartable block source for `device` (default the card;
    without one, pass device="cpu")."""

    def __init__(self, limbs: np.ndarray, spec: FieldSpec = FR, device=None):
        assert limbs.ndim == 2 and limbs.shape[0] == spec.n_limbs
        self.limbs = limbs
        self.spec = spec
        self.device = resolve(device)

    @classmethod
    def from_ints(cls, values: Sequence[int], spec: FieldSpec = FR,
                  device=None):
        return cls(spec.encode(list(values)), spec, device)

    @classmethod
    def from_device(cls, arr: torch.Tensor, spec: FieldSpec = FR):
        """A device tensor read back to host RAM; blocks go back to the
        tensor's device."""
        return cls(from_device_limbs(arr), spec, arr.device)

    def __len__(self) -> int:
        return self.limbs.shape[1]

    def slice(self, start: int, end: int) -> np.ndarray:
        """(L, end-start) limb view/array; end is clamped to len."""
        return self.limbs[:, start:end]

    def device_slice(self, start: int, end: int) -> torch.Tensor:
        """slice() moved to the device with the packed wire format."""
        return to_device_limbs(self.slice(start, end), self.device)

    def to_device(self) -> torch.Tensor:
        """The whole vector on its device."""
        return self.device_slice(0, len(self))

    def gather(self, idx: np.ndarray) -> "HostVector":
        """items[idx] by numpy fancy indexing on the host limbs (a
        DeviceVector reads its limbs back first)."""
        return HostVector(self.limbs[:, np.asarray(idx, dtype=np.int64)],
                          self.spec, self.device)

    def blocks(self, block_size: int) -> Iterator[tuple[int, torch.Tensor]]:
        """Yield (offset, device block) pairs, in coefficient order.
        Restartable: call again for a fresh pass."""
        n = len(self)
        for off in range(0, n, block_size):
            yield off, self.device_slice(off, min(off + block_size, n))


class VirtualHostVector(HostVector):
    """A lazily generated vector: `fn(start, end) -> (L, end-start)`
    uint32 Montgomery limbs on the host, O(1) host memory (the
    reference's `DummyStreamer`, iterable/dummy.rs:10-238).

    `device_fn(start, end) -> (L, end-start) tensor`, when given,
    generates blocks on the device: streaming passes then move no bytes
    between host and device."""

    def __init__(self, n: int, fn: Callable[[int, int], np.ndarray],
                 spec: FieldSpec = FR, device_fn=None, device=None):
        self._n = n
        self._fn = fn
        self.spec = spec
        self._device_fn = device_fn
        self.device = resolve(device)
        self._const_value = None  # the value, for a constant vector

    @classmethod
    def constant(cls, value: int, n: int, spec: FieldSpec = FR,
                 device=None) -> "VirtualHostVector":
        """n copies of one field element (iterable/dummy.rs:10-22)."""
        col = spec.encode([value % spec.modulus])

        def fn(start: int, end: int) -> np.ndarray:
            return np.broadcast_to(col, (spec.n_limbs, end - start))

        out = cls(n, fn, spec, device=device)
        dev_col = to_tensor(col, out.device)
        out._device_fn = lambda start, end: dev_col.expand(spec.n_limbs, end - start)
        out._const_value = value % spec.modulus
        return out

    def __len__(self) -> int:
        return self._n

    @property
    def limbs(self) -> np.ndarray:  # materialize (small vectors only)
        return np.ascontiguousarray(self._fn(0, self._n))

    def slice(self, start: int, end: int) -> np.ndarray:
        end = min(end, self._n)
        if end <= start:  # numpy slicing tolerates this; generators don't
            return np.zeros((self.spec.n_limbs, 0), dtype=np.uint32)
        return self._fn(start, end)

    def device_slice(self, start: int, end: int) -> torch.Tensor:
        end = min(end, self._n)
        if self._device_fn is not None and end > start:
            return self._device_fn(start, end)
        return super().device_slice(start, end)

    def gather(self, idx: np.ndarray) -> HostVector:
        """A gather from a constant is the constant at the gathered
        length, O(1); other generated vectors must be materialized by
        the caller first."""
        if self._const_value is not None:
            return VirtualHostVector.constant(self._const_value, len(idx),
                                              self.spec, self.device)
        raise NotImplementedError(
            "gather on a virtual stream; materialize explicitly first")


class DeviceVector(HostVector):
    """A HostVector whose payload stays on the device: fold levels small
    enough for device memory skip the host round trip.  Host access
    (`limbs`/`slice`) reads back on demand."""

    def __init__(self, arr: torch.Tensor, spec: FieldSpec = FR):
        assert arr.ndim == 2 and arr.shape[0] == spec.n_limbs
        self._arr = arr
        self.spec = spec
        self.device = arr.device

    def __len__(self) -> int:
        return self._arr.shape[1]

    @property
    def limbs(self) -> np.ndarray:
        return from_device_limbs(self._arr)

    def slice(self, start: int, end: int) -> np.ndarray:
        end = min(end, len(self))
        if end <= start:
            return np.zeros((self.spec.n_limbs, 0), dtype=np.uint32)
        return from_device_limbs(self._arr[:, start:end])

    def device_slice(self, start: int, end: int) -> torch.Tensor:
        end = min(end, len(self))
        return self._arr[:, start:end]


def device_block(hv: HostVector, off: int, end: int,
                 pad_to: int | None = None) -> torch.Tensor:
    """hv[off:end) on hv's device, zero-padded on the device to `pad_to`
    lanes: the shared block reader of the streaming pipelines (device
    generators and device-resident vectors transfer nothing; host
    vectors use the packed wire format)."""
    end = min(end, len(hv))
    if end > off:
        b = hv.device_slice(off, end)
    else:
        b = hv.spec.zeros((0,), hv.device)
    if pad_to is not None and b.shape[1] < pad_to:
        b = torch.cat([b, hv.spec.zeros((pad_to - b.shape[1],), hv.device)],
                      dim=1)
    return b
