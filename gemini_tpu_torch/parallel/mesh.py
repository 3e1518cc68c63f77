"""Device meshes (port of gemini_tpu/parallel/mesh.py).

gemini_tpu lays every length-N coefficient vector out as (L, N) with
the lane axis split in contiguous blocks across a 1-D JAX mesh, so

  * even/odd sumcheck folds stay shard-local (block length is kept
    even), and
  * round messages and inner products are local lane sums plus one
    small sum across the shards.

The port keeps that design in one process: a `Mesh` is an ordered
tuple of `torch.device`s, each shard's tensors live on their device,
and the host adds the shards' partial results.  Devices may repeat:
`Mesh([torch.device("cuda", 0)] * 4)` runs the sharded code, four
shards, on one card, and `Mesh([torch.device("cpu")] * 4)` runs it on
the CPU.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..device import resolve


class Mesh:
    """An ordered tuple of devices, one per shard (repeats allowed)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(resolve(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def default_mesh(n_devices: int | None = None) -> Mesh:
    """The first `n_devices` CUDA devices (all of them by default).
    Raises when fewer exist; it never builds a smaller or a CPU mesh."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n < 1 or count < n:
        raise RuntimeError(
            f"default_mesh({n_devices}): {count} CUDA device(s) available; "
            "build a Mesh of explicit devices instead")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def split_lanes(mesh: Mesh, v: torch.Tensor) -> List[torch.Tensor]:
    """(L, N) -> one contiguous lane block of N / size per shard, each
    on its device (N must divide evenly)."""
    n, size = v.shape[-1], mesh.size
    assert n % size == 0, f"lane count {n} not divisible by {size}"
    per = n // size
    return [v[..., i * per:(i + 1) * per].to(dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


def shard_vector(mesh: Mesh, v: torch.Tensor) -> List[torch.Tensor]:
    """Place an (L, N) limb tensor with lanes blocked across the mesh.
    N must be divisible by mesh size * 2 (fold locality)."""
    n = v.shape[-1]
    assert n % (2 * mesh.size) == 0, \
        f"lane count {n} not divisible by 2*{mesh.size}"
    return split_lanes(mesh, v)
