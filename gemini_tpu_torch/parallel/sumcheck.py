"""Sharded sumcheck: round messages and folds over a mesh (port of
gemini_tpu/parallel/sumcheck.py).

The round message (a, b) is a sum of per-pair terms
(time_prover.rs:96-122).  With the coefficient vectors split in
contiguous even-length lane blocks:

  * each shard computes the lane sums of its block's f_e g_e T_k and
    cross terms on its own device (relaxed (L+2,) limb columns);
  * the shards' columns are added as int64 on the mesh's first device
    (gemini_tpu's `psum`), and one readback per round decodes both
    coefficients: the sums of normalized 16-bit limbs stay exact, and
    `decode_relaxed` takes limbs of any size;
  * the fold f <- f_e + r f_o is shard-local (even block lengths), as is
    the twist-power subsample T_k <- T_2k.

Once a shard's block would drop below two lanes, the vectors are
gathered to the first device and the dense `TimeProver` finishes the
last log2(size) rounds.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..fields.fp import FR, I64
from ..ops import poly
from ..params import R
from ..subprotocols.sumcheck import (TimeProver, _fold_kernel,
                                     _round_message_kernel, required_rounds)
from .mesh import Mesh, shard_vector, split_lanes


# (a, b) relaxed (L+2,) limb rows of one shard's block: the dense round
# message's lane sums (the round kernel on the card).
_local_partial_sums = _round_message_kernel


def round_message_sharded(mesh: Mesh, f: List, g: List, t_pow: List, twist: int):
    """(a, b) as (L+2,) int64 columns on mesh.devices[0]: the shards'
    partial sums, each computed on its own device, added there."""
    dev0 = mesh.devices[0]
    a, b = None, None
    for fs, gs, ts in zip(f, g, t_pow):
        pa, pb = _local_partial_sums(fs, gs, ts, twist).to(dev0, I64)
        a, b = (pa, pb) if a is None else (a + pa, b + pb)
    return a, b


def fold_sharded(mesh: Mesh, f: List, g: List, t_pow: List, r: int, r_twist: int):
    """Shard-local fold of both sides and twist-power subsample."""
    out = [_fold_kernel(fs, gs, ts, r, r_twist)
           for fs, gs, ts in zip(f, g, t_pow)]
    return tuple(list(col) for col in zip(*out))


class ShardedTimeProver:
    """Sumcheck prover with `TimeProver`'s interface over a mesh: the
    same messages, challenges and final foldings.

    Shards stay fold-local while a shard's block has at least four
    lanes; then the vectors go to the first device and the dense
    prover finishes the tail (log2(size) rounds on O(size) elements)."""

    def __init__(self, mesh: Mesh, f, g, twist: int):
        self.mesh = mesh
        rounds = required_rounds(max(f.shape[1], g.shape[1]))
        n = max(1 << rounds, 2 * mesh.size)
        self.tot_rounds = rounds
        self.n = 1 << rounds  # logical length, as TimeProver.n
        self.f = shard_vector(mesh, poly.pad_to(FR, f, n))
        self.g = shard_vector(mesh, poly.pad_to(FR, g, n))
        self.twist = twist % R
        t = poly.powers(FR, self.twist * self.twist % R, n // 2, f.device)
        self.t_pow = split_lanes(mesh, t)
        self.round = 0
        self._tail: Optional[TimeProver] = None

    def rounds(self) -> int:
        return self.tot_rounds

    def _to_tail(self) -> TimeProver:
        """Gather the shards to the first device; the dense prover takes
        over at the logical length, with this prover's round count.  The
        lanes past that length are zero padding, so its constructor's
        twist powers are the subsampled ones."""
        dev0 = self.mesh.devices[0]
        n = self.n
        f = torch.cat([s.to(dev0) for s in self.f], dim=1)[:, :n]
        g = torch.cat([s.to(dev0) for s in self.g], dim=1)[:, :n]
        tail = TimeProver(f, g, self.twist)
        tail.tot_rounds = self.tot_rounds
        tail.round = self.round
        return tail

    def fold(self, r: int) -> None:
        if self._tail is None and self.f[0].shape[1] < 4:
            self._tail = self._to_tail()
        if self._tail is not None:
            self._tail.fold(r)
            return
        self.f, self.g, self.t_pow = fold_sharded(
            self.mesh, self.f, self.g, self.t_pow, r, r * self.twist % R)
        self.n //= 2
        self.twist = self.twist * self.twist % R

    def next_message(self, challenge: Optional[int]):
        if challenge is not None:
            self.fold(challenge)
        if self._tail is not None:
            msg = self._tail.next_message(None)
            self.round = self._tail.round
            return msg
        if self.round == self.tot_rounds:
            return None
        a, b = round_message_sharded(self.mesh, self.f, self.g, self.t_pow,
                                     self.twist)
        self.round += 1
        return tuple(FR.decode_relaxed(torch.stack([a, b], dim=1).cpu()))

    def final_foldings(self) -> Optional[Tuple[int, int]]:
        if self._tail is not None:
            return self._tail.final_foldings()
        if self.round != self.tot_rounds:
            return None
        return (FR.decode(self.f[0][:, :1])[0], FR.decode(self.g[0][:, :1])[0])
