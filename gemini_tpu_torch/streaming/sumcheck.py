"""Space- and elastic-flavour sumcheck provers (port of
gemini_tpu/streaming/sumcheck.py; subprotocols/sumcheck/
{space,elastic}_prover.rs analogues).

The coefficients stay in host RAM (`HostVector`); each round streams
blocks to the device and computes the current folding of a block as
one contraction

    f^(j)[i] = Σ_b  w_f[b] · f[i·2^j + b],   w_f = ⊗_l (1, r_l·twist^(2^l))

(a reshape, a broadcast Montgomery product and a relaxed lane sum).
Round messages are the dense prover's (a, b) partial sums, accumulated
across blocks on the host, so the transcript equals the dense one.

Per-round device memory: one block and the 2^j-entry weight tensor.
The elastic prover switches to the dense `TimeProver` once the folded
instance has at most 2^threshold entries, so j stays below
log2(N) - threshold.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import SPACE_TIME_THRESHOLD
from ..fields import fp
from ..fields.fp import FR
from ..ops import poly
from ..params import R
from ..subprotocols.sumcheck import TimeProver, required_rounds
from .host import HostVector, device_block


def _fold_weights(challenges: List[int], twisted: bool, twist: int, device):
    """⊗_l (1, r_l) or ⊗_l (1, r_l · twist^(2^l)) as an (L, 2^j)
    tensor on `device`."""
    if twisted:
        tw = twist % R
        elems = []
        for r_l in challenges:
            elems.append(r_l * tw % R)
            tw = tw * tw % R
        return poly.tensor_device(FR, elems, device)
    return poly.tensor_device(FR, challenges, device)


def _fold_block(block: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(L, B) base block -> (L, B / 2^j) folded values."""
    L, B = block.shape
    m = weights.shape[1]
    assert B % m == 0
    grouped = block.reshape(L, B // m, m)
    prods = fp.mont_mul(FR, grouped, weights[:, None, :])
    return fp.reduce_relaxed(FR, fp.lane_sum(FR, prods, axis=2))


class SpaceProver:
    """Streaming sumcheck prover over host-resident f, g; emits the
    dense TimeProver's round messages."""

    def __init__(self, f: HostVector, g: HostVector, twist: int,
                 block_size: int = 1 << 20):
        self.fv = f
        self.gv = g
        self.device = f.device
        self.twist0 = twist % R
        self.block_size = block_size
        self.tot_rounds = required_rounds(max(len(f), len(g)))
        self.emitted = 0
        self.challenges: List[int] = []
        self.twist = self.twist0  # twist^(2^len(challenges))

    def rounds(self) -> int:
        return self.tot_rounds

    def fold(self, r: int) -> None:
        self.challenges.append(r)
        self.twist = self.twist * self.twist % R

    def _stream_round_message(self) -> Tuple[int, int]:
        """(a, b) for the current round from one streaming pass."""
        dev = self.device
        j = len(self.challenges)
        group = 1 << (j + 1)  # base coefficients per output pair
        blk = max(self.block_size, group)
        blk -= blk % group
        wf = _fold_weights(self.challenges, True, self.twist0, dev)
        wg = _fold_weights(self.challenges, False, 0, dev)
        tw2 = self.twist * self.twist % R
        tw = poly.scalar(FR, self.twist, dev)
        a_acc, b_acc = 0, 0
        n = max(len(self.fv), len(self.gv))
        for off in range(0, n, blk):
            size = min(blk, n - off)
            f_e, f_o = poly.eo_split(_fold_block(self._load(self.fv, off, size, group), wf))
            g_e, g_o = poly.eo_split(_fold_block(self._load(self.gv, off, size, group), wg))
            # T_k = twist_j^(2(k0 + k)) for the global pair index
            k0 = off // group
            t_pow = fp.mont_mul(FR, poly.powers(FR, tw2, f_e.shape[1], dev),
                                poly.scalar(FR, pow(self.twist, 2 * k0, R), dev))
            a_vec = fp.mont_mul(FR, fp.mont_mul(FR, f_e, g_e), t_pow)
            cross = fp.add(FR, fp.mont_mul(FR, f_e, g_o),
                           fp.mont_mul(FR, fp.mont_mul(FR, g_e, f_o), tw))
            b_vec = fp.mont_mul(FR, cross, t_pow)
            a, b = FR.decode_relaxed(torch.stack(
                [fp.lane_sum(FR, a_vec, axis=1), fp.lane_sum(FR, b_vec, axis=1)],
                dim=1).cpu())
            a_acc = (a_acc + a) % R
            b_acc = (b_acc + b) % R
        return a_acc, b_acc

    @staticmethod
    def _load(hv: HostVector, off: int, size: int, group: int) -> torch.Tensor:
        """Device block [off, off+size) zero-padded to a group multiple
        (and zero-filled beyond the vector's end)."""
        end = min(off + size, len(hv))
        m = max(0, end - off)
        pad_to = m + (-m % group)
        if pad_to < size:
            pad_to = size + (-size % group)
        return device_block(hv, off, end, pad_to=pad_to)

    def next_message(self, challenge: Optional[int]):
        if challenge is not None:
            self.fold(challenge)
        if self.emitted == self.tot_rounds:
            return None
        msg = self._stream_round_message()
        self.emitted += 1
        return msg

    def final_foldings(self) -> Optional[Tuple[int, int]]:
        if len(self.challenges) != self.tot_rounds:
            return None
        f0 = self._materialize_folded(twisted=True)
        g0 = self._materialize_folded(twisted=False)
        return (FR.decode(f0[:, :1])[0], FR.decode(g0[:, :1])[0])

    def _materialize_folded(self, twisted: bool) -> torch.Tensor:
        """Current folding of f or g as a dense device tensor."""
        group = 1 << len(self.challenges)
        hv = self.fv if twisted else self.gv
        w = _fold_weights(self.challenges, twisted, self.twist0, self.device)
        blk = max(self.block_size, group)
        blk -= blk % group
        n = 1 << self.tot_rounds
        return torch.cat([
            _fold_block(self._load(hv, off, min(blk, n - off), group), w)
            for off in range(0, n, blk)], dim=1)


class ElasticProver:
    """Space prover that hands over to the dense prover once the folded
    instance fits under `threshold` rounds
    (sumcheck/elastic_prover.rs:44-57)."""

    def __init__(self, f: HostVector, g: HostVector, twist: int,
                 block_size: int = 1 << 20,
                 threshold: int = SPACE_TIME_THRESHOLD):
        self.space = SpaceProver(f, g, twist, block_size)
        self.threshold = threshold
        self.time: Optional[TimeProver] = None
        self._maybe_switch()

    def _maybe_switch(self):
        s = self.space
        remaining = s.tot_rounds - len(s.challenges)
        if self.time is None and remaining <= self.threshold:
            f = s._materialize_folded(twisted=True)
            g = s._materialize_folded(twisted=False)
            # The dense prover starts mid-protocol: its twist powers are
            # built for the folded width from s.twist, and its round
            # counter continues the space prover's.
            t = TimeProver(f, g, s.twist)
            t.tot_rounds = s.tot_rounds
            t.round = len(s.challenges)
            self.time = t

    def rounds(self) -> int:
        return self.space.tot_rounds

    def fold(self, r: int) -> None:
        if self.time is not None:
            self.time.fold(r)
        else:
            self.space.fold(r)
            self._maybe_switch()

    def next_message(self, challenge: Optional[int]):
        if challenge is not None:
            self.fold(challenge)
        if self.time is not None:
            return self.time.next_message(None)
        return self.space.next_message(None)

    def final_foldings(self):
        if self.time is not None:
            return self.time.final_foldings()
        return self.space.final_foldings()
