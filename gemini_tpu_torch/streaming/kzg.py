"""Space-efficient KZG committer (port of gemini_tpu/streaming/kzg.py;
kzg/space.rs analogue).

The SRS lives on the device and the coefficients stream from host RAM:
commit is a loop of partial MSMs over `max_msm_buffer`-sized chunks
(ops/msm.py, so every chunk runs the padd/padd01 kernels, or add under
GEMINI_TPU_PROJ=0), accumulated with single host group additions.  The
group elements are those of the dense committer, and device memory is
bounded by the chunk size.

`open` uses the streaming quotient identity q_i = x^-(i+1) * S_{i+1}
with S_i = sum_{j>=i} f_j x^j: blocks are processed high to low and the
suffix S carries across blocks in one (L, 1) device column, so a
division is one pass (kzg/space.rs:95-166).  Multi-point openings chain
`_DivideStage`s block by block and feed the last quotient's blocks
straight into partial MSMs (`_fused_open_msm`), so
`batch_open_multi_points` reads each input once and writes nothing to
the host.
"""

from __future__ import annotations

import random
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..curve import g1
from ..device import resolve
from ..fields import fp
from ..fields.fp import FR
from ..hostcurve import g1_add, g1_mul, g2_mul
from ..kzg.commit import CommitterKey, VerifierKey, _suffix_sums
from ..ops import poly
from ..ops.msm import msm_mont_scalars
from ..params import R
from ..refimpl import g1_generator, g2_generator
from .host import DeviceVector, HostVector, device_block, from_device_limbs
from .ops import _lincomb_device_block, hv_evaluate, hv_lincomb

G1Host = Optional[Tuple[int, int]]

MAX_MSM_BUFFER_LOG = 20  # kzg/space.rs:41 analogue


class _DivideStage:
    """Streaming synthetic division by (X - x), x != 0 mod R: consumes
    blocks of the dividend high to low and emits quotient blocks high to
    low in the same pass.  Its state is one (L, 1) device column, the
    rolling suffix S_off = sum_{j>=off} f_j x^j (kzg/space.rs:95-126).
    After the last (lowest) block, `evaluation()` is f(x)."""

    def __init__(self, x: int, n: int, device):
        assert x % R != 0
        self.x = x % R
        self.xinv = pow(self.x, -1, R)
        self.n = n  # dividend length; the quotient has n-1 slots
        self.device = device
        self.s_after = FR.zeros((1,), device)

    def feed(self, off: int, block) -> Tuple[int, torch.Tensor]:
        """One dividend block [off, off+m) -> (off, quotient block),
        trimmed to the quotient's n-1 valid slots."""
        m = block.shape[1]
        dev = self.device
        t = fp.mont_mul(FR, block, poly.powers(FR, self.x, m, dev))
        s_local = _suffix_sums(t)
        s_global = fp.add(
            FR,
            fp.mont_mul(FR, s_local, poly.scalar(FR, pow(self.x, off, R), dev)),
            self.s_after.expand_as(s_local),
        )
        # q_i = S_{i+1} x^-(i+1): within the block shift by one; the
        # tail slot's S_{off+m} is the incoming carry.
        s_next = torch.cat([s_global[:, 1:], self.s_after], dim=1)
        inv_pows = fp.mont_mul(
            FR,
            poly.powers(FR, self.xinv, m, dev),
            poly.scalar(FR, pow(self.xinv, off + 1, R), dev),
        )
        qblock = fp.mont_mul(FR, s_next, inv_pows)
        self.s_after = s_global[:, :1]
        take = max(0, min(m, self.n - 1 - off))
        return off, qblock[:, :take]

    def evaluation(self) -> int:
        """f(x), valid once every block has been fed."""
        return FR.decode(self.s_after)[0]


def _lincomb_rev_blocks(hvs, coeffs, block_size: int):
    """Blocks of sum_i coeffs[i]*hvs[i] (index-0 aligned, max length),
    yielded high to low without materializing the combination."""
    n = max(len(hv) for hv in hvs)
    dev = hvs[0].device
    cs = [poly.scalar(FR, c, dev) for c in coeffs]
    for off in reversed(range(0, n, block_size)):
        m = min(block_size, n - off)
        acc = _lincomb_device_block(hvs, cs, off, m)
        yield off, acc if acc is not None else FR.zeros((m,), dev)


class CommitterKeyStream:
    """Streaming flavour of CommitterKey (kzg/space.rs:59); the key's G1
    powers and the streamed vectors share a device.  `mesh`: an optional
    `parallel.Mesh` across whose devices every partial MSM splits its
    lanes."""

    def __init__(self, ck: CommitterKey,
                 max_msm_buffer: int = 1 << MAX_MSM_BUFFER_LOG, mesh=None):
        self.ck = ck
        self.max_msm_buffer = max_msm_buffer
        self.devices = list(mesh.devices) if mesh is not None else None

    def bases(self, off: int, m: int):
        """SRS G1 window [off, off+m): the override point of synthetic
        key streams."""
        a = self.ck.powers_of_g
        return g1.APoint(a.x[:, off: off + m], a.y[:, off: off + m],
                         a.inf[off: off + m])

    def _partial(self, acc: G1Host, off: int, scalars_mont) -> G1Host:
        """acc + MSM(bases[off:], scalars): one partial MSM folded into
        the host accumulator; its lanes split across the mesh's devices
        when one was given."""
        part = msm_mont_scalars(self.bases(off, scalars_mont.shape[1]),
                                scalars_mont, devices=self.devices)
        return g1_add(acc, g1.decode_jacobian(part)[0])

    def commit(self, hv: HostVector) -> G1Host:
        """Chunked MSM accumulation (kzg/space.rs:22-55)."""
        acc = None
        for off, block in hv.blocks(self.max_msm_buffer):
            acc = self._partial(acc, off, block)
        return acc

    def batch_commit(self, hvs: Sequence[HostVector]) -> List[G1Host]:
        return [self.commit(v) for v in hvs]

    def evaluate(self, hv: HostVector, x: int) -> int:
        """Streaming f(x), in blocks of the MSM buffer."""
        return hv_evaluate(hv, x, self.max_msm_buffer)

    def open(self, hv: HostVector, x: int) -> Tuple[int, G1Host]:
        """(f(x), commitment to the quotient (f - f(x))/(X - x)) in one
        streaming pass: `_DivideStage` emits quotient blocks high to
        low, each folded into the MSM accumulator at once."""
        n = len(hv)
        blk = self.max_msm_buffer
        if n == 0:
            return 0, None
        acc = None
        if x % R == 0:
            ev = FR.decode(hv.device_slice(0, 1))[0]
            for off, block in hv.blocks(blk):
                qblock = block[:, 1:] if off == 0 else block
                if qblock.shape[1]:
                    acc = self._partial(acc, max(off - 1, 0), qblock)
            return ev, acc
        stage = _DivideStage(x, n, hv.device)
        for off in reversed(range(0, n, blk)):
            qoff, qblock = stage.feed(off, hv.device_slice(off, min(off + blk, n)))
            if qblock.shape[1]:
                acc = self._partial(acc, qoff, qblock)
        return stage.evaluation(), acc

    def commit_folding(self, hv: HostVector, challenges: Sequence[int]
                       ) -> Tuple[List[G1Host], List[HostVector]]:
        """Commit to every folding f^(1..len-1) of hv, skipping the last
        challenge (kzg/space.rs:192-223 `commit_folding`).  Each level
        is one streaming pass over geometrically shrinking data: every
        folded block is committed (partial MSM) as it is produced and
        kept for the next level and the later openings.  Returns
        (commitments, foldings), the group elements of the dense
        `foldings_polynomial` + `batch_commit`."""
        cur = hv
        comms: List[G1Host] = []
        folds: List[HostVector] = []
        for ch in challenges[:-1]:
            cur, cm = self._fold_commit(cur, ch)
            comms.append(cm)
            folds.append(cur)
        return comms, folds

    def _fold_commit(self, hv: HostVector, r: int) -> Tuple[HostVector, G1Host]:
        """Fused streaming fold + commit: out[k] = f[2k] + r*f[2k+1],
        kept AND partially MSM'd per block in one pass.  A fold that
        fits half an MSM buffer stays on the device; a larger one goes
        back to host RAM."""
        n = len(hv)
        out_n = (n + 1) // 2
        rs = poly.scalar(FR, r, hv.device)
        blk = max(2, self.max_msm_buffer - (self.max_msm_buffer % 2))
        keep_dev = out_n <= blk // 2
        out = None if keep_dev else np.zeros((FR.n_limbs, out_n), dtype=np.uint32)
        dev_out = []
        acc = None
        for off in range(0, n, blk):
            end = min(off + blk, n)
            m = end - off
            fb = poly.fold_polynomial(FR, device_block(hv, off, end,
                                                      pad_to=m + (m % 2)), rs)
            acc = self._partial(acc, off // 2, fb)
            if keep_dev:
                dev_out.append(fb)
            else:
                out[:, off // 2: off // 2 + fb.shape[1]] = from_device_limbs(fb)
        if keep_dev:
            return DeviceVector(torch.cat(dev_out, dim=1)[:, :out_n], hv.spec), acc
        return HostVector(out, hv.spec, hv.device), acc

    def open_multi_points(self, hv: HostVector, points: Sequence[int]) -> G1Host:
        """Streaming multi-point open (kzg/space.rs:128-166): chained
        synthetic divisions fused into one reverse pass with partial
        MSMs on the emitted quotient blocks."""
        return self._fused_open_msm([hv], [1], points)

    def batch_open_multi_points(self, hvs: Sequence[HostVector],
                                points: Sequence[int], eval_chal: int) -> G1Host:
        """Open sum_i eta^i f_i at every point: the streaming twin of
        CommitterKey.batch_open_multi_points (kzg/space.rs:229-285).
        One fused pass reads each input once."""
        etas = poly.powers_host(eval_chal, len(hvs))
        return self._fused_open_msm(list(hvs), etas, points)

    def _fused_open_msm(self, hvs: Sequence[HostVector], coeffs: Sequence[int],
                        points: Sequence[int]) -> G1Host:
        """One streaming pass, high to low: lincomb the sources block by
        block, chain the per-point `_DivideStage`s, and fold the last
        quotient's partial MSMs into the accumulator (the MSM does not
        depend on order).  A point equal to 0 takes the unfused chain:
        materialized lincomb, then one division per point."""
        pts = [p % R for p in points]
        if any(p == 0 for p in pts):
            q = hv_lincomb(list(hvs), coeffs, self.max_msm_buffer)
            for pt in pts:
                _, q = divide_linear_stream(q, pt, self.max_msm_buffer)
            return self.commit(q) if len(q) else None
        n = max(len(hv) for hv in hvs)
        stages = [_DivideStage(p, n - t, hvs[0].device) for t, p in enumerate(pts)]
        acc = None
        for off, block in _lincomb_rev_blocks(hvs, coeffs, self.max_msm_buffer):
            for st in stages:
                off, block = st.feed(off, block)
                if block.shape[1] == 0:
                    break
            if block.shape[1]:
                acc = self._partial(acc, off, block)
        return acc


class FakeCommitterKeyStream(CommitterKeyStream):
    """Constant-base synthetic SRS stream: powers_of_g[i] = g for every
    i, a real SRS with trapdoor τ = 1 (insecure, benchmark-only).

    The `DummyStreamer` SRS of the reference's examples
    (examples/snark.rs:55-67): commitments need one device column of
    g, expanded to the block width, whatever the degree.  τ = 1 is a valid trapdoor, so
    `verifier_key()` checks the proofs."""

    def __init__(self, max_eval_points: int = 4, seed: int = 0,
                 max_msm_buffer: int = 1 << MAX_MSM_BUFFER_LOG, device=None,
                 mesh=None):
        self.devices = list(mesh.devices) if mesh is not None else None
        rng = random.Random(seed)
        self.g = g1_mul(g1_generator(), rng.randrange(1, R))
        self.g2 = g2_mul(g2_generator(), rng.randrange(1, R))
        self.max_msm_buffer = max_msm_buffer
        ap = g1.encode_affine([self.g], resolve(device))
        self._tile = g1.APoint(ap.x.expand(-1, max_msm_buffer),
                               ap.y.expand(-1, max_msm_buffer),
                               ap.inf.expand(max_msm_buffer))
        self.powers_of_g2 = [self.g2] * (max_eval_points + 1)
        # The part of the dense key's surface that provers read.
        self.ck = SimpleNamespace(powers_of_g2=self.powers_of_g2)

    def bases(self, off: int, m: int):
        return g1.APoint(self._tile.x[:, :m], self._tile.y[:, :m],
                         self._tile.inf[:m])

    def verifier_key(self, max_eval_points: int | None = None) -> VerifierKey:
        """VerifierKey consistent with τ = 1."""
        m = max_eval_points if max_eval_points is not None else \
            len(self.powers_of_g2) - 1
        return VerifierKey([self.g] * (m + 1), list(self.powers_of_g2))


def divide_linear_stream(hv: HostVector, x: int,
                         block_size: int = 1 << MAX_MSM_BUFFER_LOG
                         ) -> Tuple[int, HostVector]:
    """Streaming division of f by (X - x): (f(x), quotient HostVector).
    One reverse pass of `_DivideStage` (kzg/space.rs:95-126), the
    quotient written to host RAM so that divisions can chain."""
    n = len(hv)
    if n == 0:
        return 0, hv
    if n == 1:
        return FR.decode(hv.device_slice(0, 1))[0], \
            HostVector(np.zeros((FR.n_limbs, 0), dtype=np.uint32), hv.spec,
                       hv.device)
    if x % R == 0:
        return FR.decode(hv.device_slice(0, 1))[0], \
            HostVector(np.asarray(hv.slice(1, n)), hv.spec, hv.device)
    out = np.zeros((FR.n_limbs, n - 1), dtype=np.uint32)
    stage = _DivideStage(x, n, hv.device)
    for off in reversed(range(0, n, block_size)):
        qoff, qblock = stage.feed(off, hv.device_slice(off, min(off + block_size, n)))
        if qblock.shape[1]:
            out[:, qoff: qoff + qblock.shape[1]] = from_device_limbs(qblock)
    return stage.evaluation(), HostVector(out, hv.spec, hv.device)
