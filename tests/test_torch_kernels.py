"""The port's kernels: plain versions against the Pallas kernels, and the
rules around them.

padd, padd01 and mont_mul's plain PyTorch versions (the versions the
wrappers take for CPU tensors, and the ones chip_smoke.py holds the CUDA
kernels against on the card) must equal gemini_tpu's Pallas kernels bit
for bit, relaxed outputs included.  The Pallas kernels run as the JAX
package's own TPU code does, through `pl.pallas_call(..., interpret=True)`
with the module's kernels, specs and constants, at 128 lanes with edge
lanes.  Tolerance: exact.

At most 3 collected cases, so that xdist's loadfile scheduling hands
this file out after the seed's files (ROADMAP.md, tier-1 rule); the JAX
side compiles with XLA's optimizations off (integer results do not
depend on them), which cuts its CPU time about fivefold.
"""

import ast
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from gemini_tpu.curve import pallas_g1 as pg
from gemini_tpu_torch.curve import g1_kernels as gk

torch.set_num_threads(1)

T = 128  # one Pallas tile
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = pg.FQ.modulus
# Per-compile XLA options for the interpret-mode kernels: one codegen
# thread and no fusion emitters (the graphs are huge, the data tiny).
CHEAP_COMPILE = {"xla_cpu_use_fusion_emitters": False,
                 "xla_cpu_parallel_codegen_split_count": 1}


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _pallas(kernel, ins, specs, nout):
    out_spec = [pg._coord_spec(T)] * nout
    out_shape = [pg._coord_out(T)] * nout

    def call(*args):
        return pl.pallas_call(
            kernel, grid=(1,),
            in_specs=[pg._const_spec(), pg._mx_spec()] + specs,
            out_specs=out_spec, out_shape=out_shape, interpret=True,
        )(pg._consts(), pg._mx(), *args)

    args = [jnp.asarray(x) for x in ins]
    outs = jax.jit(call).lower(*args).compile(CHEAP_COMPILE)(*args)
    return [np.asarray(o).astype(np.int64) for o in outs]


def _lanes(rng, top):
    """(24, T) 16-bit limbs with the top limb < top (0x3402: < 2p,
    0x1A01: < p)."""
    a = rng.integers(0, 1 << 16, size=(24, T)).astype(np.uint32)
    a[23] = rng.integers(0, top, size=T)
    return a


def _put(arr, lane, val):
    arr[:, lane] = [(val >> (16 * i)) & 0xFFFF for i in range(24)]


def _int(arr, lane):
    return sum(int(arr[i, lane]) << (16 * i) for i in range(24))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _same(ref, got):
    return all(np.array_equal(r, g.numpy().astype(np.int64))
               for r, g in zip(ref, got))


def test_plain_kernels_match_pallas():
    """mont_mul, padd and padd01 (in that order) with edge lanes."""
    rng = np.random.default_rng(11)
    a, b = _lanes(rng, 0x1A01), _lanes(rng, 0x1A01)
    for i, v in enumerate((0, 1, P - 1, pg._R384)):
        _put(a, i, v)
        _put(b, 4 + i, v)
    ref = _pallas(pg._mm_kernel, [a, b], [pg._coord_spec(T)] * 2, 1)
    assert _same(ref, [gk.mont_mul(_t(a), _t(b))])

    ins = [_lanes(rng, 0x3402) for _ in range(6)]
    x1, y1, z1, x2, y2, z2 = ins
    for k in range(3):  # P = Q (lanes 0-7), P = -Q (lanes 8-15)
        ins[3 + k][:, :16] = ins[k][:, :16]
    for lane in range(8, 16):
        _put(y2, lane, 2 * P - _int(y1, lane))
    z1[:, 16:24] = 0  # identity on the left (0 : y : 0)
    x1[:, 16:24] = 0
    z2[:, 24:32] = 0  # identity on the right
    x2[:, 24:32] = 0
    for lane in range(32, 40):  # coordinates in [p, 2p)
        for arr in ins:
            _put(arr, lane, P + lane * 977)
    ref = _pallas(pg._padd_kernel, ins, [pg._coord_spec(T)] * 6, 3)
    assert _same(ref, gk.padd(tuple(map(_t, ins[:3])), tuple(map(_t, ins[3:]))))

    x1, y1, x2, y2 = (_lanes(rng, 0x3402) for _ in range(4))
    m1 = rng.integers(0, 2, size=(1, T)).astype(np.uint32)
    m2 = rng.integers(0, 2, size=(1, T)).astype(np.uint32)
    m1[0, :4], m2[0, :4] = [0, 0, 1, 1], [0, 1, 0, 1]  # every combination
    x2[:, 4:8], y2[:, 4:8] = x1[:, 4:8], y1[:, 4:8]  # P = Q
    m1[0, 4:8] = m2[0, 4:8] = 1
    x1[:, m1[0] == 0] = 0  # dead lanes are (0 : y : 0)
    x2[:, m2[0] == 0] = 0
    specs = [pg._coord_spec(T), pg._coord_spec(T), pg._mask_spec(T)] * 2
    ref = _pallas(pg._padd01_kernel, [x1, y1, m1, x2, y2, m2], specs, 3)
    got = gk.padd01((_t(x1), _t(y1), torch.from_numpy(m1[0] > 0)),
                    (_t(x2), _t(y2), torch.from_numpy(m2[0] > 0)))
    assert _same(ref, got)


def test_relaxed_ops_match_bigint_model():
    """rmm / rmm_add / radd / rsub of the plain version against Python
    integers: REDC returns (T + m p) / 2^384 with the unique m in
    [0, 2^384), the reference's relaxed-domain contract."""
    rnd = random.Random(14)
    R384 = 1 << 384
    nprime = (-pow(P, -1, R384)) % R384
    vals = [[rnd.randrange(2 * P) for _ in range(16)] for _ in range(4)]

    def limbs(vs):
        a = np.zeros((24, len(vs)), np.int64)
        for j, v in enumerate(vs):
            _put(a, j, v)
        return torch.from_numpy(a)

    def ints(t):
        a = t.numpy()
        return [sum(int(a[i, j]) << (16 * i) for i in range(24))
                for j in range(a.shape[1])]

    def redc(t):
        m = (t % R384) * nprime % R384
        return (t + m * P) // R384 % R384

    a, b, c, d = vals
    A, B, C, D = (limbs(v) for v in vals)
    assert ints(gk._rmm(A, B)) == [redc(x * y) for x, y in zip(a, b)]
    assert ints(gk._rmm_add(A, B, C, D)) == [
        redc(x * y + z * w) for x, y, z, w in zip(a, b, c, d)]
    assert ints(gk._radd(A, B)) == [
        x + y - 2 * P if x + y >= 2 * P else x + y for x, y in zip(a, b)]
    assert ints(gk._rsub(A, B)) == [
        x - y + 2 * P if x < y else x - y for x, y in zip(a, b)]
    assert ints(gk._rneg(limbs([0] * 16))) == [2 * P] * 16


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_boundaries(monkeypatch):
    """The port imports neither jax nor gemini_tpu; CUDA entry points
    raise without a card; CPU calls take the plain versions and count no
    launch (the group-law kernels and the benchmark probes)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "gemini_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "gemini_tpu")]
    assert bad == []

    from gemini_tpu_torch.device import resolve
    from gemini_tpu_torch.kzg.commit import CommitterKey
    from gemini_tpu_torch.relation import dummy_r1cs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve(None)
    with pytest.raises(RuntimeError):
        CommitterKey.new(max_degree=3, max_eval_points=1)
    with pytest.raises(RuntimeError):
        dummy_r1cs(random.Random(0), 4)
    assert resolve("cpu").type == "cpu"
    # the launch path itself refuses tensors that are not on a card
    x = torch.zeros((24, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        gk._launch("padd", "g1_padd", [x] * 6, 3, [24] * 6)

    gk.reset_launches()
    rng = np.random.default_rng(15)
    a = _t(_lanes(rng, 0x1A01)[:, :8])
    gk.mont_mul(a, a)
    gk.padd((a, a, a), (a, a, a))
    m = torch.ones(8, dtype=torch.bool)
    gk.padd01((a, a, m), (a, a, m))
    gk.add((a, a, a), (a, a, a))
    gk.double((a, a, a))
    assert gk.LAUNCHES == {"padd": 0, "padd01": 0, "mont_mul": 0, "add": 0,
                           "dbl": 0}
    assert gk.LANES == dict.fromkeys(gk.LAUNCHES, 0)
    # padd/padd01 read the MSM's views as laid out: (limb, batch, lane)
    # strides of a (24, W, n) tensor's halves, even/odd split, transposed
    # halves (the SRS tree), and of its (W, n) bool masks
    c = torch.zeros((24, 4, 16), dtype=torch.int32)
    mk = torch.zeros((4, 16), dtype=torch.bool)
    assert gk.lane_strides(c[..., 8:], 24) == (64, 16, 1)
    assert gk.lane_strides(c[..., 1::2], 24) == (64, 16, 2)
    assert gk.lane_strides(c.transpose(1, 2)[..., :2], 24) == (64, 1, 16)
    assert gk.lane_strides(mk[..., 0::2], 0) == (0, 16, 2)
    assert gk.lane_strides(a, 24) == (8, 0, 1)
    assert gk.lane_strides(c.reshape(24, 2, 2, 16)[:, :, 1], 24) == (64, 32, 1)
    with pytest.raises(ValueError):  # leading dims that do not merge
        gk.lane_strides(c.reshape(24, 2, 2, 16)[:, :, :, :4].transpose(1, 2), 24)
    with pytest.raises(ValueError):
        gk.lane_strides(torch.zeros(24, dtype=torch.int32), 24)
    from gemini_tpu_torch.benches import probes

    probes.reset_launches()
    probes.vpu_chain(a, a, 3)
    probes.copy_add(a, a)
    assert probes.LAUNCHES == {"vpu_chain": 0, "copy_add": 0}
    with pytest.raises(ValueError):
        probes._launch("copy_add", "probe_copy_add", a, a)
    # batch shapes pass through the wrappers: (24, 2, 4) in, out
    out = gk.padd((a.reshape(24, 2, 4),) * 3, (a.reshape(24, 2, 4),) * 3)
    assert out[0].shape == (24, 2, 4)
