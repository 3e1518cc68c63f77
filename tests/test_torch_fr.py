"""Fr field-core parity: the plain versions of the port's Fr ops (the
CUDA kernels' references, csrc/fr_kernels.cu) against gemini_tpu.fields.fp
on the CPU, and the rule that CPU tensors never reach the kernels.

The same numpy-seeded inputs go through both packages: edge values
(0, 1, r - 1), broadcast (16, 1) and (16, 1, m) operands, half and
even/odd views, the fused product-and-sum (`mul_lane_sum`, `ip`,
`_fold_block`) against gemini_tpu's `lane_sum(mont_mul(a, b))`, and
`reduce_relaxed` on edge rows, against gemini_tpu inside its uint32 row
contract and against Python integers beyond it (rows up to 2^47 - 1).
chip_smoke.py holds the kernels against these plain versions bit for bit
on the card.  Tolerance: exact limbs everywhere.  At most 3 collected
cases (ROADMAP.md, tier-1 rule).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemini_tpu.fields import fp as jfp
from gemini_tpu_torch.fields import fp, fr_kernels
from gemini_tpu_torch.fields.fp import FR
from gemini_tpu_torch.ops import poly
from gemini_tpu_torch.params import R
from gemini_tpu_torch.streaming.sumcheck import _fold_block

torch.set_num_threads(1)

JFR = jfp.FR
EDGES = [0, 1, R - 1, 2, R - 2]


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _values(rng, n, edges=True):
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    return (EDGES + vals)[:n] if edges else vals


def _enc(vals, shape=None, mont=True):
    arr = JFR.encode(vals, mont=mont)
    return arr if shape is None else arr.reshape(16, *shape)


def _same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def _t(arr):
    return torch.from_numpy(arr.astype(np.int32))


def test_plain_fr_ops_match_gemini_tpu():
    """add, sub, neg, mont_mul and from_mont (a non-Montgomery one as b)
    on edge values, on halves and even/odd views of one tensor, against
    broadcast (16, 1) scalars and (16, 1, m) weights."""
    rng = np.random.default_rng(1201)
    x = _enc(_values(rng, 32))
    xt = _t(x)
    views = {"halves": (xt[:, :16], xt[:, 16:], x[:, :16], x[:, 16:]),
             "even/odd": (xt[:, 0::2], xt[:, 1::2], x[:, 0::2], x[:, 1::2])}
    for a_t, b_t, a_j, b_j in views.values():
        a_j, b_j = jnp.asarray(np.ascontiguousarray(a_j)), jnp.asarray(
            np.ascontiguousarray(b_j))
        assert _same(jfp.mont_mul(JFR, a_j, b_j), fp.mont_mul(FR, a_t, b_t))
        assert _same(jfp.add(JFR, a_j, b_j), fp.add(FR, a_t, b_t))
        assert _same(jfp.sub(JFR, a_j, b_j), fp.sub(FR, a_t, b_t))
        assert _same(jfp.neg(JFR, a_j), fp.neg(FR, a_t))
        assert _same(jfp.from_mont(JFR, a_j), fp.from_mont(FR, a_t))
    s = _enc(_values(rng, 1, edges=False))  # (16, 1)
    a_t, a_j = views["halves"][0], jnp.asarray(np.ascontiguousarray(x[:, :16]))
    for fj, ft in ((jfp.mont_mul, fp.mont_mul), (jfp.add, fp.add), (jfp.sub, fp.sub)):
        assert _same(fj(JFR, a_j, jnp.asarray(s)), ft(FR, a_t, _t(s)))
    r_minus_1 = _enc([R - 1], mont=False)  # the largest canonical b
    assert _same(jfp.mont_mul(JFR, a_j, jnp.asarray(r_minus_1)),
                 fp.mont_mul(FR, a_t, _t(r_minus_1)))
    grouped = _enc(_values(rng, 16), (2, 8))
    w = _enc(_values(rng, 8, edges=False), (1, 8))
    assert _same(jfp.mont_mul(JFR, jnp.asarray(grouped), jnp.asarray(w)),
                 fp.mont_mul(FR, _t(grouped), _t(w)))


def _rows_value(v):
    return [sum(int(v[k, j]) << (16 * k) for k in range(v.shape[0])) % R
            for j in range(v.shape[1])]


def test_fused_lane_sum_and_reduce_match_gemini_tpu():
    """mul_lane_sum (2D, and grouped with (16, 1, m) weights), poly.ip and
    _fold_block against gemini_tpu's lane_sum(mont_mul(a, b)) and its
    reduction; reduce_relaxed at E = 16-21 rows: every row at 2^32 - 2^16
    - 1 (gemini_tpu's largest) and random rows against gemini_tpu, every
    row at 2^47 - 1 and V = 0, V = r against Python integers."""
    rng = np.random.default_rng(1202)
    a = _enc(_values(rng, 64))
    b = _enc(_values(rng, 64, edges=False))
    want = jfp.lane_sum(JFR, jfp.mont_mul(JFR, jnp.asarray(a), jnp.asarray(b)), axis=1)
    assert _same(want, fp.mul_lane_sum(FR, _t(a), _t(b), axis=1))
    assert poly.ip(FR, _t(a), _t(b)) == JFR.decode_relaxed(np.asarray(want)[:, None])[0]

    block = _enc(_values(rng, 64), (8, 8))
    w = _enc(_values(rng, 8, edges=False), (1, 8))
    sums = jfp.lane_sum(JFR, jfp.mont_mul(JFR, jnp.asarray(block), jnp.asarray(w)),
                        axis=2)
    assert _same(sums, fp.mul_lane_sum(FR, _t(block), _t(w), axis=2))
    assert _same(jfp.reduce_relaxed(JFR, sums),
                 _fold_block(_t(block.reshape(16, 64)), _t(w.reshape(16, 8))))

    top = (1 << 32) - (1 << 16) - 1
    for e in (16, 18):
        v = rng.integers(0, top + 1, size=(e, 5), dtype=np.uint64)
        v[:, 0] = top
        v[:, 1] = 0
        v = v.astype(np.uint32)
        got = fp.reduce_relaxed(FR, torch.from_numpy(v.astype(np.int64)))
        assert _same(jfp.reduce_relaxed(JFR, jnp.asarray(v)), got)
        assert FR.decode(got, mont=False) == _rows_value(v)
    for e in range(16, 22):
        v = np.zeros((e, 4), dtype=np.int64)
        v[:, 0] = (1 << 47) - 1
        v[:16, 2] = [(R >> (16 * k)) & 0xFFFF for k in range(16)]  # V = r
        v[:, 3] = rng.integers(0, 1 << 47, size=e)
        got = fp.reduce_relaxed(FR, torch.from_numpy(v))
        assert FR.decode(got, mont=False) == _rows_value(v)
        assert _rows_value(v)[1:3] == [0, 0]


def test_cpu_tensors_never_reach_fr_kernels(monkeypatch):
    """The wrappers of fields/fr_kernels.py raise on CPU tensors, and with
    every one of them made to raise, the golden SNARK instance still
    proves on the CPU to gemini_tpu's bytes (testdata/snark_golden.json)
    with no `_carry` counted on a CUDA tensor."""
    from gemini_tpu_torch.kzg.commit import CommitterKey
    from gemini_tpu_torch.relation import random_r1cs
    from gemini_tpu_torch.serialize import snark_proof_bytes
    from gemini_tpu_torch.snark import Proof

    x = FR.tensor([1, 2], "cpu")
    for call in (lambda: fr_kernels.mul(x, x), lambda: fr_kernels.addsub(x, x, True),
                 lambda: fr_kernels.reduce(x), lambda: fr_kernels.lane_sum(x)):
        with pytest.raises(ValueError, match="CUDA"):
            call()

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached an Fr kernel")

    for name in ("mul", "addsub", "reduce", "lane_sum", "_lib"):
        monkeypatch.setattr(fr_kernels, name, refuse)
    monkeypatch.setattr(fp, "CUDA_CARRIES", {"Fr": 0, "Fq": 0})
    path = os.path.join(os.path.dirname(fp.__file__), os.pardir, "testdata",
                        "snark_golden.json")
    with open(path) as f:
        g = json.load(f)
    r1 = random_r1cs(random.Random(g["r1cs_seed"]), g["n"], device="cpu")
    ck = CommitterKey.new(max_degree=g["max_degree"],
                          max_eval_points=g["max_eval_points"], seed=g["srs_seed"],
                          device="cpu")
    assert snark_proof_bytes(Proof.new_time(r1, ck)).hex() == g["proof_hex"]
    assert fp.CUDA_CARRIES == {"Fr": 0, "Fq": 0}
