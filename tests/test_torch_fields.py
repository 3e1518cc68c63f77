"""Field-op parity: gemini_tpu_torch.fields.fp against gemini_tpu.fields.fp.

The same numpy-seeded inputs go through both packages on the CPU; every
comparison is exact (np.array_equal on the 16-bit limbs).  At most 3
collected cases (the tier-1 scheduling rule in ROADMAP.md); the JAX side
compiles with XLA's optimizations off (integer results do not depend on
them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gemini_tpu.fields import fp as jfp
from gemini_tpu_torch.fields import fp as tfp

torch.set_num_threads(1)

SPECS = {"Fq": (jfp.FQ, tfp.FQ), "Fr": (jfp.FR, tfp.FR)}
N = 16  # lanes: one shape per op keeps the JAX compiles few


@pytest.fixture(scope="module", autouse=True)
def _unoptimized_jax():
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


def _values(modulus: int, n: int, seed: int) -> list[int]:
    """n field elements from a numpy generator, edge values first."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 12), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % modulus
            for row in words]
    return [0, 1, modulus - 1, 2] + vals[4:]


def _pair(spec_j, n, seed, mont=True):
    enc = spec_j.encode(_values(spec_j.modulus, n, seed), mont=mont)
    return jnp.asarray(enc), torch.from_numpy(enc.astype(np.int32))


def _same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64),
                          t.numpy().astype(np.int64))


@pytest.mark.parametrize("name", ["Fq", "Fr"])
def test_field_ops_match_gemini_tpu(name):
    """add, sub, neg, mont_mul, to_mont, from_mont, inv."""
    sj, st = SPECS[name]
    aj, at = _pair(sj, N, 1)
    bj, bt = _pair(sj, N, 2)
    assert _same(jfp.add(sj, aj, bj), tfp.add(st, at, bt))
    assert _same(jfp.sub(sj, aj, bj), tfp.sub(st, at, bt))
    assert _same(jfp.sub(sj, bj, aj), tfp.sub(st, bt, at))
    assert _same(jfp.neg(sj, aj), tfp.neg(st, at))
    assert _same(jfp.mont_mul(sj, aj, bj), tfp.mont_mul(st, at, bt))
    cj, ct = _pair(sj, N, 5, mont=False)
    assert _same(jfp.to_mont(sj, cj), tfp.to_mont(st, ct))
    assert _same(jfp.from_mont(sj, aj), tfp.from_mont(st, at))
    assert _same(jfp.inv(sj, aj), tfp.inv(st, at))
    # the port's own broadcasting of an (L, 1) scalar, and pow_fixed
    assert torch.equal(tfp.mont_mul(st, at, bt[:, 5:6]),
                       tfp.mont_mul(st, at, bt[:, 5:6].expand(-1, N)))
    inv = st.decode(tfp.inv(st, at))
    src = st.decode(at)
    assert all((v * x - (1 if x else 0)) % st.modulus == 0
               for v, x in zip(inv, src))
    assert st.decode(tfp.pow_fixed(st, at, 5)) == [
        pow(x, 5, st.modulus) for x in src]


def test_sums_and_selects_match_gemini_tpu():
    """lane_sum, reduce_relaxed, select, is_zero, eq, encode/decode."""
    sj, st = jfp.FR, tfp.FR
    aj, at = _pair(sj, N, 7)
    sum_j = jfp.lane_sum(sj, aj, axis=1)
    sum_t = tfp.lane_sum(st, at, axis=1)
    assert _same(sum_j, sum_t)
    red_j = jfp.reduce_relaxed(sj, jnp.asarray(sum_j)[:, None])
    red_t = tfp.reduce_relaxed(st, sum_t[:, None])
    assert _same(red_j, red_t)
    assert st.decode(red_t)[0] == sum(st.decode(at)) % st.modulus

    sj, st = jfp.FQ, tfp.FQ
    aj, at = _pair(sj, N, 8)
    bj, bt = _pair(sj, N, 9)
    mask = np.arange(N) % 3 == 0
    assert _same(jfp.select(jnp.asarray(mask), aj, bj),
                 tfp.select(torch.from_numpy(mask), at, bt))
    assert np.array_equal(np.asarray(jfp.is_zero(sj, aj)),
                          tfp.is_zero(st, at).numpy())
    assert np.array_equal(np.asarray(jfp.eq(sj, aj, aj)), tfp.eq(st, at, at).numpy())
    vals = _values(st.modulus, N, 8)
    assert st.decode(st.tensor(vals, "cpu")) == sj.decode(aj) == vals
    assert _same(sj.ones_mont((3,)), st.ones_mont((3,), "cpu"))
