"""Sparse MVM, batched MVM / GEMM, element access, data-gen parity."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import clover_tpu as ct
from clover_tpu.formats import BLOCK, QVec4
from clover_tpu.ops import (
    gemm_f32, mat_get, mvm_batched, mvm_f32, mvm_sparse, random_floats,
    random_integers, vec_get, vec_get_code, vec_set_code,
)
from clover_tpu.ops.quantize import restore_mat


def _sparse_vec(rng, n, k, bits):
    x = np.zeros(n, np.float32)
    idx = rng.permutation(n)[:k]
    x[idx] = rng.random(k, dtype=np.float32) + 0.5
    return ct.quantize(jnp.asarray(x), bits)


@pytest.mark.parametrize("bits", [4, 8])
def test_mvm_sparse_matches_dense(rng, bits):
    m, n, k = 256, 512, 16
    A = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    qA = ct.quantize(jnp.asarray(A), bits)
    qAT = ct.transpose(qA)
    qx = _sparse_vec(rng, n, k, bits)
    y_sparse = mvm_sparse(qAT, qx, k)
    y_dense = np.asarray(mvm_f32(qA, qx))
    got = np.asarray(ct.restore(y_sparse).values)
    lsb = np.repeat(np.asarray(y_sparse.scales), BLOCK) / (
        7.0 if y_sparse.bits == 4 else 127.0)
    # requant LSB + f32 ordering slack
    assert np.all(np.abs(got - y_dense) <= lsb + 1e-3 * np.abs(y_dense) + 1e-4)


def test_mvm_batched_matches_loop(rng):
    m, n, r = 128, 256, 4
    A = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    qA = ct.quantize(jnp.asarray(A), 4)
    vecs = [ct.quantize(jnp.asarray(
        rng.random(n, dtype=np.float32) * 2 - 1), 4) for _ in range(r)]
    xs = jax.tree.map(lambda *a: jnp.stack(a), *vecs)
    ys = mvm_batched(qA, xs)
    for i, v in enumerate(vecs):
        ref = ct.mvm(qA, v)
        got_codes = np.asarray(ys.codes[i])
        np.testing.assert_array_equal(got_codes, np.asarray(ref.codes))
        np.testing.assert_array_equal(np.asarray(ys.scales[i]),
                                      np.asarray(ref.scales))


def _stack(qs):
    return jax.tree.map(lambda *a: jnp.stack(a), *qs)


@pytest.mark.parametrize("bits_a,bits_x", [(4, 4), (4, 8), (8, 8)])
@pytest.mark.parametrize("b", [2, 3, 8])        # 3: non-power-of-two batch
def test_mvm_batched_matches_single(rng, bits_a, bits_x, b):
    """Each vector of a batch gets exactly its single-vector MVM."""
    m, n = 256, 512
    qA = ct.quantize(jnp.asarray(rng.random((m, n), dtype=np.float32)
                                 * 2 - 1), bits_a)
    vecs = [ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) * 2
                                    - 1), bits_x) for _ in range(b)]
    ys = mvm_batched(qA, _stack(vecs))
    for j, v in enumerate(vecs):
        want = ct.mvm(qA, v)
        np.testing.assert_array_equal(np.asarray(ys.codes[j]),
                                      np.asarray(want.codes))
        np.testing.assert_array_equal(np.asarray(ys.scales[j]),
                                      np.asarray(want.scales))


@pytest.mark.parametrize("bits_a,bits_x", [(4, 4), (4, 8), (8, 8)])
def test_mvm_batched_f32_matches_single(rng, bits_a, bits_x):
    """The batched f32-output form (the sharded server's per-shard
    partial) equals the per-vector f32 MVM."""
    from clover_tpu.ops.gemm import mvm_batched_f32
    m, n, b = 256, 512, 4
    qA = ct.quantize(jnp.asarray(rng.random((m, n), dtype=np.float32)
                                 * 2 - 1), bits_a)
    vecs = [ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) * 2
                                    - 1), bits_x) for _ in range(b)]
    got = np.asarray(mvm_batched_f32(qA, _stack(vecs)))
    assert got.shape == (b, m)
    for j, v in enumerate(vecs):
        np.testing.assert_array_equal(got[j], np.asarray(mvm_f32(qA, v)))


def test_mvm_batched_sr_statistics(rng):
    """With SR on, each vector draws its own stream (seed + j): equal
    inputs get different codes, and the mean over draws is unbiased."""
    m, n = 256, 512
    qA = ct.quantize(jnp.asarray(rng.random((m, n), dtype=np.float32)
                                 * 2 - 1), 4)
    qx = ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1),
                     4)
    y = np.asarray(mvm_f32(qA, qx))
    outs = []
    for s in range(4):
        ys = mvm_batched(qA, _stack([qx] * 4), key=jax.random.PRNGKey(s))
        outs += [np.asarray(ct.restore(jax.tree.map(lambda a: a[j],
                                                    ys)).values)
                 for j in range(4)]
    assert not np.array_equal(outs[0], outs[1])
    lsb = np.abs(y).reshape(-1, BLOCK).max(1).repeat(BLOCK) / 7.0
    assert np.all(np.abs(np.mean(outs, axis=0) - y) <= 0.75 * lsb + 1e-6)


@pytest.mark.parametrize("bits", [4, 8])
def test_gemm_f32_matches_restore_matmul(rng, bits):
    m, n, r = 128, 256, 8
    A = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    B = (rng.random((n, r), dtype=np.float32) * 2 - 1)
    qA = ct.quantize(jnp.asarray(A), bits)
    got = np.asarray(gemm_f32(qA, jnp.asarray(B)))
    ref = np.asarray(restore_mat(qA).values) @ B
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_element_access_roundtrip(rng):
    x = (rng.random(200, dtype=np.float32) * 2 - 1)
    for bits in (4, 8):
        q = ct.quantize(jnp.asarray(x), bits)
        restored = np.asarray(ct.restore(q).values)
        for i in (0, 1, 31, 32, 63, 64, 100, 199):
            assert abs(vec_get(q, i) - restored[i]) < 1e-6
        q2 = vec_set_code(q, 5, 3)
        assert vec_get_code(q2, 5) == 3
        assert vec_get_code(q2, 4) == vec_get_code(q, 4)
        assert vec_get_code(q2, 5 + 32) == vec_get_code(q, 5 + 32)

    A = (rng.random((130, 130), dtype=np.float32) * 2 - 1)
    qA = ct.quantize(jnp.asarray(A), 4)
    ra = np.asarray(restore_mat(qA).values)
    for (i, j) in ((0, 0), (1, 95), (65, 64), (129, 129)):
        assert abs(mat_get(qA, i, j) - ra[i, j]) < 1e-6


def test_vec_gather_matches_restore(rng):
    """Vectorized element gather (ops.access.vec_gather) equals the
    restored values at the gathered indices, every precision."""
    from clover_tpu.ops.access import vec_gather
    n = 512
    x = (rng.random(n, dtype=np.float32) * 2 - 1)
    idx = jnp.asarray(rng.integers(0, n, 64), jnp.int32)
    for bits in (4, 8, 16, 32):
        q = ct.quantize(jnp.asarray(x), bits)
        restored = np.asarray(ct.restore(q).values)
        got = np.asarray(jax.jit(vec_gather)(q, idx))
        np.testing.assert_allclose(got, restored[np.asarray(idx)],
                                   rtol=1e-6, atol=1e-7)


def test_random_generators_reproducible():
    a = np.asarray(random_floats(5, 7, 100))
    b = np.asarray(random_floats(5, 7, 100))
    np.testing.assert_array_equal(a, b)
    assert np.all((a >= 0) & (a < 1))
    ints = np.asarray(random_integers(5, 7, 1000, 7))
    assert ints.min() >= -7 and ints.max() <= 7
    assert np.all(ints == np.round(ints))


def test_threshold4_hybrid_exact(rng):
    """The hybrid (compressed-multiset top-k selector + integer-cutoff
    mask) must match the wide-view bisect path bit-for-bit across tie
    storms and degenerate inputs, including blocks whose magnitude
    planes collapse to one f32 value (a scale so small that s/7
    underflows: every code of the block is a zero-valued tie)."""
    import jax
    import clover_tpu as ct
    from clover_tpu import golden
    from clover_tpu.formats import QVec4, pack_nibbles, unpack_nibbles
    from clover_tpu.ops.threshold import (_threshold4_hybrid,
                                          _threshold4_xla)

    cases = []
    for (n, k) in ((256, 3), (1024, 64), (4096, 257), (65536, 64)):
        v = (rng.random(n, dtype=np.float32) * 2 - 1)
        cases.append((ct.quantize(jnp.asarray(v), 4), k))
        cases.append((ct.quantize(jnp.asarray(
            rng.integers(-3, 4, n).astype(np.float32)), 4), k))
        z = np.zeros(n, np.float32)
        z[rng.permutation(n)[:max(1, k // 2)]] = 1.0
        cases.append((ct.quantize(jnp.asarray(z), 4), k))   # tau == 0
    for n, k in ((4096, 200), (4096, 40)):
        codes = rng.integers(-7, 8, n).astype(np.int8)
        scales = np.full(n // 64, 1e-45, np.float32)        # s/7 -> 0
        scales[:2] = [1.0, 0.5]
        cases.append((QVec4(codes=pack_nibbles(jnp.asarray(codes)),
                            scales=jnp.asarray(scales), length=n), k))
    for q, k in cases:
        a = jax.jit(_threshold4_xla, static_argnums=1)(q, k)
        b = jax.jit(_threshold4_hybrid, static_argnums=1)(q, k)
        assert np.array_equal(np.asarray(a.codes),
                              np.asarray(b.codes)), (q.length, k)
        assert np.array_equal(np.asarray(a.scales), np.asarray(b.scales))
        want = golden.threshold(np.asarray(unpack_nibbles(q.codes)),
                                np.asarray(q.scales), k, q.length, 4)
        np.testing.assert_array_equal(
            np.asarray(unpack_nibbles(b.codes)), want)
