"""Quantize/restore validation vs the golden oracle.

Mirrors the reference validation suite (test/validate/02_vector.cpp:112-256,
test/validate/03_matrix.cpp:38-149): bit-exact equality in deterministic
mode, quantize->restore consistency |x - x̂| <= 1 on integer data, across a
size sweep covering every padding phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clover_tpu import golden
from clover_tpu.formats import unpack_nibbles, pad_to
from clover_tpu.ops import quantize_vec, quantize_mat, restore_vec, restore_mat

SIZES = [128, 129, 191, 192, 255, 256, 257, 500, 1000, 1023, 1024, 512,
         4096]
SHAPES = [(128, 128), (128, 256), (200, 300), (256, 128), (130, 570),
          (256, 384), (192, 512)]


def _int_data(rng, n):
    return rng.integers(-10, 11, size=n).astype(np.float32)


def _float_data(rng, n):
    return (rng.random(n, dtype=np.float32) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_vec_deterministic_bitexact(rng, bits, n):
    x = _float_data(rng, n)
    q = quantize_vec(jnp.asarray(x), bits, key=None)
    xp = np.zeros(pad_to(n), np.float32)
    xp[:n] = x
    g_codes, g_scales = golden.quantize_vec(xp, bits, noise=0.0)
    codes = np.asarray(unpack_nibbles(q.codes)) if bits == 4 else np.asarray(q.codes)
    np.testing.assert_array_equal(codes, g_codes)
    np.testing.assert_array_equal(np.asarray(q.scales), g_scales)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_restore_consistency(rng, bits, n):
    # Integer data in [-7, 7]: restored values within 1.0 of the input
    # (reference: test/validate/02_vector.cpp:182-221, setRandomInteger(7)),
    # even with SR on (4-bit SR step = s/7 <= 1 for this data).
    x = rng.integers(-7, 8, size=n).astype(np.float32)
    key = jax.random.PRNGKey(7)
    q = quantize_vec(jnp.asarray(x), bits, key=key)
    xr = np.asarray(restore_vec(q).values)[:n]
    assert np.max(np.abs(xr - x)) <= 1.0 + 1e-5


@pytest.mark.parametrize("bits", [4, 8])
def test_restore_matches_golden(rng, bits):
    n = 512
    x = _float_data(rng, n)
    q = quantize_vec(jnp.asarray(x), bits, key=None)
    codes = np.asarray(unpack_nibbles(q.codes)) if bits == 4 else np.asarray(q.codes)
    g = golden.restore_vec(codes, np.asarray(q.scales), bits)
    np.testing.assert_array_equal(np.asarray(restore_vec(q).values), g)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [512, 4000, 16384])
def test_restore_vec_sizes_vs_golden(rng, bits, n):
    """restore is bit-identical to golden's code * (scale/qmax), padding
    included."""
    q = quantize_vec(jnp.asarray(_float_data(rng, n)), bits, key=None)
    codes = np.asarray(unpack_nibbles(q.codes)) if bits == 4 else np.asarray(q.codes)
    got = restore_vec(q)
    assert got.length == n and got.values.shape == (pad_to(n),)
    np.testing.assert_array_equal(
        np.asarray(got.values), golden.restore_vec(codes, np.asarray(q.scales),
                                                   bits))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,n", [(256, 512), (128, 1024), (200, 500)])
def test_restore_mat_vs_golden(rng, bits, m, n):
    a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    q = quantize_mat(jnp.asarray(a), bits, key=None)
    codes = np.asarray(unpack_nibbles(q.codes)) if bits == 4 else np.asarray(q.codes)
    got = restore_mat(q)
    assert (got.rows, got.cols) == (m, n)
    np.testing.assert_array_equal(
        np.asarray(got.values), golden.restore_mat(codes, np.asarray(q.scales),
                                                   bits))


def test_quantize_zero_block():
    x = np.zeros(256, np.float32)
    x[128:] = 3.0
    q = quantize_vec(jnp.asarray(x), 4, key=None)
    s = np.asarray(q.scales)
    assert s[0] == 1.0 and s[1] == 1.0  # zero blocks normalized
    assert s[2] == 3.0 and s[3] == 3.0
    np.testing.assert_allclose(np.asarray(restore_vec(q).values), x,
                               rtol=1e-6)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_mat_deterministic_bitexact(rng, bits, shape):
    m, n = shape
    a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    q = quantize_mat(jnp.asarray(a), bits, key=None)
    ap = np.zeros((pad_to(m), pad_to(n)), np.float32)
    ap[:m, :n] = a
    g_codes, g_scales = golden.quantize_mat(ap, bits, noise=0.0)
    codes = np.asarray(unpack_nibbles(q.codes)) if bits == 4 else np.asarray(q.codes)
    np.testing.assert_array_equal(codes, g_codes)
    np.testing.assert_array_equal(np.asarray(q.scales), g_scales)
    rest = np.asarray(restore_mat(q).values)
    np.testing.assert_array_equal(rest, golden.restore_mat(g_codes, g_scales, bits))


@pytest.mark.parametrize("bits", [16, 32])
def test_fp_formats_roundtrip(rng, bits):
    x = _int_data(rng, 300)  # exactly representable in fp16
    q = quantize_vec(jnp.asarray(x), bits)
    xr = np.asarray(restore_vec(q).values)[:300]
    np.testing.assert_array_equal(xr, x)


def test_sr_statistics(rng):
    # Stochastic rounding must be unbiased: E[q] = x * qmax / s.
    n = 64
    x = np.full(n, 0.35, np.float32)
    x[0] = 1.0  # pin the scale to 1.0
    reps = 128
    xx = jnp.asarray(np.tile(x, (reps, 1)).reshape(-1))  # reps blocks
    q = quantize_vec(xx, 4, key=jax.random.PRNGKey(0))
    codes = np.asarray(unpack_nibbles(q.codes), np.float64).reshape(reps, n)
    mean = codes[:, 1:].mean()
    # true value 0.35 * 7 = 2.45
    assert abs(mean - 2.45) < 0.05
    # deterministic mode truncates: floor(2.45) = 2
    qd = quantize_vec(jnp.asarray(x), 4, key=None)
    assert np.all(np.asarray(unpack_nibbles(qd.codes))[1:n] == 2)
