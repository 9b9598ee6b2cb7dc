"""dot / scaleAndAdd / threshold / transpose validation vs the golden
oracle, mirroring the reference's tolerances
(test/validate/02_vector.cpp:259-554, 03_matrix.cpp:153-245)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clover_tpu import golden
from clover_tpu.formats import pad_to, unpack_nibbles
from clover_tpu.ops import (
    dot, quantize_vec, quantize_mat, restore_vec, scale_and_add, threshold,
    transpose,
)

SIZES = [128, 191, 256, 500, 1024]


def _int_data(rng, n, mag=10):
    return rng.integers(-mag, mag + 1, size=n).astype(np.float32)


def _codes_of(q):
    return (np.asarray(unpack_nibbles(q.codes)) if q.bits == 4
            else np.asarray(q.codes))


# ---------------------------------------------------------------------------
# dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_dot_vs_golden(rng, bits, n):
    # Reference tolerance: |delta| <= 0.02 on integer data in [-10, 10]
    # scaled by size (accumulation reorder), 02_vector.cpp:259-295.
    u = _int_data(rng, n)
    v = _int_data(rng, n)
    qu = quantize_vec(jnp.asarray(u), bits, key=None)
    qv = quantize_vec(jnp.asarray(v), bits, key=None)
    got = float(dot(qu, qv))
    want = golden.dot(_codes_of(qu), np.asarray(qu.scales),
                      _codes_of(qv), np.asarray(qv.scales), bits)
    assert abs(got - want) <= 0.02 * max(1.0, abs(want))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [512, 1024, 4096])
def test_dot_float_vs_golden(rng, bits, n):
    """Float data: the blocked int dot against golden within the
    reference's reordered-accumulation tolerance (02_vector.cpp:280)."""
    u = rng.random(n, dtype=np.float32) * 2 - 1
    v = rng.random(n, dtype=np.float32) * 2 - 1
    qu = quantize_vec(jnp.asarray(u), bits, key=None)
    qv = quantize_vec(jnp.asarray(v), bits, key=None)
    got = float(dot(qu, qv))
    want = float(golden.dot(_codes_of(qu), np.asarray(qu.scales),
                            _codes_of(qv), np.asarray(qv.scales), bits))
    assert abs(got - want) <= 0.02 * max(1.0, abs(want) / 10)


@pytest.mark.parametrize("bits", [16, 32])
def test_dot_fp(rng, bits):
    n = 512
    u = _int_data(rng, n)
    v = _int_data(rng, n)
    qu = quantize_vec(jnp.asarray(u), bits)
    qv = quantize_vec(jnp.asarray(v), bits)
    want = float(np.dot(u.astype(np.float64), v.astype(np.float64)))
    assert abs(float(dot(qu, qv)) - want) <= 1e-3 * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# scaleAndAdd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", SIZES)
def test_scale_and_add_deterministic_bitexact(rng, bits, n):
    u = _int_data(rng, n)
    v = _int_data(rng, n)
    qu = quantize_vec(jnp.asarray(u), bits, key=None)
    qv = quantize_vec(jnp.asarray(v), bits, key=None)
    r = scale_and_add(qu, qv, -0.5, key=None)
    g_codes, g_scales = golden.scale_and_add(
        _codes_of(qu), np.asarray(qu.scales),
        _codes_of(qv), np.asarray(qv.scales), -0.5, bits, noise=0.0)
    np.testing.assert_array_equal(_codes_of(r), g_codes)
    np.testing.assert_array_equal(np.asarray(r.scales), g_scales)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [512, 1000, 1024])
def test_scale_and_add_float_vs_golden(rng, bits, n):
    """Float data: XLA may contract the dequant-fma into one rounding, so
    a razor-edge floor() can flip a code by one on <= 0.5% of elements
    (the reference's own validation is tolerance-based for reordered
    arithmetic, 02_vector.cpp:280-283); scales match to 1e-6."""
    u = rng.random(n, dtype=np.float32) * 2 - 1
    v = rng.random(n, dtype=np.float32) * 2 - 1
    qu = quantize_vec(jnp.asarray(u), bits, key=None)
    qv = quantize_vec(jnp.asarray(v), bits, key=None)
    r = scale_and_add(qu, qv, -0.5, key=None)
    g_codes, g_scales = golden.scale_and_add(
        _codes_of(qu), np.asarray(qu.scales),
        _codes_of(qv), np.asarray(qv.scales), -0.5, bits, noise=0.0)
    diff = _codes_of(r).astype(np.int32) - g_codes.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).mean() <= 0.005
    np.testing.assert_allclose(np.asarray(r.scales), g_scales, rtol=1e-6)


def test_scale_and_add_fp32_exact(rng):
    n = 300
    u = _int_data(rng, n)
    v = _int_data(rng, n)
    qu = quantize_vec(jnp.asarray(u), 32)
    qv = quantize_vec(jnp.asarray(v), 32)
    r = scale_and_add(qu, qv, 2.0)
    np.testing.assert_array_equal(np.asarray(r.values)[:n], u + 2.0 * v)


# ---------------------------------------------------------------------------
# threshold (top-K)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("n", [128, 500, 1024, 8192])  # 8192 -> two-stage
def test_threshold_vs_golden(rng, bits, n):
    k = 32
    x = (rng.random(n, dtype=np.float32) * 2 - 1)
    q = quantize_vec(jnp.asarray(x), bits, key=None)
    t = threshold(q, k)
    got = np.asarray(restore_vec(t).values)[:n]
    if bits in (4, 8):
        g_codes = golden.threshold(_codes_of(q), np.asarray(q.scales),
                                   k, pad_to(n), bits)
        want = golden.restore_vec(g_codes, np.asarray(q.scales), bits)[:n]
    else:
        want = golden.threshold_f32(
            np.asarray(restore_vec(q).values), k, pad_to(n))[:n]
    # Reference tolerance: top-K sets equal within 10% on restored
    # magnitudes (02_vector.cpp:449-554); with our deterministic
    # tie-break both sides should in fact match exactly.
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) <= k
    # scales untouched
    if bits in (4, 8):
        np.testing.assert_array_equal(np.asarray(t.scales),
                                      np.asarray(q.scales))


@pytest.mark.parametrize("n,k", [(2048, 64), (8192, 2048), (4096, 4095),
                                 (65536, 17), (131072, 100)])
def test_threshold4_sizes_vs_golden(rng, n, k):
    """4-bit threshold at the sizes and k of the retired fused kernel's
    checks, through the shipped dispatch, against golden."""
    x = rng.random(n, dtype=np.float32) * 2 - 1
    q = quantize_vec(jnp.asarray(x), 4, key=None)
    got = _codes_of(threshold(q, k))
    want = golden.threshold(_codes_of(q), np.asarray(q.scales), k, n, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(2048, 64), (8192, 2048), (65536, 17)])
def test_threshold8_sizes_vs_golden(rng, n, k):
    """8-bit dense path (approx candidate + exact verification, or
    bisection for k > 1024) against golden."""
    x = rng.random(n, dtype=np.float32) * 2 - 1
    q = quantize_vec(jnp.asarray(x), 8, key=None)
    got = _codes_of(threshold(q, k))
    want = golden.threshold(_codes_of(q), np.asarray(q.scales), k, n, 8)
    np.testing.assert_array_equal(got, want)


def test_threshold_keeps_largest(rng):
    x = np.zeros(256, np.float32)
    x[10] = 5.0
    x[100] = -9.0
    x[200] = 1.0
    q = quantize_vec(jnp.asarray(x), 8, key=None)
    t = threshold(q, 2)
    got = np.asarray(restore_vec(t).values)
    assert got[100] != 0 and got[10] != 0 and got[200] == 0


def test_threshold_adjacent_bit_ties(rng):
    """Regression: values whose f32 bit patterns are ADJACENT integers
    must still yield exactly k nonzeros.  A 10-level bisection (ignoring
    the per-level remainder slack) left a ~10-wide final bracket whose
    tau was not an element, dropping ties and keeping k-1."""
    from clover_tpu.formats import QVec32
    v = np.zeros(256, np.float32)
    v[3] = np.int32(774840985).view(np.float32)
    v[77] = np.int32(774840984).view(np.float32)
    out = np.asarray(threshold(QVec32(values=jnp.asarray(v),
                                      length=256), 2).values)
    assert np.count_nonzero(out) == 2

    loc = np.random.default_rng(7)
    for _ in range(25):
        base = loc.integers(1, 2 ** 30, dtype=np.int32)
        v = np.zeros(512, np.float32)
        idx = loc.choice(512, 5, replace=False)
        for j, d in zip(idx, [0, 1, 2, -1, 7]):
            v[j] = np.int32(base + d).view(np.float32)
        k = int(loc.integers(1, 6))
        out = np.asarray(threshold(QVec32(values=jnp.asarray(v),
                                          length=512), k).values)
        assert np.count_nonzero(out) == k


@pytest.mark.parametrize("fan", [9, 27, 81, 243])
def test_bisect_helpers_adversarial(fan):
    """The bisector (ops._tau_bisect) finds the exact k-th largest on
    adversarial adjacent-integer multisets, at every sweepable fan-out
    (_bisect_levels guarantees the depth)."""
    from clover_tpu.ops.threshold import _tau_bisect
    loc = np.random.default_rng(3)
    for _ in range(25):
        base = int(loc.integers(1, 2 ** 30))
        vals = np.array([base, base + 1, base + 2, base - 1, base + 9],
                        np.int32)
        cnts = loc.integers(1, 4, size=5).astype(np.int32)
        k = int(loc.integers(1, int(cnts.sum()) + 1))
        bits = jnp.asarray(vals)
        fvals = jax.lax.bitcast_convert_type(bits, jnp.float32)
        tau, n_above, n_eq = _tau_bisect(fvals, jnp.asarray(cnts), k, fan=fan)
        tau = int(tau)
        srt = np.repeat(vals, cnts)[np.argsort(-np.repeat(vals, cnts))]
        want = int(srt[k - 1])
        assert tau == want, (tau, want, k)
        assert int(n_above) < k <= int(n_above) + int(n_eq)


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("shape", [(128, 128), (128, 256), (200, 440)])
def test_transpose_roundtrip(rng, bits, shape):
    m, n = shape
    a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    q = quantize_mat(jnp.asarray(a), bits, key=None)
    t = transpose(q)
    assert (t.rows, t.cols) == (n, m)
    # Bit-exact: T(A)[j, i] == A[i, j] on restored values
    # (reference: 03_matrix.cpp:153-245).
    from clover_tpu.ops import restore_mat
    ra = np.asarray(restore_mat(q).values)
    rt = np.asarray(restore_mat(t).values)
    np.testing.assert_array_equal(rt, ra.T)
    tt = transpose(t)
    rtt = np.asarray(restore_mat(tt).values)
    np.testing.assert_array_equal(rtt, ra)
