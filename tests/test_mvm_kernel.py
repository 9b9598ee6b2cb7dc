"""The Triton MVM kernel (clover_tpu/kernels/mvm.py) in interpret mode
against golden.py and the plain XLA path, the wrapper's choice of
kernel, and — on a GPU only — the compiled kernel.

The integer accumulation is exact by construction; only the f32 order of
the scale combine differs (per k-tile vs golden's sequential order), so
f32 results compare at a tight relative tolerance and requantized codes
may differ by one LSB.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import clover_tpu as ct
from clover_tpu import golden
from clover_tpu.formats import BLOCK, QVec4, QVec8, unpack_nibbles
from clover_tpu.kernels import mvm as kmvm
from clover_tpu.ops.axpy import scale_and_add

ops_mvm = importlib.import_module("clover_tpu.ops.mvm")

MODES = [(4, 4), (4, 8), (8, 8)]
# padded m (200, 1000) and n (1000, 3000); 2048 and 3000 take several
# k-tiles of NBT * 64 = 1024 columns
SHAPES = [(128, 1024), (200, 1000), (256, 2048), (1000, 3000)]


def _mk(rng, m, n, bits_a, bits_x):
    A = rng.random((m, n), dtype=np.float32) * 2 - 1
    x = rng.random(n, dtype=np.float32) * 2 - 1
    return ct.quantize(jnp.asarray(A), bits_a), ct.quantize(jnp.asarray(x),
                                                            bits_x)


def _codes(q):
    return np.asarray(unpack_nibbles(q.codes) if q.bits == 4 else q.codes,
                      np.int32)


def _golden_f32(qA, qx):
    return golden.mvm_f32_exact(_codes(qA), np.asarray(qA.scales),
                                _codes(qx), np.asarray(qx.scales),
                                qA.bits, qx.bits)


def _assert_close(got, want):
    """Codes within one LSB, scales within 1e-6 relative."""
    assert type(got) is type(want) and got.length == want.length
    assert got.codes.shape == want.codes.shape
    assert np.abs(_codes(got) - _codes(want)).max(initial=0) <= 1
    np.testing.assert_allclose(np.asarray(got.scales),
                               np.asarray(want.scales), rtol=1e-6)


def _plain(qA, qx, key=None):
    y32 = ops_mvm.mvm_f32(qA, qx)
    return ops_mvm._requant_output(y32, qA.rows, ops_mvm._out_bits(qA, qx),
                                   key)


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("m,n", SHAPES)
def test_kernel_f32_vs_golden(rng, bits_a, bits_x, m, n):
    qA, qx = _mk(rng, m, n, bits_a, bits_x)
    assert kmvm.eligible(qA, qx)
    got = np.asarray(kmvm.mvm_f32(qA, qx, interpret=True))
    want = _golden_f32(qA, qx)
    assert got.shape == want.shape == (qA.rows_pad,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
    assert np.all(got[m:] == 0)                     # padding rows


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("m,n", SHAPES)
def test_kernel_requant_vs_golden(rng, bits_a, bits_x, m, n):
    """Deterministic requantization against golden's band requant of
    golden's own f32 result."""
    qA, qx = _mk(rng, m, n, bits_a, bits_x)
    got = kmvm.mvm(qA, qx, key=None, interpret=True)
    out_bits = 4 if (bits_a, bits_x) == (4, 4) else 8
    g_codes, g_scales = golden.quantize_vec(_golden_f32(qA, qx), out_bits)
    assert got.bits == out_bits and got.length == m
    assert np.abs(_codes(got) - g_codes).max() <= 1
    np.testing.assert_allclose(np.asarray(got.scales), g_scales, rtol=1e-6)


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("m,n", [(256, 1024), (200, 3000)])
def test_kernel_sr_matches_plain(rng, bits_a, bits_x, m, n):
    """Kernel and plain path draw the same SR noise from the same key."""
    qA, qx = _mk(rng, m, n, bits_a, bits_x)
    for key in (jax.random.PRNGKey(3), jnp.asarray([77], jnp.int32)):
        _assert_close(kmvm.mvm(qA, qx, key, interpret=True),
                      _plain(qA, qx, key))


@pytest.mark.parametrize("bits_a,bits_x", MODES)
def test_kernel_sr_statistics(rng, bits_a, bits_x):
    """SR is unbiased: the mean of 16 draws beats truncation's error, and
    the draws differ."""
    qA, qx = _mk(rng, 128, 1024, bits_a, bits_x)
    y = _golden_f32(qA, qx)
    outs = [np.asarray(ct.restore(kmvm.mvm(
        qA, qx, jax.random.PRNGKey(s), interpret=True)).values)
        for s in range(16)]
    lsb = np.abs(y).reshape(-1, BLOCK).max(1).repeat(BLOCK) / (
        7.0 if (bits_a, bits_x) == (4, 4) else 127.0)
    assert np.all(np.abs(np.mean(outs, axis=0) - y) <= 0.75 * lsb + 1e-6)
    assert any(not np.array_equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("bits_a,bits_x", MODES)
@pytest.mark.parametrize("m,n", [(512, 1024), (200, 2048), (1024, 1000)])
def test_kernel_axpy_matches_unfused(rng, bits_a, bits_x, m, n):
    """The AXPY epilogue equals scale_and_add applied to the kernel's own
    MVM output, within one LSB (fma contraction), for both signs of
    alpha."""
    qA, qx = _mk(rng, m, n, bits_a, bits_x)
    out_bits = 4 if (bits_a, bits_x) == (4, 4) else 8
    u = ct.quantize(jnp.asarray(rng.random(m, dtype=np.float32) * 2 - 1),
                    out_bits)
    t1 = kmvm.mvm(qA, qx, interpret=True)
    for alpha in (-1.0, 0.00513):
        _assert_close(kmvm.mvm_axpy(qA, qx, u, alpha, interpret=True),
                      scale_and_add(u, t1, alpha))


@pytest.mark.parametrize("bits_a,bits_x", MODES)
def test_kernel_axpy_sr(rng, bits_a, bits_x):
    """With SR on both legs the epilogue follows the unfused sequence
    drawn from the same two keys."""
    qA, qx = _mk(rng, 256, 1024, bits_a, bits_x)
    out_bits = 4 if (bits_a, bits_x) == (4, 4) else 8
    u = ct.quantize(jnp.asarray(rng.random(256, dtype=np.float32)), out_bits)
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    t1 = kmvm.mvm(qA, qx, k1, interpret=True)
    _assert_close(kmvm.mvm_axpy(qA, qx, u, -0.5, k1, k2, interpret=True),
                  scale_and_add(u, t1, -0.5, key=k2))


def test_kernel_output_containers(rng):
    qA, qx = _mk(rng, 192, 1024, 4, 4)
    out = kmvm.mvm(qA, qx, interpret=True)
    assert isinstance(out, QVec4) and out.length == 192
    assert out.codes.shape == (256 // 2,) and out.scales.shape == (4,)
    qA8, qx8 = _mk(rng, 192, 1024, 4, 8)
    out8 = kmvm.mvm(qA8, qx8, interpret=True)
    assert isinstance(out8, QVec8) and out8.codes.shape == (256,)


def test_kernel_zero_matrix():
    """A zero band requantizes to zero codes with scale 1.0 (the zero
    4-bit code packs to byte 0x08)."""
    qA = ct.quantize(jnp.zeros((128, 1024), jnp.float32), 4)
    qx = ct.quantize(jnp.ones((1024,), jnp.float32), 4)
    out = kmvm.mvm(qA, qx, interpret=True)
    assert np.all(np.asarray(out.codes) == 0x08)
    assert np.all(np.asarray(out.scales) == 1.0)


def _eligibility_cases():
    q4 = ct.quantize(jnp.ones((128, 1024), jnp.float32), 4)
    q8 = ct.quantize(jnp.ones((128, 1024), jnp.float32), 8)
    v4, v8 = (ct.quantize(jnp.ones((1024,), jnp.float32), b) for b in (4, 8))
    u4 = ct.quantize(jnp.ones((128,), jnp.float32), 4)
    u8 = ct.quantize(jnp.ones((128,), jnp.float32), 8)
    return {
        "4x4": (q4, v4, None, True),
        "4x8": (q4, v8, None, True),
        "8x8": (q8, v8, None, True),
        "8x4": (q8, v4, None, False),
        "16x16": (ct.quantize(jnp.ones((128, 1024)), 16),
                  ct.quantize(jnp.ones((1024,)), 16), None, False),
        "partial-k-tile": (ct.quantize(jnp.ones((128, 512)), 4),
                           ct.quantize(jnp.ones((512,)), 4), None, False),
        "axpy-u-ok": (q4, v4, u4, True),
        "axpy-u-precision": (q4, v4, u8, False),
        "axpy-u-length": (q4, v4, ct.quantize(jnp.ones((256,)), 4), False),
    }


@pytest.mark.parametrize("case", ["4x4", "4x8", "8x8", "8x4", "16x16",
                                  "partial-k-tile", "axpy-u-ok",
                                  "axpy-u-precision", "axpy-u-length"])
def test_kernel_eligibility(case):
    A, x, u, want = _eligibility_cases()[case]
    assert kmvm.eligible(A, x, u) is want


@pytest.fixture
def kernel_on_gpu(monkeypatch):
    """Make ops.mvm see a GPU and count kernel calls; the kernel itself
    runs in interpret mode."""
    calls = []

    def spy(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k, interpret=True)
        return run

    monkeypatch.setattr(ops_mvm, "_on_gpu", lambda: True)
    for name in ("mvm", "mvm_f32", "mvm_axpy"):
        monkeypatch.setattr(kmvm, name, spy(getattr(kmvm, name)))
    return calls


@pytest.mark.parametrize("op", ["mvm", "mvm_f32_fast", "mvm_axpy"])
@pytest.mark.parametrize("n", [1024, 640])
def test_wrapper_chooses_kernel(rng, kernel_on_gpu, op, n):
    """On a GPU the ops take the kernel for eligible shapes (n=1024) and
    the plain path otherwise (n=640: not whole k-tiles); both agree."""
    qA, qx = _mk(rng, 256, n, 4, 4)
    u = ct.quantize(jnp.asarray(rng.random(256, dtype=np.float32)), 4)
    run = {"mvm": lambda: ops_mvm.mvm(qA, qx),
           "mvm_f32_fast": lambda: ops_mvm.mvm_f32_fast(qA, qx),
           "mvm_axpy": lambda: ops_mvm.mvm_axpy(qA, qx, u, -1.0)}[op]
    got = run()
    assert len(kernel_on_gpu) == (1 if n == 1024 else 0)
    if op == "mvm_f32_fast":
        np.testing.assert_allclose(np.asarray(got),
                                   np.asarray(ops_mvm.mvm_f32(qA, qx)),
                                   atol=2e-6 * float(jnp.abs(got).max()))
    elif op == "mvm":
        _assert_close(got, _plain(qA, qx))


def test_wrapper_plain_off_gpu(rng):
    """Off a GPU (this CPU suite) every op takes the plain path."""
    qA, qx = _mk(rng, 256, 1024, 4, 4)
    assert not ops_mvm._use_kernel(qA, qx)
    _assert_close(ops_mvm.mvm(qA, qx), _plain(qA, qx))


@pytest.mark.parametrize("mb,vb", [(4, 4), (4, 8)])
def test_solver_iteration_on_kernel(rng, kernel_on_gpu, mb, vb):
    """One solver iteration through the kernel path (two MVM+AXPY
    epilogues traced under jit) tracks the plain iteration; the
    threshold then keeps K elements on both."""
    from clover_tpu.models.solvers import _iteration
    m, n = 1024, 1024
    phi = rng.random((m, n), dtype=np.float32) * 2 - 1
    y = phi @ (rng.random(n, dtype=np.float32) * 2 - 1)
    qphi = ct.quantize(jnp.asarray(phi), mb)
    qphit = ct.transpose(qphi)
    qy = ct.quantize(jnp.asarray(y / np.abs(y).max()), vb)
    qx = ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) - 0.5), vb)
    step = jax.jit(lambda *a: _iteration(*a, jnp.float32(1e-3), None, None))
    got = step(qphi, qphit, qy, qx)
    assert kernel_on_gpu == ["mvm_axpy", "mvm_axpy"]
    assert np.count_nonzero(np.asarray(ct.restore(
        ct.threshold(got, 64)).values)) <= 64
    ops_mvm._on_gpu = lambda: False       # restored by monkeypatch
    want = jax.jit(lambda *a: _iteration(*a, jnp.float32(1e-3), None,
                                         None))(qphi, qphit, qy, qx)
    gv = np.asarray(ct.restore(got).values)
    wv = np.asarray(ct.restore(want).values)
    step_lsb = np.repeat(np.maximum(np.asarray(got.scales),
                                    np.asarray(want.scales)), BLOCK) / (
        7.0 if vb == 4 else 127.0)
    assert np.mean(np.abs(gv - wv) <= 2 * step_lsb + 1e-7) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("bits_a,bits_x", MODES)
def test_compiled_kernel_matches_plain(rng, bits_a, bits_x):
    """The compiled kernel on the card against the plain XLA path at a
    streaming width (n=32768, 1024 rows): f32 mode, deterministic and SR
    requantization, and the AXPY epilogue."""
    qA, qx = _mk(rng, 1024, 32768, bits_a, bits_x)
    y32 = ops_mvm.mvm_f32(qA, qx)
    np.testing.assert_allclose(np.asarray(kmvm.mvm_f32(qA, qx)),
                               np.asarray(y32),
                               atol=2e-6 * float(jnp.abs(y32).max()))
    out_bits = ops_mvm._out_bits(qA, qx)
    u = ct.quantize(jnp.asarray(rng.random(1024, dtype=np.float32)),
                    out_bits)
    for key in (None, jax.random.PRNGKey(5)):
        t1 = kmvm.mvm(qA, qx, key)
        _assert_close(t1, _plain(qA, qx, key))
        _assert_close(kmvm.mvm_axpy(qA, qx, u, -0.5, key, key),
                      scale_and_add(u, t1, -0.5, key=key))
