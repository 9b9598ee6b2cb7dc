"""`-v` validation mode: production ops vs the golden oracle.

Re-creates the reference's validation suite (test/validate/02_vector.cpp:
557-641, 03_matrix.cpp:576-645): size sweeps across padding phases,
bit-exact checks where the reference is bit-exact (quantize/restore/
scaleAndAdd with SR off, transpose round-trip), tolerance checks where it
is tolerance-based (dot 0.02, mixed MVM 0.016 relative, threshold top-K
within 10%).  Prints Good/Failed per check and dumps the first mismatch
side by side (the reference's simd_debug::compare behavior).

The reference sweeps EVERY size in 128..2047; each distinct shape is a
fresh XLA compile, so the default sweep covers every padding phase once
(64 consecutive sizes) plus larger spot sizes, and an accelerator runs a
compact set; ``full=True`` restores the exhaustive range.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import golden
from ..formats import BLOCK, pad_matrix, pad_vector, unpack_nibbles
from ..ops import dot, mvm, quantize, restore, scale_and_add, threshold, \
    transpose
from ..ops.mvm import mvm_f32
from ..utils.debug import compare

DEFAULT_VEC_SIZES = list(range(128, 192)) + [255, 256, 384, 511, 512, 1000,
                                             1024, 2047]
DEFAULT_MAT_SHAPES = [(128, 128), (128, 256), (192, 320), (256, 128),
                      (384, 640), (512, 512), (1000, 200), (1280, 1280)]


def codes_close(got, want) -> bool:
    """Two requantized containers agree: codes within one LSB, scales
    within 1e-6 relative (the kernel and the plain path differ only in
    the f32 order of the scale combine)."""
    def codes(q):
        return np.asarray(unpack_nibbles(q.codes) if q.bits == 4
                          else q.codes).astype(np.int32)
    sg, sw = np.asarray(got.scales), np.asarray(want.scales)
    return (np.abs(codes(got) - codes(want)).max(initial=0) <= 1
            and np.all(np.abs(sg - sw) <= 1e-6 * np.abs(sw)))


def mvm_close(got, want) -> bool:
    """Two f32 MVM results agree to f32 summation-order noise."""
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.all(np.abs(got - want)
                       <= 1e-5 * (np.abs(want).max() + 1e-30)))


class Validator:
    def __init__(self, log=print):
        self.log = log
        self.failures = 0
        self.checks = 0

    def check(self, name, ok, a=None, b=None):
        self.checks += 1
        if ok:
            self.log(f"Validating {name:60s} Good")
        else:
            self.failures += 1
            self.log(f"Validating {name:60s} Failed")
            if a is not None:
                self.log(compare(np.asarray(a), np.asarray(b)))
        return ok

    # -- vector ops (ref 02_vector.cpp) ------------------------------------

    def vector_quantize(self, rng, bits, n):
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        q = quantize(jnp.asarray(x), bits)
        gc, gs = golden.quantize_vec(np.asarray(pad_vector(jnp.asarray(x))),
                                     bits, noise=0.0)
        codes = np.asarray(unpack_nibbles(q.codes) if bits == 4 else q.codes)
        ok = np.array_equal(codes, gc) and np.array_equal(
            np.asarray(q.scales), gs)
        return self.check(f"quantize  {bits:2d}-bit n={n}", ok, codes, gc)

    def vector_consistency(self, rng, bits, n):
        # integer data in [-7, 7] (ref setRandomInteger(7),
        # 02_vector.cpp:193): |x - restore(quantize(x))| <= 1
        x = rng.integers(-7, 8, n).astype(np.float32)
        q = quantize(jnp.asarray(x), bits)
        xr = np.asarray(restore(q).values)[:n]
        ok = np.all(np.abs(x - xr) <= 1.0)
        return self.check(f"consistency {bits:2d}-bit n={n}", ok, xr, x)

    def vector_restore(self, rng, bits, n):
        """Standalone restore bit-exactness — runs with SR ON, like the
        reference (test/validate/02_vector.cpp:224-256): whatever codes
        SR produced, restore must be bit-identical to codes*scale/qmax."""
        import jax
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        q = quantize(jnp.asarray(x), bits, key=jax.random.PRNGKey(n))
        got = np.asarray(restore(q).values)
        codes = np.asarray(unpack_nibbles(q.codes) if bits == 4 else q.codes)
        ref = golden.restore_vec(codes, np.asarray(q.scales), bits)
        ok = np.array_equal(got, ref)
        return self.check(f"restore   {bits:2d}-bit n={n} (SR on)", ok,
                          got, ref)

    def vector_dot(self, rng, bits, n):
        u = (rng.random(n, dtype=np.float32) * 2 - 1)
        v = (rng.random(n, dtype=np.float32) * 2 - 1)
        qu, qv = quantize(jnp.asarray(u), bits), quantize(jnp.asarray(v), bits)
        got = float(dot(qu, qv))
        if bits in (16, 32):
            ref = float(np.dot(np.asarray(restore(qu).values),
                               np.asarray(restore(qv).values)))
            ok = abs(got - ref) <= 0.02 * max(1.0, abs(ref))
        else:
            uc = np.asarray(unpack_nibbles(qu.codes) if bits == 4 else qu.codes)
            vc = np.asarray(unpack_nibbles(qv.codes) if bits == 4 else qv.codes)
            ref = float(golden.dot(uc, np.asarray(qu.scales), vc,
                                   np.asarray(qv.scales), bits))
            ok = abs(got - ref) <= 0.02   # ref tolerance 02_vector.cpp:280
        return self.check(f"dot       {bits:2d}-bit n={n}", ok,
                          [got], [ref])

    def vector_scale_and_add(self, rng, bits, n):
        u = (rng.random(n, dtype=np.float32) * 2 - 1)
        v = (rng.random(n, dtype=np.float32) * 2 - 1)
        qu, qv = quantize(jnp.asarray(u), bits), quantize(jnp.asarray(v), bits)
        r = scale_and_add(qu, qv, -0.5)
        if bits in (16, 32):
            ref = np.asarray(restore(qu).values) - 0.5 * np.asarray(
                restore(qv).values)
            got = np.asarray(restore(r).values)
            ok = np.allclose(got, ref.astype(got.dtype), rtol=1e-3, atol=1e-3)
            return self.check(f"scaleAndAdd {bits:2d}-bit n={n}", ok, got, ref)
        uc = np.asarray(unpack_nibbles(qu.codes) if bits == 4 else qu.codes)
        vc = np.asarray(unpack_nibbles(qv.codes) if bits == 4 else qv.codes)
        gc, gs = golden.scale_and_add(uc, np.asarray(qu.scales), vc,
                                      np.asarray(qv.scales), -0.5, bits, 0.0)
        rc = np.asarray(unpack_nibbles(r.codes) if bits == 4 else r.codes)
        # 1-ulp fma freedom: XLA may contract the dequant-fma
        diff = rc.astype(np.int32) - gc.astype(np.int32)
        ok = np.abs(diff).max(initial=0) <= 1 and (diff != 0).mean() <= 0.005
        return self.check(f"scaleAndAdd {bits:2d}-bit n={n}", ok, rc, gc)

    def vector_threshold(self, rng, bits, n):
        k = max(1, n // 8)
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        q = quantize(jnp.asarray(x), bits)
        t = threshold(q, k)
        vals = np.abs(np.asarray(restore(t).values)[:n])
        ref_vals = np.abs(np.asarray(restore(q).values)[:n])
        top_got = np.sort(vals[vals > 0])[::-1]
        top_ref = np.sort(ref_vals)[::-1][:len(top_got)]
        # top-K within 10% relative (ref 02_vector.cpp:449-554)
        ok = (np.count_nonzero(vals) <= k and len(top_got) > 0
              and np.all(top_got >= top_ref * 0.9 - 1e-6))
        return self.check(f"threshold {bits:2d}-bit n={n} K={k}", ok)

    # -- matrix ops (ref 03_matrix.cpp) ------------------------------------

    def matrix_quantize(self, rng, bits, m, n):
        a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
        q = quantize(jnp.asarray(a), bits)
        gc, gs = golden.quantize_mat(np.asarray(pad_matrix(jnp.asarray(a))),
                                     bits, noise=0.0)
        codes = np.asarray(unpack_nibbles(q.codes) if bits == 4 else q.codes)
        ok = np.array_equal(codes, gc) and np.array_equal(
            np.asarray(q.scales), gs)
        return self.check(f"mat quantize {bits:2d}-bit {m}x{n}", ok)

    def matrix_mvm(self, rng, bits_a, bits_x, m, n):
        a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        qa = quantize(jnp.asarray(a), bits_a)
        qx = quantize(jnp.asarray(x), bits_x)
        y = mvm(qa, qx)
        got = np.asarray(restore(y).values)
        if bits_x == 32 and bits_a in (4, 8):
            # dequant-on-the-fly x32 MVM vs an independent float64
            # reference (ref: 03_matrix.cpp:419-489, |delta| <= 0.01)
            ra = np.asarray(restore(qa).values).astype(np.float64)
            ref = (ra[:m, :n] @ x.astype(np.float64)).astype(np.float32)
            ok = bool(np.all(np.abs(got[:m] - ref) <= 0.01))
            return self.check(
                f"mvm {bits_a:2d}x{bits_x:2d}-bit {m}x{n}", ok,
                got[:8], ref[:8])
        ref = np.asarray(mvm_f32(qa, qx))
        if y.bits in (16, 32):
            ok = np.allclose(got, ref, rtol=1e-3, atol=1e-3)
        else:
            lsb = np.repeat(np.asarray(y.scales), BLOCK) / (
                7.0 if y.bits == 4 else 127.0)
            ok = np.all(np.abs(got - ref) <= lsb * (1 + 1e-3) + 1e-5)
        return self.check(
            f"mvm {bits_a:2d}x{bits_x:2d}-bit {m}x{n}", ok, got[:8], ref[:8])

    def matrix_mvm_kernel(self, rng, bits_a, bits_x, m, n):
        """The compiled MVM kernel (kernels/mvm.py) against the plain XLA
        formulation on the same inputs: f32 mode, deterministic and SR
        requantization, and the AXPY epilogue against the unfused
        scale_and_add of the kernel's own MVM.  Codes may differ by one
        LSB (f32 combine order); scales by 1e-6 relative.  GPU only."""
        import jax
        from ..kernels import mvm as kmvm
        from ..ops.mvm import _out_bits, _requant_output
        a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
        x = (rng.random(n, dtype=np.float32) * 2 - 1)
        qa = quantize(jnp.asarray(a), bits_a)
        qx = quantize(jnp.asarray(x), bits_x)
        if not kmvm.eligible(qa, qx):
            return True
        ob = _out_bits(qa, qx)
        u = quantize(jnp.asarray(rng.random(m, dtype=np.float32) * 2 - 1), ob)
        key = jax.random.PRNGKey(m + n)
        y32 = mvm_f32(qa, qx)
        ok = mvm_close(kmvm.mvm_f32(qa, qx), y32)
        for k in (None, key):
            ok &= codes_close(kmvm.mvm(qa, qx, k),
                              _requant_output(y32, qa.rows, ob, k))
            t1 = kmvm.mvm(qa, qx, k)
            ok &= codes_close(kmvm.mvm_axpy(qa, qx, u, -0.5, k, k),
                              scale_and_add(u, t1, -0.5, key=k))
        return self.check(
            f"mvm-kernel {bits_a:2d}x{bits_x:2d}-bit {m}x{n}", bool(ok))

    def matrix_transpose(self, rng, bits, m, n):
        a = (rng.random((m, n), dtype=np.float32) * 2 - 1)
        q = quantize(jnp.asarray(a), bits)
        t = transpose(q)
        ra = np.asarray(restore(q).values)
        rt = np.asarray(restore(t).values)
        ok = np.array_equal(ra, rt.T)        # bit-exact round trip (ref
        return self.check(                   # 03_matrix.cpp:153-245)
            f"transpose {bits:2d}-bit {m}x{n}", ok)


ACCEL_VEC_SIZES = [128, 129, 191, 192, 512, 1000, 1024, 2047]
ACCEL_MAT_SHAPES = [(128, 128), (256, 384), (512, 1024), (1000, 200),
                    (1024, 2048)]


def run_validation(full: bool = False, seed: int = 1, log=print,
                   vec_sizes=None, mat_shapes=None) -> bool:
    """``vec_sizes``/``mat_shapes`` override the sweep sets (used by the
    chunked full-sweep runner: one process cannot hold the ~27k distinct
    XLA executables of the full 128..2047 sweep — LLVM's JIT code arena
    exhausts around ~6k compiles)."""
    import jax
    rng = np.random.default_rng(seed)
    v = Validator(log=log)
    on_accel = jax.default_backend() != "cpu"
    explicit = vec_sizes is not None or mat_shapes is not None
    if explicit:
        vec_sizes = vec_sizes or []
        mat_shapes = mat_shapes or []
    elif full:
        vec_sizes = list(range(128, 2048))
        mat_shapes = [(mm, nn) for mm in range(128, 1281, 128)
                      for nn in range(128, 1281, 128)]
    elif on_accel:
        # every distinct shape is an XLA compile (~seconds on an
        # accelerator); cover the padding phases with a compact set
        vec_sizes, mat_shapes = ACCEL_VEC_SIZES, ACCEL_MAT_SHAPES
    else:
        vec_sizes, mat_shapes = DEFAULT_VEC_SIZES, DEFAULT_MAT_SHAPES

    for n in vec_sizes:
        for bits in (4, 8):
            v.vector_quantize(rng, bits, n)
            v.vector_restore(rng, bits, n)
            v.vector_consistency(rng, bits, n)
            v.vector_dot(rng, bits, n)
            v.vector_scale_and_add(rng, bits, n)
        for bits in (4, 8, 16, 32):
            v.vector_threshold(rng, bits, n)

    for (m, n) in mat_shapes:
        for bits in (4, 8):
            v.matrix_quantize(rng, bits, m, n)
            v.matrix_transpose(rng, bits, m, n)
        for (ba, bx) in ((4, 4), (4, 8), (8, 8), (16, 16), (32, 32),
                         (4, 32), (8, 32)):
            v.matrix_mvm(rng, ba, bx, m, n)
        if jax.default_backend() == "gpu":
            for (ba, bx) in ((4, 4), (4, 8), (8, 8)):
                v.matrix_mvm_kernel(rng, ba, bx, m, n)

    log(f"\n{v.checks} checks, {v.failures} failures")
    return v.failures == 0
