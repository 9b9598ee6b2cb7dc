"""Problem generators for the GD / IHT solvers.

Reference: test/performance/03_iht_gd_util.cpp:449-536.
- IHT: Phi ~ U(-1,1), x* a random K-sparse 0/1 vector, y = Phi x*.
- GD:  Phi ~ U(-1,1) with L2-normalized rows, x* = sign(U(-1,1)) in
  {-1,+1}, y = Phi x*.

The reference seeds a shared XORShift128+ with fixed keys
(445560390295639063 / 2935984234003016713, test/random/00_random.cpp:42) so
*data* is reproducible on its platform; we use JAX threefry keys for the
same reproducibility property (bit-identical data across runs/backends of
this framework; statistical parity with the reference's distributions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DEFAULT_SEED = 445560390295639063 % (2**32)

# The reference's fixed data-generation keys (test/random/00_random.cpp:42).
REF_KEY1 = 445560390295639063
REF_KEY2 = 2935984234003016713


def make_iht_problem(m: int, n: int, k: int, seed: int = DEFAULT_SEED):
    """-> (Phi f32[m,n], x_star f32[n], y f32[m])."""
    key = jax.random.PRNGKey(seed)
    k_phi, k_perm = jax.random.split(key)
    phi = jax.random.uniform(k_phi, (m, n), jnp.float32, -1.0, 1.0)
    x = jnp.zeros((n,), jnp.float32).at[
        jax.random.permutation(k_perm, n)[:k]].set(1.0)
    y = jnp.dot(phi, x, precision=jax.lax.Precision.HIGHEST)
    return phi, x, y


def _avx_floats(i32: "np.ndarray", min_v: float, max_v: float):
    """setRandomFloats recipe (CloverVector32.h:746-781): abs_epi32 (wraps
    INT32_MIN like the hardware), cvtepi32_ps, then one f32 FMA with
    scale (max-min)/2^31 and addend min."""
    import numpy as np
    ir = np.abs(i32, dtype=np.int32)
    frandom = ir.astype(np.float32)
    scale = np.float32(np.float32(max_v - min_v) / np.float32(2147483648.0))
    # FMA: exact f64 product + addend, single rounding to f32.
    return (frandom.astype(np.float64) * np.float64(scale)
            + np.float64(np.float32(min_v))).astype(np.float32)


def _avx_unit(i32: "np.ndarray"):
    """create_array_of_random_values recipe (test/accuracy/01_math.cpp:33-50):
    mask bit 31, cvtepi32_ps, f32-multiply by 2^-31 -> U[0,1)."""
    import numpy as np
    m = (i32.view(np.uint32) & np.uint32(0x7FFFFFFF)).view(np.int32)
    return np.float32(m.astype(np.float32)) * np.float32(1.0 / 2147483648.0)


def make_iht_problem_reference(m: int = 512, n: int = 1024, k: int = 64):
    """Bit-exact reproduction of the reference's IHT accuracy problem
    instance: the exact (Phi, x*, y) that ``clover -a`` solves.

    Reproduces initialize_random_IHT_values
    (test/performance/03_iht_gd_util.cpp:449-495) with the committed data
    keys (test/random/00_random.cpp:42), including the vendored AVX
    generator's 64-bit-state quirk (rng.avx_quirk_stream) and the
    round-to-nearest swap permutation.  y = Phi @ x* accumulated in f64
    and rounded to f32 (the reference computes it with MKL sgemv; f64
    accumulation reproduces the exact f32 values for this instance).

    This matters because tuned step sizes are *instance*-specific: the
    reference's published mu values (test/accuracy/00_accuracy.cpp:74-78)
    sit at the convergence boundary OF THIS Phi — at mu(4x8), a different
    random Phi of the same distribution makes ANY valid-SR implementation
    (including the reference itself) diverge for a fraction of SR seeds
    (doc/results/mixed48_rootcause_r3.md).  Accuracy-parity comparisons
    must therefore run on this instance.

    -> (Phi f32[m,n], x_star f32[n], y f32[m]) as NumPy arrays.
    """
    import numpy as np
    from ..rng import avx_part2_lanes, avx_quirk_stream
    state = avx_part2_lanes(REF_KEY1, REF_KEY2)
    draws, state = avx_quirk_stream(state, (m * n + 7) // 8)
    phi = _avx_floats(draws.reshape(-1)[:m * n].view(np.int32),
                      -1.0, 1.0).reshape(m, n)
    draws, state = avx_quirk_stream(state, (n + 7) // 8)
    rf = _avx_unit(draws.reshape(-1)[:n].view(np.int32))
    x = np.zeros(n, np.float32)
    x[:k] = 1.0
    for i in range(n - 1):   # reference's swap shuffle (:480-486)
        j = int(np.float32(np.round(np.float32(i) * rf[i])))
        x[i], x[j] = x[j], x[i]
    y = (phi.astype(np.float64) @ x.astype(np.float64)).astype(np.float32)
    return phi, x, y


def make_gd_problem_reference(m: int = 384, n: int = 256):
    """The reference's GD accuracy problem instance (test_gd,
    test/accuracy/00_accuracy.cpp:93-128): initialize_random_GD_values
    (test/performance/03_iht_gd_util.cpp) with the committed data keys,
    the vendored AVX generator's quirk stream, sequential-f64 row norms
    (test/accuracy/01_math.h:44-49, scale = (float)(1.0/norm2) then one
    f32 multiply per element), and y from a sequential-f64 sgemv
    accumulation rounded once to f32.

    Scope of the bit-exactness claim (ADVICE r4): verified bit-identical
    to the FROM-SOURCE reference build's dump (doc/results/refrun,
    gd_accuracy_parity_r4.txt), whose MKL shim implements cblas_sgemv as
    the same sequential-f64 accumulation.  A genuinely MKL-linked
    reference binary computes y with vectorized f32 accumulation and may
    differ in the last f32 ulps of y (Phi and x_star are unaffected —
    they never pass through sgemv).

    -> (Phi f32[m,n], x_star f32[n], y f32[m]) as NumPy arrays.
    """
    import numpy as np
    from ..rng import avx_part2_lanes, avx_quirk_stream
    state = avx_part2_lanes(REF_KEY1, REF_KEY2)
    draws, state = avx_quirk_stream(state, (m * n + 7) // 8)
    phi = _avx_floats(draws.reshape(-1)[:m * n].view(np.int32),
                      -1.0, 1.0).reshape(m, n)
    p64 = phi.astype(np.float64)
    # norm2: sequential f64 sum of squares (np.cumsum is sequential;
    # np.sum's pairwise order could differ in the last f64 ulp)
    nrm = np.sqrt(np.cumsum(p64 * p64, axis=1)[:, -1])
    scale = (1.0 / nrm).astype(np.float32)
    phi = phi * scale[:, None]                         # f32 multiplies
    draws, state = avx_quirk_stream(state, (n + 7) // 8)
    xr = _avx_floats(draws.reshape(-1)[:n].view(np.int32), -1.0, 1.0)
    x = np.where(xr < 0, np.float32(-1.0), np.float32(1.0))
    p64 = phi.astype(np.float64)
    y = np.cumsum(p64 * x.astype(np.float64), axis=1)[:, -1].astype(
        np.float32)
    return phi, x, y


def make_gd_problem(m: int, n: int, seed: int = DEFAULT_SEED):
    """-> (Phi row-normalized f32[m,n], x_star in {-1,1}^n, y f32[m])."""
    key = jax.random.PRNGKey(seed)
    k_phi, k_x = jax.random.split(key)
    phi = jax.random.uniform(k_phi, (m, n), jnp.float32, -1.0, 1.0)
    phi = phi / jnp.linalg.norm(phi, axis=1, keepdims=True)
    x = jnp.where(jax.random.uniform(k_x, (n,)) < 0.5, -1.0, 1.0)
    y = jnp.dot(phi, x, precision=jax.lax.Precision.HIGHEST)
    return phi, x, y
