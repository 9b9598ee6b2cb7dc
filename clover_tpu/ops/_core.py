"""Shared jnp primitives for the quantized ops.

These implement the same math as :mod:`clover_tpu.golden` but vectorized
over packed containers; everything here runs on any backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import BLOCK

_QMAX = {4: 7.0, 8: 127.0}

# Large odd constants for deriving per-op SR seed streams by integer
# arithmetic (no threefry on the solver loop's critical path).
SEED_GOLD = -1640531527           # 0x9E3779B9 as int32 (golden-ratio mix)
SEED_OP = 40503                   # per-op stride within an iteration


def seed_from(key):
    """Normalize an SR randomness argument to (int32[1] seed, noise_flag).

    Accepts: None (deterministic), a Python int, an int32 scalar/(1,)
    array (cheap carried seed — the solver hot path), or a JAX PRNG key
    (one threefry draw to derive the seed).
    """
    if key is None:
        return jnp.zeros((1,), jnp.int32), False
    if isinstance(key, int):
        return jnp.asarray([key], jnp.int32), True
    arr = jnp.asarray(key)
    if arr.dtype == jnp.int32:
        return arr.reshape(1), True
    return jax.lax.bitcast_convert_type(
        jax.random.bits(key, (1,), jnp.uint32), jnp.int32), True


def qmax(bits: int) -> float:
    return _QMAX[bits]


def f16_rounded(x32: jax.Array) -> jax.Array:
    """f32 -> f16 with the rounding GUARANTEED to happen.

    XLA folds a convert(f32->f16) whose consumer converts straight back
    to f32 into identity — inside one jit,
    ``x.astype(f16).astype(f32)`` returns the unrounded f32 for 99.8%
    of random inputs.  Inside a fused solver loop that silently
    deleted the fp16 quantization of every intermediate (t1/t2/t3),
    leaving only the scan-carried x rounded — the round-5 root cause of
    the 16-bit GD accuracy divergence (0.0034 plateau vs the
    reference's 0.00097; doc/results/gd16_rootcause_r5.md).  The
    optimization barrier pins the convert pair."""
    return jax.lax.optimization_barrier(x32.astype(jnp.float16))


def block_scales(x: jax.Array) -> jax.Array:
    """Per-64-block absmax of a padded 1-D f32 array; zero blocks -> 1.0."""
    xb = x.reshape(-1, BLOCK)
    s = jnp.max(jnp.abs(xb), axis=-1)
    return jnp.where(s == 0, 1.0, s).astype(jnp.float32)


def tile_scales(a: jax.Array) -> jax.Array:
    """Per-64x64-tile absmax of a padded f32 matrix; zero tiles -> 1.0."""
    m, n = a.shape
    t = jnp.abs(a).reshape(m // BLOCK, BLOCK, n // BLOCK, BLOCK)
    s = jnp.max(t, axis=(1, 3))
    return jnp.where(s == 0, 1.0, s).astype(jnp.float32)


def sr_codes(x: jax.Array, scale_per_elem: jax.Array, bits: int,
             noise: jax.Array | None) -> jax.Array:
    """q = floor(|x| * (qmax/s) + u) * sign(x), clipped; int8 output.

    ``noise`` is U[0,1) of x's shape, or None for deterministic mode
    (reference: CloverVector4.h:499-514 with
    CLOVER_STOCHASTIC_ROUNDING_DISABLED).
    """
    qm = _QMAX[bits]
    mult = (qm / scale_per_elem).astype(jnp.float32)
    mag = jnp.abs(x) * mult
    if noise is not None:
        mag = mag + noise
    q_abs = jnp.minimum(jnp.floor(mag).astype(jnp.int32), int(qm))
    sign = jnp.where(x < 0, -1, 1).astype(jnp.int32)
    return (q_abs * sign).astype(jnp.int8)


def noise_like(key, shape) -> jax.Array | None:
    """U[0,1) SR noise.  ``key`` may be a JAX PRNG key or a cheap int32
    seed (scalar/(1,) array or Python int) carried through solver loops."""
    if key is None:
        return None
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    else:
        arr = jnp.asarray(key)
        if arr.dtype == jnp.int32:
            key = jax.random.PRNGKey(arr.reshape(()))
    return jax.random.uniform(key, shape, dtype=jnp.float32)


def expand_vec_scales(scales: jax.Array, bits: int) -> jax.Array:
    """(nb,) block scales -> per-element dequant multiplier (npad,)."""
    return jnp.repeat(scales / _QMAX[bits], BLOCK).astype(jnp.float32)


def expand_tile_scales(scales: jax.Array, bits: int) -> jax.Array:
    """(mb, nb) tile scales -> per-element dequant multiplier (m, n)."""
    s = (scales / _QMAX[bits]).astype(jnp.float32)
    return jnp.repeat(jnp.repeat(s, BLOCK, axis=0), BLOCK, axis=1)
