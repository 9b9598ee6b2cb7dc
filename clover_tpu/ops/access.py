"""Element access for quantized containers — the functional equivalents of
the reference's get/set/getBits/setBits (CloverVector4.h:154-227,
CloverMatrix4.h:123-177) and the random-data generators
(CloverVector32.h:697-781 setRandomInteger/setRandomFloats).

These are host/debug utilities: O(1) element reads and .at-based writes.
Bulk paths should use quantize/restore.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import (
    BLOCK, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32,
)

HALF = BLOCK // 2


def _nib_pos(i):
    """element index -> (byte index, is_hi) in the deinterleaved layout."""
    b, j = i // BLOCK, i % BLOCK
    return b * HALF + (j % HALF), j >= HALF


def vec_get_code(q, i: int) -> int:
    """The stored integer code of element i (the reference's getBits)."""
    if isinstance(q, QVec8):
        return int(q.codes[i])
    assert isinstance(q, QVec4)
    byte, is_hi = _nib_pos(i)
    p = int(q.codes[byte])
    return (p >> 4) if is_hi else ((p & 15) - 8)


def vec_get(q, i: int) -> float:
    """Dequantized value of element i (the reference's get)."""
    if isinstance(q, (QVec16, QVec32)):
        return float(q.values[i])
    qm = 7.0 if q.bits == 4 else 127.0
    return float(vec_get_code(q, i) * (q.scales[i // BLOCK] / qm))


def vec_set_code(q, i: int, code: int):
    """Functionally set the stored code of element i (setBits)."""
    if isinstance(q, QVec8):
        return QVec8(codes=q.codes.at[i].set(jnp.int8(code)),
                     scales=q.scales, length=q.length)
    assert isinstance(q, QVec4)
    byte, is_hi = _nib_pos(i)
    p = q.codes[byte].astype(jnp.int32)
    if is_hi:
        newp = jnp.bitwise_or(jnp.bitwise_and(p, 0x0F),
                              jnp.left_shift(jnp.bitwise_and(code, 15), 4))
    else:
        newp = jnp.bitwise_or(jnp.bitwise_and(p, ~0x0F),
                              jnp.bitwise_and(code + 8, 15))
    return QVec4(codes=q.codes.at[byte].set(newp.astype(jnp.int8)),
                 scales=q.scales, length=q.length)


def mat_get(q, i: int, j: int) -> float:
    if isinstance(q, (QMat16, QMat32)):
        return float(q.values[i, j])
    qm = 7.0 if q.bits == 4 else 127.0
    s = q.scales[i // BLOCK, j // BLOCK]
    if isinstance(q, QMat8):
        return float(q.codes[i, j] * (s / qm))
    byte, is_hi = _nib_pos(j)
    p = int(q.codes[i, byte])
    code = (p >> 4) if is_hi else ((p & 15) - 8)
    return float(code * (s / qm))


def vec_gather(q, idx: jax.Array) -> jax.Array:
    """Dequantized values at ``idx`` (int array) — the vectorized,
    jit-friendly form of :func:`vec_get` (the reference benches
    per-element vector get, test/performance/00_test.cpp:272-288; on an
    accelerator the idiomatic bulk form is one gather)."""
    if isinstance(q, (QVec16, QVec32)):
        return q.values[idx].astype(jnp.float32)
    qm = 7.0 if q.bits == 4 else 127.0
    s = q.scales[idx // BLOCK] / qm
    if isinstance(q, QVec8):
        return q.codes[idx].astype(jnp.float32) * s
    b, j = idx // BLOCK, idx % BLOCK
    byte = q.codes[b * HALF + (j % HALF)].astype(jnp.int32)
    code = jnp.where(j >= HALF, byte >> 4,
                     jnp.bitwise_and(byte, 15) - 8)
    return code.astype(jnp.float32) * s


# ---------------------------------------------------------------------------
# Reproducible random data generation (the setRandom* parity, driven by the
# XORShift128+ module so data streams match across the NumPy/JAX/C++
# implementations)
# ---------------------------------------------------------------------------

def random_floats(key1: int, key2: int, n: int):
    """f32[n] in [0, ~1), from the XORShift stream's noise recipe
    (8 floats per 64-bit draw; CloverVector32.h:757-781 capability)."""
    from .. import rng as cr
    import numpy as np
    draws = -(-n // 8)
    stream = cr.np_stream(key1, key2, draws, lanes=1).ravel()
    out = np.zeros((draws, 8), np.float32)
    for d, w in enumerate(stream):
        halves = [np.uint32(w & 0xFFFFFFFF), np.uint32(w >> np.uint64(32))]
        vals = []
        for h in halves:
            m = np.uint32(h) & np.uint32(0x7F7F7F7F)
            for k in (0, 8, 16, 24):
                vals.append(np.float32(np.int32(np.uint32(m << np.uint32(k))
                                                & 0xFFFFFFFF)) * 2.0 ** -31)
        out[d] = vals
    return jnp.asarray(out.ravel()[:n])


def random_integers(key1: int, key2: int, n: int, r: int):
    """int values in [-r, r] (setRandomInteger semantics) as f32[n]."""
    u = random_floats(key1, key2, n)
    return jnp.floor(u * (2 * r + 1)).astype(jnp.float32) - r
