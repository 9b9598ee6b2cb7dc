"""Quantized dot products (reference: CloverVector4.h:555-595 & :1095-1191,
CloverVector8.h:268-330 & :911-977, CloverVector16.h:193-253 & :473-530).

Semantics: per 64-element block, exact integer accumulation of code
products (the reference keeps these in int16 via ``maddubs``; we use int32
via XLA's integer dot), then an f32 combine
with ``(su/qmax) * (sv/qmax)`` per block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import BLOCK, QVec4, QVec16, QVec32, unpack_nibbles
from . import _core


def _codes(q) -> jax.Array:
    return unpack_nibbles(q.codes) if isinstance(q, QVec4) else q.codes


def dot(u, v) -> jax.Array:
    """Dot product of two quantized vectors of the same precision.

    Returns a scalar f32.  Mixed fp precisions (16/32) upcast to f32.
    """
    if isinstance(u, (QVec16, QVec32)) or isinstance(v, (QVec16, QVec32)):
        uf = u.values.astype(jnp.float32)
        vf = v.values.astype(jnp.float32)
        return jnp.dot(uf, vf, preferred_element_type=jnp.float32)

    assert u.bits == v.bits, "mixed 4/8 dot not in the reference API"
    qm = _core.qmax(u.bits)
    ub = _codes(u).reshape(-1, BLOCK)
    vb = _codes(v).reshape(-1, BLOCK)
    # Exact per-block integer dot.
    acc = jax.lax.dot_general(
        ub[:, None, :], vb[:, :, None],
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    ).reshape(-1)
    combined = (u.scales / qm) * (v.scales / qm)
    return jnp.sum(combined * acc.astype(jnp.float32))
