"""scaleAndAdd (AXPY with blockwise requantization).

``scale_and_add(u, v, a)`` returns ``quantize(restore(u) + a*restore(v))``
computed blockwise with fresh scales and stochastic rounding — the fused
dequant-FMA-absmax-requant of the reference (CloverVector4.h:336-430 &
:1196-1517, CloverVector8.h:1089-1386, CloverVector16.h:309-471).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..formats import QVec16, QVec32
from .quantize import quantize_vec, restore_vec


def scale_and_add(u, v, a, key=None):
    """r = Q(restore(u) + a * restore(v)) at u's precision.

    Matches the reference call shape ``u.scaleAndAdd(v, a, r)``; the
    solvers use both the out-of-place and accumulate-into-u forms, which
    are the same function here (functional style).
    """
    assert type(u) is type(v), f"precision mismatch: {type(u)} vs {type(v)}"
    uf = restore_vec(u).values
    vf = restore_vec(v).values
    x = uf + jnp.float32(a) * vf
    if isinstance(u, QVec32):
        return QVec32(values=x, length=u.length)
    if isinstance(u, QVec16):
        from . import _core
        return QVec16(values=_core.f16_rounded(x), length=u.length)
    return quantize_vec(QVec32(values=x, length=u.length), u.bits, key)
