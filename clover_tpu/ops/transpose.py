"""Quantized matrix transpose.

Reference: CloverMatrix4.h:1549-1663 (SIMD nibble-block transpose + IPP
scale-tile transpose), CloverMatrix8.h:1359-1386, CloverMatrix16.h:424-475,
CloverMatrix32.h:181-216.

Because tile scales are per 64x64 block, transposing values and transposing
the scale grid commute exactly: ``T(A).get(i,j) == A.get(j,i)`` bit-for-bit
(the reference validates exactly this, test/validate/03_matrix.cpp:153-245).
Here the nibble relayout is a pack/unpack pair around ``jnp.transpose``,
which XLA fuses into one copy; transposes are one-time setup (the
solvers materialize PhiT up front, as the reference does).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..formats import QMat4, QMat8, QMat16, QMat32, pack_nibbles, unpack_nibbles


def transpose(A):
    if isinstance(A, QMat4):
        codes = unpack_nibbles(A.codes)
        return QMat4(codes=pack_nibbles(codes.T), scales=A.scales.T,
                     rows=A.cols, cols=A.rows)
    if isinstance(A, QMat8):
        return QMat8(codes=A.codes.T, scales=A.scales.T,
                     rows=A.cols, cols=A.rows)
    if isinstance(A, QMat16):
        return QMat16(values=A.values.T, rows=A.cols, cols=A.rows)
    return QMat32(values=A.values.T, rows=A.cols, cols=A.rows)
