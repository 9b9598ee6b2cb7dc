"""Sparse-vector MVM: the reference's IHT-specific optimization
``dense_matrix_transpose_times_sparse_vector_parallel``
(CloverMatrix8.h:979-1000): when x is K-sparse (as after IHT's hard
threshold), y = Phi x = sum over the K nonzero j of x_j * Phi[:, j] —
equivalently, with the transposed matrix materialized (as IHT already
does), y = sum x_j * PhiT[j, :] over rows, which are contiguous.

Design: rows of PhiT are byte-aligned even in the packed 4-bit
layout, so this is one gather (``jnp.take`` of K rows), an in-register
dequant, and a (K x n) matmul with the K nonzero values — O(K*n) memory
traffic instead of O(m*n).  Requires static K (JAX shapes), which IHT has.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import (
    BLOCK, QMat4, QMat8, QVec4, QVec8, QVec16, QVec32, unpack_nibbles,
)
from . import _core
from .mvm import _out_bits, _requant_output
from .quantize import restore_vec


def _nonzeros(x, k: int):
    """Indices and f32 values of the K largest-|value| entries of x
    (IHT guarantees at most K nonzeros; ties resolved by top_k)."""
    vals = restore_vec(x).values
    mag = jnp.abs(vals)
    if x.length < mag.shape[-1]:
        mag = jnp.where(jnp.arange(mag.shape[-1]) < x.length, mag, -1.0)
    _, idx = jax.lax.top_k(mag, k)
    return idx, vals[idx]


def mvm_sparse(AT, x, k: int, key=None):
    """y = A @ x with x K-sparse, computed from the materialized transpose
    AT (rows of AT = columns of A), requantized to the standard output
    precision.  Matches mvm(A, x) semantics up to f32 summation order.
    """
    idx, vals = _nonzeros(x, k)
    m_pad = AT.cols_pad                   # AT is (n x m)

    if isinstance(AT, (QMat4, QMat8)):
        rows_codes = jnp.take(AT.codes, idx, axis=0)       # (K, m_pad/pack)
        rows_scales = jnp.take(AT.scales, idx // BLOCK, axis=0)  # (K, mb)
        codes = (unpack_nibbles(rows_codes) if isinstance(AT, QMat4)
                 else rows_codes).astype(jnp.float32)      # (K, m_pad)
        mult = jnp.repeat(rows_scales / _core.qmax(AT.bits), BLOCK, axis=1)
        rows = codes * mult                                # dequantized rows
    else:
        rows = jnp.take(AT.values, idx, axis=0).astype(jnp.float32)

    y32 = jnp.dot(vals, rows, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    return _requant_output(y32, AT.cols, _out_bits_sparse(AT, x), key)


def _out_bits_sparse(AT, x) -> int:
    # same table as mvm's, with A = transpose(AT)
    if isinstance(x, QVec32):
        return 32
    if isinstance(AT, QMat4) and isinstance(x, QVec4):
        return 4
    if isinstance(AT, QMat4) and isinstance(x, QVec8):
        return 8
    if isinstance(AT, QMat8) and isinstance(x, QVec8):
        return 8
    if isinstance(x, QVec16):
        return 16
    return 32
