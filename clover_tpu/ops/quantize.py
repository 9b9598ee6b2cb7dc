"""Quantize / restore for all container precisions.

Re-creates the reference's ``quantize``/``restore`` families
(CloverVector4.h:605-1094, CloverVector8.h:393-910, CloverVector16.h:212-307,
CloverMatrix4.h:512-777, CloverMatrix8.h:203-265, CloverMatrix16.h:383-423)
as functional ops over pytree containers.  Stochastic rounding is driven by
an explicit JAX PRNG key (``key=None`` = deterministic truncation, the
equivalent of the reference's SR-disabled validation build).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import (
    BLOCK, QMat4, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32,
    pack_nibbles, pad_matrix, pad_vector, unpack_nibbles,
)
from . import _core


def _as_padded_vec(x) -> tuple[jax.Array, int]:
    if isinstance(x, QVec32):
        return x.values, x.length
    x = jnp.asarray(x, jnp.float32)
    return pad_vector(x), x.shape[-1]


def _as_padded_mat(a) -> tuple[jax.Array, int, int]:
    if isinstance(a, QMat32):
        return a.values, a.rows, a.cols
    a = jnp.asarray(a, jnp.float32)
    return pad_matrix(a), a.shape[-2], a.shape[-1]


# ---------------------------------------------------------------------------
# Vector quantize
# ---------------------------------------------------------------------------

def quantize_vec(x, bits: int, key=None):
    """fp32 vector (array or QVec32) -> quantized container."""
    xp, length = _as_padded_vec(x)
    if bits == 32:
        return QVec32(values=xp, length=length)
    if bits == 16:
        return QVec16(values=_core.f16_rounded(xp), length=length)
    scales = _core.block_scales(xp)
    per_elem = jnp.repeat(scales, BLOCK)
    noise = _core.noise_like(key, xp.shape)
    codes = _core.sr_codes(xp, per_elem, bits, noise)
    if bits == 8:
        return QVec8(codes=codes, scales=scales, length=length)
    return QVec4(codes=pack_nibbles(codes), scales=scales, length=length)


def restore_vec(q) -> QVec32:
    """Quantized vector -> fp32 container (reference 'restore')."""
    if isinstance(q, QVec32):
        return q
    if isinstance(q, QVec16):
        return QVec32(values=q.values.astype(jnp.float32), length=q.length)
    codes = unpack_nibbles(q.codes) if isinstance(q, QVec4) else q.codes
    mult = _core.expand_vec_scales(q.scales, q.bits)
    return QVec32(values=codes.astype(jnp.float32) * mult, length=q.length)


# ---------------------------------------------------------------------------
# Matrix quantize
# ---------------------------------------------------------------------------

def quantize_mat(a, bits: int, key=None):
    """fp32 matrix (array or QMat32) -> quantized container."""
    ap, rows, cols = _as_padded_mat(a)
    if bits == 32:
        return QMat32(values=ap, rows=rows, cols=cols)
    if bits == 16:
        return QMat16(values=_core.f16_rounded(ap), rows=rows, cols=cols)
    scales = _core.tile_scales(ap)
    per_elem = jnp.repeat(jnp.repeat(scales, BLOCK, axis=0), BLOCK, axis=1)
    noise = _core.noise_like(key, ap.shape)
    codes = _core.sr_codes(ap, per_elem, bits, noise)
    if bits == 8:
        return QMat8(codes=codes, scales=scales, rows=rows, cols=cols)
    return QMat4(codes=pack_nibbles(codes), scales=scales, rows=rows, cols=cols)


def restore_mat(q) -> QMat32:
    if isinstance(q, QMat32):
        return q
    if isinstance(q, QMat16):
        return QMat32(values=q.values.astype(jnp.float32),
                      rows=q.rows, cols=q.cols)
    codes = unpack_nibbles(q.codes) if isinstance(q, QMat4) else q.codes
    mult = _core.expand_tile_scales(q.scales, q.bits)
    return QMat32(values=codes.astype(jnp.float32) * mult,
                  rows=q.rows, cols=q.cols)


# ---------------------------------------------------------------------------
# Generic entry points
# ---------------------------------------------------------------------------

def quantize(x, bits: int, key=None):
    x_arr = x.values if isinstance(x, (QVec32, QMat32)) else jnp.asarray(x)
    if x_arr.ndim == 1:
        return quantize_vec(x, bits, key)
    if x_arr.ndim == 2:
        return quantize_mat(x, bits, key)
    raise ValueError(f"unsupported rank {x_arr.ndim}")


def restore(q):
    if isinstance(q, (QVec4, QVec8, QVec16, QVec32)):
        return restore_vec(q)
    return restore_mat(q)
