"""Quantized container formats.

Re-creates the capability of Clover's block-scaled formats
(reference: include/CloverVector4.h:44-103, include/CloverVector8.h:45-78,
include/CloverVector16.h:38-63, include/CloverMatrix4.h:38-93,
include/CloverMatrix8.h:40-75) with layouts chosen for vector units and
matrix engines, not AVX2:

* 4-bit codes are two's-complement values in [-7, 7], two per byte — but
  packed *deinterleaved per 64-element block*: byte ``j`` of a block holds
  element ``j`` in the low nibble and element ``j + 32`` in the high nibble.
  No cross-lane interleave is ever required on the VPU.  (The reference
  packs adjacent pairs and needs an 8x8 register transpose,
  CloverVector4.h:777-805; that design is AVX2-specific.)
* The low nibble is stored *biased by +8* (``lo + 8`` in [1, 15]); the high
  nibble is plain two's complement.  A packed byte therefore equals
  ``16*hi + (lo+8)`` exactly as a signed int8, which lets the fused MVM
  kernel consume packed bytes DIRECTLY on the MXU (one int8 mask + two
  int8 matmuls recover the exact blocked integer dot — see
  clover_tpu/kernels/mvm.py), where Mosaic has no int8 shift/sub ops.
* One fp32 scale per 64-element block (vectors) or per 64x64 tile
  (matrices), scale = block absmax, zero blocks normalized to scale 1.0
  (reference: CloverVector4.h:661-663).
* Vector lengths padded to a multiple of 128, matrix dims padded to a
  multiple of 128 (reference: CloverVector.h:41-42, CloverMatrix.h:48-50).
  Padding codes are zero and padding scales are 1.0, and every op preserves
  that invariant.
* 16-bit is IEEE fp16 with no scales (reference: CloverVector16.h:38-63);
  32-bit is plain fp32.

All containers are registered JAX pytrees (dataclasses), so they pass
through ``jit`` / ``shard_map`` / ``lax.scan`` transparently.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Block/tile geometry (matches the reference so accuracy protocols align).
BLOCK = 64            # elements per scale block / tile side
PAD = 128             # pad granularity for vector length and matrix dims
PACK = 2              # 4-bit codes per byte


def pad_to(n: int, m: int = PAD) -> int:
    """Round ``n`` up to a multiple of ``m``."""
    return int(-(-int(n) // m) * m)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Nibble packing (deinterleaved per-block layout)
# ---------------------------------------------------------------------------

def pack_nibbles(codes: jax.Array) -> jax.Array:
    """Pack int8 codes in [-8, 7] two-per-byte, deinterleaved per 64-block.

    ``codes`` has shape ``(..., L)`` with ``L`` a multiple of 64.  Returns
    int8 of shape ``(..., L // 2)``.  Byte ``32*b + j`` holds element
    ``64*b + j`` biased by +8 in the low nibble and element
    ``64*b + j + 32`` two's-complement in the high nibble, so the byte's
    signed int8 value is exactly ``16*hi + (lo + 8)``.
    """
    *lead, L = codes.shape
    assert L % BLOCK == 0, f"length {L} not a multiple of {BLOCK}"
    c = codes.reshape(*lead, L // BLOCK, BLOCK)
    lo = c[..., : BLOCK // 2]
    hi = c[..., BLOCK // 2:]
    packed = jnp.bitwise_or(
        jnp.bitwise_and((lo + jnp.int8(8)).astype(jnp.int8), jnp.int8(0x0F)),
        jnp.left_shift(hi, 4).astype(jnp.int8),
    )
    return packed.reshape(*lead, L // 2)


def unpack_nibbles(packed: jax.Array) -> jax.Array:
    """Inverse of :func:`pack_nibbles`: int8 ``(..., K)`` -> ``(..., 2K)``."""
    *lead, K = packed.shape
    assert K % (BLOCK // 2) == 0
    p = packed.reshape(*lead, K // (BLOCK // 2), BLOCK // 2)
    hi = jnp.right_shift(p, 4)          # arithmetic: sign-extends
    lo = (jnp.bitwise_and(p, jnp.int8(0x0F)) - jnp.int8(8)).astype(jnp.int8)
    return jnp.concatenate([lo, hi], axis=-1).reshape(*lead, 2 * K)


# ---------------------------------------------------------------------------
# Pytree dataclass helper
# ---------------------------------------------------------------------------

def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------

@partial(_register, data_fields=("codes", "scales"), meta_fields=("length",))
@dataclasses.dataclass(frozen=True)
class QVec4:
    """Block-scaled 4-bit vector (reference: include/CloverVector4.h)."""
    codes: jax.Array    # int8[length_pad // 2], packed nibbles
    scales: jax.Array   # f32[length_pad // 64]
    length: int         # logical length

    bits = 4

    @property
    def length_pad(self) -> int:
        return self.codes.shape[-1] * PACK

    @property
    def blocks(self) -> int:
        return self.scales.shape[-1]

    @property
    def nbytes(self) -> int:
        """Bytes touched when streaming this vector (codes + scales)."""
        return self.codes.size + self.scales.size * 4


@partial(_register, data_fields=("codes", "scales"), meta_fields=("length",))
@dataclasses.dataclass(frozen=True)
class QVec8:
    """Block-scaled 8-bit vector (reference: include/CloverVector8.h)."""
    codes: jax.Array    # int8[length_pad]
    scales: jax.Array   # f32[length_pad // 64]
    length: int

    bits = 8

    @property
    def length_pad(self) -> int:
        return self.codes.shape[-1]

    @property
    def blocks(self) -> int:
        return self.scales.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.codes.size + self.scales.size * 4


@partial(_register, data_fields=("values",), meta_fields=("length",))
@dataclasses.dataclass(frozen=True)
class QVec16:
    """IEEE fp16 vector, no scales (reference: include/CloverVector16.h)."""
    values: jax.Array   # f16[length_pad]
    length: int

    bits = 16

    @property
    def length_pad(self) -> int:
        return self.values.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.values.size * 2


@partial(_register, data_fields=("values",), meta_fields=("length",))
@dataclasses.dataclass(frozen=True)
class QVec32:
    """fp32 vector (reference: include/CloverVector32.h)."""
    values: jax.Array   # f32[length_pad]
    length: int

    bits = 32

    @property
    def length_pad(self) -> int:
        return self.values.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.values.size * 4


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------

@partial(_register, data_fields=("codes", "scales"), meta_fields=("rows", "cols"))
@dataclasses.dataclass(frozen=True)
class QMat4:
    """Block-scaled 4-bit matrix; one fp32 scale per 64x64 tile
    (reference: include/CloverMatrix4.h:38-93).  Codes are row-major with
    each row nibble-packed per 64-column block (deinterleaved layout)."""
    codes: jax.Array    # int8[rows_pad, cols_pad // 2]
    scales: jax.Array   # f32[rows_pad // 64, cols_pad // 64]
    rows: int
    cols: int

    bits = 4

    @property
    def rows_pad(self) -> int:
        return self.codes.shape[-2]

    @property
    def cols_pad(self) -> int:
        return self.codes.shape[-1] * PACK

    @property
    def nbytes(self) -> int:
        return self.codes.size + self.scales.size * 4


@partial(_register, data_fields=("codes", "scales"), meta_fields=("rows", "cols"))
@dataclasses.dataclass(frozen=True)
class QMat8:
    """Block-scaled 8-bit matrix (reference: include/CloverMatrix8.h)."""
    codes: jax.Array    # int8[rows_pad, cols_pad]
    scales: jax.Array   # f32[rows_pad // 64, cols_pad // 64]
    rows: int
    cols: int

    bits = 8

    @property
    def rows_pad(self) -> int:
        return self.codes.shape[-2]

    @property
    def cols_pad(self) -> int:
        return self.codes.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.codes.size + self.scales.size * 4


@partial(_register, data_fields=("values",), meta_fields=("rows", "cols"))
@dataclasses.dataclass(frozen=True)
class QMat16:
    """fp16 matrix (reference: include/CloverMatrix16.h)."""
    values: jax.Array   # f16[rows_pad, cols_pad]
    rows: int
    cols: int

    bits = 16

    @property
    def rows_pad(self) -> int:
        return self.values.shape[-2]

    @property
    def cols_pad(self) -> int:
        return self.values.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.values.size * 2


@partial(_register, data_fields=("values",), meta_fields=("rows", "cols"))
@dataclasses.dataclass(frozen=True)
class QMat32:
    """fp32 matrix (reference: include/CloverMatrix32.h)."""
    values: jax.Array   # f32[rows_pad, cols_pad]
    rows: int
    cols: int

    bits = 32

    @property
    def rows_pad(self) -> int:
        return self.values.shape[-2]

    @property
    def cols_pad(self) -> int:
        return self.values.shape[-1]

    @property
    def nbytes(self) -> int:
        return self.values.size * 4


VECTOR_TYPES = {4: QVec4, 8: QVec8, 16: QVec16, 32: QVec32}
MATRIX_TYPES = {4: QMat4, 8: QMat8, 16: QMat16, 32: QMat32}


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------

def pad_vector(x: jax.Array) -> jax.Array:
    """Zero-pad a 1-D fp array to a multiple of PAD."""
    n = x.shape[-1]
    np_ = pad_to(n)
    if np_ == n:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, np_ - n)])


def pad_matrix(a: jax.Array) -> jax.Array:
    m, n = a.shape[-2:]
    mp, np_ = pad_to(m), pad_to(n)
    if (mp, np_) == (m, n):
        return a
    pads = [(0, 0)] * (a.ndim - 2) + [(0, mp - m), (0, np_ - n)]
    return jnp.pad(a, pads)


def zeros_vector(bits: int, length: int) -> "QVec4 | QVec8 | QVec16 | QVec32":
    """All-zero quantized vector with the pad invariant (pad scales = 1.0
    only matters for non-zero data; zero blocks use scale 1.0 uniformly,
    reference: CloverVector4.h:86-94)."""
    npad = pad_to(length)
    if bits == 4:
        # NB: the zero CODE packs to byte 0x08 (biased low nibble).
        return QVec4(
            codes=jnp.full((npad // 2,), 0x08, jnp.int8),
            scales=jnp.ones((npad // BLOCK,), jnp.float32),
            length=length,
        )
    if bits == 8:
        return QVec8(
            codes=jnp.zeros((npad,), jnp.int8),
            scales=jnp.ones((npad // BLOCK,), jnp.float32),
            length=length,
        )
    if bits == 16:
        return QVec16(values=jnp.zeros((npad,), jnp.float16), length=length)
    if bits == 32:
        return QVec32(values=jnp.zeros((npad,), jnp.float32), length=length)
    raise ValueError(f"unsupported bits={bits}")


def mask_pad_vector(x: jax.Array, length: int) -> jax.Array:
    """Zero out the padding tail of a padded 1-D array."""
    npad = x.shape[-1]
    if npad == length:
        return x
    idx = jnp.arange(npad)
    return jnp.where(idx < length, x, jnp.zeros_like(x))


def mask_pad_matrix(a: jax.Array, rows: int, cols: int) -> jax.Array:
    mp, np_ = a.shape[-2:]
    if (mp, np_) == (rows, cols):
        return a
    ri = jnp.arange(mp)[:, None]
    ci = jnp.arange(np_)[None, :]
    return jnp.where((ri < rows) & (ci < cols), a, jnp.zeros_like(a))
