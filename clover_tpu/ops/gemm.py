"""Batched MVM / quantized GEMM (SURVEY §7.3).  The reference is strictly
matrix-VECTOR (one RHS per call, an AVX2-era design); serving and solver
batching want many RHS at once.

``mvm_batched``: y_i = requantize(A @ x_i) for a batch of quantized
vectors — a vmap of the per-vector plain MVM (each column's output blocks
are requantized independently, identical semantics to per-vector mvm).

``gemm_f32``: C = restore(A) @ B for f32 B — blocked matmuls with the
dequantization folded into the per-block scale combine (no restored copy
of A is ever materialized).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import BLOCK, QMat16, QMat32, QMat4, unpack_nibbles
from . import _core
from .mvm import _out_bits, _requant_output, mvm_f32


def mvm_batched(A, xs, key=None):
    """Fused MVM over a batch of quantized vectors.

    ``xs`` is a quantized vector container whose arrays carry a leading
    batch dimension (stack per-vector containers with
    ``jax.tree.map(lambda *a: jnp.stack(a), *vecs)``).  Returns a
    container with the same leading batch dimension.  With SR on, vector
    ``j`` draws its noise from seed ``seed + j``.
    """
    leaf = jax.tree_util.tree_leaves(xs)[0]
    out_bits = _out_bits(A, xs)
    keys = None
    if key is not None:
        # normalize like every other op (seed_from accepts PRNG keys OR
        # the solvers' carried int32 seeds — jax.random.split would
        # reject the latter) and give each vector its own seed
        seed = _core.seed_from(key)[0]
        keys = (seed[None, :]
                + jnp.arange(leaf.shape[0], dtype=jnp.int32)[:, None])

    def one(x, k):
        y32 = mvm_f32(A, x)
        return _requant_output(y32, A.rows, out_bits, k)

    if keys is None:
        return jax.vmap(lambda x: one(x, None))(xs)
    return jax.vmap(one)(xs, keys)


def mvm_batched_f32(A, xs) -> jax.Array:
    """f32[b, m_pad] batched MVM, no output requantization — the batched
    analog of ops.mvm.mvm_f32 (the sharded path psums this before the
    band requant)."""
    return jax.vmap(lambda x: mvm_f32(A, x))(xs)


def gemm_f32(A, B: jax.Array) -> jax.Array:
    """C = restore(A) @ B with B f32[n, r]; f32[m_pad, r] out.

    Quantized A is dequantized on the fly: the per-tile scale is applied
    to the per-block partials — one batched dot_general over the 64-blocks.
    """
    if isinstance(A, (QMat16, QMat32)):
        return jnp.dot(A.values.astype(jnp.float32), B,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    qa = _core.qmax(A.bits)
    m, n = A.rows_pad, A.cols_pad
    nb = n // BLOCK
    codes = (unpack_nibbles(A.codes) if isinstance(A, QMat4)
             else A.codes)
    a3 = codes.reshape(m, nb, BLOCK).astype(jnp.float32)
    b3 = B.reshape(nb, BLOCK, -1).astype(jnp.float32)
    # (nb, m, r) per-block partials in f32 (B stays full precision,
    # matching the reference's dequant-on-the-fly x32 semantics).
    # HIGHEST keeps true f32 matmul mantissas — the GPU default would
    # round the x32 path through TF32 (reference does f32 FMA).
    part = jax.lax.dot_general(
        a3, b3, (((2,), (1,)), ((1,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)           # (nb, m, r)
    scale = (A.scales / qa).astype(jnp.float32)        # (m/64, nb)
    se = jnp.repeat(scale, BLOCK, axis=0).T            # (nb, m)
    return jnp.einsum("bmr,bm->mr", part, se,
                      precision=jax.lax.Precision.HIGHEST)
