"""Per-shard building blocks used inside ``shard_map`` regions.

These are the distributed equivalents of the reference's OpenMP kernels
(SURVEY §2.5): ``psum`` over the interconnect replaces the implicit
shared-memory reduction, per-shard PRNG keys replace
``random_key*_perthread`` (CloverRandom.h:39-41), and the two-phase
top-K (local top-K + gathered merge) is the reference's parallel
threshold algorithm (CloverVector4.h:1975-2060).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import QVec4, QVec8, QVec16, QVec32, pack_nibbles, unpack_nibbles
from ..ops import restore_vec
from ..ops._core import SEED_GOLD, f16_rounded
from ..ops.mvm import mvm_f32_fast
from ..ops.quantize import quantize_vec


def axis_key(key, axis: str):
    """Fold the mesh position along ``axis`` into the SR randomness so each
    shard of that axis draws an independent stochastic-rounding stream,
    while replicas along other axes stay bit-identical (required for
    outputs that are replicated along those axes).  This is the analog
    of the reference's per-thread key arrays (CloverRandom.h:104-113).

    ``key`` may be an int32 seed (cheap: one integer mix per shard) or a
    JAX PRNG key (fold_in)."""
    if key is None:
        return None
    idx = jax.lax.axis_index(axis)
    arr = jnp.asarray(key)
    if arr.dtype == jnp.int32:
        return arr + (idx + 1) * jnp.int32(SEED_GOLD ^ 0x5851F42D)
    return jax.random.fold_in(key, idx)


def mvm_psum(A_local, x_local, reduce_axis: str, key, out_bits: int,
             out_owner_axis: str):
    """Local fused-MVM partial -> psum over ``reduce_axis`` -> requantize.

    The psum happens BEFORE output requantization so every shard's band
    absmax sees the globally reduced values — the distributed version of
    CloverMatrix4.h:788-1083's band requant.  On a GPU the per-shard
    partial runs the fused kernel's f32 mode (mvm_f32_fast).
    """
    y32 = mvm_f32_fast(A_local, x_local)
    y32 = jax.lax.psum(y32, reduce_axis)
    if out_bits == 32:
        return QVec32(values=y32, length=A_local.rows)
    if out_bits == 16:
        return QVec16(values=f16_rounded(y32), length=A_local.rows)
    return quantize_vec(QVec32(values=y32, length=A_local.rows), out_bits,
                        key=axis_key(key, out_owner_axis))


def mvm_batched_psum(A_local, xs_local, reduce_axis: str, key,
                     out_bits: int, out_owner_axis: str):
    """Sharded batched MVM: per-shard batched f32 partials
    (ops.gemm.mvm_batched_f32), psum over ``reduce_axis``, THEN the
    per-vector band requant — the batch-of-vectors version of
    :func:`mvm_psum`, used by serving.py for mesh-resident matrices.

    ``xs_local`` is a stacked vector container whose per-vector arrays are
    sharded along ``reduce_axis``.  Returns a stacked container owned by
    ``out_owner_axis`` shards.  Per-vector SR seeds stride by batch index
    so each request draws an independent stream (same scheme as
    ops/gemm.mvm_batched).
    """
    from ..ops.gemm import mvm_batched_f32
    ys = mvm_batched_f32(A_local, xs_local)            # (b, m_local)
    ys = jax.lax.psum(ys, reduce_axis)
    b = ys.shape[0]
    rows = A_local.rows
    if out_bits == 32:
        return QVec32(values=ys, length=rows)
    if out_bits == 16:
        return QVec16(values=f16_rounded(ys), length=rows)
    k0 = axis_key(key, out_owner_axis)
    if k0 is None:
        keys = None
    else:
        arr = jnp.asarray(k0)
        if arr.dtype == jnp.int32:
            keys = arr.reshape(1, -1) + jnp.arange(b, dtype=jnp.int32)[:, None]
        else:
            keys = jax.vmap(lambda i: jax.random.fold_in(k0, i))(jnp.arange(b))

    def quant(y, k):
        return quantize_vec(QVec32(values=y, length=rows), out_bits, key=k)

    if keys is None:
        return jax.vmap(lambda y: quant(y, None))(ys)
    return jax.vmap(quant)(ys, keys)


def _col_chunk_mat(A, b0: int, b1: int):
    """Column-block slice [64*b0, 64*b1) of a quantized matrix.  The packed
    layout is block-contiguous (formats.pack_nibbles deinterleaves WITHIN
    each 64-block), so 4-bit byte columns slice at 32*b and scales at b."""
    from ..formats import QMat4, QMat8
    cols = (b1 - b0) * 64
    if isinstance(A, QMat4):
        return QMat4(codes=A.codes[:, 32 * b0:32 * b1],
                     scales=A.scales[:, b0:b1], rows=A.rows, cols=cols)
    assert isinstance(A, QMat8)
    return QMat8(codes=A.codes[:, 64 * b0:64 * b1],
                 scales=A.scales[:, b0:b1], rows=A.rows, cols=cols)


def _chunk_vec(x, b0: int, b1: int):
    from ..formats import QVec4, QVec8
    n = (b1 - b0) * 64
    if isinstance(x, QVec4):
        return QVec4(codes=x.codes[32 * b0:32 * b1],
                     scales=x.scales[b0:b1], length=n)
    assert isinstance(x, QVec8)
    return QVec8(codes=x.codes[64 * b0:64 * b1],
                 scales=x.scales[b0:b1], length=n)


def prepare_psum_chunks(A_local, chunks: int):
    """Materialize the column-chunk containers ONCE (hoist out of solver
    scans): a pytree of contiguous per-chunk matrices behind an
    optimization barrier so XLA builds them a single time."""
    nb = A_local.cols_pad // 64
    chunks = max(1, min(chunks, nb))
    bounds = [round(i * nb / chunks) for i in range(chunks + 1)]
    mats = [_col_chunk_mat(A_local, bounds[c], bounds[c + 1])
            for c in range(chunks)]
    return jax.lax.optimization_barrier(mats)


def mvm_psum_overlapped(A_local, x_local, reduce_axis: str, key,
                        out_bits: int, out_owner_axis: str,
                        chunks: int = 4, prepared=None):
    """:func:`mvm_psum` with the k-reduction chunked so the all-reduce can
    overlap compute (the BASELINE.json north star: "partial dot-products
    reduced via psum overlapped with compute").

    The local column range splits into ``chunks`` 64-aligned groups; each
    group's fused partial MVM feeds its own ``psum``.  Chunk c+1's compute
    has NO data dependency on chunk c's psum, so XLA's async-collective
    scheduler can run the (c+1)-th kernel while the c-th all-reduce is in
    flight; the final band requant still sees the fully reduced values, so
    the requant-after-psum correctness rule is preserved.  Total HBM
    traffic is unchanged (each chunk streams its own column slice once).

    Numerics: the f32 block-sum association differs from mvm_psum (per-
    chunk partial sums), the same class of difference psum itself already
    introduces; the exact-integer cross-check passes bit-for-bit
    (tests/test_parallel.py::test_mvm_psum_overlapped_exact).

    When it wins: overlap hides min(compute, psum) * (chunks-1)/chunks
    at the cost of one more kernel per chunk.  No measurement on NVLink
    judges it yet, so the sharded solvers run the plain :func:`mvm_psum`
    and this stays an explicit opt-in with its ``chunks`` argument.
    Pass ``prepared`` (from :func:`prepare_psum_chunks`) inside loops:
    unprepared column slices cost a full local-matrix copy per call.
    """
    nb = A_local.cols_pad // 64
    chunks = max(1, min(chunks, nb))
    bounds = [round(i * nb / chunks) for i in range(chunks + 1)]
    if prepared is None:
        prepared = prepare_psum_chunks(A_local, chunks)
    assert len(prepared) == chunks, (len(prepared), chunks)
    partials = []
    for c in range(chunks):
        b0, b1 = bounds[c], bounds[c + 1]
        if b0 == b1:
            continue
        partials.append(mvm_f32_fast(prepared[c],
                                     _chunk_vec(x_local, b0, b1)))
    y32 = None
    for p in partials:
        r = jax.lax.psum(p, reduce_axis)
        y32 = r if y32 is None else y32 + r
    if out_bits == 32:
        return QVec32(values=y32, length=A_local.rows)
    if out_bits == 16:
        return QVec16(values=f16_rounded(y32), length=A_local.rows)
    return quantize_vec(QVec32(values=y32, length=A_local.rows), out_bits,
                        key=axis_key(key, out_owner_axis))


def threshold_global(x_local, k: int, axis: str):
    """Global top-K over a vector sharded along ``axis``: local top-K,
    all_gather the K candidates per shard, merge, mask locally.

    Tie-break: (|value| desc, global index asc) — the gathered order is
    (shard, local rank), which coincides with global index order for
    equal values because the local top_k is index-stable.
    """
    from ..ops.threshold import _top_k_idx
    local_len = x_local.length_pad
    my = jax.lax.axis_index(axis)
    vals = jnp.abs(restore_vec(x_local).values)
    li = _top_k_idx(vals, k)       # two-stage for large shards, stable
    lv = vals[li]
    # gather candidates from all shards of `axis`
    gv = jax.lax.all_gather(lv, axis)              # (parts, k)
    gi = jax.lax.all_gather(li + 0, axis)          # local indices
    parts = gv.shape[0]
    shard_of = jnp.repeat(jnp.arange(parts), k)
    flat_v = gv.reshape(-1)
    flat_i = gi.reshape(-1)
    _, sel = jax.lax.top_k(flat_v, k)
    sel_shard = shard_of[sel]
    sel_local_idx = flat_i[sel]
    # indices that belong to me
    mine = sel_shard == my
    scatter_idx = jnp.where(mine, sel_local_idx, local_len)  # OOB -> drop
    mask = jnp.zeros((local_len,), jnp.bool_).at[scatter_idx].set(
        True, mode="drop")

    if isinstance(x_local, QVec4):
        codes = unpack_nibbles(x_local.codes)
        codes = jnp.where(mask, codes, jnp.int8(0))
        return QVec4(codes=pack_nibbles(codes), scales=x_local.scales,
                     length=x_local.length)
    if isinstance(x_local, QVec8):
        return QVec8(codes=jnp.where(mask, x_local.codes, jnp.int8(0)),
                     scales=x_local.scales, length=x_local.length)
    if isinstance(x_local, QVec16):
        return QVec16(values=jnp.where(mask, x_local.values, jnp.float16(0)),
                      length=x_local.length)
    return QVec32(values=jnp.where(mask, x_local.values, jnp.float32(0)),
                  length=x_local.length)


def dot_psum(u_local, v_local, axis: str):
    """Distributed quantized dot: local blocked dot + psum over ``axis``."""
    from ..ops import dot as _dot
    return jax.lax.psum(_dot(u_local, v_local), axis)


def norm2_psum(x32_local: jax.Array, axis: str):
    return jnp.sqrt(jax.lax.psum(jnp.sum(x32_local * x32_local), axis))
