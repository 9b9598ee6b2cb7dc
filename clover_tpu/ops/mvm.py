"""Matrix-vector multiply, including the fused output-requantization MVM
that is the reference's defining performance feature
(CloverMatrix4.h:777-1083 pure 4-bit, :1093-1449 mixed 4x8, :1451-1547
4x32; CloverMatrix8.h:481-1299; CloverMatrix16.h:98-382).

Semantics: y = A @ x where per 64-row band the f32 dot results are absmax'd
and requantized with stochastic rounding.  On a GPU the 4x4 / 4x8 / 8x8
combinations run the fused Triton kernel (kernels/mvm.py), which never
writes the f32 result to device memory; the plain XLA formulation below
keeps identical math and runs everywhere else.

The int paths accumulate code products exactly in int32 per 64-block, then
combine with ``(sA/qA) * (sx/qx)`` per tile — bit-faithful to the
reference's ``maddubs``-based blocked dot.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import (
    BLOCK, QMat4, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32,
)
from . import _core
from .quantize import quantize_vec, restore_mat, restore_vec

HALF = BLOCK // 2


def _halves(q):
    """(lo, hi) int32 code halves of a 4/8-bit vector, each shaped
    (nb, 32): elements j and j + 32 of every 64-block (for 4-bit, the
    low and high nibbles of byte j — formats.pack_nibbles layout)."""
    c = q.codes
    if q.bits == 4:
        p = c.reshape(-1, HALF)
        lo = jnp.bitwise_and(p, jnp.int8(15)) - jnp.int8(8)
        hi = jax.lax.shift_right_arithmetic(p, jnp.int8(4))
    else:
        p = c.reshape(-1, BLOCK)
        lo, hi = p[:, :HALF], p[:, HALF:]
    return lo.astype(jnp.int32), hi.astype(jnp.int32)


def _blocked_int_mvm_f32(A, x) -> jax.Array:
    """f32 result vector of a quantized-int MVM, before requantization.

    Exact int32 per-block accumulation, then the per-tile f32 scale
    combine.  The matrix's codes are read as int32 words of four bytes
    and each byte taken out with two shifts: one multiply-reduce fusion
    over the packed matrix.  (Reading them as int8 elements instead took
    2.2 times as long on an H200 at n=32768.)
    """
    qa = _core.qmax(A.bits)
    qx = _core.qmax(x.bits)
    m, nb = A.rows_pad, A.cols_pad // BLOCK
    wpb = A.codes.shape[-1] // nb // 4                      # words/block
    w = jax.lax.bitcast_convert_type(
        A.codes.reshape(m, nb, wpb, 4), jnp.int32)          # (m, nb, wpb)
    xlo, xhi = _halves(x)                                   # (nb, 32)
    if A.bits == 4:
        xlo, xhi = xlo.reshape(nb, wpb, 4), xhi.reshape(nb, wpb, 4)
    else:
        xall = jnp.concatenate([xlo, xhi], axis=1).reshape(nb, wpb, 4)
    acc = 0
    for b in range(4):                                      # byte b of word
        byte = jax.lax.shift_right_arithmetic(
            jnp.left_shift(w, 24 - 8 * b), 24)
        if A.bits == 4:
            lo = jnp.bitwise_and(byte, 15) - 8
            hi = jax.lax.shift_right_arithmetic(byte, 4)
            acc = acc + lo * xlo[..., b] + hi * xhi[..., b]
        else:
            acc = acc + byte * xall[..., b]
    acc = jnp.sum(acc, axis=-1)                             # (m, nb) exact
    comb = (jnp.repeat(A.scales / qa, BLOCK, axis=0)
            * (x.scales / qx)[None, :])                     # (m, nb) f32
    return jnp.sum(comb * acc.astype(jnp.float32), axis=1)


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def _use_kernel(A, x, u=None) -> bool:
    """The Triton kernel runs on a GPU for the shapes it takes; there is
    no other accelerator path and no fallback from a failed compile."""
    from ..kernels import mvm as kmvm
    return _on_gpu() and kmvm.eligible(A, x, u)


def mvm_f32(A, x) -> jax.Array:
    """y = A @ x as a padded f32 array (no output requantization).

    This is the building block the sharded path psums BEFORE requantizing,
    so the band absmax sees globally-reduced values.
    """
    if isinstance(A, (QMat4, QMat8)) and isinstance(x, (QVec4, QVec8)):
        return _blocked_int_mvm_f32(A, x)
    if isinstance(A, (QMat4, QMat8)) and isinstance(x, QVec32):
        # dequant-on-the-fly x32 path (CloverMatrix4.h:1451-1547): blocked
        # GEMM with the scale combine folded — no restored A in memory.
        from .gemm import gemm_f32
        return gemm_f32(A, x.values[:, None])[:, 0]
    # fp paths: dequantize and run a plain f32 matvec.
    af = restore_mat(A).values if not isinstance(A, QMat32) else A.values
    xf = restore_vec(x).values if not isinstance(x, QVec32) else x.values
    # HIGHEST: keep true f32 matvec mantissas (reference: MKL sgemv /
    # f16-to-f32 FMA accumulation; the GPU default would round through
    # TF32); a matvec is bandwidth-bound so this is free.
    return jnp.dot(af, xf, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def mvm_f32_fast(A, x) -> jax.Array:
    """Like :func:`mvm_f32` but on the fused kernel's f32-output mode on
    a GPU.  The sharded path (parallel/ops.mvm_psum) uses this per shard;
    ``mvm_f32`` itself stays plain XLA because the validation harness
    uses it as the independent reference implementation."""
    if _use_kernel(A, x):
        from ..kernels import mvm as kmvm
        return kmvm.mvm_f32(A, x)
    return mvm_f32(A, x)


def mvm(A, x, key=None):
    """Fused MVM: y = requantize_by_band(A @ x).

    Output precision follows the reference dispatch table:
    (4,4)->4, (8,8)->8, (4,8)->8, (16,16)->16, (*,32)->32, (32,32)->32.
    """
    if _use_kernel(A, x):
        from ..kernels import mvm as kmvm
        return kmvm.mvm(A, x, key)
    y32 = mvm_f32(A, x)
    out_bits = _out_bits(A, x)
    return _requant_output(y32, A.rows, out_bits, key)


def mvm_axpy(A, x, u, alpha, key_mvm=None, key_axpy=None):
    """r = scale_and_add(u, mvm(A, x), alpha).  On the kernel path the
    AXPY runs in the MVM's epilogue, so the intermediate requantized
    result never reaches device memory; both paths draw the same SR
    noise and agree within 1 output LSB.

    This is the solver hot-loop form of the reference's back-to-back
    mvm_parallel + scaleAndAdd_parallel (test/accuracy/02_iht_accuracy.h:
    79-95)."""
    if _use_kernel(A, x, u):
        from ..kernels import mvm as kmvm
        return kmvm.mvm_axpy(A, x, u, alpha, key_mvm, key_axpy)
    from .axpy import scale_and_add
    return scale_and_add(u, mvm(A, x, key=key_mvm), alpha, key=key_axpy)


def _out_bits(A, x) -> int:
    if isinstance(x, QVec32):
        return 32
    if isinstance(A, QMat4) and isinstance(x, QVec4):
        return 4
    if isinstance(A, QMat4) and isinstance(x, QVec8):
        return 8
    if isinstance(A, QMat8) and isinstance(x, QVec8):
        return 8
    if isinstance(A, QMat16) and isinstance(x, QVec16):
        return 16
    if isinstance(A, QMat32):
        return 32
    raise TypeError(f"unsupported MVM combination {type(A)} x {type(x)}")


def _requant_output(y32: jax.Array, rows: int, out_bits: int, key):
    if out_bits == 32:
        return QVec32(values=y32, length=rows)
    if out_bits == 16:
        return QVec16(values=_core.f16_rounded(y32), length=rows)
    # 64-element output blocks coincide with the 64-row bands, so plain
    # vector quantization IS the band requantization of the reference.
    return quantize_vec(QVec32(values=y32, length=rows), out_bits, key)
