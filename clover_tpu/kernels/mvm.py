"""Fused requantizing MVM for Hopper, written in Pallas for Triton.

The reference's defining mechanism (CloverMatrix4.h:777-1083 pure 4-bit,
:1093-1449 mixed 4x8, CloverMatrix8.h:481-1299 pure 8-bit): stream the
packed matrix once and requantize the output band by band, never
writing the f32 result to device memory.

* One program owns one 64-row output band, so the band absmax of the
  requantization is local to the program.
* The program loops over k-tiles of ``NBT`` 64-column blocks; Triton
  pipelines the tile loads (``num_stages``).
* The exact int32 per-(row, block) dots come from the tensor cores:
  x's codes are spread into a block-diagonal int8 tile in registers, so
  one ``(64, tile) @ (tile, NBT)`` product yields every block's integer
  dot of the band.  With the biased-nibble layout (formats.py: a packed
  byte ``p`` is ``16*hi + (lo+8)`` as int8) the 4-bit matrix is consumed
  packed, one AND per byte being its only unpacking::

      4x4: T = ((p @ W[xh] + (p & 15) @ W[16*xl - xh]) >> 4) - 8*colsum(xl)
      4x8: T = (((p & -16) @ W[xh]) >> 4) + (p & 15) @ W[xl] - 8*colsum(xl)
      8x8: T = p @ W[x]

* The per-tile scale combine ``(sA/qA)*(sx/qx)`` is formed outside the
  kernel exactly as golden.py forms it and applied per k-tile in f32.
* The epilogue takes the band absmax, requantizes (deterministic or
  stochastic rounding) and packs; or writes f32 (the sharded path
  psums before requantizing); or runs the scaleAndAdd behind the MVM.
* Stochastic-rounding noise is drawn with ``jax.random`` outside the
  kernel (``ops._core.noise_like``, the same draw the plain path uses),
  so kernel and plain path agree given the same key.

Results agree with the plain XLA path (ops/mvm.py) to one output LSB:
only the f32 order of the scale combine differs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..formats import BLOCK, QMat4, QMat8, QVec4, QVec8
from ..ops import _core

HALF = BLOCK // 2
NBT = 16                   # 64-column blocks per k-tile
NUM_WARPS = 4
NUM_STAGES = 3


def kernel_mode(A, x) -> str | None:
    if isinstance(A, QMat4) and isinstance(x, QVec4):
        return "4x4"
    if isinstance(A, QMat4) and isinstance(x, QVec8):
        return "4x8"
    if isinstance(A, QMat8) and isinstance(x, QVec8):
        return "8x8"
    return None


def eligible(A, x, u=None) -> bool:
    """The kernel takes 4x4, 4x8 and 8x8 with whole k-tiles; for the
    AXPY epilogue ``u`` must be a container of the output precision
    covering A's rows."""
    if (kernel_mode(A, x) is None or A.cols_pad % (NBT * BLOCK)
            or x.length_pad != A.cols_pad):
        return False
    if u is None:
        return True
    out_cls = QVec4 if _out_bits(A, x) == 4 else QVec8
    return type(u) is out_cls and u.length_pad == A.rows_pad


def _div(num, den, interpret: bool):
    """Correctly rounded f32 divide.  Triton lowers ``/`` to the
    approximate ``div.full.f32``; the plain path and golden.py use XLA's
    IEEE divide for the quantization multiplier, so the compiled kernel
    issues ``div.rn.f32``.  The interpreter divides exactly already."""
    if interpret:
        return num / den
    [out] = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[num, den], constraints="=f,f,f",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(num.shape,
                                                          jnp.float32)])
    return out


def _requant(v, qm: float, noise, interpret: bool):
    """Band absmax -> (SR) quantize; ``v`` is the band as (2, 32) f32.
    Same op order as ops/_core.sr_codes."""
    av = jnp.abs(v)
    s = jnp.max(av)
    s = jnp.where(s == 0.0, 1.0, s)
    mult = _div(jnp.full(v.shape, qm, jnp.float32),
                jnp.full(v.shape, s, jnp.float32), interpret)
    mag = av * mult
    if noise is not None:
        mag = mag + noise
    qa = jnp.minimum(jnp.floor(mag), qm)
    return jnp.where(v < 0.0, -qa, qa), s


def _halves(lo, hi):
    """Two (32,) rows -> one (2, 32) tile (row 0 = block elements 0..31)."""
    row = jax.lax.broadcasted_iota(jnp.int32, (2, HALF), 0)
    return jnp.where(row == 0, lo[None, :], hi[None, :])


def _dot(a, w):
    return jax.lax.dot_general(a, w, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)


def _kernel(*refs, mode, nkt, out_bits, noise, axpy, interpret):
    refs = list(refs)
    a_ref = refs.pop(0)
    x1_ref = refs.pop(0)
    x2_ref = corr_ref = None
    if mode != "8x8":
        x2_ref, corr_ref = refs.pop(0), refs.pop(0)
    comb_ref = refs.pop(0)
    n1_ref = refs.pop(0) if noise[0] else None
    if axpy:
        uc_ref, us_ref, alpha_ref = refs.pop(0), refs.pop(0), refs.pop(0)
        n2_ref = refs.pop(0) if noise[1] else None
    yc_ref = refs.pop(0)
    ys_ref = refs.pop(0) if out_bits != 32 else None

    width = BLOCK if mode == "8x8" else HALF        # A bytes per block row
    tkb = NBT * width
    onehot = (jax.lax.broadcasted_iota(jnp.int32, (tkb, NBT), 0) // width
              == jax.lax.broadcasted_iota(jnp.int32, (tkb, NBT), 1))

    def spread(ref, k):
        xs = ref[pl.ds(k * tkb, tkb)]
        return jnp.where(onehot, xs[:, None], jnp.int8(0))

    def step(k, acc):
        a = a_ref[:, pl.ds(k * tkb, tkb)]           # (64, tkb) int8
        if mode == "8x8":
            t = _dot(a, spread(x1_ref, k))
        else:
            corr = corr_ref[pl.ds(k * NBT, NBT)][None, :]
            lou = jnp.bitwise_and(a, jnp.int8(15))
            if mode == "4x4":
                t = jax.lax.shift_right_arithmetic(
                    _dot(a, spread(x1_ref, k)) + _dot(lou, spread(x2_ref, k)),
                    4) - corr
            else:
                hi16 = jnp.bitwise_and(a, jnp.int8(-16))
                t = (jax.lax.shift_right_arithmetic(
                    _dot(hi16, spread(x1_ref, k)), 4)
                    + _dot(lou, spread(x2_ref, k)) - corr)
        comb = comb_ref[0, pl.ds(k * NBT, NBT)]
        return acc + jnp.sum(t.astype(jnp.float32) * comb[None, :], axis=1)

    y = jax.lax.fori_loop(0, nkt, step, jnp.zeros((BLOCK,), jnp.float32))
    if out_bits == 32:
        yc_ref[...] = y.reshape(1, BLOCK)
        return

    qm = float(_core.qmax(out_bits))
    n1 = n1_ref[...].reshape(2, HALF) if n1_ref is not None else None
    q, s = _requant(y.reshape(2, HALF), qm, n1, interpret)
    if axpy:
        # scaleAndAdd in the plain path's op order:
        # x = u_code * (su/qm) + alpha * (t1_code * (s1/qm))
        if out_bits == 4:
            ub = uc_ref[0, :]
            u = _halves(jnp.bitwise_and(ub, jnp.int8(15)) - jnp.int8(8),
                        jax.lax.shift_right_arithmetic(ub, jnp.int8(4)))
        else:
            u = uc_ref[...].reshape(2, HALF)
        full = lambda v: jnp.full((2, HALF), v, jnp.float32)  # noqa: E731
        su = _div(full(us_ref[0, 0]), full(qm), interpret)
        s1 = _div(full(s), full(qm), interpret)
        xv = u.astype(jnp.float32) * su + alpha_ref[0] * (q * s1)
        n2 = n2_ref[...].reshape(2, HALF) if n2_ref is not None else None
        q, s = _requant(xv, qm, n2, interpret)
    if out_bits == 4:
        w = jnp.where(jax.lax.broadcasted_iota(jnp.int32, (2, HALF), 0) == 0,
                      1.0, 16.0)
        yc_ref[...] = (jnp.sum(q * w, axis=0) + 8.0).astype(
            jnp.int8).reshape(1, HALF)
    else:
        yc_ref[...] = q.astype(jnp.int8).reshape(1, BLOCK)
    ys_ref[...] = jnp.full((1, 1), s, jnp.float32)


def _x_operands(A, x, mode):
    """Per-call x-side operands: the codes W is spread from (flat, in A's
    byte order), the colsum correction and the per-tile scale combine."""
    nb = A.cols_pad // BLOCK
    qa, qx = _core.qmax(A.bits), _core.qmax(x.bits)
    comb = (A.scales / qa) * (x.scales / qx)[None, :]
    if mode == "8x8":
        return [x.codes, comb]
    if mode == "4x4":
        xp = x.codes.reshape(nb, HALF)
        xh = jax.lax.shift_right_arithmetic(xp, jnp.int8(4))
        xl = jnp.bitwise_and(xp, jnp.int8(15)) - jnp.int8(8)
        x1, x2 = xh, 16 * xl - xh
    else:
        xc = x.codes.reshape(nb, BLOCK)
        xl, x1 = xc[:, :HALF], xc[:, HALF:]
        x2 = xl
    corr = 8 * jnp.sum(xl.astype(jnp.int32), axis=1)
    return [x1.reshape(-1), x2.astype(jnp.int8).reshape(-1), corr, comb]


def _call(A, x, out_bits, noise1=None, axpy=None, interpret=False):
    mode = kernel_mode(A, x)
    assert eligible(A, x), (mode, A.cols_pad, x.length_pad)
    m_pad = A.rows_pad
    bands = m_pad // BLOCK
    nkt = A.cols_pad // (NBT * BLOCK)
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))  # noqa: E731
    band = lambda w: pl.BlockSpec((1, w), lambda i: (i, 0))  # noqa: E731

    ops = _x_operands(A, x, mode)
    args = [A.codes, *ops]
    in_specs = [pl.BlockSpec((BLOCK, A.codes.shape[1]), lambda i: (i, 0))]
    in_specs += [full(o.shape) for o in ops[:-1]]
    in_specs.append(band(ops[-1].shape[1]))
    if noise1 is not None:
        args.append(noise1.reshape(bands, BLOCK))
        in_specs.append(band(BLOCK))
    noise2 = None
    if axpy is not None:
        u, alpha, noise2 = axpy
        pck = HALF if out_bits == 4 else BLOCK
        args += [u.codes.reshape(bands, pck), u.scales.reshape(bands, 1),
                 jnp.asarray(alpha, jnp.float32).reshape(1)]
        in_specs += [band(pck), band(1), full((1,))]
        if noise2 is not None:
            args.append(noise2.reshape(bands, BLOCK))
            in_specs.append(band(BLOCK))

    if out_bits == 32:
        out_shape = [jax.ShapeDtypeStruct((bands, BLOCK), jnp.float32)]
        out_specs = [band(BLOCK)]
    else:
        pck = HALF if out_bits == 4 else BLOCK
        out_shape = [jax.ShapeDtypeStruct((bands, pck), jnp.int8),
                     jax.ShapeDtypeStruct((bands, 1), jnp.float32)]
        out_specs = [band(pck), band(1)]

    kernel = lambda *r: _kernel(  # noqa: E731
        *r, mode=mode, nkt=nkt, out_bits=out_bits,
        noise=(noise1 is not None, noise2 is not None),
        axpy=axpy is not None, interpret=interpret)
    outs = pl.pallas_call(
        kernel, out_shape=out_shape, grid=(bands,), in_specs=in_specs,
        out_specs=out_specs, backend="triton", interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        name=f"clover_mvm_{mode}",
    )(*args)
    if out_bits == 32:
        return outs[0].reshape(-1)
    cls = QVec4 if out_bits == 4 else QVec8
    return cls(codes=outs[0].reshape(-1), scales=outs[1].reshape(-1),
               length=A.rows)


def _out_bits(A, x) -> int:
    return 4 if kernel_mode(A, x) == "4x4" else 8


def mvm_f32(A, x, interpret: bool = False) -> jax.Array:
    """Padded f32 ``A @ x`` (no requantization): the per-shard partial
    the sharded path psums before its band requant."""
    return _call(A, x, 32, interpret=interpret)


def mvm(A, x, key=None, interpret: bool = False):
    """Requantized ``A @ x``: (4,4)->4, (4,8)->8, (8,8)->8."""
    noise = _core.noise_like(key, (A.rows_pad,))
    return _call(A, x, _out_bits(A, x), noise, interpret=interpret)


def mvm_axpy(A, x, u, alpha, key_mvm=None, key_axpy=None,
             interpret: bool = False):
    """``scale_and_add(u, mvm(A, x), alpha)`` with the AXPY in the
    epilogue: the intermediate requantized MVM result stays in
    registers."""
    n1 = _core.noise_like(key_mvm, (A.rows_pad,))
    n2 = _core.noise_like(key_axpy, (A.rows_pad,))
    return _call(A, x, _out_bits(A, x), n1, axpy=(u, alpha, n2),
                 interpret=interpret)
