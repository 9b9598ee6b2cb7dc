"""Mesh-sharded GD / IHT: the whole solve (scan included) runs inside one
``shard_map`` region, so every iteration is two local fused MVMs, two
psums, local AXPYs, and one gathered top-K merge — zero resharding.

Dataflow (mesh axes "row" x "col"; see parallel/mesh.py):
    Phi  P(row,col) @ x P(col)  --psum col-->  t1 P(row)
    t2 = y - t1                                 (local on row shards)
    PhiT P(col,row) @ t2 P(row) --psum row-->   t3 P(col)
    x += mu * t3; x = top_k(x, K)               (local + gather merge)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:  # JAX >= 0.5 exports shard_map at the top level
    from jax import shard_map
    def _shard_map(f, mesh, in_specs, out_specs):
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map
    def _shard_map(f, mesh, in_specs, out_specs):
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_rep=False)

from ..formats import QMat16, QMat32, QVec16, QVec32, zeros_vector
from ..models.solvers import SolveResult
from ..ops import _core, scale_and_add
from ..ops.mvm import mvm_axpy
from .mesh import COL, ROW
from .ops import axis_key, mvm_psum, norm2_psum, threshold_global


def _mat_arrays(qA):
    if isinstance(qA, (QMat16, QMat32)):
        return (qA.values,), ("values",)
    return (qA.codes, qA.scales), ("codes", "scales")


def _vec_arrays(qx):
    if isinstance(qx, (QVec16, QVec32)):
        return (qx.values,), ("values",)
    return (qx.codes, qx.scales), ("codes", "scales")


def _local_mat(qA, r_parts, c_parts, arrays):
    rows = qA.rows_pad // r_parts
    cols = qA.cols_pad // c_parts
    kw = dict(zip(_mat_arrays(qA)[1], arrays))
    return type(qA)(rows=rows, cols=cols, **kw)


def _local_vec(qx, parts, arrays):
    length = qx.length_pad // parts
    kw = dict(zip(_vec_arrays(qx)[1], arrays))
    return type(qx)(length=length, **kw)


def _out_bits(qA, qx) -> int:
    from ..ops.mvm import _out_bits as ob
    return ob(qA, qx)


def _solve_sharded(qphi, qphit, qy, x0, x_star, iterations: int, k, mu,
                   key, mesh):
    """Build and run the shard_map'ed scan.  k=None -> GD."""
    R, C = mesh.shape[ROW], mesh.shape[COL]
    t_bits = _out_bits(qphi, x0)     # precision of t1/t2 (y's side)
    x_bits = _out_bits(qphit, qy)    # precision of x updates

    phi_arrs, _ = _mat_arrays(qphi)
    phit_arrs, _ = _mat_arrays(qphit)
    y_arrs, _ = _vec_arrays(qy)
    x0_arrs, _ = _vec_arrays(x0)

    n_phi, n_y, n_x = len(phi_arrs), len(y_arrs), len(x0_arrs)
    have_key = key is not None
    have_star = x_star is not None

    def local(*args):
        i = 0
        phi = _local_mat(qphi, R, C, args[i:i + n_phi]); i += n_phi
        phit = _local_mat(qphit, C, R, args[i:i + n_phi]); i += n_phi
        y = _local_vec(qy, R, args[i:i + n_y]); i += n_y
        x_init = _local_vec(x0, C, args[i:i + n_x]); i += n_x
        xs = args[i] if have_star else None
        i += int(have_star)
        k0 = args[i] if have_key else None

        xs_norm = norm2_psum(xs, COL) if xs is not None else None

        # One threefry draw up front; per-iteration/per-op seeds are then
        # integer strides (models/solvers.py uses the same scheme).
        seed0 = _core.seed_from(k0)[0] if k0 is not None else None

        def body(x, it):
            if seed0 is not None:
                base = seed0 + it * jnp.int32(_core.SEED_GOLD)
                ks = [base + (j + 1) * jnp.int32(_core.SEED_OP)
                      for j in range(4)]
            else:
                base = None
                ks = (None,) * 4
            if R == 1 and C == 1:
                # no collectives anywhere: run the single-device
                # iteration (fused MVM+AXPY epilogues) — bit-identical to
                # models.solvers on a 1x1 mesh.  threshold_global over
                # one shard equals the local threshold.
                from ..models.solvers import _iteration
                x = _iteration(phi, phit, y, x, mu, k, base)
            else:
                x = _decomposed(x, ks)
            if xs is not None:
                from ..ops import restore_vec
                d = restore_vec(x).values - xs
                err = norm2_psum(d, COL) / xs_norm
            else:
                err = jnp.float32(0)
            return x, err

        def _decomposed(x, ks):
            if C == 1:
                # leg-1 psum is trivial: fuse the AXPY into the MVM
                # epilogue (per-shard SR streams still folded by row)
                t2 = mvm_axpy(phi, x, y, -1.0,
                              key_mvm=axis_key(ks[0], ROW),
                              key_axpy=axis_key(ks[1], ROW))
            else:
                t1 = mvm_psum(phi, x, COL, ks[0], t_bits, ROW)
                t2 = scale_and_add(y, t1, -1.0, key=axis_key(ks[1], ROW))
            if R == 1:
                x = mvm_axpy(phit, t2, x, mu,
                             key_mvm=axis_key(ks[2], COL),
                             key_axpy=axis_key(ks[3], COL))
            else:
                t3 = mvm_psum(phit, t2, ROW, ks[2], x_bits, COL)
                x = scale_and_add(x, t3, mu, key=axis_key(ks[3], COL))
            if k is not None:
                x = threshold_global(x, k, COL)
            return x

        x, trace = jax.lax.scan(body, x_init,
                                jnp.arange(iterations, dtype=jnp.int32))
        outs, _ = _vec_arrays(x)
        return (*outs, trace)

    in_specs = ([P(ROW, COL)] * n_phi + [P(COL, ROW)] * n_phi
                + [P(ROW)] * n_y + [P(COL)] * n_x)
    args = [*phi_arrs, *phit_arrs, *y_arrs, *x0_arrs]
    if have_star:
        in_specs.append(P(COL))
        args.append(x_star.values)
    if have_key:
        in_specs.append(P())
        args.append(key)
    out_specs = tuple([P(COL)] * n_x + [P()])

    fn = _shard_map(local, mesh, tuple(in_specs), out_specs)
    *x_arrs, trace = jax.jit(fn)(*args)
    kw = dict(zip(_vec_arrays(x0)[1], x_arrs))
    x_out = type(x0)(length=x0.length, **kw)
    return SolveResult(x=x_out, trace=trace)


def iht(qphi, qphit, qy, iterations: int, k: int, mu: float, mesh,
        key=None, x_star=None) -> SolveResult:
    """Mesh-sharded quantized IHT.  Inputs must be sharded per
    parallel.mesh rules (qphi P(row,col), qphit P(col,row), qy P(row));
    x_star, if given, is a padded f32 array container (QVec32)."""
    x0 = zeros_vector(_out_bits(qphit, qy), qphi.cols)
    return _solve_sharded(qphi, qphit, qy, x0, x_star, iterations, int(k),
                          jnp.float32(mu), key, mesh)


def gd(qphi, qphit, qy, iterations: int, mu: float, mesh,
       key=None, x_star=None) -> SolveResult:
    """Mesh-sharded quantized gradient descent."""
    x0 = zeros_vector(_out_bits(qphit, qy), qphi.cols)
    return _solve_sharded(qphi, qphit, qy, x0, x_star, iterations, None,
                          jnp.float32(mu), key, mesh)
