"""Batched GD / IHT: B independent problems against ONE resident matrix.

The reference is strictly single-problem (Q_IHT / Q_GD,
test/performance/01_measure.h:912-1023).  A production recovery
pipeline usually solves MANY right-hand sides against one sensing
matrix (multi-frame / multi-channel compressive sensing).  The matrix
stream is the per-iteration cost, so both MVM legs go through
ops.gemm.mvm_batched (one XLA program for the whole batch), and the
vector-sized scaleAndAdd / threshold steps ride ``jax.vmap``.

Numerics: each problem follows the UNFUSED single-problem iteration
(mvm -> scaleAndAdd -> threshold) — the documented equivalent of the
fused solver within 1 output LSB per op.  SR streams: the batched MVM
requantizes with per-problem seeds (seed + i*B + j); the vmapped
scaleAndAdds share one noise draw per stage across the batch (every
problem still sees a valid unbiased SR stream; problems are
independent, so cross-problem noise correlation affects nothing).

Supported precisions: 4x4 / 4x8 / 8x8 (pure 16/32-bit batches gain
nothing from packing — run the single solver per problem).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..formats import zeros_vector
from ..ops import _core, restore_vec, scale_and_add, threshold
from ..ops.gemm import mvm_batched
from .solvers import _op_seeds, _vec_bits


class BatchSolveResult(NamedTuple):
    xs: object           # stacked quantized solutions (B leading dim)
    trace: jax.Array     # f32[iterations, B] — ||x_j - x*_j|| / ||x*_j||
                         # (zeros when no xs_star was given)


def _batch(qs):
    return jax.tree_util.tree_leaves(qs)[0].shape[0]


def _iteration_b(Phi, PhiT, ys, xs, mu, k, seed):
    k1, k2, k3, k4 = _op_seeds(seed)
    t1 = mvm_batched(Phi, xs, key=k1)                          # (B, m)
    t2 = jax.vmap(lambda y, t: scale_and_add(y, t, -1.0, key=k2))(ys, t1)
    t3 = mvm_batched(PhiT, t2, key=k3)                         # (B, n)
    xs = jax.vmap(lambda x, t: scale_and_add(x, t, mu, key=k4))(xs, t3)
    if k is not None:
        xs = jax.vmap(lambda x: threshold(x, k))(xs)
    return xs


@partial(jax.jit, static_argnames=("iterations", "k"))
def _solve_b(Phi, PhiT, ys, xs0, xs_star, iterations: int, k, mu, key):
    if xs_star is not None:
        star32 = xs_star.values                            # (B, n_pad)
        star_norm = jnp.linalg.norm(star32, axis=-1)
    seed0 = _core.seed_from(key)[0] if key is not None else None

    def body(xs, it):
        seed = (seed0 + it * jnp.int32(_core.SEED_GOLD)
                if seed0 is not None else None)
        xs = _iteration_b(Phi, PhiT, ys, xs, mu, k, seed)
        if xs_star is not None:
            xh = jax.vmap(lambda x: restore_vec(x).values)(xs)
            err = jnp.linalg.norm(xh - star32, axis=-1) / star_norm
        else:
            err = jnp.zeros((_batch(ys),), jnp.float32)
        return xs, err

    xs, trace = jax.lax.scan(body, xs0,
                             jnp.arange(iterations, dtype=jnp.int32))
    return BatchSolveResult(xs=xs, trace=trace)


def _initial_xs(Phi, ys):
    b = _batch(ys)
    x0 = zeros_vector(_vec_bits(ys), Phi.cols)
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (b,) + a.shape), x0)


def iht_batched(Phi, PhiT, ys, iterations: int, k: int, mu: float,
                key=None, xs_star=None) -> BatchSolveResult:
    """Quantized IHT over a batch of observation vectors.

    ``ys`` is a stacked quantized vector container (leading batch dim,
    as built by ``jax.tree.map(lambda *a: jnp.stack(a), *vec_list)``);
    every problem shares ``Phi``/``PhiT``/``mu``/``k``.  ``xs_star``
    (stacked QVec32, optional) enables per-problem error traces."""
    xs0 = _initial_xs(Phi, ys)
    return _solve_b(Phi, PhiT, ys, xs0, xs_star, iterations, int(k),
                    jnp.float32(mu), key)


def gd_batched(Phi, PhiT, ys, iterations: int, mu: float,
               key=None, xs_star=None) -> BatchSolveResult:
    """Quantized gradient descent over a batch of observation vectors."""
    xs0 = _initial_xs(Phi, ys)
    return _solve_b(Phi, PhiT, ys, xs0, xs_star, iterations, None,
                    jnp.float32(mu), key)
