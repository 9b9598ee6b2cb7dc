"""Quantized GD and IHT solvers.

Reference: Q_GD / Q_IHT iteration loops (test/performance/01_measure.h:912-946
and :1001-1023), accuracy-tracing variants (test/accuracy/02_iht_accuracy.h:
30-96, 03_gd_accuracy.h:30-87).

Design: one ``lax.scan`` per solve — the whole iteration (two fused
MVMs, two scaleAndAdds, a top-K) is a single compiled program; the
reference's five OpenMP fork-joins per iteration become device work with
no host round trip.
Stochastic-rounding keys are threaded through the scan carry; ``key=None``
runs fully deterministic (the reference's SR-disabled build).

The per-iteration update (IHT; GD omits the threshold):
    t1 = Phi  @ x        (fused requantized MVM)
    t2 = y - t1          (blockwise requantized AXPY)
    t3 = PhiT @ t2
    x  = x + mu * t3
    x  = top_k(x, K)

On the reference's sparse-x trick (CloverMatrix8.h:979-1000 — compute
Phi@x as a sum of K rows of PhiT): deliberately NOT used here.  On the
CPU it wins because it skips FLOPs on a compute-bound machine.  On an
accelerator the dense fused MVM streams the packed matrix once with zero
intermediates, while a gather-based sparse MVM at the standard K = n/4
must materialize gathered rows plus a dequantized operand (f32/bf16) in
device memory — more traffic than the dense stream it replaces (it only
pays off for K < ~n/9, which none of the reference protocols use).
ops/sparse.mvm_sparse remains available and tested for genuinely sparse
regimes.  For MANY problems against one matrix, models/batch.py runs the
batch through one solve.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..formats import zeros_vector
from ..ops import _core, restore_vec, threshold
from ..ops.mvm import mvm_axpy


class SolveResult(NamedTuple):
    x: object            # quantized solution container
    trace: jax.Array     # f32[iterations] — per-iteration ||x-x*||/||x*||
                         # (all zeros when no x_star was given)


def _vec_bits(qvec) -> int:
    return qvec.bits


def _op_seeds(key_or_seed, n: int = 4):
    """Derive n per-op int32 seeds from an iteration seed (or PRNG key) by
    constant strides — pure integer adds, no threefry on the solver hot
    path (the analog of the reference's per-thread XORShift streams,
    CloverRandom.h:39-41)."""
    if key_or_seed is None:
        return (None,) * n
    seed = _core.seed_from(key_or_seed)[0]
    return tuple(seed + jnp.int32((j + 1) * _core.SEED_OP) for j in range(n))


def _iteration(Phi, PhiT, y, x, mu, k, seed):
    # Each MVM's scaleAndAdd rides the MVM kernel's epilogue on a GPU
    # (ops.mvm.mvm_axpy): the quantized intermediates t1/t3 never reach
    # device memory and the iteration is two kernels plus the threshold.
    k1, k2, k3, k4 = _op_seeds(seed)
    t2 = mvm_axpy(Phi, x, y, -1.0, key_mvm=k1, key_axpy=k2)   # y - Phi x
    x = mvm_axpy(PhiT, t2, x, mu, key_mvm=k3, key_axpy=k4)    # x+mu Phi't2
    if k is not None:
        x = threshold(x, k)
    return x


@partial(jax.jit, static_argnames=("iterations", "k"))
def _solve(Phi, PhiT, y, x0, x_star, iterations: int, k, mu, key):
    xs32 = x_star.values if x_star is not None else None
    xs_norm = (jnp.linalg.norm(xs32) if xs32 is not None else None)
    seed0 = _core.seed_from(key)[0] if key is not None else None

    def body(x, it):
        seed = (seed0 + it * jnp.int32(_core.SEED_GOLD)
                if seed0 is not None else None)
        x = _iteration(Phi, PhiT, y, x, mu, k, seed)
        if xs32 is not None:
            err = jnp.linalg.norm(restore_vec(x).values - xs32) / xs_norm
        else:
            err = jnp.float32(0)
        return x, err

    x, trace = jax.lax.scan(body, x0, jnp.arange(iterations, dtype=jnp.int32))
    return SolveResult(x=x, trace=trace)


def iht(Phi, PhiT, y, iterations: int, k: int, mu: float,
        key=None, x_star=None) -> SolveResult:
    """Quantized Iterative Hard Thresholding (compressive-sensing recovery).

    ``Phi``/``PhiT`` are quantized matrices (PhiT materialized up front,
    as the reference does at 02_iht_accuracy.h:72); ``y`` a quantized
    vector of observations.  ``x_star`` (QVec32, optional) enables the
    per-iteration relative-error trace of the accuracy protocol.
    """
    x0 = _initial_x(Phi, y)
    return _solve(Phi, PhiT, y, x0, x_star, iterations, int(k),
                  jnp.float32(mu), key)


def gd(Phi, PhiT, y, iterations: int, mu: float,
       key=None, x_star=None) -> SolveResult:
    """Quantized gradient descent on least squares ||y - Phi x||^2."""
    x0 = _initial_x(Phi, y)
    return _solve(Phi, PhiT, y, x0, x_star, iterations, None,
                  jnp.float32(mu), key)


def _initial_x(Phi, y):
    """x starts cleared (reference: x.clear(), 01_measure.h:938) at the
    precision the update loop keeps it in: the output precision of
    PhiT @ t2 — y's precision for pure configs, 8-bit for mixed 4x8."""
    return zeros_vector(_vec_bits(y), Phi.cols)
