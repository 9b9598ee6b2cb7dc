"""The reference accuracy protocols, reproduced end-to-end.

IHT: m=512, n=1024, K=64, 200 epochs, per-precision tuned mu
(test/accuracy/00_accuracy.cpp:36-91); metric = ||x - x*|| / ||x*|| per
epoch (02_iht_accuracy.h:89-94).  All five precision configs: mixed 4x8,
4, 8, 16, 32.

GD: m=384, n=256, 500 iterations, mu=0.4000000358
(test/accuracy/00_accuracy.cpp:93-119; disabled by default upstream but
provided here as a first-class protocol).
"""

from __future__ import annotations

import jax

from ..formats import QVec32
from ..ops import quantize_mat, quantize_vec, transpose
from .problems import make_gd_problem, make_iht_problem
from .solvers import gd, iht

# Tuned step sizes from the reference (test/accuracy/00_accuracy.cpp:74-78).
ACCURACY_MU = {
    "4x8": 0.0051299855,
    4: 0.0042842566,
    8: 0.0042007011,
    16: 0.0048838919,
    32: 0.0048838919,
}

GD_MU = 0.4000000358


def _quantize_problem(phi, y, mat_bits: int, vec_bits: int, key):
    kA, ky, krun = (jax.random.split(key, 3) if key is not None
                    else (None, None, None))
    qphi = quantize_mat(phi, mat_bits, key=kA)
    qphit = transpose(qphi)
    qy = quantize_vec(y, vec_bits, key=ky)
    return qphi, qphit, qy, krun


def run_iht_accuracy(config, m=512, n=1024, k=64, epochs=200,
                     mu=None, seed=None, key=None, data="auto"):
    """Run one precision config of the IHT accuracy protocol.

    ``config`` is 4, 8, 16, 32, or "4x8".  Returns the per-epoch relative
    recovery error trace (f32[epochs]).

    ``data`` selects the problem instance: "reference" = the bit-exact
    (Phi, x*, y) the reference's ``clover -a`` solves
    (problems.make_iht_problem_reference — required for accuracy-parity
    comparisons, because the published mu values are tuned to that exact
    Phi); "threefry" = this framework's own generator; "auto" (default)
    = "reference" at the protocol size (512x1024, no explicit seed),
    else "threefry".
    """
    if data == "auto":
        data = ("reference" if (m, n) == (512, 1024) and seed is None
                else "threefry")
    if data == "reference":
        import jax.numpy as jnp
        from .problems import make_iht_problem_reference
        phi, x_star, y = (jnp.asarray(a)
                          for a in make_iht_problem_reference(m, n, k))
    else:
        kwargs = {} if seed is None else {"seed": seed}
        phi, x_star, y = make_iht_problem(m, n, k, **kwargs)
    mat_bits = 4 if config == "4x8" else config
    vec_bits = 8 if config == "4x8" else config
    mu = ACCURACY_MU[config] if mu is None else mu
    qphi, qphit, qy, krun = _quantize_problem(phi, y, mat_bits, vec_bits, key)
    res = iht(qphi, qphit, qy, epochs, k, mu, key=krun,
              x_star=QVec32(values=x_star, length=n))
    return res.trace


def run_gd_accuracy(config, m=384, n=256, iterations=500, mu=GD_MU,
                    seed=None, key=None, data="auto"):
    """Run one precision config of the GD accuracy protocol.

    ``data`` as in run_iht_accuracy: "reference" = the bit-exact
    (Phi, x*, y) of the reference's test_gd
    (problems.make_gd_problem_reference, verified against the
    from-source build's dump, doc/results/refrun);
    "auto" = "reference" at the protocol size with no explicit seed.
    """
    if data == "auto":
        data = ("reference" if (m, n) == (384, 256) and seed is None
                else "threefry")
    if data == "reference":
        import jax.numpy as jnp
        from .problems import make_gd_problem_reference
        phi, x_star, y = (jnp.asarray(a)
                          for a in make_gd_problem_reference(m, n))
    else:
        kwargs = {} if seed is None else {"seed": seed}
        phi, x_star, y = make_gd_problem(m, n, **kwargs)
    mat_bits = 4 if config == "4x8" else config
    vec_bits = 8 if config == "4x8" else config
    qphi, qphit, qy, krun = _quantize_problem(phi, y, mat_bits, vec_bits, key)
    res = gd(qphi, qphit, qy, iterations, mu, key=krun,
             x_star=QVec32(values=x_star, length=n))
    return res.trace
