"""Round-5: the 16-bit GD root-cause chain (gd16_rootcause_r5.md).

Reproduces, in order: (1) NumPy fp16-GD emulations (f32/f64
accumulation) on the bit-exact instance — both converge like the
reference; (2) the XLA convert-elision probe (f32->f16->f32 inside one
jit returns unrounded values); (3) the fixed production trajectory.
Run on an accelerator (part 1 is host NumPy); from the repository root.
"""
import sys
sys.path.insert(0, ".")
import jax, jax.numpy as jnp, numpy as np
from clover_tpu.utils.compcache import enable as _cc
_cc()
from clover_tpu.models.problems import make_gd_problem_reference
from clover_tpu.models.accuracy import run_gd_accuracy

MS = (1, 10, 50, 100, 250, 500)

# (1) NumPy emulations
phi, xs, y = make_gd_problem_reference()
m, n = phi.shape
mu = np.float32(0.4000000358)
phi16 = phi.astype(np.float16); y16 = y.astype(np.float16)
xsn = np.linalg.norm(xs.astype(np.float64))
for accum in (np.float32, np.float64):
    x = np.zeros(n, np.float16)
    errs = {}
    for it in range(1, 501):
        t1 = (phi16.astype(accum) @ x.astype(accum)).astype(np.float16)
        t2 = (y16.astype(np.float32)
              - t1.astype(np.float32)).astype(np.float16)
        t3 = (phi16.T.astype(accum) @ t2.astype(accum)).astype(np.float16)
        x = (x.astype(np.float32) + mu * t3.astype(np.float32)).astype(
            np.float16)
        if it in MS:
            errs[it] = (np.linalg.norm(x.astype(np.float64)
                                       - xs.astype(np.float64)) / xsn)
    print(f"numpy {accum.__name__}-accum:",
          " ".join(f"{errs[i]:.6f}" for i in MS), flush=True)

# (2) the elision probe
v = np.random.default_rng(0).random(10000).astype(np.float32) * 2 - 1
rt = np.asarray(jax.jit(
    lambda x: x.astype(jnp.float16).astype(jnp.float32))(jnp.asarray(v)))
ref = v.astype(np.float16).astype(np.float32)
print("f32->f16->f32 round trips ELIDED inside one jit:",
      int((rt != ref).sum()), "/", len(v), flush=True)

# (3) the fixed production trajectory (ops/_core.f16_rounded in place)
tr = np.asarray(run_gd_accuracy(16, key=None))
print("production (fixed):", " ".join(f"{tr[i-1]:.6f}" for i in MS))
print("reference          : 0.667691 0.265011 0.044196 0.007770 "
      "0.001479 0.000974")
