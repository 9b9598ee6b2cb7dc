"""Kernel-versus-plain benchmark on one GPU.

Times on the card, at streaming sizes (every matrix is larger than the
H200's 50 MB L2):

* the MVM at n=32768 in the kernel's three modes (4x4, 4x8, 8x8), the
  f32-output mode and the MVM+AXPY form — the production path (the
  Triton kernel on a GPU) against the plain XLA formulation;
* the fp32 matvec baseline (``precision=HIGHEST``) and two bandwidth
  ceilings on the 4-bit matrix's bytes: a row sum and a copy;
* IHT seconds per iteration at 16384x32768, K=8192, 4-bit and 4x8, with
  the production MVM and with the plain one;
* the batched MVM at B=1 and B=8.

Each pair runs plain, production, production, plain.  With ``--trace DIR``
it also records one profiler trace per 4-bit MVM and IHT variant and
prints each one's top device operations.

    python bench.py [--trace chiprun_out/trace]

Prints the card's name and power limit, one line per row, then one JSON
line.  Exits non-zero when JAX finds no GPU.
"""

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import clover_tpu as ct  # noqa: E402
from clover_tpu.harness import profile  # noqa: E402
from clover_tpu.harness.timing import median_time, peaks  # noqa: E402
from clover_tpu.models.problems import make_iht_problem  # noqa: E402
from clover_tpu.models.solvers import _solve  # noqa: E402
from clover_tpu.models.tuned import lookup_family  # noqa: E402
from clover_tpu.ops.gemm import mvm_batched  # noqa: E402
from clover_tpu.utils.compcache import enable as _enable_compcache  # noqa: E402

N = 32768
IHT_M, IHT_N = 16384, 32768
CHAIN = 20          # dependent MVMs per timed call
IHT_ITERS = 20
REPS = 7

ops_mvm = importlib.import_module("clover_tpu.ops.mvm")


@contextlib.contextmanager
def plain_mvm():
    """Route ops.mvm through the plain XLA formulation (measurement only)."""
    orig = ops_mvm._use_kernel
    ops_mvm._use_kernel = lambda *a, **k: False
    _solve.clear_cache()
    try:
        yield
    finally:
        ops_mvm._use_kernel = orig
        _solve.clear_cache()


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def per_call(fn, *args, count=1):
    jax.block_until_ready(fn(*args))
    return median_time(lambda: fn(*args), REPS) / count


def mvm_chain(form):
    """CHAIN dependent requantizing MVMs y <- mvm(A, y) in one call."""
    @jax.jit
    def g(qA, qx, seed):
        def body(i, c):
            x, s = c
            if form == "axpy":
                y = ops_mvm.mvm_axpy(qA, x, x, -0.5, key_mvm=s,
                                     key_axpy=None if s is None else s + 1)
            else:
                y = ct.mvm(qA, x, key=s)
            return y, (None if s is None else s + 40503)
        return jax.lax.fori_loop(0, CHAIN, body, (qx, seed))[0]
    return g


def f32_chain():
    """CHAIN dependent f32-output MVMs, x <- quantize(A @ x) (the vector
    quantize is the same small cost on both paths)."""
    @jax.jit
    def g(qA, qx):
        def body(i, x):
            y = ops_mvm.mvm_f32_fast(qA, x)
            return ct.quantize_vec(ct.QVec32(values=y, length=qA.rows),
                                   x.bits)
        return jax.lax.fori_loop(0, CHAIN, body, qx)
    return g


def ab(label, make, args, count, rows):
    """plain, production, production, plain on the same inputs.  Each
    variant is traced and compiled once; the plain one inside
    :func:`plain_mvm`."""
    fns = {}
    t0 = time.perf_counter()
    with plain_mvm():
        fns["plain"] = make()
        jax.block_until_ready(fns["plain"](*args))
    fns["prod"] = make()
    jax.block_until_ready(fns["prod"](*args))
    ts = {"plain": [], "prod": [], "compile_s": time.perf_counter() - t0}
    for which in ("plain", "prod", "prod", "plain"):
        f = fns[which]
        ts[which].append(median_time(lambda: f(*args), REPS) / count)
    row = {k: float(np.mean(v)) for k, v in ts.items()}
    row["samples"] = ts
    rows[label] = row
    print(f"{label:34s} plain {row['plain'] * 1e6:10.1f} us  "
          f"production {row['prod'] * 1e6:10.1f} us  "
          f"ratio {row['plain'] / row['prod']:.3f}", flush=True)
    return row


def trace_top(logdir, fn, *args, top=8):
    jax.block_until_ready(fn(*args))
    with profile.trace(logdir):
        jax.block_until_ready(fn(*args))
    tops = {}
    for (plane, line), c in profile.device_op_times(logdir).items():
        if not c:
            continue
        tops[f"{plane} | {line}"] = [(k, v / 1e3) for k, v in
                                     c.most_common(top)]
        print(f"  trace {os.path.basename(logdir)} {plane} | {line}:")
        for k, us in tops[f"{plane} | {line}"]:
            print(f"      {us:12.1f} us  {k[:100]}")
    return tops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    _enable_compcache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform}")
    name_power = card()
    pk = peaks(dev)
    print(f"card: {name_power}; jax {jax.__version__}; "
          f"device_kind {dev.device_kind}", flush=True)

    rows = {}
    key = jax.random.PRNGKey(0)
    A = jax.random.uniform(key, (N, N), jnp.float32, -1.0, 1.0)
    x = jax.random.uniform(jax.random.fold_in(key, 1), (N,), jnp.float32,
                           -1.0, 1.0)
    q = {4: ct.quantize(A, 4), 8: ct.quantize(A, 8)}
    qx = {4: ct.quantize(x, 4), 8: ct.quantize(x, 8)}
    seed = jnp.asarray([12345], jnp.int32)

    # bandwidth ceilings on the 4-bit matrix's bytes, same call: a row
    # sum over the codes read as int32 words, and a copy of the words
    codes = q[4].codes
    words = jax.lax.bitcast_convert_type(
        codes.reshape(N, N // 8, 4), jnp.int32)
    t_read = per_call(jax.jit(lambda w: jnp.sum(w, axis=1)), words)
    t_copy = per_call(jax.jit(lambda w: w + 1), words)
    rows["read_ceiling_gbs"] = codes.nbytes / t_read / 1e9
    rows["copy_ceiling_gbs"] = 2 * codes.nbytes / t_copy / 1e9
    print(f"read ceiling {rows['read_ceiling_gbs']:.1f} GB/s, copy ceiling "
          f"{rows['copy_ceiling_gbs']:.1f} GB/s (4-bit codes, "
          f"{codes.nbytes / 1e6:.0f} MB)", flush=True)

    t32 = per_call(jax.jit(lambda a, v: jnp.dot(
        a, v, precision=jax.lax.Precision.HIGHEST)), A, x)
    rows["fp32_matvec_us"] = t32 * 1e6
    print(f"fp32 matvec n={N}: {t32 * 1e6:.1f} us "
          f"({4 * N * N / t32 / 1e9:.1f} GB/s)", flush=True)
    del A

    for (ba, bx) in ((4, 4), (4, 8), (8, 8)):
        nbytes = q[ba].nbytes
        for sr in (False, True):
            r = ab(f"mvm {ba}x{bx} n={N} {'sr' if sr else 'det'}",
                   lambda: mvm_chain("mvm"),
                   (q[ba], qx[bx], seed if sr else None), CHAIN, rows)
            r["prod_gbs"] = nbytes / r["prod"] / 1e9
            r["plain_gbs"] = nbytes / r["plain"] / 1e9
            r["prod_pct_hbm_peak"] = 100 * r["prod_gbs"] * 1e9 / pk.hbm_bytes_per_s
        ab(f"mvm_f32 {ba}x{bx} n={N}", f32_chain, (q[ba], qx[bx]), CHAIN, rows)
        ab(f"mvm_axpy {ba}x{bx} n={N} det", lambda: mvm_chain("axpy"),
           (q[ba], qx[bx], None), CHAIN, rows)

    for b in (1, 8):
        xs = jax.tree.map(lambda *a: jnp.stack(a), *([qx[4]] * b))
        tb = per_call(jax.jit(mvm_batched), q[4], xs)
        rows[f"mvm_batched_4x4_b{b}_us"] = tb * 1e6
        print(f"mvm_batched 4x4 n={N} B={b}: {tb * 1e6:.1f} us", flush=True)

    rows["trace"] = {}
    if args.trace:
        for label, fn, a in (
                ("mvm4", mvm_chain("mvm"), (q[4], qx[4], None)),):
            rows["trace"][label + "_prod"] = trace_top(
                os.path.join(args.trace, label + "_prod"), fn, *a)
            with plain_mvm():
                plain = mvm_chain("mvm")
                jax.block_until_ready(plain(*a))
            rows["trace"][label + "_plain"] = trace_top(
                os.path.join(args.trace, label + "_plain"), plain, *a)
    del q, qx

    for kind, vb in (("iht", 4), ("iht_mixed", 8)):
        fam = lookup_family(kind, IHT_M, IHT_N)
        phi, _, y = make_iht_problem(IHT_M, IHT_N, fam["K"])
        qphi = ct.quantize(phi, 4)
        qphit = ct.transpose(qphi)
        qy = ct.quantize(y / jnp.max(jnp.abs(y)), vb)
        del phi
        x0 = ct.zeros_vector(vb, IHT_N)
        mu = jnp.float32(fam[4][1])
        sargs = (qphi, qphit, qy, x0)

        def solve(iters):
            return jax.jit(lambda a, at, yy, xx: _solve(
                a, at, yy, xx, None, iters, fam["K"], mu, None).x)

        ab(f"{kind} {IHT_M}x{IHT_N} s/iter", lambda: solve(IHT_ITERS),
           sargs, IHT_ITERS, rows)
        if args.trace and kind == "iht":
            rows["trace"]["iht_prod"] = trace_top(
                os.path.join(args.trace, "iht_prod"), solve(2), *sargs)
            with plain_mvm():
                rows["trace"]["iht_plain"] = trace_top(
                    os.path.join(args.trace, "iht_plain"), solve(2),
                    *sargs)
        del qphi, qphit

    print(json.dumps({"card": name_power,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())},
                      "jax": jax.__version__, "rows": rows,
                      "time": time.strftime("%Y-%m-%dT%H:%M:%S")}))


if __name__ == "__main__":
    main()
