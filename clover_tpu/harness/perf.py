"""`-p` performance mode: per-op bandwidth/roofline tables.

Re-creates the reference's benchmark suite (test/performance/00_test.cpp:
119-217 tables; 01_measure.h measurement templates): for each op and size,
median time, effective GB/s, % of HBM roofline, and speedup vs the fp32
baseline — the reference's headline metrics (doc/results/performance.txt).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

import clover_tpu as ct
from .timing import chain_time, gbs, pct_roofline

VEC_SIZES = [1 << 16, 1 << 20, 1 << 22, 1 << 24]
MVM_SIZES = [2048, 4096, 8192, 16384]
IHT_SIZES = [(2048, 4096), (4096, 8192), (8192, 16384)]


def _row(log, name, nbytes, dt, base_dt=None):
    speed = f"{base_dt / dt:6.2f}x" if base_dt else "   ---"
    log(f"{name:28s} {dt * 1e3:9.4f} ms {gbs(nbytes, dt):9.1f} GB/s "
        f"{pct_roofline(nbytes, dt):6.1f}% {speed}")
    return dt


# A loop-carried or invariant buffer that fits in the GPU's 50 MB L2
# stays resident across chain steps and measures L2, not HBM, bandwidth.
# Every baseline therefore streams its operands from a ring of slots
# totalling >= RING_BYTES (four times the L2): the working set cannot
# stay in L2 and no row can exceed the HBM roofline.
RING_BYTES = 200 << 20


def _slots(bytes_each: int, cap: int = 4096) -> int:
    return int(min(cap, max(4, -(-RING_BYTES // max(bytes_each, 1)))))


def bench_quantize(log, sizes=VEC_SIZES):
    log("\n== vector quantize (fp32 -> q) — bytes = fp32 read + codes write")
    rng = np.random.default_rng(0)
    for n in sizes:
        p = _slots(4 * n)
        # ring generated on the device: no host->device transfer
        X = jax.random.uniform(jax.random.PRNGKey(0), (p, n),
                               minval=-1.0, maxval=1.0)
        for bits in (4, 8, 16, 32):
            def make(iters):
                if bits == 32:
                    # fp32 "quantize" is a copy (reference: CloverVector32
                    # quantize, performance.txt fp32 row ~12.6 GB/s):
                    # whole-ring carried copy per iteration
                    @jax.jit
                    def g(X):
                        def body(i, h):
                            return X + h[0, 0] * 1e-30
                        h = jax.lax.fori_loop(
                            0, iters, body, jnp.zeros((p, n), jnp.float32))
                        return h[0, 0]
                    return lambda: float(g(X))
                if bits == 16:
                    # pure convert: whole-ring batched convert per
                    # iteration (forced HBM streaming),
                    # carried so nothing is elided; time reported /p
                    @jax.jit
                    def g(X):
                        def body(i, h):
                            return (X + h[0, 0].astype(jnp.float32)
                                    * 1e-30).astype(jnp.float16)
                        h = jax.lax.fori_loop(
                            0, iters, body, jnp.zeros((p, n), jnp.float16))
                        return h[0, 0].astype(jnp.float32)
                    return lambda: float(g(X))

                # one vector, re-quantized with a fresh seed per step (the
                # seed keeps iterations distinct; at small n this row
                # measures the L2-resident regime)
                x0 = X[0]

                @jax.jit
                def g(x, seed0):
                    def body(i, s):
                        q = ct.quantize(x, bits, key=seed0 + i)
                        return s + jnp.sum(q.scales) * 1e-30
                    return jax.lax.fori_loop(0, iters, body, jnp.float32(0))
                return lambda: float(g(x0, jnp.asarray([7], jnp.int32)))
            dt = chain_time(make)
            if bits in (16, 32):
                dt /= p          # whole-ring batched convert/copy
            q = ct.quantize(X[0], bits)
            nbytes = 4 * n + q.nbytes
            _row(log, f"quantize {bits:2d}-bit n={n}", nbytes, dt)


def bench_mvm(log, sizes=MVM_SIZES):
    log("\n== fused MVM (quantized in, requantized out) — bytes = matrix")
    rng = np.random.default_rng(0)
    for n in sizes:
        A = rng.random((n, n), dtype=np.float32) * 2 - 1
        x = rng.random(n, dtype=np.float32) * 2 - 1
        Aj, xj = jnp.asarray(A), jnp.asarray(x)

        def make32(iters):
            @jax.jit
            def g(A, x):
                def body(i, v):
                    y = jnp.dot(A, v, precision=jax.lax.Precision.HIGHEST)
                    return y / (jnp.max(jnp.abs(y)) + 1e-30)
                return jnp.sum(jax.lax.fori_loop(0, iters, body, x))
            return lambda: float(g(Aj, xj))
        t32 = chain_time(make32)
        _row(log, f"mvm 32-bit n={n}", 4 * n * n, t32)

        for (ba, bx) in ((4, 4), (4, 8), (8, 8), (16, 16)):
            qA = ct.quantize(Aj, ba)
            qx = ct.quantize(xj, bx)

            def make(iters):
                @jax.jit
                def g(qA, qx):
                    def body(i, v):
                        return ct.mvm(qA, v)
                    out = jax.lax.fori_loop(0, iters, body, qx)
                    return jnp.sum(
                        out.scales if bx != 16 else
                        out.values.astype(jnp.float32) * 1e-30)
                return lambda: float(g(qA, qx))

            dt = chain_time(make)
            _row(log, f"mvm {ba:2d}x{bx:2d}-bit n={n}", qA.nbytes, dt, t32)


def bench_restore(log, sizes=VEC_SIZES):
    """q -> fp32 restore (reference benches restore at every precision,
    doc/results/performance.txt:118-160).  The f32 result is written
    into an HBM ring so the output traffic is real; the carried
    single-element code perturbation keeps iterations distinct."""
    log("\n== restore (q -> fp32) — bytes = codes read + fp32 write")
    for n in sizes:
        for bits in (4, 8, 16):
            # one LONG container (a ring's worth of f32 output per
            # restore) so the write stream is real HBM; time reported /p
            p = _slots(4 * n)
            big = jax.random.uniform(jax.random.PRNGKey(4), (p * n,),
                                     minval=-1.0, maxval=1.0)
            q = ct.quantize(big, bits)

            # a one-element consume would let XLA skip materializing
            # the write, so the result stays the carry
            def make(iters):
                @jax.jit
                def g(arr):
                    def body(i, carry):
                        arr, vb = carry
                        if bits == 16:
                            q2 = type(q)(values=arr, length=q.length)
                            one = jnp.float16(1)
                        else:
                            q2 = type(q)(codes=arr, scales=q.scales,
                                         length=q.length)
                            one = jnp.int8(1)
                        v = ct.restore(q2).values
                        arr = arr.at[0].add(
                            one + (vb[0] * 1e-30).astype(arr.dtype))
                        return (arr, v)
                    _, vb = jax.lax.fori_loop(
                        0, iters, body,
                        (arr, jnp.zeros((p * n,), jnp.float32)))
                    return vb[0]
                return lambda: float(g(
                    q.values if bits == 16 else q.codes))
            dt = chain_time(make) / p
            _row(log, f"restore {bits:2d}-bit n={n}",
                 q.nbytes // p + 4 * n, dt)


def bench_axpy(log, sizes=VEC_SIZES):
    log("\n== scaleAndAdd (dequant-FMA-requant) — bytes = 2 reads + 1 write")
    rng = np.random.default_rng(0)
    for n in sizes:
        x = jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1)
        y = jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1)
        p = _slots(4 * n)
        Y = jax.random.uniform(jax.random.PRNGKey(1), (p, n),
                               minval=-1.0, maxval=1.0)   # device-side

        def make32(iters):
            # whole-ring batched AXPY: V <- Y - 0.5 V over the ring per
            # iteration (guaranteed HBM streaming; a per-slot
            # dynamic_update protocol hides copies), reported as time/p
            # per n-sized op
            @jax.jit
            def g(Y):
                def body(i, V):
                    return Y + jnp.float32(-0.5) * V
                V = jax.lax.fori_loop(0, iters, body,
                                      Y * jnp.float32(0.5))
                return V[0, 0]
            return lambda: float(g(Y))
        t32 = chain_time(make32) / p
        _row(log, f"scaleAndAdd 32-bit n={n}", 12 * n, t32)

        for bits in (4, 8):
            qx, qy = ct.quantize(x, bits), ct.quantize(y, bits)

            # carried-output dataflow (a scales-only perturbation would
            # let XLA elide the requant work)
            def make(iters):
                @jax.jit
                def g(u, v):
                    def body(i, u):
                        return ct.scale_and_add(u, v, -0.5)
                    out = jax.lax.fori_loop(0, iters, body, u)
                    return jnp.sum(out.scales)
                return lambda: float(g(qx, qy))
            dt = chain_time(make)
            _row(log, f"scaleAndAdd {bits:2d}-bit n={n}", 3 * qx.nbytes,
                 dt, t32)

        # fp16 scaleAndAdd (reference: 00_test.cpp:372-392).  A single
        # n-length fp16 pair can stay L2-resident across loop steps, so
        # use the whole-ring protocol like the fp32 baseline; iterated u -= 0.5 v drifts
        # |u| to ~0.5*iters — well inside fp16 range at these chain
        # lengths.  Per-op time and bytes are the ring's / p16.
        p16 = _slots(2 * n)
        q16x = ct.quantize(jax.random.uniform(
            jax.random.PRNGKey(9), (p16 * n,), minval=-1.0, maxval=1.0), 16)
        q16y = ct.quantize(jax.random.uniform(
            jax.random.PRNGKey(10), (p16 * n,), minval=-1.0, maxval=1.0), 16)

        def make16(iters):
            @jax.jit
            def g(u, v):
                def body(i, u):
                    return ct.scale_and_add(u, v, -0.5)
                out = jax.lax.fori_loop(0, iters, body, u)
                return jnp.sum(out.values[:8].astype(jnp.float32))
            return lambda: float(g(q16x, q16y))
        dt = chain_time(make16) / p16
        _row(log, f"scaleAndAdd 16-bit n={n}", 3 * q16x.nbytes // p16,
             dt, t32)


def bench_small_warm(log, sizes=(1 << 16, 1 << 17, 1 << 18)):
    """Latency-regime dot/AXPY rows under SYMMETRIC warm dependent-chain
    protocols.

    The streaming rows above amortize the fp32 baselines over a ring
    while the quantized single-op chains pay launch + reduce latency per
    call — an apples-to-oranges ratio at small n.  These rows time BOTH
    sides as dependent per-call chains on warm (cache-resident) operands
    — the reference's own small-N semantics (15 warm repetitions,
    01_measure.h).  Note the reference's committed table has its own
    4-bit AXPY at 0.28-0.80x fp32 for ALL N <= 1M (performance.txt:
    246-257, in-cache, requant-compute-bound)."""
    log("\n== latency regime: warm symmetric single-op chains")
    key = jax.random.PRNGKey(0)
    for n in sizes:
        u = jax.random.uniform(key, (n,), jnp.float32, -1.0, 1.0)
        v = jax.random.uniform(jax.random.fold_in(key, 1), (n,),
                               jnp.float32, -1.0, 1.0)

        def mkdf(iters):
            @jax.jit
            def g(u, v):
                def bd(i, s):
                    return s + jnp.dot(
                        u, v + s * 1e-30,
                        preferred_element_type=jnp.float32) * 1e-30
                return jax.lax.fori_loop(0, iters, bd, jnp.float32(0))
            return lambda: float(g(u, v))
        tdf = chain_time(mkdf)
        _row(log, f"warm dot 32-bit n={n}", 8 * n, tdf)

        def mkaf(iters):
            @jax.jit
            def g(u, v):
                def bd(i, y):
                    return u + (-0.5) * y
                return jnp.sum(jax.lax.fori_loop(0, iters, bd, v))
            return lambda: float(g(u, v))
        taf = chain_time(mkaf)
        _row(log, f"warm axpy 32-bit n={n}", 12 * n, taf)

        for bits in (4, 8):
            qu, qv = ct.quantize(u, bits), ct.quantize(v, bits)

            def mkdq(iters, qu=qu, qv=qv):
                @jax.jit
                def g(qu, qv):
                    def bd(i, s):
                        qv2 = type(qv)(codes=qv.codes,
                                       scales=qv.scales + s * 1e-37,
                                       length=qv.length)
                        return s + ct.dot(qu, qv2)
                    return jax.lax.fori_loop(0, iters, bd,
                                             jnp.float32(0))
                return lambda: float(g(qu, qv))
            _row(log, f"warm dot {bits:2d}-bit n={n}", 2 * qu.nbytes,
                 chain_time(mkdq), tdf)

            def mkaq(iters, qu=qu, qv=qv):
                @jax.jit
                def g(qu, qv):
                    def bd(i, y):
                        return ct.scale_and_add(qu, y, -0.5)
                    y = jax.lax.fori_loop(0, iters, bd, qv)
                    return (jnp.sum(y.scales)
                            + jnp.sum(y.codes.astype(jnp.float32))
                            * 1e-30)
                return lambda: float(g(qu, qv))
            _row(log, f"warm axpy {bits:2d}-bit n={n}", 3 * qu.nbytes,
                 chain_time(mkaq), taf)


def bench_dot(log, sizes=VEC_SIZES):
    log("\n== dot — bytes = 2 vector reads")
    rng = np.random.default_rng(0)
    for n in sizes:
        u = jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1)
        v = jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1)

        # Dependency protocol: feed each dot's result back into ONE element
        # of the carried operand with an in-place .at[] update (XLA keeps
        # the loop carry buffer in place).  A whole-array perturbation
        # (`v + s*eps` / `where(..., codes, codes^1)`) adds a full
        # read+write of the operand per iteration and overstated dot time
        # by ~1.5x; a scales-only perturbation lets XLA hoist the integer
        # dot out of the loop entirely.
        p = _slots(8 * n)
        U = jax.random.uniform(jax.random.PRNGKey(2), (p * n,),
                               minval=-1.0, maxval=1.0)  # device-side
        V = jax.random.uniform(jax.random.PRNGKey(5), (p * n,),
                               minval=-1.0, maxval=1.0)

        def make32(iters):
            # whole-ring batched dot (the ring streamed per iteration);
            # per-op time = dt / p
            @jax.jit
            def g(U, V):
                def body(i, carry):
                    U, s = carry         # carried: the .at update is
                    U = U.at[0].add(s * 1e-30)   # in-place (donated)
                    return (U, jnp.dot(U, V,
                            preferred_element_type=jnp.float32))
                _, s = jax.lax.fori_loop(0, iters, body,
                                         (U, jnp.float32(0)))
                return s
            return lambda: float(g(U, V))
        t32 = chain_time(make32) / p
        _row(log, f"dot 32-bit n={n}", 8 * n, t32)

        for bits in (4, 8):
            qu, qv = ct.quantize(u, bits), ct.quantize(v, bits)

            def make(iters):
                # scales-only perturbation would let XLA hoist the
                # integer dot out of the loop; keep the carried codes form
                @jax.jit
                def g(qu, qv):
                    def body(i, carry):
                        codes, s = carry
                        qu2 = type(qu)(codes=codes, scales=qu.scales,
                                       length=qu.length)
                        d = ct.dot(qu2, qv)
                        delta = jax.lax.convert_element_type(d * 1e-37,
                                                             jnp.int8)
                        return (codes.at[0].add(delta), s + d)
                    _, s = jax.lax.fori_loop(0, iters, body,
                                             (qu.codes, jnp.float32(0)))
                    return s
                return lambda: float(g(qu, qv))
            dt = chain_time(make)
            _row(log, f"dot {bits:2d}-bit n={n}", 2 * qu.nbytes, dt, t32)

        # 16-bit dot (reference: 00_test.cpp:296-316 benches all four
        # precisions; fp16 here is the XLA convert path).  A single
        # n-length fp16 pair can stay L2-resident across loop steps, so
        # this uses the same whole-ring pair as the fp32 baseline;
        # per-op time and bytes are the ring's / p16.
        p16 = _slots(4 * n)
        q16u = ct.quantize(jax.random.uniform(
            jax.random.PRNGKey(7), (p16 * n,), minval=-1.0, maxval=1.0), 16)
        q16v = ct.quantize(jax.random.uniform(
            jax.random.PRNGKey(8), (p16 * n,), minval=-1.0, maxval=1.0), 16)

        def make16(iters):
            @jax.jit
            def g(vals, qv):
                def body(i, carry):
                    vals, s = carry
                    vals = vals.at[0].add((s * 1e-30).astype(jnp.float16)
                                          + jnp.float16(1e-6))
                    qu2 = type(q16u)(values=vals, length=q16u.length)
                    return (vals, s + ct.dot(qu2, qv))
                _, s = jax.lax.fori_loop(0, iters, body,
                                         (vals, jnp.float32(0)))
                return s
            return lambda: float(g(q16u.values, q16v))
        dt = chain_time(make16) / p16
        _row(log, f"dot 16-bit n={n}", 2 * q16u.nbytes // p16, dt, t32)


def bench_threshold(log, sizes=VEC_SIZES[:2], k: int = 64):
    log(f"\n== threshold (top-K, K={k}) — bytes = 1 read + 1 write")
    rng = np.random.default_rng(0)
    for n in sizes:
        x = jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1)
        for bits in (4, 8, 16, 32):
            q = ct.quantize(x, bits)

            def make(iters):
                @jax.jit
                def g(q):
                    def body(i, carry):
                        q2, s = carry
                        if bits in (4, 8):
                            q2 = type(q)(codes=q.codes,
                                         scales=q.scales + s * 1e-30,
                                         length=q.length)
                        elif bits == 16:
                            # fp16: the 1e-30 rounds away but the carried
                            # add still forces the chain dependency (cast
                            # keeps the carry dtype stable)
                            q2 = type(q)(values=q.values
                                         + (s * 1e-30).astype(jnp.float16),
                                         length=q.length)
                        else:
                            q2 = type(q)(values=q.values + s * 1e-30,
                                         length=q.length)
                        out = ct.threshold(q2, k)
                        if bits in (4, 8):
                            tot = jnp.sum(out.codes.astype(jnp.int32)
                                          ).astype(jnp.float32)
                        else:
                            tot = jnp.sum(out.values.astype(jnp.float32))
                        return (q2, s + tot * 1e-30)
                    _, s = jax.lax.fori_loop(0, iters, body,
                                             (q, jnp.float32(0)))
                    return s
                return lambda: float(g(q))
            dt = chain_time(make)
            _row(log, f"threshold {bits:2d}-bit n={n}", 2 * q.nbytes, dt)


def bench_get(log, n=1 << 20, r=4096):
    """Element access (reference: test/performance/00_test.cpp:272-288
    benches per-element vector get at every precision).  Here: one
    jitted gather of r random indices, dequantized (ops.access.
    vec_gather); reported per element."""
    from ..ops.access import vec_gather
    log(f"\n== element get (gather of {r} random indices, n={n}) — ns/elem")
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1)
    idx0 = jnp.asarray(rng.integers(0, n, r), jnp.int32)
    for bits in (4, 8, 16, 32):
        q = ct.quantize(x, bits)

        def make(iters):
            @jax.jit
            def g(q, idx):
                def body(i, carry):
                    idx, s = carry
                    v = vec_gather(q, idx)
                    idx = jnp.bitwise_and(
                        idx + 1 + (s * 1e-30).astype(jnp.int32), n - 1)
                    return (idx, s + v[0])
                _, s = jax.lax.fori_loop(0, iters, body,
                                         (idx, jnp.float32(0)))
                return s
            return lambda: float(g(q, idx0))
        dt = chain_time(make)
        log(f"get {bits:2d}-bit                     {dt * 1e3:9.4f} ms "
            f"{dt / r * 1e9:9.2f} ns/elem")


def bench_mvm_batched(log, sizes=MVM_SIZES[-2:], batches=(1, 4, 16)):
    """Serving throughput: B requests in one batched MVM
    (ops.gemm.mvm_batched).  The reference has no batched MVM — this is
    the extension the continuous-batching server uses."""
    log("\n== batched MVM (one program per batch) — mvm/s")
    rng = np.random.default_rng(0)
    from ..ops.gemm import mvm_batched
    for n in sizes:
        A = jnp.asarray(rng.random((n, n), dtype=np.float32) * 2 - 1)
        x = jnp.asarray(rng.random(n, dtype=np.float32) * 2 - 1)
        for (ba, bx) in ((4, 4), (8, 8)):
            qA = ct.quantize(A, ba)
            qx = ct.quantize(x, bx)
            base = None
            for b in batches:
                xs = jax.tree.map(lambda *a: jnp.stack(a), *([qx] * b))

                def make(iters):
                    @jax.jit
                    def g(qA, xs):
                        def body(i, s):
                            xs2 = type(xs)(codes=xs.codes,
                                           scales=xs.scales + s * 1e-30,
                                           length=xs.length)
                            ys = mvm_batched(qA, xs2)
                            return jnp.sum(ys.scales) * 1e-30
                        return jax.lax.fori_loop(0, iters, body,
                                                 jnp.float32(0))
                    return lambda: float(g(qA, xs))
                dt = chain_time(make)
                base = base or dt
                log(f"mvm_batched {ba}x{bx} n={n} B={b:<3d}"
                    f"   {dt * 1e3:10.4f} ms/batch {b / dt:10.0f} mvm/s"
                    f"  {b * base / dt:5.1f}x vs B=1")


def bench_transpose(log, sizes=MVM_SIZES):
    """Matrix transpose sweep (reference: performance.txt:508-560 — the
    4-bit nibble-shuffle transpose runs ~1x fp32 there; here both are
    XLA relayouts and the quantized one moves 8x fewer bytes)."""
    log("\n== transpose — bytes = 1 matrix read + 1 write")
    rng = np.random.default_rng(0)
    for n in sizes:
        A = jnp.asarray(rng.random((n, n), dtype=np.float32) * 2 - 1)

        # fp paths (pure XLA relayouts) transpose slots of a ring so
        # small matrices cannot stay in L2; quantized paths chain the
        # carry itself (q_{k+1} = T(q_k)).
        def ring_make(dtype, nbytes_slot):
            if nbytes_slot >= RING_BYTES // 2:
                # a single matrix already dwarfs the L2: plain carry chain
                A0 = A.astype(dtype)

                def make(iters):
                    @jax.jit
                    def g(a):
                        def body(i, a):
                            return jnp.transpose(a)
                        return jax.lax.fori_loop(0, iters, body, a)[0, 0]
                    return lambda: float(g(A0))
                return make, 1
            p = _slots(nbytes_slot, cap=64)
            B0 = jax.random.uniform(jax.random.PRNGKey(3), (p, n, n),
                                    minval=-1.0, maxval=1.0).astype(dtype)

            def make(iters):
                # whole-ring batched transpose per iteration (forced
                # HBM streaming); per-op time = dt / p
                @jax.jit
                def g(B):
                    def body(i, B):
                        return jnp.transpose(B, (0, 2, 1))
                    return jax.lax.fori_loop(0, iters, body, B)[0, 0, 0]
                return lambda: float(g(B0))
            return make, p

        mk32, p32 = ring_make(jnp.float32, 8 * n * n)
        t32 = chain_time(mk32) / p32
        _row(log, f"transpose 32-bit n={n}", 8 * n * n, t32)

        for bits in (4, 8, 16):
            qA = ct.quantize(A, bits)
            if bits == 16:
                mk16, p16 = ring_make(jnp.float16, 4 * n * n)
                dt = chain_time(mk16) / p16
                _row(log, f"transpose {bits:2d}-bit n={n}", 2 * qA.nbytes,
                     dt, t32)
                continue

            # carry a TUPLE of pq independent containers per iteration
            # so the working set exceeds the L2; per-op time = dt / pq
            pq = int(min(64, max(1, (RING_BYTES // 2) // (2 * qA.nbytes))))
            qAs = tuple(
                type(qA)(codes=jnp.roll(qA.codes, j, axis=0),
                         scales=qA.scales, rows=qA.rows, cols=qA.cols)
                for j in range(pq))

            def make(iters):
                @jax.jit
                def g(qs):
                    def body(i, qs):
                        return tuple(ct.transpose(q) for q in qs)
                    out = jax.lax.fori_loop(0, iters, body, qs)
                    # consume EVERY tuple element or XLA dead-code-
                    # eliminates all but the first chain
                    return sum(jnp.sum(o.codes[0, :1].astype(jnp.float32))
                               for o in out)
                return lambda: float(g(qAs))
            dt = chain_time(make) / pq
            _row(log, f"transpose {bits:2d}-bit n={n}", 2 * qA.nbytes, dt,
                 t32)


IHT_CONFIGS = (("4x8", 4, 8), ("4", 4, 4), ("8", 8, 8),
               ("16", 16, 16), ("32", 32, 32))


def bench_iht(log, sizes=IHT_SIZES, configs=IHT_CONFIGS):
    """All five reference precision configs (4x8 mixed, pure 4/8/16/32 —
    doc/results/performance.txt:561-590)."""
    log("\n== IHT end-to-end (iters/s; bytes = 2 matrix streams / iter)")
    from ..models.solvers import _solve
    from ..formats import zeros_vector
    rng = np.random.default_rng(0)
    for (m, n) in sizes:
        Phi = rng.random((m, n), dtype=np.float32) * 2 - 1
        yv = Phi @ rng.random(n, dtype=np.float32)
        for (name, mat_bits, vec_bits) in configs:
            qphi = ct.quantize(jnp.asarray(Phi), mat_bits)
            qphit = ct.transpose(qphi)
            qy = ct.quantize(jnp.asarray(yv / np.abs(yv).max()), vec_bits)
            bits = vec_bits

            def make(iters):
                def run():
                    x0 = zeros_vector(bits, n)
                    res = _solve(qphi, qphit, qy, x0, None, iters, n // 4,
                                 jnp.float32(1e-4), jax.random.PRNGKey(0))
                    arr = res.x.scales if bits in (4, 8) else res.x.values
                    return float(jnp.sum(arr[:1]))
                return run
            dt = chain_time(make)
            _row(log, f"IHT {name:>4s}-bit {m}x{n}", 2 * qphi.nbytes, dt)
            log(f"{'':28s} -> {1 / dt:10.0f} iters/s")


def bench_iht_batched(log, sizes=IHT_SIZES[:2], b: int = 8):
    """Per-problem throughput of the batched solver (models/batch.py):
    B problems share one matrix stream per MVM leg.  The single solver
    is deliberately RE-measured here (not reused from bench_iht) so the
    printed ratio pairs both sides in the same run."""
    log(f"\n== batched IHT (B={b} problems, one matrix stream) — "
        "iters/s per problem")
    from ..models.solvers import _solve
    from ..models.batch import _solve_b
    from ..formats import zeros_vector
    rng = np.random.default_rng(0)
    for (m, n) in sizes:
        Phi = rng.random((m, n), dtype=np.float32) * 2 - 1
        qphi = ct.quantize(jnp.asarray(Phi), 4)
        qphit = ct.transpose(qphi)
        yv = Phi @ rng.random(n, dtype=np.float32)
        qy = ct.quantize(jnp.asarray(yv / np.abs(yv).max()), 4)
        k = n // 4

        def make1(iters):
            def run():
                x0 = zeros_vector(4, n)
                res = _solve(qphi, qphit, qy, x0, None, iters, k,
                             jnp.float32(1e-4), jax.random.PRNGKey(0))
                return float(jnp.sum(res.x.scales[:1]))
            return run
        t1 = chain_time(make1)

        ys = jax.tree.map(lambda *a: jnp.stack(a), *([qy] * b))

        from ..models.batch import _initial_xs

        def makeb(iters):
            def run():
                x0 = _initial_xs(qphi, ys)
                res = _solve_b(qphi, qphit, ys, x0, None, iters, k,
                               jnp.float32(1e-4), jax.random.PRNGKey(0))
                return float(jnp.sum(res.xs.scales[:1, :1]))
            return run
        tb = chain_time(makeb)
        log(f"IHT_batched 4-bit {m}x{n} B={b}:"
            f" {tb / b * 1e6:7.1f} us/prob/iter"
            f" ({b / tb:8.0f} solves*iters/s,"
            f" {t1 / (tb / b):4.2f}x vs single @ {t1 * 1e6:.1f} us)")


def bench_sharded(log, sizes=(8192,), iht_size=(4096, 8192)):
    """`-p --sharded`: drive the shard_map path (parallel/ops.mvm_psum,
    parallel/solvers.iht) over whatever mesh exists — on the single real
    chip a 1x1 mesh (parity + overhead vs the direct kernel), on the CPU
    sim the plumbing — reporting per-shard effective bandwidth.  This is
    the same code path ``dryrun_multichip`` compiles (BASELINE.json:
    "measured at 1 chip, 1 host, and N>=2 hosts")."""
    from jax.sharding import PartitionSpec as P
    from ..parallel import make_mesh, shard_matrix, shard_vector
    from ..parallel.mesh import COL, ROW
    from ..parallel.ops import mvm_psum, mvm_psum_overlapped
    from ..parallel.solvers import (
        _local_mat, _local_vec, _shard_map, iht as iht_sharded)
    from ..formats import zeros_vector
    from ..models.solvers import _solve

    mesh = make_mesh()
    R, C = mesh.shape[ROW], mesh.shape[COL]
    n_dev = R * C
    log(f"\n== sharded path: mesh {R}x{C} ({n_dev} device(s)) — "
        "mvm_psum / iht_sharded via shard_map")
    rng = np.random.default_rng(0)

    for n in sizes:
        A = rng.random((n, n), dtype=np.float32) * 2 - 1
        x = rng.random(n, dtype=np.float32) * 2 - 1
        qA = ct.quantize(jnp.asarray(A), 4)
        qx = ct.quantize(jnp.asarray(x), 4)

        # direct (unsharded) fused MVM reference in the same session
        def make_direct(iters):
            @jax.jit
            def g(qA, qx):
                def body(i, s):
                    q2 = type(qx)(codes=qx.codes, scales=qx.scales + s * 1e-30,
                                  length=qx.length)
                    y = ct.mvm(qA, q2)
                    return s + jnp.sum(y.scales) * 1e-30
                return jax.lax.fori_loop(0, iters, body, jnp.float32(0))
            return lambda: float(g(qA, qx))
        t_direct = chain_time(make_direct)
        _row(log, f"mvm 4x4 direct n={n}", qA.nbytes, t_direct)

        qAs = shard_matrix(qA, mesh)
        qxs = shard_vector(qx, mesh, COL)
        for label, mv in (("psum", mvm_psum),
                          ("psum-ovl4", lambda *a, **k: mvm_psum_overlapped(
                              *a, chunks=4, **k))):
            def make(iters):
                def local(ac, asc, xc, xsc):
                    A_l = _local_mat(qA, R, C, (ac, asc))
                    def body(i, s):
                        x_l = _local_vec(qx, C, (xc, xsc + s * 1e-30))
                        y = mv(A_l, x_l, COL, None, 4, ROW)
                        return s + jnp.sum(y.scales) * 1e-30
                    return jax.lax.fori_loop(0, iters, body, jnp.float32(0))
                fn = jax.jit(_shard_map(
                    local, mesh,
                    (P(ROW, COL), P(ROW, COL), P(COL), P(COL)), P()))
                return lambda: float(fn(qAs.codes, qAs.scales,
                                        qxs.codes, qxs.scales))
            dt = chain_time(make)
            _row(log, f"mvm_{label} 4x4 n={n} {R}x{C}", qA.nbytes, dt,
                 t_direct)
            log(f"{'':28s} -> per-shard "
                f"{gbs(qA.nbytes // n_dev, dt):9.1f} GB/s, "
                f"overhead vs direct {dt / t_direct:5.2f}x")

    (m, n) = iht_size
    Phi = rng.random((m, n), dtype=np.float32) * 2 - 1
    yv = Phi @ rng.random(n, dtype=np.float32)
    qphi = ct.quantize(jnp.asarray(Phi), 4)
    qphit = ct.transpose(qphi)
    qy = ct.quantize(jnp.asarray(yv / np.abs(yv).max()), 4)

    def make_single(iters):
        def run():
            x0 = zeros_vector(4, n)
            res = _solve(qphi, qphit, qy, x0, None, iters, n // 4,
                         jnp.float32(1e-4), None)
            return float(jnp.sum(res.x.scales[:1]))
        return run
    t1 = chain_time(make_single)
    _row(log, f"IHT 4-bit single {m}x{n}", 2 * qphi.nbytes, t1)

    s_phi = shard_matrix(qphi, mesh)
    s_phit = shard_matrix(qphit, mesh, transposed=True)
    s_y = shard_vector(qy, mesh, ROW)

    def make_shard(iters):
        def run():
            res = iht_sharded(s_phi, s_phit, s_y, iters, n // 4, 1e-4, mesh)
            return float(jnp.sum(res.x.scales[:1]))
        return run
    ts = chain_time(make_shard)
    _row(log, f"IHT 4-bit sharded {m}x{n} {R}x{C}", 2 * qphi.nbytes, ts)
    log(f"{'':28s} -> per-shard {gbs(2 * qphi.nbytes // n_dev, ts):9.1f}"
        f" GB/s, overhead vs single {ts / t1:5.2f}x")


def run_perf(log=print, quick: bool = False, sharded: bool = False):
    vec = VEC_SIZES[:2] if quick else VEC_SIZES
    mvm = MVM_SIZES[:2] if quick else MVM_SIZES
    iht = IHT_SIZES[:1] if quick else IHT_SIZES
    log(f"\n{'op':28s} {'time':>12} {'bandwidth':>14} {'%roof':>6} {'vs f32':>7}")
    if sharded:
        bench_sharded(log, sizes=(mvm[-1],) if quick else (4096, 8192),
                      iht_size=iht[0])
        return
    bench_quantize(log, vec)
    bench_restore(log, vec)
    bench_dot(log, vec if quick else vec + [1 << 25])
    bench_axpy(log, vec)
    bench_small_warm(log)
    bench_threshold(log, vec[:2])
    bench_get(log)
    bench_mvm(log, mvm)
    bench_mvm_batched(log, mvm[:1] if quick else MVM_SIZES[-2:])
    bench_transpose(log, mvm)
    bench_iht(log, iht)
    bench_iht_batched(log, iht[:1] if quick else IHT_SIZES[:2])
