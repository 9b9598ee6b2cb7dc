"""Bring-up check on GPUs: the main path end to end, at real sizes.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --cards 4   # four GPUs: the sharded path only

One process drives the card(s); each phase prints its wall time on its own
line, and any failed check raises, so the script exits non-zero.  The last
line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

One card:
 1. device check (no CPU fallback), card name and power limit;
 2. harness.validate.run_validation() — every op at every precision
    against golden.py, plus the compiled kernel against the plain path;
 3. MVM at n=32768 (4x4, 4x8, 8x8; deterministic and SR; f32 output;
    MVM+AXPY): the production ct.mvm against the plain XLA formulation
    over all rows, and a 1024-row slice at full width against golden.py;
 4. IHT at 16384x32768 (4-bit and 4x8) reaches the tuned quality target
    within the tuned iterations + 1 (harness.search.SearchProblem);
 5. GD 4-bit at 49152x32768, the same way;
 6. batched IHT, B=8 at 8192x16384, 20 iterations, against each
    problem's single solve;
 7. MVMServer on a resident 4-bit n=32768 matrix: a client thread sends
    64 vectors; each answer is within 1 LSB of ct.mvm.

Four cards: parallel.solvers.iht (4-bit and 4x8) on a 2x2 and a 4x1 mesh
at 32768x65536, K=16384, against the single-card solve; the exact-integer
mvm_psum cross-check and a sharded MVMServer round trip at that size.

Tolerances: requantized codes may differ by one LSB and scales by 1e-6
relative — the kernel, the plain path and golden.py differ only in the f32
order of the scale combine.  golden's quantization multiplier divides
through XLA on the default backend (golden._xla_div), so it follows the
card's divide, as the production path does.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

N_MVM = 32768
GOLDEN_ROWS = 1024
IHT_SIZE = (16384, 32768)
GD_SIZE = (49152, 32768)
BATCH_SIZE, BATCH, BATCH_ITERS = (8192, 16384), 8, 20
SERVE_VECTORS = 64
SHARDED_SIZE = (32768, 65536)
SEED = 0


def phase(name):
    """Decorator: run, print the phase's wall time; failures propagate."""
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out
        return run
    return wrap


def codes(q, rows=None):
    """Unpacked codes of a container (its first ``rows`` rows only: the
    slice is taken on the device)."""
    from clover_tpu.formats import unpack_nibbles
    c = q.codes if rows is None else q.codes[:rows]
    return np.asarray(unpack_nibbles(c) if q.bits == 4 else c, np.int32)


def code_diff(got_codes, got_scales, want_codes, want_scales):
    """(max code difference, max relative scale difference)."""
    d = np.abs(np.asarray(got_codes, np.int32)
               - np.asarray(want_codes, np.int32)).max(initial=0)
    gs, ws = np.asarray(got_scales), np.asarray(want_scales)
    return int(d), float(np.max(np.abs(gs - ws) / np.abs(ws)))


def check_codes(name, *diff_args):
    d, rel = code_diff(*diff_args)
    print(f"  {name}: max code diff {d}, max scale rel diff {rel:.2e}",
          flush=True)
    assert d <= 1 and rel <= 1e-6, name


def check_requests(name, got, want):
    """Every served result within one LSB of its direct ct.mvm."""
    diffs = [code_diff(codes(g), g.scales, codes(w), w.scales)
             for g, w in zip(got, want)]
    d, rel = max(d for d, _ in diffs), max(r for _, r in diffs)
    print(f"  {len(diffs)} {name}: max code diff {d}, max scale rel diff "
          f"{rel:.2e}", flush=True)
    assert len(diffs) == len(want) and d <= 1 and rel <= 1e-6, name


def check_q(name, got, want):
    check_codes(name, codes(got), got.scales, codes(want), want.scales)


def check_f32(name, got, want, tol=2e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"  {name}: max abs diff / max |y| = {rel:.2e}", flush=True)
    assert rel <= tol, name


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


@phase("1 device")
def device_check(cards: int):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found {devs[0].platform}, not a GPU")
    if len(devs) < cards:
        sys.exit(f"chip_smoke: need {cards} GPUs, JAX found {len(devs)}")
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}; devices {[d.device_kind for d in devs]}; "
          f"compile cache {jax.config.jax_compilation_cache_dir}",
          flush=True)


@phase("2 validation")
def validation():
    from clover_tpu.harness.validate import run_validation
    lines = []
    ok = run_validation(log=lines.append)
    print("  " + lines[-1].strip(), flush=True)
    for line in lines:
        if "Failed" in line:
            print("  " + line, flush=True)
    assert ok, "validation failed"


def golden_rows(qA, qx, rows):
    """golden's f32 MVM of the first ``rows`` rows two ways: its
    block-ordered f32 sum (the reference's scalar kernel) and its
    f64-accumulated form (golden.mvm_mixed on restored values)."""
    from clover_tpu import golden
    a, sa = codes(qA, rows), np.asarray(qA.scales[:rows // 64])
    xc, sx = codes(qx), np.asarray(qx.scales)
    seq = golden.mvm_f32_exact(a, sa, xc, sx, qA.bits, qx.bits)
    f64 = golden.mvm_mixed(a, sa, qA.bits, golden.restore_vec(xc, sx, qx.bits))
    return seq, f64


@phase("3 mvm n=32768")
def mvm_phase():
    import importlib
    import clover_tpu as ct
    from clover_tpu import golden
    from clover_tpu.ops import _core
    ops_mvm = importlib.import_module("clover_tpu.ops.mvm")
    key = jax.random.PRNGKey(SEED)
    A = jax.random.uniform(key, (N_MVM, N_MVM), jnp.float32, -1.0, 1.0)
    x = jax.random.uniform(jax.random.fold_in(key, 1), (N_MVM,),
                           jnp.float32, -1.0, 1.0)
    u32 = jax.random.uniform(jax.random.fold_in(key, 2), (N_MVM,),
                             jnp.float32, -1.0, 1.0)
    mats = {4: ct.quantize(A, 4), 8: ct.quantize(A, 8)}
    del A
    R = GOLDEN_ROWS
    for ba, bx in ((4, 4), (4, 8), (8, 8)):
        qA, qx = mats[ba], ct.quantize(x, bx)
        assert ops_mvm._use_kernel(qA, qx), "kernel not chosen on the GPU"
        ob = ops_mvm._out_bits(qA, qx)
        tag = f"{ba}x{bx}"
        y_plain = ops_mvm.mvm_f32(qA, qx)
        y_prod = ops_mvm.mvm_f32_fast(qA, qx)
        check_f32(f"{tag} f32 kernel vs plain", y_prod, y_plain)
        # golden's block-ordered f32 sum over 512 blocks carries its own
        # rounding error, a random walk of 512 half-ulps that reaches
        # ~1.1e-6 of the band maximum over 512 rows; the kernel sums
        # 16-block tiles first and lands within ~2e-7 of the f64 sum.
        # So values and scales are held to golden's f64-accumulated
        # result at 2e-6 and 1e-6, the block-ordered values at 4e-6 and
        # codes to both within one LSB.
        gseq, g32 = golden_rows(qA, qx, R)
        check_f32(f"{tag} f32 kernel vs golden f64 ({R} rows)",
                  np.asarray(y_prod)[:R], g32)
        check_f32(f"{tag} f32 kernel vs golden block-ordered ({R} rows)",
                  np.asarray(y_prod)[:R], gseq, tol=4e-6)
        u = ct.quantize(u32, ob)
        for k1 in (None, jax.random.PRNGKey(7)):
            k2 = None if k1 is None else jax.random.PRNGKey(8)
            mode = "sr" if k1 is not None else "det"
            prod = ct.mvm(qA, qx, key=k1)
            plain = ops_mvm._requant_output(y_plain, qA.rows, ob, k1)
            check_q(f"{tag} {mode} kernel vs plain", prod, plain)
            n1 = (0.0 if k1 is None else
                  np.asarray(_core.noise_like(k1, (qA.rows_pad,)))[:R])
            gc, gs = golden.quantize_vec(g32, ob, n1)
            check_codes(f"{tag} {mode} kernel vs golden f64 ({R} rows)",
                        codes(prod)[:R], np.asarray(prod.scales)[:R // 64],
                        gc, gs)
            gc, _ = golden.quantize_vec(gseq, ob, n1)
            d = np.abs(codes(prod)[:R] - gc).max()
            print(f"  {tag} {mode} kernel vs golden block-ordered "
                  f"({R} rows): max code diff {d}", flush=True)
            assert d <= 1, tag
            fused = ct.mvm_axpy(qA, qx, u, -0.5, key_mvm=k1, key_axpy=k2)
            check_q(f"{tag} {mode} mvm_axpy vs plain scale_and_add", fused,
                    ct.scale_and_add(u, prod, -0.5, key=k2))
            n2 = (0.0 if k2 is None else
                  np.asarray(_core.noise_like(k2, (qA.rows_pad,)))[:R])
            gc, gs = golden.scale_and_add(
                codes(u)[:R], np.asarray(u.scales)[:R // 64],
                codes(prod)[:R], np.asarray(prod.scales)[:R // 64],
                -0.5, ob, n2)
            check_codes(f"{tag} {mode} mvm_axpy vs golden ({R} rows)",
                        codes(fused)[:R], np.asarray(fused.scales)[:R // 64],
                        gc, gs)
    return mats[4]


def reach_target(kind, mat_bits, vec_bits, size, make):
    from clover_tpu.harness.search import SearchProblem
    from clover_tpu.models.tuned import lookup_family
    fam = lookup_family(kind, *size)
    iters, mu = fam[4]
    phi, x_star, y = make(*size, fam["K"]) if fam["K"] else make(*size)
    prob = SearchProblem(phi, y, x_star, mat_bits, vec_bits, k=fam["K"],
                         iteration_limit=iters + 2)
    del phi
    it = prob.iterations_to(mu, fam["quality_target"])
    print(f"  {kind} {mat_bits}x{vec_bits} {size[0]}x{size[1]}: target "
          f"{fam['quality_target']:.4f} reached at iteration {it} "
          f"(tabled {iters}, allowed {iters + 1})", flush=True)
    assert it <= iters + 1, (kind, it, iters)


@phase("4 iht 16384x32768")
def iht_phase():
    from clover_tpu.models.problems import make_iht_problem
    reach_target("iht", 4, 4, IHT_SIZE, make_iht_problem)
    reach_target("iht_mixed", 4, 8, IHT_SIZE, make_iht_problem)


@phase("5 gd 49152x32768")
def gd_phase():
    from clover_tpu.models.problems import make_gd_problem
    reach_target("gd", 4, 4, GD_SIZE, make_gd_problem)


def traces_agree(name, got, want):
    """Two solves of one instance by different reduction orders: 1-LSB
    requant flips compound, so compare regimes, not trajectories — the
    first iteration close, the last in the same plateau."""
    got, want = np.asarray(got), np.asarray(want)
    print(f"  {name}: first {got[0]:.4f}/{want[0]:.4f} "
          f"last {got[-1]:.4f}/{want[-1]:.4f}", flush=True)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(want)), name
    assert abs(got[0] - want[0]) <= 0.05 * want[0] + 1e-4, name
    assert got[-1] <= max(1.3 * want[-1], want[-1] + 0.05), name


@phase("6 batched iht B=8 8192x16384")
def batched_phase():
    import clover_tpu as ct
    from clover_tpu.formats import QVec32
    from clover_tpu.models import iht, iht_batched
    from clover_tpu.models.tuned import lookup_family
    m, n = BATCH_SIZE
    fam = lookup_family("iht", m, n)
    k, mu = fam["K"], fam[4][1]
    key = jax.random.PRNGKey(SEED + 3)
    phi = jax.random.uniform(key, (m, n), jnp.float32, -1.0, 1.0)
    qphi = ct.quantize(phi, 4)
    qphit = ct.transpose(qphi)
    stars, ys = [], []
    for j in range(BATCH):
        perm = jax.random.permutation(jax.random.fold_in(key, j + 1), n)
        xs = jnp.zeros((n,), jnp.float32).at[perm[:k]].set(1.0)
        y = jnp.dot(phi, xs, precision=jax.lax.Precision.HIGHEST)
        s = jnp.max(jnp.abs(y))
        ys.append(ct.quantize(y / s, 4))
        stars.append(QVec32(values=xs / s, length=n))
    del phi
    stack = lambda qs: jax.tree.map(lambda *a: jnp.stack(a), *qs)  # noqa
    res = iht_batched(qphi, qphit, stack(ys), BATCH_ITERS, k, mu,
                      xs_star=stack(stars))
    tr = np.asarray(res.trace)
    assert tr.shape == (BATCH_ITERS, BATCH)
    for j in range(BATCH):
        single = iht(qphi, qphit, ys[j], BATCH_ITERS, k, mu,
                     x_star=stars[j])
        traces_agree(f"problem {j} batched vs single", tr[:, j],
                     single.trace)


@phase("7 MVMServer n=32768")
def serving_phase(qA):
    import clover_tpu as ct
    from clover_tpu.serving import MVMServer
    key = jax.random.PRNGKey(SEED + 4)
    vecs = [ct.quantize(jax.random.uniform(jax.random.fold_in(key, j),
                                           (qA.cols,), jnp.float32,
                                           -1.0, 1.0), 4)
            for j in range(SERVE_VECTORS)]
    futures = []
    server = MVMServer(qA, max_batch=8, max_wait_s=0.002)
    try:
        client = threading.Thread(
            target=lambda: futures.extend(server.submit(v) for v in vecs))
        client.start()
        client.join()
        results = [f.result(timeout=600) for f in futures]
    finally:
        server.close()
    check_requests("requests vs ct.mvm", results,
                   [ct.mvm(qA, v) for v in vecs])


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def on_all_cards(arr, n):
    devs = {s.device for s in arr.addressable_shards}
    assert len(devs) == n, f"shards on {len(devs)} devices, want {n}"
    return sorted(d.id for d in devs)


@phase("S1 sharded iht 32768x65536")
def sharded_iht_phase(cards):
    import clover_tpu as ct
    from clover_tpu.formats import QVec32
    from clover_tpu.models import iht as iht_single
    from clover_tpu.models.problems import make_iht_problem
    from clover_tpu.models.tuned import lookup_family
    from clover_tpu.parallel import make_mesh, shard_matrix, shard_vector
    from clover_tpu.parallel.solvers import iht as iht_sharded
    m, n = SHARDED_SIZE
    meshes = [make_mesh(cards), make_mesh(shape=(cards, 1))]
    for kind, vb in (("iht", 4), ("iht_mixed", 8)):
        fam = lookup_family(kind, m, n)
        iters, mu = fam[4]
        iters += 2                  # reach the target by tabled + 1
        phi, x_star, y = make_iht_problem(m, n, fam["K"])
        qphi = ct.quantize(phi, 4)
        del phi
        qphit = ct.transpose(qphi)
        qy = ct.quantize(y, vb)
        xs = QVec32(values=x_star, length=n)
        single = iht_single(qphi, qphit, qy, iters, fam["K"], mu, x_star=xs)
        ts = np.asarray(single.trace)
        print(f"  {kind} single card: trace {np.round(ts, 4).tolist()}, "
              f"tuned target {fam['quality_target']:.4f}", flush=True)
        for mesh in meshes:
            R, C = mesh.shape["row"], mesh.shape["col"]
            s_phi = shard_matrix(qphi, mesh)
            ids = on_all_cards(s_phi.codes, cards)
            res = iht_sharded(s_phi, shard_matrix(qphit, mesh,
                                                  transposed=True),
                              shard_vector(qy, mesh, "row"), iters,
                              fam["K"], mu, mesh, x_star=xs)
            tp = np.asarray(res.trace)
            traces_agree(f"{kind} 4x{vb} mesh {R}x{C} on devices {ids}, "
                         f"sharded vs single", tp, ts)
            del s_phi, res
        del qphi, qphit


@phase("S2 mvm_psum exact integer 32768x65536")
def sharded_exact_phase(cards):
    from jax.sharding import PartitionSpec as P
    from clover_tpu.formats import QMat4, QVec4, pack_nibbles
    from clover_tpu.parallel import make_mesh, shard_matrix, shard_vector
    from clover_tpu.parallel.ops import mvm_psum
    from clover_tpu.parallel.solvers import _shard_map
    m, n = SHARDED_SIZE
    mesh = make_mesh(cards)
    R, C = mesh.shape["row"], mesh.shape["col"]
    key = jax.random.PRNGKey(SEED + 5)
    ac = jax.random.randint(key, (m, n), -7, 8, jnp.int8)
    xc = jax.random.randint(jax.random.fold_in(key, 1), (n,), -7, 8,
                            jnp.int8)
    want = np.asarray(jax.lax.dot(ac, xc, preferred_element_type=jnp.int32)
                      ).astype(np.float32)
    qA = QMat4(codes=pack_nibbles(ac),
               scales=jnp.full((m // 64, n // 64), 7.0, jnp.float32),
               rows=m, cols=n)
    qx = QVec4(codes=pack_nibbles(xc),
               scales=jnp.full((n // 64,), 7.0, jnp.float32), length=n)
    del ac

    def local(acl, asc, xcl, xsc):
        A_l = QMat4(codes=acl, scales=asc, rows=m // R, cols=n // C)
        x_l = QVec4(codes=xcl, scales=xsc, length=n // C)
        return mvm_psum(A_l, x_l, "col", None, 32, "row").values

    fn = _shard_map(local, mesh,
                    (P("row", "col"), P("row", "col"), P("col"), P("col")),
                    P("row"))
    qAs, qxs = shard_matrix(qA, mesh), shard_vector(qx, mesh, "col")
    ids = on_all_cards(qAs.codes, cards)
    got = np.asarray(jax.jit(fn)(qAs.codes, qAs.scales, qxs.codes,
                                 qxs.scales))
    np.testing.assert_array_equal(got, want)
    print(f"  mesh {R}x{C} on devices {ids}: bit-exact", flush=True)


@phase("S3 sharded MVMServer 32768x65536")
def sharded_server_phase(cards):
    import clover_tpu as ct
    from clover_tpu.parallel import make_mesh, shard_matrix
    from clover_tpu.serving import MVMServer
    m, n = SHARDED_SIZE
    mesh = make_mesh(cards)
    key = jax.random.PRNGKey(SEED + 6)
    qA = ct.quantize(jax.random.uniform(key, (m, n), jnp.float32, -1.0,
                                        1.0), 4)
    qAs = shard_matrix(qA, mesh)
    ids = on_all_cards(qAs.codes, cards)
    vecs = [ct.quantize(jax.random.uniform(jax.random.fold_in(key, j + 1),
                                           (n,), jnp.float32, -1.0, 1.0), 4)
            for j in range(8)]
    server = MVMServer(qAs, max_batch=4, max_wait_s=0.02, mesh=mesh)
    try:
        results = [f.result(timeout=600)
                   for f in [server.submit(v) for v in vecs]]
    finally:
        server.close()
    check_requests(f"requests on devices {ids} vs ct.mvm", results,
                   [ct.mvm(qA, v) for v in vecs])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path, on four GPUs")
    args = ap.parse_args(argv)

    from clover_tpu.utils.compcache import enable as enable_compcache
    enable_compcache()
    device_check(args.cards)
    if args.cards == 1:
        validation()
        qA4 = mvm_phase()
        iht_phase()
        gd_phase()
        batched_phase()
        serving_phase(qA4)
    else:
        sharded_iht_phase(args.cards)
        sharded_exact_phase(args.cards)
        sharded_server_phase(args.cards)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
