"""Sharded ops / solvers on the simulated 8-device CPU mesh: results must
match the single-device path (deterministic mode: bit-exact up to psum
reduction order; SR mode: statistically converging)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clover_tpu.models import make_iht_problem
from clover_tpu.models.solvers import iht as iht_single
from clover_tpu.ops import quantize_mat, quantize_vec, restore_vec, transpose
from clover_tpu.parallel import make_mesh, shard_matrix, shard_vector
from clover_tpu.parallel.solvers import gd as gd_sharded, iht as iht_sharded
from clover_tpu.formats import QVec32


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_mesh(8)  # (2, 4)


def _problem(m=512, n=1024, k=64):
    phi, x_star, y = make_iht_problem(m, n, k)
    return phi, x_star, y, k


@pytest.mark.parametrize("bits", [4, 8, 32, "4x8"])
def test_sharded_iht_matches_single(mesh, bits):
    """Includes the mixed 4-bit-matrix x 8-bit-vector config — a
    first-class reference feature (test/accuracy/00_accuracy.cpp:84)."""
    phi, x_star, y, k = _problem()
    m, n = phi.shape
    mat_bits, vec_bits = (4, 8) if bits == "4x8" else (bits, bits)
    qphi = quantize_mat(phi, mat_bits, key=None)
    qphit = transpose(qphi)
    qy = quantize_vec(y, vec_bits, key=None)
    mu = 0.0042
    single = iht_single(qphi, qphit, qy, 15, k, mu, key=None,
                        x_star=QVec32(values=x_star, length=n))

    s_phi = shard_matrix(qphi, mesh)
    s_phit = shard_matrix(qphit, mesh, transposed=True)
    s_y = shard_vector(qy, mesh, "row")
    shard = iht_sharded(s_phi, s_phit, s_y, 15, k, mu, mesh,
                        x_star=QVec32(values=x_star, length=n))

    ts = np.asarray(single.trace)
    tp = np.asarray(shard.trace)
    assert np.all(np.isfinite(tp))
    # The psum reduction order differs from the single-device block-sum,
    # so requant floor() flips compound across iterations (chaotic at low
    # bits).  Assert matching behavior, not trajectory identity: the first
    # iteration is close, and both reach the same plateau regime.
    assert abs(tp[0] - ts[0]) <= 0.05 * ts[0] + 1e-4
    assert tp[-1] <= max(1.3 * ts[-1], ts[-1] + 0.05)
    assert tp[-1] < 0.6 * tp[0]


def test_sharded_iht_sr_converges(mesh):
    phi, x_star, y, k = _problem()
    n = phi.shape[1]
    qphi = quantize_mat(phi, 4, key=None)
    qphit = transpose(qphi)
    qy = quantize_vec(y, 4, key=None)
    res = iht_sharded(shard_matrix(qphi, mesh),
                      shard_matrix(qphit, mesh, transposed=True),
                      shard_vector(qy, mesh, "row"),
                      40, k, 0.0042842566, mesh,
                      key=jax.random.PRNGKey(3),
                      x_star=QVec32(values=x_star, length=n))
    tr = np.asarray(res.trace)
    assert tr[-1] < 0.5 * tr[0]
    assert tr[-1] < 0.3


def test_sharded_gd_converges(mesh):
    from clover_tpu.models import make_gd_problem
    phi, x_star, y = make_gd_problem(384, 256)
    n = phi.shape[1]
    qphi = quantize_mat(phi, 8, key=None)
    qphit = transpose(qphi)
    qy = quantize_vec(y, 8, key=None)
    res = gd_sharded(shard_matrix(qphi, mesh),
                     shard_matrix(qphit, mesh, transposed=True),
                     shard_vector(qy, mesh, "row"),
                     100, 0.4, mesh, key=None,
                     x_star=QVec32(values=x_star, length=n))
    tr = np.asarray(res.trace)
    assert np.all(np.isfinite(tr))
    assert tr[-1] < 0.3 * tr[0]


def test_sharded_threshold_matches_single(mesh):
    from jax.sharding import PartitionSpec as P
    from clover_tpu.ops import threshold as threshold_single
    from clover_tpu.parallel.solvers import _shard_map
    from clover_tpu.parallel.ops import threshold_global
    from clover_tpu.formats import QVec8

    rng = np.random.default_rng(0)
    n = 1024
    x = (rng.random(n, dtype=np.float32) * 2 - 1)
    q = quantize_vec(jnp.asarray(x), 8, key=None)
    want = np.asarray(restore_vec(threshold_single(q, 50)).values)

    qs = shard_vector(q, mesh, "col")

    def local(codes, scales):
        xl = QVec8(codes=codes, scales=scales, length=n // 4)
        out = threshold_global(xl, 50, "col")
        return out.codes, out.scales

    fn = _shard_map(local, mesh, (P("col"), P("col")), (P("col"), P("col")))
    codes, scales = jax.jit(fn)(qs.codes, qs.scales)
    got = np.asarray(restore_vec(QVec8(codes=codes, scales=scales,
                                       length=n)).values)
    np.testing.assert_array_equal(got, want)


def _integer_mvm_problem(m=256, n=512):
    """QMat4/QVec4 with integer codes and scale 7 everywhere: restored
    values are exact small integers, per-shard partials are int-valued
    f32 < 2^24, so the psum is EXACT in any reduction order — a
    deterministic cross-check of mvm_psum against the single-device
    reference (VERDICT: no tolerance hides a reduction-order bug)."""
    from clover_tpu.formats import QMat4, QVec4, pack_nibbles

    rng = np.random.default_rng(7)
    ac = rng.integers(-7, 8, (m, n)).astype(np.int8)
    xc = rng.integers(-7, 8, n).astype(np.int8)
    qA = QMat4(codes=pack_nibbles(jnp.asarray(ac)),
               scales=jnp.full((m // 64, n // 64), 7.0, jnp.float32),
               rows=m, cols=n)
    qx = QVec4(codes=pack_nibbles(jnp.asarray(xc)),
               scales=jnp.full((n // 64,), 7.0, jnp.float32),
               length=n)
    want = ac.astype(np.int64) @ xc.astype(np.int64)  # exact integer MVM
    return qA, qx, want.astype(np.float32)


def _run_mvm_psum(mesh, qA, qx):
    from jax.sharding import PartitionSpec as P
    from clover_tpu.formats import QMat4, QVec4
    from clover_tpu.parallel.solvers import _shard_map
    from clover_tpu.parallel.ops import mvm_psum

    m, n = qA.rows, qA.cols

    def local(ac, asc, xc, xsc):
        A_l = QMat4(codes=ac, scales=asc, rows=m // 2, cols=n // 4)
        x_l = QVec4(codes=xc, scales=xsc, length=n // 4)
        y = mvm_psum(A_l, x_l, "col", None, 32, "row")
        return y.values

    fn = _shard_map(local, mesh,
                    (P("row", "col"), P("row", "col"), P("col"), P("col")),
                    P("row"))
    qAs = shard_matrix(qA, mesh)
    qxs = shard_vector(qx, mesh, "col")
    return np.asarray(jax.jit(fn)(qAs.codes, qAs.scales,
                                  qxs.codes, qxs.scales))


def test_mvm_psum_exact_cross_check(mesh):
    qA, qx, want = _integer_mvm_problem()
    got = _run_mvm_psum(mesh, qA, qx)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunks", [1, 3, 4])
def test_mvm_psum_overlapped_exact(mesh, chunks):
    """The chunked-k psum-overlap variant (parallel/ops.py
    mvm_psum_overlapped) must match the exact integer MVM bit-for-bit for
    any chunking, including uneven 64-block splits (VERDICT r2 #6)."""
    from jax.sharding import PartitionSpec as P
    from clover_tpu.formats import QMat4, QVec4
    from clover_tpu.parallel.solvers import _shard_map
    from clover_tpu.parallel.ops import mvm_psum_overlapped

    qA, qx, want = _integer_mvm_problem()
    m, n = qA.rows, qA.cols

    def local(ac, asc, xc, xsc):
        A_l = QMat4(codes=ac, scales=asc, rows=m // 2, cols=n // 4)
        x_l = QVec4(codes=xc, scales=xsc, length=n // 4)
        y = mvm_psum_overlapped(A_l, x_l, "col", None, 32, "row",
                                chunks=chunks)
        return y.values

    fn = _shard_map(local, mesh,
                    (P("row", "col"), P("row", "col"), P("col"), P("col")),
                    P("row"))
    qAs = shard_matrix(qA, mesh)
    qxs = shard_vector(qx, mesh, "col")
    got = np.asarray(jax.jit(fn)(qAs.codes, qAs.scales,
                                 qxs.codes, qxs.scales))
    np.testing.assert_array_equal(got, want)


def test_mvm_psum_overlapped_requant_matches(mesh):
    """With a quantized output precision, the overlapped variant's requant
    must see the fully reduced values: on the exact integer problem the
    4-bit output codes/scales equal mvm_psum's bit-for-bit."""
    from jax.sharding import PartitionSpec as P
    from clover_tpu.formats import QMat4, QVec4
    from clover_tpu.parallel.solvers import _shard_map
    from clover_tpu.parallel.ops import mvm_psum, mvm_psum_overlapped

    qA, qx, _ = _integer_mvm_problem()
    m, n = qA.rows, qA.cols

    def run(fn_inner):
        def local(ac, asc, xc, xsc):
            A_l = QMat4(codes=ac, scales=asc, rows=m // 2, cols=n // 4)
            x_l = QVec4(codes=xc, scales=xsc, length=n // 4)
            y = fn_inner(A_l, x_l)
            return y.codes, y.scales
        fn = _shard_map(local, mesh,
                        (P("row", "col"), P("row", "col"), P("col"),
                         P("col")), (P("row"), P("row")))
        qAs = shard_matrix(qA, mesh)
        qxs = shard_vector(qx, mesh, "col")
        c, s = jax.jit(fn)(qAs.codes, qAs.scales, qxs.codes, qxs.scales)
        return np.asarray(c), np.asarray(s)

    c1, s1 = run(lambda A, x: mvm_psum(A, x, "col", None, 4, "row"))
    c2, s2 = run(lambda A, x: mvm_psum_overlapped(A, x, "col", None, 4,
                                                  "row", chunks=4))
    np.testing.assert_array_equal(c2, c1)
    np.testing.assert_array_equal(s2, s1)


def _integer_iteration_problem(m, n, mat_bits, vec_bits, seed=11):
    """A problem where the FULL first IHT iteration is exact in any
    reduction order: Phi integer-coded with scales = qmax (restored ==
    codes), y integer-coded with a +/-qmax planted per 64-block so its
    requantization through scale_and_add is lossless, x0 = 0.  Then
    t1 = 0 (exact), t2 == y bit-for-bit, the second MVM's psum terms are
    integers < 2^24, and every later step is deterministic elementwise
    math on bit-identical inputs — so the sharded iteration must equal
    the single-device one BIT-FOR-BIT (codes and scales), extending the
    mvm_psum integer trick (above) to the AXPY and threshold legs."""
    from clover_tpu.formats import QMat4, QMat8, QVec4, QVec8, pack_nibbles

    rng = np.random.default_rng(seed)
    qa = 7 if mat_bits == 4 else 127
    qv = 7 if vec_bits == 4 else 127
    ac = rng.integers(-qa, qa + 1, (m, n)).astype(np.int8)
    yc = rng.integers(-qv, qv + 1, m).astype(np.int8)
    yc[::64] = qv                      # plant the per-block absmax
    if mat_bits == 4:
        qA = QMat4(codes=pack_nibbles(jnp.asarray(ac)),
                   scales=jnp.full((m // 64, n // 64), 7.0, jnp.float32),
                   rows=m, cols=n)
    else:
        qA = QMat8(codes=jnp.asarray(ac),
                   scales=jnp.full((m // 64, n // 64), 127.0, jnp.float32),
                   rows=m, cols=n)
    if vec_bits == 4:
        qy = QVec4(codes=pack_nibbles(jnp.asarray(yc)),
                   scales=jnp.full((m // 64,), 7.0, jnp.float32), length=m)
    else:
        qy = QVec8(codes=jnp.asarray(yc),
                   scales=jnp.full((m // 64,), 127.0, jnp.float32), length=m)
    return qA, qy


def _unpacked(qv):
    from clover_tpu.formats import QVec4, unpack_nibbles
    if isinstance(qv, QVec4):
        return np.asarray(unpack_nibbles(qv.codes))
    return np.asarray(qv.codes)


@pytest.mark.parametrize("bits", [4, "4x8"])
def test_sharded_iteration_exact_cross_check(mesh, bits):
    """One full sharded IHT iteration (MVM psum -> AXPY -> MVM psum ->
    AXPY -> gathered threshold) bit-identical to the single-device
    iteration on an exactness-by-construction problem (VERDICT r2 #10)."""
    m, n, k = 512, 1024, 64
    mat_bits, vec_bits = (4, 8) if bits == "4x8" else (4, 4)
    qA, qy = _integer_iteration_problem(m, n, mat_bits, vec_bits)
    qAt = transpose(qA)

    single = iht_single(qA, qAt, qy, 1, k, 0.25, key=None)
    shard = iht_sharded(shard_matrix(qA, mesh),
                        shard_matrix(qAt, mesh, transposed=True),
                        shard_vector(qy, mesh, "row"),
                        1, k, 0.25, mesh, key=None)
    np.testing.assert_array_equal(_unpacked(shard.x), _unpacked(single.x))
    np.testing.assert_array_equal(np.asarray(shard.x.scales),
                                  np.asarray(single.x.scales))
    # the iteration must have produced a real K-sparse update, or the
    # bit-equality above is vacuous
    assert np.count_nonzero(_unpacked(single.x)) == k


def test_mvm_psum_fused_kernel_interpret(mesh, monkeypatch):
    """Same exact cross-check with the fused Triton kernel (interpret
    mode) as each shard's partial: on a GPU mvm_f32_fast dispatches to
    kernels.mvm.mvm_f32 inside shard_map and still matches bit-for-bit."""
    import importlib
    from clover_tpu.formats import QMat4, QVec4
    from clover_tpu.kernels import mvm as kmvm

    ops_mvm = importlib.import_module("clover_tpu.ops.mvm")
    calls = []

    def spy(A, x):
        calls.append(A.codes.shape)
        return orig(A, x, interpret=True)
    orig = kmvm.mvm_f32
    monkeypatch.setattr(ops_mvm, "_on_gpu", lambda: True)
    monkeypatch.setattr(kmvm, "mvm_f32", spy)
    qA, qx, want = _integer_mvm_problem(256, 4096)
    # the per-shard geometry must be kernel-eligible or this test is vacuous
    m, n = qA.rows, qA.cols
    A_l = QMat4(codes=qA.codes[: m // 2, : n // 8],
                scales=qA.scales[: m // 128, : n // 256],
                rows=m // 2, cols=n // 4)
    x_l = QVec4(codes=qx.codes[: n // 8], scales=qx.scales[: n // 256],
                length=n // 4)
    assert kmvm.eligible(A_l, x_l)
    got = _run_mvm_psum(mesh, qA, qx)
    assert calls == [A_l.codes.shape]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [4, "4x8"])
def test_sharded_1x1_bitidentical_to_single(bits):
    """On a 1x1 mesh the sharded solver routes to the single-chip
    iteration (no collectives; parallel/solvers.py r4 fast path) — the
    trajectory must be BIT-identical to models.solvers, SR on and off."""
    from clover_tpu.parallel import make_mesh
    mesh1 = make_mesh(shape=(1, 1))
    phi, x_star, y, k = _problem(256, 512, 32)
    m, n = phi.shape
    mat_bits, vec_bits = (4, 8) if bits == "4x8" else (bits, bits)
    for key in (None, jax.random.PRNGKey(3)):
        qphi = quantize_mat(phi, mat_bits, key=None)
        qphit = transpose(qphi)
        qy = quantize_vec(y, vec_bits, key=None)
        single = iht_single(qphi, qphit, qy, 10, k, 0.0042, key=key,
                            x_star=QVec32(values=x_star, length=n))
        shard = iht_sharded(shard_matrix(qphi, mesh1),
                            shard_matrix(qphit, mesh1, transposed=True),
                            shard_vector(qy, mesh1, "row"),
                            10, k, 0.0042, mesh1, key=key,
                            x_star=QVec32(values=x_star, length=n))
        np.testing.assert_array_equal(np.asarray(single.trace),
                                      np.asarray(shard.trace))
        np.testing.assert_array_equal(np.asarray(single.x.codes),
                                      np.asarray(shard.x.codes))


def test_solver_auto_chunked_psum(mesh):
    """The chunked-psum leg as a solver loop would run it: chunk
    containers prepared ONCE outside a scan and reused by every step
    (unprepared slices would copy the local matrix per call).  Exact on
    the integer problem at every step; a ``prepared`` list of the wrong
    length is rejected.  (The sharded solvers themselves run the plain
    one-chunk mvm_psum until a four-card measurement judges overlap.)"""
    from jax.sharding import PartitionSpec as P
    from clover_tpu.formats import QMat4, QVec4
    from clover_tpu.parallel.ops import (mvm_psum_overlapped,
                                         prepare_psum_chunks)
    from clover_tpu.parallel.solvers import _shard_map

    qA, qx, want = _integer_mvm_problem()
    m, n = qA.rows, qA.cols

    def local(ac, asc, xc, xsc):
        A_l = QMat4(codes=ac, scales=asc, rows=m // 2, cols=n // 4)
        x_l = QVec4(codes=xc, scales=xsc, length=n // 4)
        prep = prepare_psum_chunks(A_l, 3)

        def step(carry, _):
            y = mvm_psum_overlapped(A_l, x_l, "col", None, 32, "row",
                                    chunks=3, prepared=prep)
            return carry, y.values
        return jax.lax.scan(step, 0, None, length=3)[1]

    fn = _shard_map(local, mesh,
                    (P("row", "col"), P("row", "col"), P("col"), P("col")),
                    P(None, "row"))
    qAs = shard_matrix(qA, mesh)
    qxs = shard_vector(qx, mesh, "col")
    got = np.asarray(jax.jit(fn)(qAs.codes, qAs.scales,
                                 qxs.codes, qxs.scales))
    for row in got:
        np.testing.assert_array_equal(row, want)

    A_l = QMat4(codes=qA.codes[: m // 2, : n // 8],
                scales=qA.scales[: m // 128, : n // 256],
                rows=m // 2, cols=n // 4)
    with pytest.raises(AssertionError):
        mvm_psum_overlapped(A_l, None, "col", None, 32, "row", chunks=3,
                            prepared=prepare_psum_chunks(A_l, 2))
