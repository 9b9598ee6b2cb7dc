"""End-to-end solver accuracy, mirroring the reference accuracy mode
(test/accuracy/00_accuracy.cpp): IHT recovery error per precision, GD
convergence.  Shorter epoch counts than the full protocol keep CI fast;
the CLI runs the full 200-epoch protocol."""

import jax
import numpy as np
import pytest

from clover_tpu.models import (
    make_gd_problem, make_iht_problem, run_gd_accuracy, run_iht_accuracy,
)

# Empirical plateaus at 60 epochs (full protocol converges further); the
# ordering fp32 < fp16 < 8 < 4x8 < 4 is the reference's reported
# precision-quality relationship.
IHT_BOUNDS = {32: 1e-6, 16: 1e-3, 8: 0.02, "4x8": 0.08, 4: 0.2}


@pytest.mark.parametrize("config", [32, 16, 8, "4x8", 4])
def test_iht_recovery(config):
    key = jax.random.PRNGKey(3) if config in (4, 8, "4x8") else None
    tr = np.asarray(run_iht_accuracy(config, epochs=60, key=key))
    assert tr.shape == (60,)
    assert np.all(np.isfinite(tr))
    assert tr[-1] <= IHT_BOUNDS[config], f"{config}: {tr[-1]}"
    # must actually make progress
    assert tr[-1] < 0.5 * tr[0]


def test_iht_deterministic_reproducible():
    t1 = np.asarray(run_iht_accuracy(4, epochs=10, key=None))
    t2 = np.asarray(run_iht_accuracy(4, epochs=10, key=None))
    np.testing.assert_array_equal(t1, t2)


def test_iht_sr_keys_differ():
    t1 = np.asarray(run_iht_accuracy(4, epochs=10, key=jax.random.PRNGKey(0)))
    t2 = np.asarray(run_iht_accuracy(4, epochs=10, key=jax.random.PRNGKey(1)))
    assert not np.array_equal(t1, t2)


@pytest.mark.parametrize("config", [32, 8])
def test_gd_convergence(config):
    key = jax.random.PRNGKey(5) if config == 8 else None
    tr = np.asarray(run_gd_accuracy(config, iterations=100, key=key))
    assert np.all(np.isfinite(tr))
    assert tr[-1] < 0.3 * tr[0]


def _batched_setup(B, m, n, k, bits, seed=0):
    import jax.numpy as jnp
    import clover_tpu as ct
    from clover_tpu.formats import QVec32
    phi, _, _ = make_iht_problem(m, n, k)
    phn = np.asarray(phi)
    rng = np.random.default_rng(seed)
    stars, qys, stars_q = [], [], []
    qphi = ct.quantize(jax.numpy.asarray(phi), bits, key=None)
    for _ in range(B):
        xs = np.zeros(n, np.float32)
        xs[rng.choice(n, k, replace=False)] = 1.0
        y = phn @ xs
        s = float(np.abs(y).max())
        qys.append(ct.quantize(jnp.asarray(y / s), bits, key=None))
        stars_q.append(QVec32(
            values=jnp.asarray(np.pad(xs / s, (0, qphi.cols_pad - n))),
            length=n))
    qphit = ct.transpose(qphi)
    stack = lambda qs: jax.tree.map(lambda *a: jnp.stack(a), *qs)
    return qphi, qphit, qys, stars_q, stack(qys), stack(stars_q)


@pytest.mark.parametrize("bits", [4, 8])
def test_iht_batched_matches_singles(bits):
    """Batched IHT (one matrix stream for B problems) lands in the same
    recovery regime as B independent single solves — same loose 4/8-bit
    tolerance as the sharded solver tests (per-op 1-LSB differences
    compound chaotically at low precision)."""
    from clover_tpu.models import iht, iht_batched
    B, m, n, k, mu, iters = 3, 256, 512, 32, 0.01, 30
    qphi, qphit, qys, stars_q, ys_stack, star_stack = _batched_setup(
        B, m, n, k, bits)
    res = iht_batched(qphi, qphit, ys_stack, iters, k, mu,
                      key=None, xs_star=star_stack)
    tr = np.asarray(res.trace)
    assert tr.shape == (iters, B)
    assert np.all(np.isfinite(tr)) and np.all(tr[-1] < 0.7 * tr[0])
    for j in range(B):
        single = iht(qphi, qphit, qys[j], iters, k, mu,
                     key=None, x_star=stars_q[j])
        st = np.asarray(single.trace)
        # first iteration agrees tightly; finals in the same regime
        assert abs(tr[0, j] - st[0]) <= 0.05 * st[0]
        assert tr[-1, j] <= max(1.3 * st[-1], st[-1] + 0.05)

    # deterministic mode is bit-reproducible
    res2 = iht_batched(qphi, qphit, ys_stack, iters, k, mu,
                       key=None, xs_star=star_stack)
    np.testing.assert_array_equal(np.asarray(res.xs.codes),
                                  np.asarray(res2.xs.codes))


def test_iht_batched_sr_on_fallback():
    """Regression: SR-enabled batched solves must work on the vmapped
    batched MVM — _op_seeds passes carried int32 seeds as `key`, which
    jax.random.split rejected (mvm_batched normalizes via seed_from like
    every other op)."""
    from clover_tpu.models import iht_batched
    B, m, n, k = 2, 256, 512, 32
    qphi, qphit, qys, stars_q, ys_stack, star_stack = _batched_setup(
        B, m, n, k, 4)
    res = iht_batched(qphi, qphit, ys_stack, 5, k, 0.01,
                      key=jax.random.PRNGKey(0), xs_star=star_stack)
    tr = np.asarray(res.trace)
    assert np.all(np.isfinite(tr))
    # SR draws differ between keys
    res2 = iht_batched(qphi, qphit, ys_stack, 5, k, 0.01,
                       key=jax.random.PRNGKey(1), xs_star=star_stack)
    assert not np.array_equal(np.asarray(res.xs.codes),
                              np.asarray(res2.xs.codes))


def test_gd_batched_converges():
    from clover_tpu.models import gd_batched
    B, m, n = 2, 256, 512
    qphi, qphit, qys, stars_q, ys_stack, star_stack = _batched_setup(
        B, m, n, 32, 8)
    res = gd_batched(qphi, qphit, ys_stack, 40, 0.002,
                     key=None, xs_star=star_stack)
    tr = np.asarray(res.trace)
    assert np.all(np.isfinite(tr)) and np.all(tr[-1] < tr[0])


def _iteration_problem(m, n, mb, vb, seed=0):
    import jax.numpy as jnp
    import clover_tpu as ct
    rng = np.random.default_rng(seed)
    phi = rng.random((m, n), dtype=np.float32) * 2 - 1
    y = phi @ (rng.random(n, dtype=np.float32) * 2 - 1)
    qphi = ct.quantize(jnp.asarray(phi), mb)
    return (qphi, ct.transpose(qphi),
            ct.quantize(jnp.asarray(y / np.abs(y).max()), vb),
            ct.quantize(jnp.asarray(rng.random(n, dtype=np.float32) - 0.5),
                        vb))


@pytest.mark.parametrize("mb,vb", [(4, 4), (4, 8)])
@pytest.mark.parametrize("m,n", [(512, 1024), (1024, 512)])
def test_iteration_matches_op_sequence(mb, vb, m, n):
    """One solver iteration is exactly the op sequence it stands for:
    t2 = y - Phi x; x += mu PhiT t2 (each an MVM with its scaleAndAdd),
    then the threshold — deterministic mode, bit for bit."""
    import jax.numpy as jnp
    import clover_tpu as ct
    from clover_tpu.models.solvers import _iteration
    qphi, qphit, qy, qx = _iteration_problem(m, n, mb, vb)
    got = _iteration(qphi, qphit, qy, qx, jnp.float32(1e-3), 64, None)
    t2 = ct.scale_and_add(qy, ct.mvm(qphi, qx), -1.0)
    want = ct.threshold(ct.scale_and_add(qx, ct.mvm(qphit, t2), 1e-3), 64)
    np.testing.assert_array_equal(np.asarray(got.codes),
                                  np.asarray(want.codes))
    np.testing.assert_array_equal(np.asarray(got.scales),
                                  np.asarray(want.scales))


@pytest.mark.parametrize("mb,vb", [(4, 4), (4, 8)])
@pytest.mark.parametrize("k", [64, None])
def test_solve_matches_iteration_sequence(mb, vb, k):
    """A one-step scanned solve equals the jitted iteration bit for bit
    (IHT and, with k=None, GD; SR off).  Longer solves are not compared
    bitwise: XLA fuses the scan body differently from a standalone
    iteration, so a 1-LSB flip can appear from the second step on."""
    import jax.numpy as jnp
    from clover_tpu.models import solvers
    from clover_tpu.formats import unpack_nibbles
    qphi, qphit, qy, _ = _iteration_problem(512, 1024, mb, vb)
    x0 = solvers._initial_x(qphi, qy)
    res = solvers._solve(qphi, qphit, qy, x0, None, 1, k,
                         jnp.float32(1e-3), None)
    # operands as arguments: closed-over constants would be folded at
    # compile time, a different evaluation than the solve's
    step = jax.jit(lambda *a: solvers._iteration(*a, k, None))
    x = step(qphi, qphit, qy, x0, jnp.float32(1e-3))
    np.testing.assert_array_equal(np.asarray(res.x.codes),
                                  np.asarray(x.codes))
    np.testing.assert_array_equal(np.asarray(res.x.scales),
                                  np.asarray(x.scales))
    res3 = solvers._solve(qphi, qphit, qy, x0, None, 3, k,
                          jnp.float32(1e-3), None)
    nnz = np.count_nonzero(np.asarray(unpack_nibbles(res3.x.codes))
                           if res3.x.bits == 4 else np.asarray(res3.x.codes))
    assert nnz > 0 and (k is None or nnz <= k)


def test_problem_generators():
    phi, x, y = make_iht_problem(128, 256, 16)
    assert phi.shape == (128, 256) and x.shape == (256,) and y.shape == (128,)
    assert int(np.count_nonzero(np.asarray(x))) == 16
    np.testing.assert_allclose(np.asarray(phi @ x), np.asarray(y), rtol=1e-6)

    phi, x, y = make_gd_problem(96, 64)
    norms = np.linalg.norm(np.asarray(phi), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)
    assert set(np.unique(np.asarray(x))) == {-1.0, 1.0}


def test_reference_problem_instance_bit_exact():
    """make_iht_problem_reference reproduces the exact (Phi, x*, y) the
    reference's `clover -a` solves.  The pinned bit patterns below were
    cross-validated in round 3 against a from-source build of the
    reference driven with its committed data keys
    (doc/results/mixed48_rootcause_r3.md): Phi, x*, y all bit-equal."""
    from clover_tpu.models.problems import make_iht_problem_reference
    phi, x, y = make_iht_problem_reference(512, 1024, 64)
    assert phi.view(np.int32)[0, 0] == 1040173136       # 0.12489378
    assert phi.view(np.int32)[0, 1] == -1104141380      # -0.17201132
    assert phi.view(np.int32)[511, 1023] == 1064194060
    assert abs(float(phi.astype(np.float64).sum()) - (-183.7597440481186)) < 1e-9
    nz = np.nonzero(x)[0]
    assert nz[:8].tolist() == [6, 10, 11, 27, 45, 85, 87, 133]
    assert len(nz) == 64 and int(nz.sum()) == 32050
    assert y.view(np.int32)[:3].tolist() == [1090290054, 1091896697, -1074667511]
    assert y.view(np.int32)[511] == 1072825040
    np.testing.assert_allclose(phi @ x, y, rtol=1e-5, atol=1e-5)
