"""Continuous-batching MVM server: concurrent requests match individual
fused MVMs."""

import jax
import numpy as np
import jax.numpy as jnp

import clover_tpu as ct
from clover_tpu.formats import BLOCK
from clover_tpu.serving import MVMServer


def _assert_1lsb(got, ref):
    """Batched and per-vector paths agree within 1 output LSB (the f32
    scale-combine may fuse differently across programs; the integer
    accumulation is identical)."""
    gv = np.asarray(ct.restore(got).values)
    rv = np.asarray(ct.restore(ref).values)
    lsb = np.asarray(ref.scales).repeat(BLOCK) / (
        7.0 if ref.bits == 4 else 127.0)
    assert np.all(np.abs(gv - rv) <= lsb * (1 + 1e-3))


def test_server_matches_individual_mvm(rng):
    m, n = 128, 256
    A = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    qA = ct.quantize(jnp.asarray(A), 4)
    vecs = [ct.quantize(jnp.asarray(
        rng.random(n, dtype=np.float32) * 2 - 1), 4) for _ in range(10)]

    server = MVMServer(qA, max_batch=4, max_wait_s=0.01)
    try:
        futures = [server.submit(v) for v in vecs]
        results = [f.result(timeout=120) for f in futures]
    finally:
        server.close()

    for v, got in zip(vecs, results):
        _assert_1lsb(got, ct.mvm(qA, v))


def test_server_sharded_matrix(rng):
    """A mesh-sharded resident matrix serves correctly without a mesh
    argument: the batched MVM is plain XLA, which GSPMD partitions
    following the container's sharding."""
    from clover_tpu.parallel import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = make_mesh(8)                                   # (2, 4)
    m, n = 256, 512
    A = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    qA = ct.quantize(jnp.asarray(A), 4)
    qA_sharded = type(qA)(
        codes=jax.device_put(
            qA.codes, NamedSharding(mesh, P("row", None))),
        scales=jax.device_put(
            qA.scales, NamedSharding(mesh, P("row", None))),
        rows=qA.rows, cols=qA.cols)
    vecs = [ct.quantize(jnp.asarray(
        rng.random(n, dtype=np.float32) * 2 - 1), 4) for _ in range(6)]
    server = MVMServer(qA_sharded, max_batch=4, max_wait_s=0.01)
    try:
        results = [f.result(timeout=120)
                   for f in [server.submit(v) for v in vecs]]
    finally:
        server.close()
    for v, got in zip(vecs, results):
        _assert_1lsb(got, ct.mvm(qA, v))


def test_server_sharded_kernel_path(rng):
    """MVMServer(mesh=...) serves through the shard_map path (per-shard
    batched f32 partials -> psum -> band requant,
    parallel/ops.mvm_batched_psum) and matches both per-vector MVMs and
    the GSPMD-partitioned server."""
    from clover_tpu.parallel import make_mesh, shard_matrix
    mesh = make_mesh(8)                                   # (2, 4)
    m, n = 256, 1024
    A = (rng.random((m, n), dtype=np.float32) * 2 - 1)
    qA = ct.quantize(jnp.asarray(A), 4)
    qAs = shard_matrix(qA, mesh)

    vecs = [ct.quantize(jnp.asarray(
        rng.random(n, dtype=np.float32) * 2 - 1), 4) for _ in range(6)]
    server = MVMServer(qAs, max_batch=4, max_wait_s=0.05, mesh=mesh)
    try:
        results = [f.result(timeout=300)
                   for f in [server.submit(v) for v in vecs]]
    finally:
        server.close()
    fallback = MVMServer(qAs, max_batch=4, max_wait_s=0.05)
    try:
        ref_results = [f.result(timeout=300)
                       for f in [fallback.submit(v) for v in vecs]]
    finally:
        fallback.close()
    for v, got, ref in zip(vecs, results, ref_results):
        _assert_1lsb(got, ct.mvm(qA, v))
        _assert_1lsb(got, ref)


def test_server_error_propagates(rng):
    qA = ct.quantize(jnp.asarray(rng.random((128, 128), np.float32)), 4)
    server = MVMServer(qA, max_batch=2)
    try:
        fut = server.submit("not a vector")
        try:
            fut.result(timeout=60)
            raised = False
        except Exception:
            raised = True
        assert raised
    finally:
        server.close()
