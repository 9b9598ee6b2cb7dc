"""Continuous-batching MVM server (BASELINE.json north-star component).

The reference is a synchronous library; a production deployment serves
many concurrent quantized-MVM requests against a resident matrix.  This
server implements continuous batching: requests accumulate in a queue, a
dispatcher thread packs up to ``max_batch`` of them into one stacked
container, runs one jitted batched MVM (ops/gemm.mvm_batched), and
resolves each request's future.

Batch sizes are bucketed to powers of two so XLA compiles a bounded set
of programs; short batches are padded with the first request's vector and
the padding results dropped.

Works with a matrix resident on one chip or sharded over a mesh (pass the
already-placed container; the batched MVM follows its sharding).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp

from .ops.gemm import mvm_batched

_BUCKETS = (1, 2, 4, 8, 16, 32)


class MVMServer:
    def __init__(self, qA, max_batch: int = 8, max_wait_s: float = 0.002,
                 key=None, mesh=None):
        """``mesh``: pass the mesh the matrix is sharded over (via
        parallel.shard_matrix) to serve through shard_map — per-shard
        batched f32 partials + psum + band requant
        (parallel/ops.mvm_batched_psum) — instead of leaving the
        partitioning to GSPMD."""
        assert max_batch in _BUCKETS
        self._qA = qA
        self._max_batch = max_batch
        self._max_wait = max_wait_s
        self._key = key
        self._mesh = mesh
        self._sharded_fns: dict = {}
        self._mvm = jax.jit(mvm_batched)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API --------------------------------------------------------

    def submit(self, qx) -> Future:
        """Enqueue a quantized vector; resolves to the quantized result.

        Raises ``RuntimeError`` after :meth:`close` — the dispatcher has
        stopped, so an enqueued future would never resolve."""
        if self._stop.is_set():
            raise RuntimeError("MVMServer is closed")
        fut: Future = Future()
        self._q.put((qx, fut))
        return fut

    def mvm(self, qx):
        """Synchronous convenience wrapper."""
        return self.submit(qx).result()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        # Fail anything still queued so no caller blocks forever.
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("MVMServer closed"))

    # -- dispatcher --------------------------------------------------------

    def _drain(self):
        """Collect up to max_batch requests; ``max_wait_s`` is a single
        deadline for the whole straggler wait, not per get."""
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self._max_wait
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            try:
                self._run(batch)
            except Exception as e:         # resolve futures with the error
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def _run(self, batch):
        n = len(batch)
        size = next(b for b in _BUCKETS if b >= n)
        vecs = [qx for qx, _ in batch]
        vecs += [vecs[0]] * (size - n)              # pad to the bucket
        xs = jax.tree.map(lambda *a: jnp.stack(a), *vecs)
        if self._key is not None:
            self._key, sub = jax.random.split(self._key)
        else:
            sub = None
        if self._mesh is not None:
            ys = self._mvm_sharded(xs, sub)
        else:
            ys = self._mvm(self._qA, xs, key=sub)
        for i, (_, fut) in enumerate(batch):
            yi = jax.tree.map(lambda a: a[i], ys)
            fut.set_result(yi)

    def _mvm_sharded(self, xs, key):
        """shard_map'ed batched MVM: f32 partials per shard -> psum over
        the col axis -> per-vector band requant owned by the row axis.  The function is built once per (vector type,
        bucket, keyed) and jitted."""
        from jax.sharding import PartitionSpec as P
        from .ops.mvm import _out_bits
        from .parallel.mesh import COL, ROW
        from .parallel.ops import mvm_batched_psum
        from .parallel.solvers import (
            _local_mat, _local_vec, _mat_arrays, _shard_map, _vec_arrays)

        mesh, qA = self._mesh, self._qA
        b = jax.tree_util.tree_leaves(xs)[0].shape[0]
        have_key = key is not None
        sig = (type(xs).__name__, b, have_key)
        if sig not in self._sharded_fns:
            R, C = mesh.shape[ROW], mesh.shape[COL]
            out_bits = _out_bits(qA, xs)
            a_arrs, _ = _mat_arrays(qA)
            x_arrs, _ = _vec_arrays(xs)
            n_a, n_x = len(a_arrs), len(x_arrs)

            def local(*args):
                A_l = _local_mat(qA, R, C, args[:n_a])
                xs_l = _local_vec(xs, C, args[n_a:n_a + n_x])
                k0 = args[-1] if have_key else None
                y = mvm_batched_psum(A_l, xs_l, COL, k0, out_bits, ROW)
                return _vec_arrays(y)[0]

            in_specs = ([P(ROW, COL)] * n_a
                        + [P(None, COL)] * n_x
                        + ([P()] if have_key else []))
            n_out = 1 if out_bits in (16, 32) else 2
            out_specs = tuple([P(None, ROW)] * n_out)
            self._sharded_fns[sig] = jax.jit(_shard_map(
                local, mesh, tuple(in_specs), out_specs))

        call_args = [*_mat_arrays(qA)[0], *_vec_arrays(xs)[0]]
        if have_key:
            call_args.append(key)
        outs = self._sharded_fns[sig](*call_args)
        from .formats import QVec4, QVec8
        out_bits = _out_bits(qA, xs)
        if out_bits in (16, 32):
            return type(xs)(values=outs[0], length=qA.rows)
        cls = QVec4 if out_bits == 4 else QVec8
        return cls(codes=outs[0], scales=outs[1], length=qA.rows)
