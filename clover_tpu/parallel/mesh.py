"""Device mesh construction and container sharding rules.

The reference's only parallelism is single-node OpenMP over contiguous
block ranges (SURVEY §2.5).  The scale-out here: a 2-D
("row", "col") mesh; matrices sharded over both axes, vectors over the
axis that matches their role in the MVM dataflow:

    Phi  : P(row, col)   over (m, n)
    PhiT : P(col, row)   over (n, m)
    x,t3 : P(col)        (length n)
    y,t1,t2 : P(row)     (length m)

With this layout the whole IHT/GD iteration needs exactly two psums (one
per MVM) and zero resharding — the quantized partial products
are reduced BEFORE output requantization so the band absmax sees the
globally-reduced values (the key correctness subtlety vs the single-node
reference, SURVEY §7.6).

Block alignment: every shard boundary must fall on a 64-element block /
64x64 tile boundary, so per-block scales never straddle shards
(64 divides any shard of a 128-padded dim as long as the per-shard size
is a multiple of 64 — asserted below).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats import BLOCK, QMat4, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32

ROW, COL = "row", "col"


def make_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None,
              devices=None) -> Mesh:
    """Build a ("row", "col") mesh, as square as possible by default."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices) if shape is None else shape[0] * shape[1]
    devices = devices[:n_devices]
    if shape is None:
        r = int(np.floor(np.sqrt(n_devices)))
        while n_devices % r:
            r -= 1
        shape = (r, n_devices // r)
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, (ROW, COL))


def _check(dim: int, parts: int, what: str):
    assert dim % (parts * BLOCK) == 0, (
        f"{what}={dim} must be divisible by {parts} shards x {BLOCK} block")


def _put(arr, mesh: Mesh, spec):
    """Place an array with a NamedSharding.  In a multi-process job
    (jax.distributed over DCN) the full array is assumed replicated on
    every host — the per-process addressable shards are served from it
    via make_array_from_callback, since device_put cannot target
    non-addressable devices."""
    sh = NamedSharding(mesh, spec)
    if jax.process_count() > 1:
        arr_np = np.asarray(arr)
        return jax.make_array_from_callback(
            arr_np.shape, sh, lambda idx: arr_np[idx])
    return jax.device_put(arr, sh)


def mat_sharding(mesh: Mesh, transposed: bool = False):
    """PartitionSpecs for a quantized matrix's (codes, scales).

    ``transposed=True`` gives the PhiT layout P(col, row)."""
    spec = P(COL, ROW) if transposed else P(ROW, COL)
    return spec


def shard_matrix(qA, mesh: Mesh, transposed: bool = False):
    """device_put a quantized matrix with the mesh sharding rules."""
    spec = mat_sharding(mesh, transposed)
    r_parts = mesh.shape[spec[0]]
    c_parts = mesh.shape[spec[1]]
    _check(qA.rows_pad, r_parts, "rows")
    _check(qA.cols_pad, c_parts, "cols")
    if isinstance(qA, (QMat16, QMat32)):
        return type(qA)(values=_put(qA.values, mesh, spec),
                        rows=qA.rows, cols=qA.cols)
    return type(qA)(
        codes=_put(qA.codes, mesh, spec),
        scales=_put(qA.scales, mesh, spec),
        rows=qA.rows, cols=qA.cols)


def shard_vector(qx, mesh: Mesh, axis: str):
    """device_put a quantized vector sharded along one mesh axis,
    replicated along the other."""
    parts = mesh.shape[axis]
    _check(qx.length_pad, parts, "length")
    spec = P(axis)
    if isinstance(qx, (QVec16, QVec32)):
        return type(qx)(values=_put(qx.values, mesh, spec),
                        length=qx.length)
    return type(qx)(
        codes=_put(qx.codes, mesh, spec),
        scales=_put(qx.scales, mesh, spec),
        length=qx.length)
