"""Checkpoint / resume for quantized containers and solver state.

The reference persists nothing (SURVEY §5: every error path is exit(1),
the only saved state is grid-search logs).  A production framework
needs real checkpointing: containers are registered pytrees, so Orbax
handles them natively — including sharded containers on a mesh (each host
writes its shards).

    save(path, {"phi": qphi, "x": x, "step": 123})
    state = load(path, like={"phi": qphi0, "x": x0, "step": 0})
"""

from __future__ import annotations

import jax


def save(path: str, state) -> None:
    """Write a pytree (may contain quantized containers) to ``path``."""
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, state, force=True)
    ckptr.wait_until_finished()


def load(path: str, like):
    """Restore a pytree saved by :func:`save`.

    ``like`` is a matching pytree of abstract or concrete values (shape/
    dtype/sharding template) — pass the initial state of your solve.
    """
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    template = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype,
                                       sharding=getattr(x, "sharding", None))
        if hasattr(x, "shape") else x, like)
    return ckptr.restore(path, template)
