"""Multi-host initialization and pod-level mesh construction.

The reference has no distributed layer (SURVEY §2.5); this is the
framework's scale-out entry point: ``jax.distributed`` for process
coordination, with the ("row", "col") compute mesh laid out so that MVM
psums stay on the fast links within a host and only gradient-free
container movement crosses hosts.

Testable single-host via the CPU device simulation
(XLA_FLAGS=--xla_force_host_platform_device_count=N); on real hosts pass
coordinator_address/num_processes/process_id.
"""

from __future__ import annotations

import jax

from .mesh import make_mesh


def _already_initialized() -> bool:
    # NB: do NOT probe via jax.process_count() — that initializes the
    # backends, after which jax.distributed.initialize always fails.
    try:
        return jax.distributed.is_initialized()
    except AttributeError:  # pragma: no cover - older jax
        from jax._src.distributed import global_state
        return global_state.client is not None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """Bring up jax.distributed (idempotent).

    With explicit coordinator args a failure is raised (a multi-process
    job that cannot form is fatal); the no-arg auto-bootstrap downgrades
    to single-process when no cluster environment is detected."""
    if _already_initialized():
        return
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except (RuntimeError, ValueError):
            pass  # no cluster env: single-process mode
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def pod_mesh(shape: tuple[int, int] | None = None):
    """Global ("row", "col") mesh over every addressable device in the
    pod.  Shard-boundary rules (64-block alignment) are enforced by
    parallel.mesh when containers are placed."""
    return make_mesh(n_devices=len(jax.devices()), shape=shape)


def is_coordinator() -> bool:
    return jax.process_index() == 0
