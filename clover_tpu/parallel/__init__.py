"""Mesh-sharded execution: sharding rules, per-shard collective ops, and
distributed GD/IHT solvers (a psum over the interconnect replaces the
reference's OpenMP shared-memory combines)."""

from .mesh import COL, ROW, make_mesh, shard_matrix, shard_vector
from .multihost import initialize, is_coordinator, pod_mesh
from .ops import dot_psum, mvm_psum, threshold_global
from . import solvers

__all__ = [
    "make_mesh", "shard_matrix", "shard_vector", "ROW", "COL",
    "mvm_psum", "dot_psum", "threshold_global", "solvers",
    "initialize", "pod_mesh", "is_coordinator",
]
